"""SQL tokenizer, recursive-descent parser and AST for the SQL frontend
(the port's copy of ``repro.core.sqlast``, pure Python, unchanged in
behaviour so that both engines parse a text into the same tree).

This is the engine's *bundled* parser: a dependency-free implementation of
the ANSI-ish SELECT subset the lowering layer (``core.sql``) can execute —
SELECT [DISTINCT] / FROM (comma and explicit INNER JOIN) / WHERE / GROUP BY
/ HAVING / ORDER BY / LIMIT, WITH-CTEs, derived tables, scalar & IN/EXISTS
subqueries, CASE, EXTRACT, SUBSTRING, LIKE, BETWEEN, IN, date + interval
literals. When the optional ``sqlglot`` dependency is installed (the
``[sql]`` extra), ``core.sql`` first normalizes other dialects down to this
subset; the bundled parser is always the one producing the AST.

Two error types, both loud:

* ``SqlParseError`` — the text is not valid SQL for this grammar (carries
  the offending token and position).
* ``SqlUnsupportedError`` — the construct parsed fine but the engine cannot
  execute it (names the construct, e.g. ``UNION``, ``LEFT OUTER JOIN``,
  window functions). Raised here for syntax-level constructs and by
  ``core.sql`` for semantic ones.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


class SqlParseError(ValueError):
    """The SQL text does not parse under the supported grammar."""


class SqlUnsupportedError(ValueError):
    """Valid SQL, but a construct the engine cannot lower/execute.

    The message always names the offending construct so failures are
    diagnosable from the exception alone (never silently wrong results).
    """


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------

_KEYWORDS = {
    "SELECT", "DISTINCT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER",
    "LIMIT", "AS", "AND", "OR", "NOT", "IN", "EXISTS", "BETWEEN", "LIKE",
    "IS", "NULL", "CASE", "WHEN", "THEN", "ELSE", "END", "JOIN", "INNER",
    "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "ON", "ASC", "DESC", "DATE",
    "INTERVAL", "EXTRACT", "SUBSTRING", "FOR", "WITH", "UNION", "EXCEPT",
    "INTERSECT", "ALL", "ANY", "SOME", "OVER", "CAST", "TRUE", "FALSE",
    "OFFSET", "USING", "NATURAL", "VALUES",
}

_TWO_CHAR_OPS = ("<=", ">=", "<>", "!=", "||")
_ONE_CHAR_OPS = "+-*/(),.;=<>"


@dataclasses.dataclass
class Token:
    """One lexed token (kind, text, source offset)."""
    kind: str          # kw | ident | int | float | str | op | end
    value: str
    pos: int           # character offset (error messages)


def tokenize(sql: str) -> List[Token]:
    """Lex SQL text into tokens; raises ``SqlParseError`` on bad input."""
    out: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):                      # line comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "'":                                     # string ('' escapes)
            j, buf = i + 1, []
            while True:
                if j >= n:
                    raise SqlParseError(
                        f"unterminated string literal at position {i}")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            out.append(Token("str", "".join(buf), i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n and (sql[j].isdigit() or (sql[j] == "." and not seen_dot)):
                seen_dot = seen_dot or sql[j] == "."
                j += 1
            text = sql[i:j]
            out.append(Token("float" if "." in text else "int", text, i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            upper = word.upper()
            if upper in _KEYWORDS:
                out.append(Token("kw", upper, i))
            else:
                out.append(Token("ident", word.lower(), i))
            i = j
            continue
        two = sql[i:i + 2]
        if two in _TWO_CHAR_OPS:
            out.append(Token("op", two, i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS:
            out.append(Token("op", c, i))
            i += 1
            continue
        raise SqlParseError(f"unexpected character {c!r} at position {i}")
    out.append(Token("end", "", n))
    return out


# ---------------------------------------------------------------------------
# expression AST
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SqlExpr:
    """Base class for parsed SQL expressions."""


@dataclasses.dataclass
class SCol(SqlExpr):
    """Column reference, optionally qualified: ``n1.n_name``."""
    qualifier: Optional[str]
    name: str


@dataclasses.dataclass
class SLit(SqlExpr):
    """Literal; ``kind`` in int | float | str | date | bool."""
    value: object
    kind: str


@dataclasses.dataclass
class SInterval(SqlExpr):
    """``INTERVAL 'n' unit`` — only valid added to / subtracted from dates."""
    n: int
    unit: str          # year | month | day


@dataclasses.dataclass
class SBin(SqlExpr):
    """Binary operator; op in and/or/add/sub/mul/div/eq/ne/lt/le/gt/ge."""
    op: str
    lhs: SqlExpr
    rhs: SqlExpr


@dataclasses.dataclass
class SNot(SqlExpr):
    """Logical negation: ``NOT expr``."""
    operand: SqlExpr


@dataclasses.dataclass
class SNeg(SqlExpr):
    """Arithmetic negation: ``-expr``."""
    operand: SqlExpr


@dataclasses.dataclass
class SFunc(SqlExpr):
    """Function call (aggregates and scalar functions)."""
    name: str                      # lowercased
    args: List[SqlExpr]
    distinct: bool = False
    star: bool = False             # count(*)


@dataclasses.dataclass
class SExtract(SqlExpr):
    """``EXTRACT(field FROM expr)``."""
    field: str                     # lowercased, e.g. 'year'
    operand: SqlExpr


@dataclasses.dataclass
class SSubstr(SqlExpr):
    """``SUBSTRING(x FROM a FOR b)`` / ``SUBSTRING(x, a, b)``."""
    operand: SqlExpr
    start: int
    length: int


@dataclasses.dataclass
class SCase(SqlExpr):
    """Searched CASE: ``CASE WHEN c THEN v ... [ELSE d] END``."""
    whens: List[Tuple[SqlExpr, SqlExpr]]
    default: Optional[SqlExpr]


@dataclasses.dataclass
class SIn(SqlExpr):
    """``x IN (literal, ...)``."""
    operand: SqlExpr
    values: List[SLit]
    negated: bool = False


@dataclasses.dataclass
class SInSelect(SqlExpr):
    """``x [NOT] IN (SELECT ...)``."""
    operand: SqlExpr
    select: "Select"
    negated: bool = False


@dataclasses.dataclass
class SExists(SqlExpr):
    """``[NOT] EXISTS (SELECT ...)``."""
    select: "Select"
    negated: bool = False


@dataclasses.dataclass
class SBetween(SqlExpr):
    """``expr BETWEEN lo AND hi`` (inclusive bounds)."""
    operand: SqlExpr
    lo: SqlExpr
    hi: SqlExpr


@dataclasses.dataclass
class SLike(SqlExpr):
    """``expr [NOT] LIKE 'pattern'`` (``%`` wildcards only)."""
    operand: SqlExpr
    pattern: str
    negated: bool = False


@dataclasses.dataclass
class SScalar(SqlExpr):
    """Scalar subquery: ``(SELECT agg(...) ...)`` used as a value."""
    select: "Select"


@dataclasses.dataclass
class SStar(SqlExpr):
    """``*`` / ``alias.*`` in a select list."""
    qualifier: Optional[str] = None


# ---------------------------------------------------------------------------
# statement AST
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SelectItem:
    """One SELECT-list entry: expression plus optional ``AS`` alias."""
    expr: SqlExpr
    alias: Optional[str]


@dataclasses.dataclass
class TableRef:
    """Base-table (or CTE) reference in FROM."""
    name: str
    alias: str                     # defaults to the table name


@dataclasses.dataclass
class SubqueryRef:
    """Derived table: ``( SELECT ... ) alias``."""
    select: "Select"
    alias: str


@dataclasses.dataclass
class Select:
    """One parsed SELECT statement (plus its WITH-bound CTEs)."""
    items: List[SelectItem]
    from_items: List[object]                 # TableRef | SubqueryRef
    distinct: bool = False
    # ON-conjuncts from explicit JOIN syntax; merged with WHERE by lowering
    join_conditions: List[SqlExpr] = dataclasses.field(default_factory=list)
    where: Optional[SqlExpr] = None
    group_by: List[SqlExpr] = dataclasses.field(default_factory=list)
    having: Optional[SqlExpr] = None
    order_by: List[Tuple[SqlExpr, bool]] = dataclasses.field(
        default_factory=list)               # (expr, descending)
    limit: Optional[int] = None
    ctes: List[Tuple[str, "Select"]] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

_AGG_FUNCS = {"sum", "avg", "min", "max", "count"}
_CMP_OPS = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt", "<=": "le",
            ">": "gt", ">=": "ge"}


class _Parser:
    def __init__(self, tokens: List[Token], sql: str):
        self.toks = tokens
        self.sql = sql
        self.i = 0

    # -- token helpers ------------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "end":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        t = self.next()
        if t.kind != "kw" or t.value != kw:
            raise SqlParseError(
                f"expected {kw} at position {t.pos}, got {t.value!r}")

    def expect_op(self, op: str) -> None:
        t = self.next()
        if t.kind != "op" or t.value != op:
            raise SqlParseError(
                f"expected {op!r} at position {t.pos}, got {t.value!r}")

    def expect_ident(self, what: str) -> str:
        t = self.next()
        if t.kind == "ident":
            return t.value
        raise SqlParseError(
            f"expected {what} at position {t.pos}, got {t.value!r}")

    # -- statement ----------------------------------------------------------
    def parse_statement(self) -> Select:
        ctes: List[Tuple[str, Select]] = []
        if self.accept_kw("WITH"):
            while True:
                name = self.expect_ident("CTE name")
                self.expect_kw("AS")
                self.expect_op("(")
                ctes.append((name, self.parse_select()))
                self.expect_op(")")
                if not self.accept_op(","):
                    break
        sel = self.parse_select()
        sel.ctes = ctes + sel.ctes
        self.accept_op(";")
        t = self.peek()
        if t.kind != "end":
            raise SqlParseError(
                f"trailing input at position {t.pos}: {t.value!r}")
        return sel

    def parse_select(self) -> Select:
        self.expect_kw("SELECT")
        distinct = bool(self.accept_kw("DISTINCT"))
        self.accept_kw("ALL")
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())
        sel = Select(items=items, from_items=[], distinct=distinct)
        if self.accept_kw("FROM"):
            self.parse_from(sel)
        if self.accept_kw("WHERE"):
            sel.where = self.parse_expr()
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            sel.group_by.append(self.parse_expr())
            while self.accept_op(","):
                sel.group_by.append(self.parse_expr())
        if self.accept_kw("HAVING"):
            sel.having = self.parse_expr()
        if self.at_kw("UNION", "EXCEPT", "INTERSECT"):
            raise SqlUnsupportedError(
                f"set operation {self.peek().value} is not supported")
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.parse_expr()
                desc = False
                if self.accept_kw("DESC"):
                    desc = True
                else:
                    self.accept_kw("ASC")
                sel.order_by.append((e, desc))
                if not self.accept_op(","):
                    break
        if self.accept_kw("LIMIT"):
            t = self.next()
            if t.kind != "int":
                raise SqlParseError(
                    f"LIMIT expects an integer at position {t.pos}")
            sel.limit = int(t.value)
        if self.at_kw("OFFSET"):
            raise SqlUnsupportedError("OFFSET is not supported")
        return sel

    def parse_from(self, sel: Select) -> None:
        sel.from_items.append(self.parse_from_item())
        while True:
            if self.accept_op(","):
                sel.from_items.append(self.parse_from_item())
                continue
            if self.at_kw("LEFT", "RIGHT", "FULL", "CROSS", "NATURAL"):
                raise SqlUnsupportedError(
                    f"{self.peek().value} JOIN is not supported "
                    f"(only INNER equi-joins)")
            if self.at_kw("JOIN", "INNER"):
                self.accept_kw("INNER")
                self.expect_kw("JOIN")
                sel.from_items.append(self.parse_from_item())
                if self.at_kw("USING"):
                    raise SqlUnsupportedError(
                        "JOIN ... USING is not supported (use ON)")
                self.expect_kw("ON")
                sel.join_conditions.append(self.parse_expr())
                continue
            break

    def parse_from_item(self):
        if self.accept_op("("):
            sub = self.parse_select()
            self.expect_op(")")
            self.accept_kw("AS")
            alias = self.expect_ident("derived-table alias")
            return SubqueryRef(sub, alias)
        name = self.expect_ident("table name")
        alias = name
        if self.accept_kw("AS"):
            alias = self.expect_ident("table alias")
        elif self.peek().kind == "ident":
            alias = self.next().value
        return TableRef(name, alias)

    def parse_select_item(self) -> SelectItem:
        if self.at_op("*"):
            self.next()
            return SelectItem(SStar(), None)
        if (self.peek().kind == "ident" and self.peek(1).kind == "op"
                and self.peek(1).value == "."
                and self.peek(2).kind == "op" and self.peek(2).value == "*"):
            qual = self.next().value
            self.next()
            self.next()
            return SelectItem(SStar(qual), None)
        e = self.parse_expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.expect_ident("column alias")
        elif self.peek().kind == "ident":
            alias = self.next().value
        return SelectItem(e, alias)

    # -- expressions --------------------------------------------------------
    def parse_expr(self) -> SqlExpr:
        return self.parse_or()

    def parse_or(self) -> SqlExpr:
        e = self.parse_and()
        while self.accept_kw("OR"):
            e = SBin("or", e, self.parse_and())
        return e

    def parse_and(self) -> SqlExpr:
        e = self.parse_not()
        while self.accept_kw("AND"):
            e = SBin("and", e, self.parse_not())
        return e

    def parse_not(self) -> SqlExpr:
        if self.at_kw("NOT") and not (
                self.peek(1).kind == "kw" and self.peek(1).value == "EXISTS"):
            self.next()
            return SNot(self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> SqlExpr:
        if self.at_kw("EXISTS") or (
                self.at_kw("NOT") and self.peek(1).kind == "kw"
                and self.peek(1).value == "EXISTS"):
            negated = self.accept_kw("NOT")
            self.expect_kw("EXISTS")
            self.expect_op("(")
            sub = self.parse_select()
            self.expect_op(")")
            return SExists(sub, negated)
        e = self.parse_additive()
        # postfix predicates: IN / BETWEEN / LIKE / IS [NOT] NULL
        negated = False
        if self.at_kw("NOT") and self.peek(1).kind == "kw" \
                and self.peek(1).value in ("IN", "BETWEEN", "LIKE"):
            self.next()
            negated = True
        if self.accept_kw("IN"):
            self.expect_op("(")
            if self.at_kw("SELECT", "WITH"):
                sub = self.parse_select()
                self.expect_op(")")
                return SInSelect(e, sub, negated)
            values = [self.parse_literal("IN list")]
            while self.accept_op(","):
                values.append(self.parse_literal("IN list"))
            self.expect_op(")")
            out: SqlExpr = SIn(e, values)
            return SNot(out) if negated else out
        if self.accept_kw("BETWEEN"):
            lo = self.parse_additive()
            self.expect_kw("AND")
            hi = self.parse_additive()
            out = SBetween(e, lo, hi)
            return SNot(out) if negated else out
        if self.accept_kw("LIKE"):
            t = self.next()
            if t.kind != "str":
                raise SqlParseError(
                    f"LIKE expects a string pattern at position {t.pos}")
            return SLike(e, t.value, negated)
        if self.accept_kw("IS"):
            raise SqlUnsupportedError(
                "IS [NOT] NULL is not supported (the engine has no NULLs)")
        for op_text, op in _CMP_OPS.items():
            if self.at_op(op_text):
                self.next()
                if self.at_kw("ANY", "SOME", "ALL"):
                    raise SqlUnsupportedError(
                        f"quantified comparison {self.peek().value} "
                        f"is not supported")
                return SBin(op, e, self.parse_additive())
        return e

    def parse_additive(self) -> SqlExpr:
        e = self.parse_multiplicative()
        while True:
            if self.accept_op("+"):
                e = SBin("add", e, self.parse_multiplicative())
            elif self.accept_op("-"):
                e = SBin("sub", e, self.parse_multiplicative())
            elif self.at_op("||"):
                raise SqlUnsupportedError(
                    "string concatenation || is not supported")
            else:
                return e

    def parse_multiplicative(self) -> SqlExpr:
        e = self.parse_unary()
        while True:
            if self.accept_op("*"):
                e = SBin("mul", e, self.parse_unary())
            elif self.accept_op("/"):
                e = SBin("div", e, self.parse_unary())
            else:
                return e

    def parse_unary(self) -> SqlExpr:
        if self.accept_op("-"):
            e = self.parse_unary()
            if isinstance(e, SLit) and e.kind in ("int", "float"):
                return SLit(-e.value, e.kind)
            return SNeg(e)
        self.accept_op("+")
        return self.parse_primary()

    def parse_literal(self, ctx: str) -> SLit:
        t = self.peek()
        if t.kind == "int":
            self.next()
            return SLit(int(t.value), "int")
        if t.kind == "float":
            self.next()
            return SLit(float(t.value), "float")
        if t.kind == "str":
            self.next()
            return SLit(t.value, "str")
        if self.accept_kw("DATE"):
            s = self.next()
            if s.kind != "str":
                raise SqlParseError(
                    f"DATE expects a 'YYYY-MM-DD' string at position {s.pos}")
            return SLit(s.value, "date")
        if self.accept_op("-"):
            lit = self.parse_literal(ctx)
            if lit.kind not in ("int", "float"):
                raise SqlParseError(f"cannot negate {lit.kind} in {ctx}")
            return SLit(-lit.value, lit.kind)
        raise SqlParseError(
            f"{ctx}: expected a literal at position {t.pos}, got {t.value!r}")

    def parse_primary(self) -> SqlExpr:
        t = self.peek()
        if t.kind in ("int", "float", "str"):
            return self.parse_literal("expression")
        if self.accept_kw("TRUE"):
            return SLit(True, "bool")
        if self.accept_kw("FALSE"):
            return SLit(False, "bool")
        if self.at_kw("NULL"):
            raise SqlUnsupportedError(
                "NULL literal is not supported (the engine has no NULLs)")
        if self.at_kw("DATE"):
            return self.parse_literal("expression")
        if self.accept_kw("INTERVAL"):
            s = self.next()
            if s.kind != "str":
                raise SqlParseError(
                    f"INTERVAL expects a quoted count at position {s.pos}")
            unit = self.expect_ident("interval unit").lower().rstrip("s")
            if unit not in ("year", "month", "day"):
                raise SqlUnsupportedError(
                    f"INTERVAL unit '{unit}' is not supported")
            return SInterval(int(s.value), unit)
        if self.accept_kw("CASE"):
            if not self.at_kw("WHEN"):
                raise SqlUnsupportedError(
                    "simple CASE <expr> WHEN is not supported "
                    "(use searched CASE WHEN <cond>)")
            whens = []
            while self.accept_kw("WHEN"):
                cond = self.parse_expr()
                self.expect_kw("THEN")
                whens.append((cond, self.parse_expr()))
            default = self.parse_expr() if self.accept_kw("ELSE") else None
            self.expect_kw("END")
            return SCase(whens, default)
        if self.accept_kw("EXTRACT"):
            self.expect_op("(")
            field = self.expect_ident("EXTRACT field").lower()
            self.expect_kw("FROM")
            operand = self.parse_expr()
            self.expect_op(")")
            return SExtract(field, operand)
        if self.accept_kw("SUBSTRING"):
            self.expect_op("(")
            operand = self.parse_expr()
            if not self.accept_kw("FROM"):
                self.expect_op(",")
            start = self._int_arg("SUBSTRING start")
            if not self.accept_kw("FOR"):
                self.expect_op(",")
            length = self._int_arg("SUBSTRING length")
            self.expect_op(")")
            return SSubstr(operand, start, length)
        if self.at_kw("CAST"):
            raise SqlUnsupportedError("CAST is not supported")
        if self.accept_op("("):
            if self.at_kw("SELECT", "WITH"):
                sub = self.parse_select()
                self.expect_op(")")
                return SScalar(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "ident":
            # function call?
            if self.peek(1).kind == "op" and self.peek(1).value == "(":
                name = self.next().value
                self.next()                               # '('
                distinct = bool(self.accept_kw("DISTINCT"))
                star = False
                args: List[SqlExpr] = []
                if self.accept_op("*"):
                    star = True
                elif not self.at_op(")"):
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
                self.expect_op(")")
                if self.at_kw("OVER"):
                    raise SqlUnsupportedError(
                        f"window function {name}() OVER is not supported")
                return SFunc(name, args, distinct=distinct, star=star)
            name = self.next().value
            if self.accept_op("."):
                col = self.next()
                if col.kind == "op" and col.value == "*":
                    return SStar(name)
                if col.kind not in ("ident", "kw"):
                    raise SqlParseError(
                        f"expected column after '{name}.' at position "
                        f"{col.pos}")
                return SCol(name, col.value.lower())
            return SCol(None, name)
        raise SqlParseError(
            f"unexpected token {t.value!r} at position {t.pos}")

    def _int_arg(self, ctx: str) -> int:
        t = self.next()
        if t.kind != "int":
            raise SqlParseError(
                f"{ctx} expects an integer at position {t.pos}")
        return int(t.value)


def parse(sql: str) -> Select:
    """Parse one SELECT statement into the AST.

    Raises ``SqlParseError`` for invalid syntax and ``SqlUnsupportedError``
    for recognized-but-unsupported constructs (set operations, outer joins,
    window functions, ...)::

        >>> sel = parse("SELECT a, sum(b) AS s FROM t GROUP BY a")
        >>> [i.alias for i in sel.items]
        [None, 's']
    """
    return _Parser(tokenize(sql), sql).parse_statement()


# ---------------------------------------------------------------------------
# AST walking helpers (used by the lowering layer)
# ---------------------------------------------------------------------------

def children(e: SqlExpr) -> Sequence[SqlExpr]:
    """Direct subexpressions of ``e`` (subquery bodies are NOT descended)."""
    if isinstance(e, SBin):
        return (e.lhs, e.rhs)
    if isinstance(e, (SNot, SNeg)):
        return (e.operand,)
    if isinstance(e, SFunc):
        return tuple(e.args)
    if isinstance(e, (SExtract, SSubstr)):
        return (e.operand,)
    if isinstance(e, SCase):
        out = []
        for c, v in e.whens:
            out.extend((c, v))
        if e.default is not None:
            out.append(e.default)
        return tuple(out)
    if isinstance(e, SIn):
        return (e.operand,)
    if isinstance(e, SInSelect):
        return (e.operand,)
    if isinstance(e, SBetween):
        return (e.operand, e.lo, e.hi)
    if isinstance(e, SLike):
        return (e.operand,)
    return ()


def walk(e: SqlExpr):
    """Yield ``e`` and every descendant (subquery bodies not descended)."""
    yield e
    for c in children(e):
        yield from walk(c)


def conjuncts(e: Optional[SqlExpr]) -> List[SqlExpr]:
    """Split a predicate on top-level ANDs."""
    if e is None:
        return []
    if isinstance(e, SBin) and e.op == "and":
        return conjuncts(e.lhs) + conjuncts(e.rhs)
    return [e]


def contains_aggregate(e: SqlExpr) -> bool:
    """True if ``e`` contains an aggregate function call (not in subqueries)."""
    return any(isinstance(x, SFunc) and x.name in _AGG_FUNCS
               for x in walk(e))


def contains_subquery(e: SqlExpr) -> bool:
    """True if ``e`` contains an IN/EXISTS/scalar subquery node."""
    return any(isinstance(x, (SInSelect, SExists, SScalar))
               for x in walk(e))
