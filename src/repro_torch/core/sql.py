"""SQL frontend: lower parsed SQL onto the fluent ``QueryBuilder`` (the
port's copy of ``repro.core.sql``, over the port's builder, expressions,
dtypes and optimizer statistics, so that a text lowers to a plan whose
fingerprint equals the reference's).

The paper runs unmodified Presto SQL against the GPU engine; this module is
that surface for the repro: ``Session.sql("SELECT ...")`` parses the text
with the bundled recursive-descent parser (``core.sqlast``) and lowers it
onto the existing ``core.builder.QueryBuilder`` — reusing its build-time
schema validation and the rule-based optimizer unchanged — so the returned
builder supports ``.collect()``, ``.submit()``, ``.explain()`` exactly like
a hand-built query::

    out = session.sql(
        "SELECT l_returnflag, sum(l_quantity) AS q "
        "FROM lineitem WHERE l_shipdate <= DATE '1998-09-02' "
        "GROUP BY l_returnflag ORDER BY l_returnflag").collect()

Supported: SELECT [DISTINCT] / FROM (comma joins + INNER JOIN ... ON) /
WHERE / GROUP BY / HAVING / ORDER BY / LIMIT, WITH-CTEs, derived tables,
arithmetic + comparison + boolean expressions, BETWEEN / IN / LIKE /
EXTRACT(YEAR) / SUBSTRING / searched CASE, the aggregates
sum/avg/min/max/count (+ the sole-aggregate COUNT(DISTINCT)), semi/anti
joins from [NOT] IN (SELECT ...) and [NOT] EXISTS, and scalar subqueries
(uncorrelated → ``ScalarBroadcast``; equi-correlated → group-by
decorrelation into a join). Everything else raises ``SqlUnsupportedError``
naming the construct — never silently wrong results.

String semantics follow the engine's dtypes: dict-encoded columns compare
as codes (the dictionaries are sorted, so order comparisons are
lexicographic) and LIKE over them constant-folds against the dictionary;
fixed-width bytes columns support the %-pattern subset of LIKE via
``BytesMatch``; ``SUBSTRING(col, 1, n)`` over digit prefixes lowers to
``PrefixCode``.

When the optional ``sqlglot`` dependency (the ``[sql]`` extra) is
installed, ``lower_sql(..., dialect="postgres")`` first transpiles foreign
dialects to this subset; without it, a ``dialect=`` request fails loudly.
"""

from __future__ import annotations

import bisect
import re
from typing import Callable, Dict, List, Optional, Tuple

from . import dtypes as dt
from . import optimizer as opt
from . import sqlast as A
from .builder import QueryBuilder, SchemaError
from .expr import (BinaryOp, BytesMatch, ColumnRef, Expr, IsIn, Literal,
                   PrefixCode, UnaryOp, Year, col)
from .sqlast import SqlParseError, SqlUnsupportedError  # noqa: F401 (re-export)

_AGG_FUNCS = {"sum", "avg", "min", "max", "count"}
_CMP_FLIP = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge",
             "gt": "lt", "ge": "le"}
_LARGE_ROWS = 1 << 20


class _Source:
    """One FROM item: its builder, logical→physical column map, stats."""

    def __init__(self, alias: str, builder: QueryBuilder, rows: int,
                 unique: List[frozenset]):
        self.alias = alias
        self.builder = builder
        # logical (SQL-visible) name -> physical column name in the joined
        # builder; identical until a cross-source collision forces a rename
        self.colmap: Dict[str, str] = {c: c for c in builder.schema}
        self.rows = max(int(rows), 1)
        self.unique = unique            # frozensets of *logical* names


class _Frame:
    """The joined FROM/WHERE state of one SELECT: builder + resolution."""

    def __init__(self, sources: List[_Source]):
        self.sources = sources
        self.builder: Optional[QueryBuilder] = None
        # correlation equi-pairs discovered while lowering a subquery:
        # (outer physical column, inner physical column)
        self.corr: List[Tuple[str, str]] = []

    def locate(self, qual: Optional[str], name: str) -> Optional[_Source]:
        if qual is not None:
            src = next((s for s in self.sources if s.alias == qual), None)
            return src if src is not None and name in src.colmap else None
        hits = [s for s in self.sources if name in s.colmap]
        if len(hits) > 1:
            raise SchemaError(
                f"column '{name}' is ambiguous between "
                f"{sorted(s.alias for s in hits)}; qualify it")
        return hits[0] if hits else None

    def phys(self, qual: Optional[str], name: str) -> Optional[str]:
        src = self.locate(qual, name)
        return src.colmap[name] if src is not None else None


class _ExprCtx:
    """Everything expression lowering needs at one point in the pipeline."""

    def __init__(self, resolve: Callable[[Optional[str], str], Optional[str]],
                 schema: Dict[str, dt.DType],
                 subst: Optional[Dict[int, Expr]] = None,
                 structural: Optional[List[Tuple[A.SqlExpr, Expr]]] = None):
        self.resolve = resolve
        self.schema = schema
        self.subst = subst or {}          # id(ast node) -> lowered Expr
        self.structural = structural or []  # (ast, lowered) matched by ==


def _walk_all(e: A.SqlExpr):
    """Like ``sqlast.walk`` but also descends into subquery bodies."""
    for x in A.walk(e):
        yield x
        if isinstance(x, (A.SInSelect, A.SExists, A.SScalar)):
            yield from _select_exprs(x.select)


def _select_exprs(sel: A.Select):
    for it in sel.items:
        if not isinstance(it.expr, A.SStar):
            yield from _walk_all(it.expr)
    for jc in sel.join_conditions:
        yield from _walk_all(jc)
    if sel.where is not None:
        yield from _walk_all(sel.where)
    for g in sel.group_by:
        yield from _walk_all(g)
    if sel.having is not None:
        yield from _walk_all(sel.having)
    for oe, _ in sel.order_by:
        yield from _walk_all(oe)
    for _, c in sel.ctes:
        yield from _select_exprs(c)


def _refs_of(exprs) -> set:
    """(qualifier, name) pairs referenced by ``exprs`` (descending into
    subquery bodies — correlation refs must survive the outer joins)."""
    refs = set()
    for e in exprs:
        for x in _walk_all(e):
            if isinstance(x, A.SCol):
                refs.add((x.qualifier, x.name))
    return refs


def _like_regex(pattern: str):
    return re.compile(
        "".join(".*" if ch == "%" else re.escape(ch) for ch in pattern))


def _outer_ctx(frame: _Frame, cur: QueryBuilder) -> _ExprCtx:
    """Resolution context a subquery uses to see its *outer* query: only
    columns that actually survived into the outer builder are visible."""
    def resolve(qual, name):
        phys = frame.phys(qual, name)
        return phys if phys is not None and phys in cur.schema else None
    return _ExprCtx(resolve, cur.schema)


class _Lowering:
    """One ``lower_sql`` invocation (fresh-name counter + catalog/session)."""

    def __init__(self, catalog, session=None):
        self.catalog = catalog
        self.session = session
        self._n = 0

    def fresh(self, prefix: str) -> str:
        self._n += 1
        return f"__{prefix}{self._n}"

    # ------------------------------------------------------------------
    # statement lowering
    # ------------------------------------------------------------------
    def lower_select(self, sel: A.Select, env: Dict[str, QueryBuilder],
                     outer: Optional[_ExprCtx] = None) -> QueryBuilder:
        env = dict(env)
        for name, cte in sel.ctes:
            env[name] = self.lower_select(cte, env)

        frame = self.lower_from_where(sel, env, outer)
        cur = frame.builder

        # alias / positional substitution for GROUP BY and ORDER BY
        aliases = {it.alias: it.expr for it in sel.items if it.alias}

        def _resolve_item(e: A.SqlExpr, ctx_name: str) -> A.SqlExpr:
            if isinstance(e, A.SLit) and e.kind == "int":
                idx = int(e.value)
                if not 1 <= idx <= len(sel.items):
                    raise SqlParseError(
                        f"{ctx_name} position {idx} out of range")
                return sel.items[idx - 1].expr
            if (isinstance(e, A.SCol) and e.qualifier is None
                    and frame.locate(None, e.name) is None
                    and e.name in aliases):
                return aliases[e.name]
            return e

        group_exprs = [_resolve_item(g, "GROUP BY") for g in sel.group_by]
        agg_nodes = self._collect_aggregates(sel)

        if group_exprs or agg_nodes:
            cur, ctx = self._lower_aggregation(
                sel, cur, frame, env, group_exprs, agg_nodes)
        else:
            if sel.having is not None:
                raise SqlUnsupportedError(
                    "HAVING without GROUP BY or aggregates")
            ctx = _ExprCtx(frame.phys, cur.schema)

        # final projection to the select-list names, in order
        out_items: List[Tuple[str, Expr]] = []
        used = set()
        for i, it in enumerate(sel.items):
            if isinstance(it.expr, A.SStar):
                for src in frame.sources:
                    if it.expr.qualifier and src.alias != it.expr.qualifier:
                        continue
                    for logical, phys in src.colmap.items():
                        if logical in used:
                            raise SqlUnsupportedError(
                                f"SELECT * with duplicate column "
                                f"'{logical}' across tables")
                        used.add(logical)
                        out_items.append((logical, col(phys)))
                continue
            name = it.alias or (it.expr.name if isinstance(it.expr, A.SCol)
                                else f"col{i}")
            if name in used:
                raise SqlParseError(f"duplicate output column '{name}'")
            used.add(name)
            out_items.append((name, self.lower_expr(it.expr, ctx)))
        cur = cur.project(*out_items)

        if sel.distinct:
            cur = cur.distinct()

        if sel.order_by:
            keys, desc = [], []
            for oe, d in sel.order_by:
                keys.append(self._order_key(oe, sel, out_items, cur.schema))
                desc.append(d)
            cur = cur.order_by(*keys, descending=desc, limit=sel.limit)
        elif sel.limit is not None:
            cur = cur.limit(sel.limit)
        return cur

    def _order_key(self, oe: A.SqlExpr, sel: A.Select,
                   out_items: List[Tuple[str, Expr]],
                   schema: Dict[str, dt.DType]) -> str:
        if isinstance(oe, A.SLit) and oe.kind == "int":
            idx = int(oe.value)
            if not 1 <= idx <= len(out_items):
                raise SqlParseError(f"ORDER BY position {idx} out of range")
            return out_items[idx - 1][0]
        if isinstance(oe, A.SCol) and oe.qualifier is None \
                and oe.name in schema:
            return oe.name
        for it, (name, _) in zip(sel.items, out_items):
            if it.expr == oe:
                return name
        raise SqlUnsupportedError(
            "ORDER BY expression must be an output column, alias, or "
            f"select-list position; got {oe!r}")

    # ------------------------------------------------------------------
    # FROM + WHERE: sources, filters, join tree, subquery predicates
    # ------------------------------------------------------------------
    def lower_from_where(self, sel: A.Select, env: Dict[str, QueryBuilder],
                         outer: Optional[_ExprCtx]) -> _Frame:
        if not sel.from_items:
            raise SqlUnsupportedError("SELECT without FROM is not supported")
        sources: List[_Source] = []
        seen = set()
        for item in sel.from_items:
            if isinstance(item, A.SubqueryRef):
                base = self.lower_select(item.select, env)
                alias = item.alias
                rows, unique = self._derived_stats(base)
            else:
                alias = item.alias
                if item.name in env:
                    base = env[item.name]
                    rows, unique = self._derived_stats(base)
                else:
                    base = QueryBuilder.scan(self.catalog, item.name,
                                             session=self.session)
                    src = self.catalog.get(item.name)
                    rows = src.num_rows()
                    unique = [frozenset(u) for u in
                              getattr(src, "unique_keys", ())]
            if alias in seen:
                raise SqlParseError(f"duplicate table alias '{alias}'")
            seen.add(alias)
            sources.append(_Source(alias, base, rows, unique))
        frame = _Frame(sources)

        # classify WHERE/ON conjuncts
        conjs = ([c for jc in sel.join_conditions for c in A.conjuncts(jc)]
                 + A.conjuncts(sel.where))
        local: Dict[str, List[A.SqlExpr]] = {}
        edges: List[Tuple[Tuple[str, str], Tuple[str, str]]] = []
        post: List[A.SqlExpr] = []
        subq: List[A.SqlExpr] = []
        corr_asts: List[Tuple[A.SCol, A.SCol]] = []   # (outer ref, inner ref)
        for conj in conjs:
            if A.contains_aggregate(conj):
                raise SqlUnsupportedError("aggregate in WHERE clause")
            if A.contains_subquery(conj):
                subq.append(conj)
                continue
            refs = [x for x in A.walk(conj) if isinstance(x, A.SCol)]
            local_aliases, outer_refs = set(), []
            for r in refs:
                src = frame.locate(r.qualifier, r.name)
                if src is not None:
                    local_aliases.add(src.alias)
                elif outer is not None and outer.resolve(
                        r.qualifier, r.name) is not None:
                    outer_refs.append(r)
                else:
                    raise SchemaError(
                        f"unknown column "
                        f"'{(r.qualifier + '.') if r.qualifier else ''}"
                        f"{r.name}' in WHERE clause")
            if outer_refs:
                if not (isinstance(conj, A.SBin) and conj.op == "eq"
                        and isinstance(conj.lhs, A.SCol)
                        and isinstance(conj.rhs, A.SCol)
                        and len(outer_refs) == 1):
                    raise SqlUnsupportedError(
                        "correlated subquery predicate must be a simple "
                        f"column equality; got {conj!r}")
                inner_ref = (conj.rhs if outer_refs[0] is conj.lhs
                             else conj.lhs)
                corr_asts.append((outer_refs[0], inner_ref))
            elif len(local_aliases) <= 1:
                alias = next(iter(local_aliases), sources[0].alias)
                local.setdefault(alias, []).append(conj)
            elif (isinstance(conj, A.SBin) and conj.op == "eq"
                    and isinstance(conj.lhs, A.SCol)
                    and isinstance(conj.rhs, A.SCol)):
                ls = frame.locate(conj.lhs.qualifier, conj.lhs.name)
                rs = frame.locate(conj.rhs.qualifier, conj.rhs.name)
                edges.append(((ls.alias, conj.lhs.name),
                              (rs.alias, conj.rhs.name)))
            else:
                post.append(conj)

        # columns that must survive the join tree: everything referenced
        # downstream of it. Local-filter and join-edge conjuncts are
        # consumed by the tree itself, so a dimension table filtered and
        # joined purely for its effect (e.g. region in Q5) carries no
        # payload and lowers to a semi join.
        downstream = [it.expr for it in sel.items
                      if not isinstance(it.expr, A.SStar)]
        downstream.extend(sel.group_by)
        if sel.having is not None:
            downstream.append(sel.having)
        downstream.extend(oe for oe, _ in sel.order_by)
        downstream.extend(post)
        downstream.extend(subq)
        needed_refs = _refs_of(downstream)
        for _, inner_ref in corr_asts:
            needed_refs.add((inner_ref.qualifier, inner_ref.name))
        star = any(isinstance(it.expr, A.SStar) for it in sel.items)

        # per-source filters (before renames: identity colmap)
        for src in sources:
            for conj in local.get(src.alias, ()):
                ctx = _ExprCtx(
                    lambda q, n, _s=src: n if n in _s.colmap else None,
                    src.builder.schema)
                src.builder = src.builder.filter(self.lower_expr(conj, ctx))
                src.rows = max(1, src.rows // 2)

        # rename columns that collide across sources (self-joins)
        counts: Dict[str, int] = {}
        for src in sources:
            for c in src.colmap:
                counts[c] = counts.get(c, 0) + 1
        for src in sources:
            if any(counts[c] > 1 for c in src.colmap):
                src.colmap = {c: (f"{c}__{src.alias}" if counts[c] > 1 else c)
                              for c in src.colmap}
                src.builder = src.builder.project(
                    *[(src.colmap[c], col(c)) for c in src.builder.schema])

        frame.builder = self._join_tree(frame, edges, needed_refs, star)

        # residual multi-source predicates
        ctx = _ExprCtx(frame.phys, frame.builder.schema)
        for conj in post:
            frame.builder = frame.builder.filter(self.lower_expr(conj, ctx))

        # IN/EXISTS/scalar-subquery predicates
        for conj in subq:
            frame.builder = self._apply_subquery_conjunct(
                frame, conj, env)

        # correlation pairs, as physical columns on both sides
        for outer_ref, inner_ref in corr_asts:
            frame.corr.append((
                outer.resolve(outer_ref.qualifier, outer_ref.name),
                frame.phys(inner_ref.qualifier, inner_ref.name)))
        return frame

    def _derived_stats(self, base: QueryBuilder):
        try:
            rows = opt.row_bound(base.plan, self.catalog)
        except TypeError:
            rows = _LARGE_ROWS
        unique = [frozenset(u)
                  for u in opt.unique_sets(base.plan, self.catalog)]
        return rows, unique

    def _join_tree(self, frame: _Frame, edges, needed_refs,
                   star: bool) -> QueryBuilder:
        sources = frame.sources
        by_alias = {s.alias: s for s in sources}

        def needed(src: _Source) -> List[str]:
            return [c for c in src.colmap
                    if star or (src.alias, c) in needed_refs
                    or (None, c) in needed_refs]

        def covers(alias: str, keys) -> bool:
            return any(u <= keys for u in by_alias[alias].unique)

        # greedy left-deep tree: the root streams as the probe side; each
        # step materializes one connected source as a build side. Every
        # build's join keys must cover a declared/derived unique set: the
        # engine's static ``max_matches`` capacity silently truncates
        # matches past the bound, so a many-rows build side would be
        # silently wrong, not slow. Try roots largest-first until an
        # orientation proves unique on every build.
        def simulate(root: _Source):
            joined = {root.alias}
            steps: List[Tuple[str, List[Tuple[str, str, str]], bool]] = []
            all_cover = True
            while len(joined) < len(sources):
                cand: Dict[str, List[Tuple[str, str, str]]] = {}
                for (aa, an), (ba, bn) in edges:
                    if aa in joined and ba not in joined:
                        cand.setdefault(ba, []).append((aa, an, bn))
                    elif ba in joined and aa not in joined:
                        cand.setdefault(aa, []).append((ba, bn, an))
                if not cand:
                    missing = sorted(s.alias for s in sources
                                     if s.alias not in joined)
                    raise SqlUnsupportedError(
                        f"no equi-join condition connects {missing} to "
                        f"{sorted(joined)} (cross joins are not supported)")

                def cov(alias: str) -> bool:
                    return covers(alias, {bn for _, _, bn in cand[alias]})

                build_alias = min(
                    cand, key=lambda a: (not cov(a), by_alias[a].rows, a))
                steps.append((build_alias, cand[build_alias],
                              cov(build_alias)))
                all_cover = all_cover and cov(build_alias)
                joined.add(build_alias)
            return steps, all_cover

        roots = sorted(sources, key=lambda s: (-s.rows, s.alias))
        root, steps = roots[0], None
        for r in roots:
            s, all_cover = simulate(r)
            if steps is None or all_cover:
                root, steps = r, s
            if all_cover:
                break

        joined = {root.alias}
        cur = root.builder
        for build_alias, cand_edges, cov in steps:
            if not cov:
                keys = sorted({bn for _, _, bn in cand_edges})
                raise SqlUnsupportedError(
                    f"join builds '{build_alias}' on {keys}, which cover "
                    f"no unique key of it under any join order; the "
                    f"engine's static max_matches capacity cannot bound "
                    f"a many-to-many join")
            build = by_alias[build_alias]
            probe_keys = [by_alias[pa].colmap[pn]
                          for pa, pn, _ in cand_edges]
            build_keys = [build.colmap[bn]
                          for _, _, bn in cand_edges]
            # build columns that later joins will need as probe keys
            # (edges whose other endpoint is still unjoined) must ride
            # along as payload even when nothing downstream reads them
            future = set()
            for (aa, an), (ba, bn) in edges:
                if aa == build_alias and ba != build_alias \
                        and ba not in joined:
                    future.add(an)
                elif ba == build_alias and aa != build_alias \
                        and aa not in joined:
                    future.add(bn)
            want = set(needed(build)) | future
            payload = [build.colmap[c] for c in build.colmap
                       if c in want and build.colmap[c] not in cur.schema]
            if not payload and cov:
                cur = cur.semi_join(build.builder, probe_keys, build_keys)
            else:
                cur = cur.join(build.builder, probe_keys, build_keys,
                               payload=payload)
            joined.add(build_alias)
        return cur

    # ------------------------------------------------------------------
    # subquery predicates: IN / EXISTS / scalar comparisons
    # ------------------------------------------------------------------
    def _apply_subquery_conjunct(self, frame: _Frame, conj: A.SqlExpr,
                                 env) -> QueryBuilder:
        cur = frame.builder
        node, negated = conj, False
        while isinstance(node, A.SNot):
            node, negated = node.operand, not negated

        if isinstance(node, A.SExists):
            neg = node.negated ^ negated
            if node.select.group_by or node.select.having is not None:
                raise SqlUnsupportedError(
                    "EXISTS over a grouped subquery is not supported")
            inner = self.lower_from_where(
                node.select, env, _outer_ctx(frame, cur))
            if not inner.corr:
                raise SqlUnsupportedError(
                    "uncorrelated EXISTS is not supported")
            left = [o for o, _ in inner.corr]
            right = [i for _, i in inner.corr]
            join = cur.anti_join if neg else cur.semi_join
            return join(inner.builder, left, right)

        if isinstance(node, A.SInSelect):
            neg = node.negated ^ negated
            if not isinstance(node.operand, A.SCol):
                raise SqlUnsupportedError(
                    "IN (SELECT ...) needs a plain column on the left")
            phys = frame.phys(node.operand.qualifier, node.operand.name)
            if phys is None:
                raise SchemaError(
                    f"unknown column '{node.operand.name}' in IN predicate")
            inner = self.lower_select(node.select, env)
            if len(inner.schema) != 1:
                raise SqlUnsupportedError(
                    "IN (SELECT ...) subquery must produce one column, "
                    f"got {list(inner.schema)}")
            (inner_col,) = inner.schema
            join = cur.anti_join if neg else cur.semi_join
            return join(inner, [phys], [inner_col])

        # comparison containing scalar subqueries
        subst: Dict[int, Expr] = {}
        for x in A.walk(conj):
            if isinstance(x, (A.SInSelect, A.SExists)):
                raise SqlUnsupportedError(
                    f"IN/EXISTS nested inside an expression: {conj!r}")
            if isinstance(x, A.SScalar):
                cur = self._attach_scalar(cur, frame, x, env, subst)
        ctx = _ExprCtx(frame.phys, cur.schema, subst=subst)
        return cur.filter(self.lower_expr(conj, ctx))

    def _attach_scalar(self, cur: QueryBuilder, frame: Optional[_Frame],
                       node: A.SScalar, env,
                       subst: Dict[int, Expr]) -> QueryBuilder:
        """Lower one scalar subquery; register its replacement in subst."""
        sub = node.select
        if len(sub.items) != 1 or sub.group_by or sub.having:
            raise SqlUnsupportedError(
                "scalar subquery must be a single ungrouped aggregate")
        item = sub.items[0]
        aggs = [x for x in A.walk(item.expr)
                if isinstance(x, A.SFunc) and x.name in _AGG_FUNCS]
        if not aggs:
            raise SqlUnsupportedError(
                "scalar subquery must compute an aggregate")

        outer_ctx = _outer_ctx(frame, cur) if frame is not None else None
        inner = self.lower_from_where(sub, env, outer_ctx)

        ib = inner.builder
        agg_specs: Dict[str, Tuple[str, Optional[str]]] = {}
        agg_subst: Dict[int, Expr] = {}
        ictx = _ExprCtx(inner.phys, ib.schema)
        pre: List[Tuple[str, Expr]] = []
        for a in aggs:
            out = self.fresh("agg")
            spec, pre_col = self._agg_spec(a, ictx)
            if pre_col is not None:
                pre.append(pre_col)
            agg_specs[out] = spec
            agg_subst[id(a)] = col(out)
        if pre:
            ib = ib.project(*ib.schema, *pre)
        keys = [i for _, i in inner.corr]
        ib = ib.group_by(*keys).agg(**agg_specs) if keys \
            else ib.agg(**agg_specs)
        sname = self.fresh("s")
        post_ctx = _ExprCtx(lambda q, n: n if n in ib.schema else None,
                            ib.schema, subst=agg_subst)
        ib = ib.project(*keys, (sname, self.lower_expr(item.expr, post_ctx)))

        if inner.corr:
            cur = cur.join(ib, [o for o, _ in inner.corr], keys,
                           payload=[sname])
        else:
            cur = cur.attach_scalar(ib, [sname])
        subst[id(node)] = col(sname)
        return cur

    def _agg_spec(self, a: A.SFunc, ctx: _ExprCtx):
        """(kind, in_col) for one aggregate call, plus an optional
        precomputed input column (name, expr) when the argument is not a
        plain column reference."""
        if a.distinct:
            raise SqlUnsupportedError(
                f"{a.name.upper()}(DISTINCT ...) in this position")
        if a.name == "count":
            return ("count", None), None       # no NULLs: count(x) == count(*)
        if len(a.args) != 1:
            raise SqlUnsupportedError(
                f"{a.name}() takes exactly one argument")
        e = self.lower_expr(a.args[0], ctx)
        if isinstance(e, ColumnRef):
            return (a.name, e.name), None
        name = self.fresh("a")
        return (a.name, name), (name, e)

    # ------------------------------------------------------------------
    # aggregation (GROUP BY / HAVING / aggregate select items)
    # ------------------------------------------------------------------
    def _collect_aggregates(self, sel: A.Select) -> List[A.SFunc]:
        nodes: List[A.SFunc] = []
        exprs = [it.expr for it in sel.items
                 if not isinstance(it.expr, A.SStar)]
        if sel.having is not None:
            exprs.append(sel.having)
        exprs.extend(oe for oe, _ in sel.order_by)
        for e in exprs:
            for x in A.walk(e):      # not _walk_all: subqueries own theirs
                if isinstance(x, A.SFunc) and x.name in _AGG_FUNCS:
                    nodes.append(x)
        return nodes

    def _lower_aggregation(self, sel: A.Select, cur: QueryBuilder,
                           frame: _Frame, env, group_exprs,
                           agg_nodes) -> Tuple[QueryBuilder, _ExprCtx]:
        base_ctx = _ExprCtx(frame.phys, cur.schema)
        aliases = {id(it.expr): it.alias for it in sel.items if it.alias}

        keys: List[str] = []
        pre: List[Tuple[str, Expr]] = []
        structural: List[Tuple[A.SqlExpr, Expr]] = []
        for gi, ge in enumerate(group_exprs):
            e = self.lower_expr(ge, base_ctx)
            if isinstance(e, ColumnRef):
                keys.append(e.name)
            else:
                name = aliases.get(id(ge)) or f"__g{gi}"
                pre.append((name, e))
                keys.append(name)
            structural.append((ge, col(keys[-1])))

        distinct_counts = [a for a in agg_nodes
                           if a.distinct and a.name == "count"]
        for a in agg_nodes:
            if a.distinct and a.name != "count":
                raise SqlUnsupportedError(
                    f"{a.name.upper()}(DISTINCT ...) is not supported")
        if distinct_counts and len(agg_nodes) != len(distinct_counts):
            raise SqlUnsupportedError(
                "COUNT(DISTINCT ...) mixed with other aggregates")

        agg_specs: Dict[str, Tuple[str, Optional[str]]] = {}
        subst: Dict[int, Expr] = {}
        seen: List[Tuple[A.SFunc, str]] = []
        if distinct_counts:
            d0 = distinct_counts[0]
            if any(a != d0 for a in distinct_counts):
                raise SqlUnsupportedError(
                    "multiple distinct COUNT(DISTINCT ...) aggregates")
            if len(d0.args) != 1:
                raise SqlUnsupportedError("COUNT(DISTINCT ...) arity")
            de = self.lower_expr(d0.args[0], base_ctx)
            if not isinstance(de, ColumnRef):
                dname = self.fresh("d")
                pre.append((dname, de))
                de = col(dname)
            if pre:
                cur = cur.project(*cur.schema, *pre)
            cur = cur.distinct(*keys, de.name)
            out = self.fresh("agg")
            cur = cur.group_by(*keys).agg(**{out: ("count", None)})
            for a in distinct_counts:
                subst[id(a)] = col(out)
        else:
            for a in agg_nodes:
                prior = next((o for n, o in seen if n == a), None)
                if prior is not None:
                    subst[id(a)] = col(prior)
                    continue
                out = self.fresh("agg")
                spec, pre_col = self._agg_spec(a, base_ctx)
                if pre_col is not None:
                    pre.append(pre_col)
                agg_specs[out] = spec
                subst[id(a)] = col(out)
                seen.append((a, out))
            if pre:
                cur = cur.project(*cur.schema, *pre)
            cur = cur.group_by(*keys).agg(**agg_specs)

        def post_resolve(qual, name):
            phys = frame.phys(qual, name)
            if phys is not None and phys in cur.schema:
                return phys
            return None

        ctx = _ExprCtx(post_resolve, cur.schema, subst=subst,
                       structural=structural)

        if sel.having is not None:
            for conj in A.conjuncts(sel.having):
                if A.contains_subquery(conj):
                    for x in A.walk(conj):
                        if isinstance(x, (A.SInSelect, A.SExists)):
                            raise SqlUnsupportedError(
                                "IN/EXISTS in HAVING is not supported")
                        if isinstance(x, A.SScalar):
                            cur = self._attach_scalar(
                                cur, None, x, env, subst)
                    ctx = _ExprCtx(post_resolve, cur.schema, subst=subst,
                                   structural=structural)
                cur = cur.filter(self.lower_expr(conj, ctx))
                ctx = _ExprCtx(post_resolve, cur.schema, subst=subst,
                               structural=structural)
        return cur, ctx

    # ------------------------------------------------------------------
    # expression lowering
    # ------------------------------------------------------------------
    def lower_expr(self, e: A.SqlExpr, ctx: _ExprCtx) -> Expr:
        if id(e) in ctx.subst:
            return ctx.subst[id(e)]
        for ast, lowered in ctx.structural:
            if ast == e:
                return lowered
        if isinstance(e, A.SCol):
            phys = ctx.resolve(e.qualifier, e.name)
            if phys is None:
                raise SchemaError(
                    f"unknown column "
                    f"'{(e.qualifier + '.') if e.qualifier else ''}{e.name}'"
                    f"; available: {sorted(ctx.schema)}")
            return col(phys)
        if isinstance(e, A.SLit):
            return self._literal(e)
        if isinstance(e, A.SInterval):
            raise SqlUnsupportedError(
                "INTERVAL outside date +/- INTERVAL arithmetic")
        if isinstance(e, A.SBin):
            if e.op in ("and", "or"):
                return BinaryOp(e.op, self.lower_expr(e.lhs, ctx),
                                self.lower_expr(e.rhs, ctx))
            if e.op in _CMP_FLIP:
                return self._lower_cmp(e.op, e.lhs, e.rhs, ctx)
            return self._lower_arith(e, ctx)
        if isinstance(e, A.SNot):
            return UnaryOp("not", self.lower_expr(e.operand, ctx))
        if isinstance(e, A.SNeg):
            return UnaryOp("neg", self.lower_expr(e.operand, ctx))
        if isinstance(e, A.SExtract):
            if e.field != "year":
                raise SqlUnsupportedError(
                    f"EXTRACT({e.field.upper()}) is not supported "
                    f"(only YEAR)")
            return Year(self.lower_expr(e.operand, ctx))
        if isinstance(e, A.SSubstr):
            if e.start != 1:
                raise SqlUnsupportedError(
                    "SUBSTRING must start at position 1")
            operand = self.lower_expr(e.operand, ctx)
            if operand.out_dtype(ctx.schema).name != "bytes":
                raise SqlUnsupportedError(
                    "SUBSTRING needs a fixed-width bytes column")
            return PrefixCode(operand, e.length)
        if isinstance(e, A.SCase):
            return self._lower_case(e, ctx)
        if isinstance(e, A.SIn):
            return self._lower_in(e, ctx)
        if isinstance(e, A.SLike):
            return self._lower_like(e, ctx)
        if isinstance(e, A.SBetween):
            lo = self._lower_cmp("ge", e.operand, e.lo, ctx)
            hi = self._lower_cmp("le", e.operand, e.hi, ctx)
            return BinaryOp("and", lo, hi)
        if isinstance(e, A.SFunc):
            if e.name in _AGG_FUNCS:
                raise SqlUnsupportedError(
                    f"aggregate {e.name}() is not allowed here")
            raise SqlUnsupportedError(f"function {e.name}() is not supported")
        if isinstance(e, (A.SScalar, A.SInSelect, A.SExists)):
            raise SqlUnsupportedError(
                "subquery in this expression position is not supported")
        raise SqlUnsupportedError(f"cannot lower {type(e).__name__}")

    def _literal(self, e: A.SLit) -> Expr:
        if e.kind == "int":
            return Literal(int(e.value))
        if e.kind == "float":
            return Literal(float(e.value))
        if e.kind == "bool":
            return Literal(bool(e.value))
        if e.kind == "date":
            return Literal(dt.date_to_i32(e.value), dt.DATE32)
        raise SqlUnsupportedError(
            f"string literal {e.value!r} needs a string-typed column "
            f"context (comparison, IN, LIKE)")

    def _lower_arith(self, e: A.SBin, ctx: _ExprCtx) -> Expr:
        # date +/- INTERVAL folds at plan time (calendar arithmetic)
        for a, b in ((e.lhs, e.rhs), (e.rhs, e.lhs)):
            if isinstance(b, A.SInterval):
                if e.op not in ("add", "sub"):
                    raise SqlUnsupportedError(
                        f"INTERVAL with operator '{e.op}'")
                base = self.lower_expr(a, ctx)
                n = -b.n if e.op == "sub" else b.n
                if isinstance(base, Literal) and base.dtype is dt.DATE32:
                    return Literal(_shift_date(base.value, n, b.unit),
                                   dt.DATE32)
                if b.unit == "day":
                    return BinaryOp("add", base, Literal(int(n)))
                raise SqlUnsupportedError(
                    f"non-constant date +/- INTERVAL '{b.n}' {b.unit}")
        return BinaryOp(e.op, self.lower_expr(e.lhs, ctx),
                        self.lower_expr(e.rhs, ctx))

    def _lower_case(self, e: A.SCase, ctx: _ExprCtx) -> Expr:
        acc = (self.lower_expr(e.default, ctx)
               if e.default is not None else Literal(0))
        # first-match semantics: acc = cond*val + (!cond)*acc, right-to-left
        for cond_ast, val_ast in reversed(e.whens):
            c = self.lower_expr(cond_ast, ctx)
            v = self.lower_expr(val_ast, ctx)
            acc = BinaryOp("add",
                           BinaryOp("mul", c, v),
                           BinaryOp("mul", UnaryOp("not", c), acc))
        return acc

    def _lower_in(self, e: A.SIn, ctx: _ExprCtx) -> Expr:
        operand = self.lower_expr(e.operand, ctx)
        values = []
        for lit in e.values:
            values.append(self._encode_for(operand, lit, ctx,
                                           skip_missing=True))
        values = [v for v in values if v is not None]
        out: Expr = IsIn(operand, tuple(values))
        return UnaryOp("not", out) if e.negated else out

    def _lower_like(self, e: A.SLike, ctx: _ExprCtx) -> Expr:
        operand = self.lower_expr(e.operand, ctx)
        t = operand.out_dtype(ctx.schema)
        pattern = e.pattern
        if "_" in pattern:
            raise SqlUnsupportedError(
                f"LIKE wildcard '_' is not supported: {pattern!r}")
        if t.name == "dict32":
            rx = _like_regex(pattern)
            codes = tuple(i for i, v in enumerate(t.dictionary)
                          if rx.fullmatch(v))
            out: Expr = IsIn(operand, codes)
        elif t.name == "bytes":
            parts = pattern.split("%")
            if len(parts) >= 3 and parts[0] == "" and parts[-1] == "":
                out = BytesMatch(operand, tuple(p for p in parts if p),
                                 "contains")
            elif len(parts) == 2 and parts[1] == "" and parts[0]:
                out = BytesMatch(operand, (parts[0],), "startswith")
            elif len(parts) == 2 and parts[0] == "" and parts[1]:
                out = BytesMatch(operand, (parts[1],), "endswith")
            else:
                raise SqlUnsupportedError(
                    f"LIKE pattern {pattern!r} is not supported on "
                    f"bytes columns")
        else:
            raise SqlUnsupportedError(
                f"LIKE over a {t} column is not supported")
        return UnaryOp("not", out) if e.negated else out

    def _lower_cmp(self, op: str, lhs: A.SqlExpr, rhs: A.SqlExpr,
                   ctx: _ExprCtx) -> Expr:
        if isinstance(rhs, A.SLit) and not isinstance(lhs, A.SLit):
            return self._cmp_literal(op, self.lower_expr(lhs, ctx), rhs, ctx)
        if isinstance(lhs, A.SLit) and not isinstance(rhs, A.SLit):
            return self._cmp_literal(_CMP_FLIP[op],
                                     self.lower_expr(rhs, ctx), lhs, ctx)
        return BinaryOp(op, self.lower_expr(lhs, ctx),
                        self.lower_expr(rhs, ctx))

    def _cmp_literal(self, op: str, expr: Expr, lit: A.SLit,
                     ctx: _ExprCtx) -> Expr:
        encoded = self._encode_for(expr, lit, ctx, op=op)
        if isinstance(encoded, Expr):
            return encoded                       # fully folded predicate
        return BinaryOp(op, expr, Literal(encoded[0], encoded[1]))

    def _encode_for(self, expr: Expr, lit: A.SLit, ctx: _ExprCtx,
                    op: Optional[str] = None, skip_missing: bool = False):
        """Encode a literal for comparison against ``expr``.

        Returns ``(value, dtype)`` normally, a raw value for IN lists,
        ``None`` for IN-list members outside a dictionary domain, or a
        fully folded ``Expr`` when the comparison itself constant-folds
        (dictionary misses)."""
        if isinstance(expr, PrefixCode):
            if lit.kind == "str" and str(lit.value).isdigit():
                return (int(lit.value) if skip_missing
                        else (int(lit.value), dt.INT32))
            raise SqlUnsupportedError(
                f"SUBSTRING comparison needs a digit-string literal, "
                f"got {lit.value!r}")
        t = expr.out_dtype(ctx.schema)
        if t.name == "date32" and lit.kind in ("date", "str"):
            v = dt.date_to_i32(str(lit.value))
            return v if skip_missing else (v, dt.DATE32)
        if t.name == "dict32":
            if lit.kind != "str":
                raise SqlUnsupportedError(
                    f"comparing dictionary column with {lit.kind} literal")
            value = str(lit.value)
            if value in t.dictionary:
                code = t.dictionary.index(value)
                return code if skip_missing else (code, dt.INT32)
            if skip_missing:
                return None
            # dictionaries are sorted: fold against the insertion point
            pos = bisect.bisect_left(t.dictionary, value)
            if op == "eq":
                return IsIn(expr, ())
            if op == "ne":
                return UnaryOp("not", IsIn(expr, ()))
            if op in ("lt", "le"):
                return BinaryOp("lt", expr, Literal(pos))
            return BinaryOp("ge", expr, Literal(pos))
        if t.name == "bytes":
            raise SqlUnsupportedError(
                "comparison between a bytes column and a literal "
                "(use LIKE)")
        if lit.kind == "int":
            v = int(lit.value)
        elif lit.kind == "float":
            v = float(lit.value)
        elif lit.kind == "bool":
            v = bool(lit.value)
        else:
            raise SqlUnsupportedError(
                f"cannot compare {t} column with string literal "
                f"{lit.value!r}")
        return v if skip_missing else (v, None)


def _shift_date(days: int, n: int, unit: str) -> int:
    import datetime
    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))
    if unit == "day":
        return days + n
    months = d.year * 12 + (d.month - 1) + (n * 12 if unit == "year" else n)
    y, m = divmod(months, 12)
    # clamp the day into the target month (SQL interval semantics)
    for day in (d.day, 30, 29, 28):
        try:
            return (datetime.date(y, m + 1, day)
                    - datetime.date(1970, 1, 1)).days
        except ValueError:
            continue
    raise AssertionError("unreachable")


def lower_sql(sql: str, catalog, session=None,
              dialect: Optional[str] = None) -> QueryBuilder:
    """Parse SQL text and lower it to a ``QueryBuilder``.

    ``dialect`` transpiles foreign SQL dialects to the engine's subset via
    the optional ``sqlglot`` dependency (the ``[sql]`` extra); without the
    package installed a dialect request fails loudly rather than guessing::

        q = lower_sql("SELECT count(*) AS n FROM orders", catalog)
        plan = q.optimized()

    Raises ``SqlParseError`` for invalid syntax, ``SqlUnsupportedError``
    for recognized-but-unexecutable constructs (naming the construct), and
    ``SchemaError`` for unknown tables/columns.
    """
    if dialect is not None:
        try:
            import sqlglot
        except ImportError as exc:
            raise SqlUnsupportedError(
                f"dialect={dialect!r} normalization needs the optional "
                f"'sqlglot' dependency (pip install 'repro[sql]')"
            ) from exc
        sql = sqlglot.transpile(sql, read=dialect, write="duckdb")[0]
    ast = A.parse(sql)
    builder = _Lowering(catalog, session).lower_select(ast, {})
    builder.sql_text = sql
    return builder
