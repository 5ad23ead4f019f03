"""Fluent, schema-propagating query builder (the port's copy of
``repro.core.builder``): the engine's public frontend.

Queries are composed as method chains that validate every step against the
propagated schema at *build* time -- unknown columns, type mismatches and
malformed aggregations fail immediately with the available columns in the
error, instead of surfacing as shape errors deep inside the driver:

    (session.table("lineitem")
        .filter(col("l_shipdate") <= date_lit("1998-09-02"))
        .project("l_returnflag", rev=col("l_extendedprice") * 0.9)
        .group_by("l_returnflag")
        .agg(revenue=("sum", "rev"))
        .order_by("revenue", descending=[True])
        .collect())

Each step produces the existing ``PlanNode`` IR (``.plan`` exposes it), so
the ``Driver`` executes builder queries unchanged; ``.collect()`` runs the
plan through the rule-based logical optimizer first (see ``optimizer.py``).
Builders are immutable: every method returns a new builder.

The port binds ``collect`` and ``submit`` to its own ``Session``;
``Session.sql`` lowers SQL text onto this builder (``core.sql``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from . import dtypes as dt
from . import plan as P
from .expr import (BinaryOp, BytesMatch, Expr, IsIn, Literal,
                   UnaryOp, col)
from . import optimizer as opt


class SchemaError(ValueError):
    """A builder step referenced a column or type the schema cannot satisfy."""


_ARITH_OPS = ("add", "sub", "mul", "div")
_AGG_KINDS = ("sum", "avg", "min", "max", "count", "first")


def _fmt_cols(schema: Dict[str, dt.DType]) -> str:
    return ", ".join(f"{n}: {t}" for n, t in schema.items())


def _check_expr(e: Expr, schema: Dict[str, dt.DType], ctx: str) -> dt.DType:
    """Validate references and operand types; return the output dtype."""
    unknown = sorted(e.references() - set(schema))
    if unknown:
        raise SchemaError(
            f"{ctx}: unknown column(s) {unknown}; "
            f"available: [{_fmt_cols(schema)}]")
    _check_types(e, schema, ctx)
    return e.out_dtype(schema)


def _check_types(e: Expr, schema: Dict[str, dt.DType], ctx: str) -> None:
    if isinstance(e, BinaryOp):
        _check_types(e.lhs, schema, ctx)
        _check_types(e.rhs, schema, ctx)
        if e.op in _ARITH_OPS:
            for side in (e.lhs, e.rhs):
                t = side.out_dtype(schema)
                if t.is_string:
                    raise SchemaError(
                        f"{ctx}: arithmetic '{e.op}' on {t} operand {side}; "
                        f"string columns support only comparisons and "
                        f"pattern predicates")
    elif isinstance(e, UnaryOp):
        _check_types(e.operand, schema, ctx)
        if e.op == "neg" and e.operand.out_dtype(schema).is_string:
            raise SchemaError(f"{ctx}: cannot negate {e.operand}")
    elif isinstance(e, IsIn):
        _check_types(e.operand, schema, ctx)
    elif isinstance(e, BytesMatch):
        _check_types(e.operand, schema, ctx)
        if e.operand.out_dtype(schema).name != "bytes":
            raise SchemaError(
                f"{ctx}: pattern predicate '{e.mode}' needs a bytes column, "
                f"got {e.operand.out_dtype(schema)} for {e.operand}")
    else:
        for child in getattr(e, "__dict__", {}).values():
            if isinstance(child, Expr):
                _check_types(child, schema, ctx)


def _key_family(t: dt.DType) -> str:
    """Join keys hash by raw value: only same-family keys can ever match."""
    if t.name in ("int32", "int64", "date32", "dict32", "bool"):
        return "int"
    if t.name in ("float32", "float64"):
        return "float"
    return "bytes"


class QueryBuilder:
    """Immutable fluent wrapper around a ``PlanNode`` + its output schema.

    Every step validates against the propagated schema at build time and
    returns a *new* builder; ``.plan`` exposes the logical IR at any point::

        q = (session.table("lineitem")
             .filter(col("l_quantity") < 5.0)
             .group_by("l_returnflag")
             .agg(n=("count", None)))
        out = q.collect()                 # optimize + execute on this thread
        handle = q.submit(priority=1)     # or: schedule it concurrently
        out = handle.result()
    """

    # set on the FINAL builder only (by Session.sql / lower_sql), never
    # propagated by _derive: the SQL text a builder was lowered from (a
    # scheduler cache-key prefix) and its attached ExecutionOptions
    sql_text: Optional[str] = None
    _options = None

    def __init__(self, plan: P.PlanNode, schema: Dict[str, dt.DType],
                 catalog, session=None):
        self.plan = plan
        self.schema = dict(schema)
        self._catalog = catalog
        self._session = session

    # -- constructors -------------------------------------------------------
    @classmethod
    def scan(cls, catalog, table: str,
             columns: Optional[Sequence[str]] = None,
             session=None) -> "QueryBuilder":
        """Root builder over a catalog table (all columns by default)."""
        try:
            src = catalog.get(table)
        except KeyError:
            raise SchemaError(
                f"table('{table}'): unknown table; "
                f"catalog has {sorted(catalog.tables())}") from None
        if columns is not None:
            unknown = sorted(set(columns) - set(src.schema))
            if unknown:
                raise SchemaError(
                    f"table('{table}'): unknown column(s) {unknown}; "
                    f"available: [{_fmt_cols(src.schema)}]")
        schema = {c: src.schema[c] for c in (columns or src.schema)}
        return cls(P.TableScan(table, columns=list(columns) if columns else None),
                   schema, catalog, session)

    def _derive(self, plan: P.PlanNode,
                schema: Dict[str, dt.DType]) -> "QueryBuilder":
        return QueryBuilder(plan, schema, self._catalog, self._session)

    # -- row-level steps ----------------------------------------------------
    def filter(self, predicate: Expr) -> "QueryBuilder":
        """Keep rows satisfying a boolean expression:
        ``.filter(col("l_quantity") < 24)``."""
        t = _check_expr(predicate, self.schema, "filter")
        if t.name != "bool":
            raise SchemaError(
                f"filter: predicate {predicate} has type {t}, expected bool")
        return self._derive(P.Filter(self.plan, predicate), self.schema)

    where = filter

    def project(self, *columns: Union[str, Tuple[str, Expr]],
                **named: Expr) -> "QueryBuilder":
        """Positional strings pass columns through; kwargs compute new ones."""
        projections: List[Tuple[str, Expr]] = []
        for c in columns:
            if isinstance(c, str):
                projections.append((c, col(c)))
            else:
                name, e = c
                projections.append((name, e))
        for name, e in named.items():
            projections.append((name, e if isinstance(e, Expr) else Literal(e)))
        if not projections:
            raise SchemaError("project: no columns given")
        schema = {}
        for name, e in projections:
            schema[name] = _check_expr(e, self.schema, f"project({name})")
        return self._derive(P.Project(self.plan, projections), schema)

    select = project

    def with_column(self, name: str, e: Expr) -> "QueryBuilder":
        """Append one computed column, keeping every existing column."""
        return self.project(*self.schema, **{name: e})

    # -- aggregation --------------------------------------------------------
    def group_by(self, *keys: str) -> "GroupedBuilder":
        """Start a grouped aggregation; follow with ``.agg(...)``."""
        for k in keys:
            if k not in self.schema:
                raise SchemaError(
                    f"group_by: unknown column '{k}'; "
                    f"available: [{_fmt_cols(self.schema)}]")
        return GroupedBuilder(self, keys)

    def agg(self, **aggs) -> "QueryBuilder":
        """Global (no group keys) aggregation: ``.agg(total=('sum', 'x'))``."""
        return self.group_by().agg(**aggs)

    def distinct(self, *keys: str) -> "QueryBuilder":
        """Unique rows over ``keys`` (all columns when omitted)."""
        keys = keys or tuple(self.schema)
        for k in keys:
            if k not in self.schema:
                raise SchemaError(
                    f"distinct: unknown column '{k}'; "
                    f"available: [{_fmt_cols(self.schema)}]")
        return self._derive(P.Distinct(self.plan, list(keys)),
                            {k: self.schema[k] for k in keys})

    # -- joins --------------------------------------------------------------
    def join(self, build: "QueryBuilder", left_on: Sequence[str],
             right_on: Sequence[str], payload: Sequence[str] = (),
             how: str = "inner",
             build_rows: Optional[int] = None) -> "QueryBuilder":
        """Hash join; ``self`` streams as the probe side, ``build`` is
        materialized. ``payload`` names build columns carried into the
        output (semi/anti joins carry none). ``build_rows`` optionally
        asserts an upper bound on valid build-side rows (sizes the kernel
        backend's probe table); when omitted the optimizer derives one
        from catalog statistics."""
        if how not in ("inner", "left_semi", "left_anti", "left_outer"):
            raise SchemaError(f"join: unknown join type '{how}'")
        if build_rows is not None and build_rows <= 0:
            raise SchemaError(
                f"join: build_rows must be positive, got {build_rows}")
        if len(left_on) != len(right_on) or not left_on:
            raise SchemaError(
                f"join: key lists must be equal-length and non-empty, "
                f"got {list(left_on)} vs {list(right_on)}")
        for k in left_on:
            if k not in self.schema:
                raise SchemaError(
                    f"join: unknown probe key '{k}'; "
                    f"available: [{_fmt_cols(self.schema)}]")
        for k in right_on:
            if k not in build.schema:
                raise SchemaError(
                    f"join: unknown build key '{k}'; "
                    f"available: [{_fmt_cols(build.schema)}]")
        for lk, rk in zip(left_on, right_on):
            lt, rt = self.schema[lk], build.schema[rk]
            if _key_family(lt) != _key_family(rt):
                raise SchemaError(
                    f"join: key type mismatch {lk}: {lt} vs {rk}: {rt}")
        if how in ("left_semi", "left_anti") and payload:
            raise SchemaError(f"join: {how} joins carry no build payload")
        for c in payload:
            if c not in build.schema:
                raise SchemaError(
                    f"join: unknown payload column '{c}'; "
                    f"build side has: [{_fmt_cols(build.schema)}]")
        schema = dict(self.schema)
        for c in payload:
            schema[c] = build.schema[c]
        if how == "left_outer":
            schema["__matched"] = dt.BOOL
        return self._derive(
            P.Join(probe=self.plan, build=build.plan,
                   probe_keys=list(left_on), build_keys=list(right_on),
                   build_payload=list(payload), join_type=how,
                   build_rows=build_rows),
            schema)

    def semi_join(self, build: "QueryBuilder", left_on: Sequence[str],
                  right_on: Sequence[str]) -> "QueryBuilder":
        """Keep probe rows with at least one build match (EXISTS)."""
        return self.join(build, left_on, right_on, how="left_semi")

    def anti_join(self, build: "QueryBuilder", left_on: Sequence[str],
                  right_on: Sequence[str]) -> "QueryBuilder":
        """Keep probe rows with no build match (NOT EXISTS)."""
        return self.join(build, left_on, right_on, how="left_anti")

    def attach_scalar(self, scalar: "QueryBuilder",
                      columns: Sequence[str]) -> "QueryBuilder":
        """Attach columns of a 1-row subquery result to every row
        (uncorrelated scalar subqueries: Q11/Q15/Q22 shapes)."""
        for c in columns:
            if c not in scalar.schema:
                raise SchemaError(
                    f"attach_scalar: unknown column '{c}'; "
                    f"scalar side has: [{_fmt_cols(scalar.schema)}]")
        schema = dict(self.schema)
        for c in columns:
            schema[c] = scalar.schema[c]
        return self._derive(
            P.ScalarBroadcast(self.plan, scalar.plan, list(columns)), schema)

    # -- ordering / limiting ------------------------------------------------
    def order_by(self, *keys: str, descending: Optional[Sequence[bool]] = None,
                 limit: Optional[int] = None) -> "QueryBuilder":
        """Sort by ``keys`` (per-key ``descending`` flags, optional
        top-``limit``): ``.order_by("revenue", descending=[True])``."""
        for k in keys:
            if k not in self.schema:
                raise SchemaError(
                    f"order_by: unknown column '{k}'; "
                    f"available: [{_fmt_cols(self.schema)}]")
        if descending is not None and len(descending) != len(keys):
            raise SchemaError(
                f"order_by: {len(keys)} keys but {len(descending)} "
                f"descending flags")
        return self._derive(
            P.OrderBy(self.plan, list(keys),
                      list(descending) if descending else None, limit),
            self.schema)

    def limit(self, n: int) -> "QueryBuilder":
        """Keep the first ``n`` rows (fuses into a preceding order_by)."""
        if n <= 0:
            raise SchemaError(f"limit: n must be positive, got {n}")
        plan = self.plan
        if isinstance(plan, P.OrderBy) and plan.limit is None:
            return self._derive(dataclasses.replace(plan, limit=n), self.schema)
        return self._derive(P.Limit(plan, n), self.schema)

    # -- terminal steps ------------------------------------------------------
    def to_plan(self) -> P.PlanNode:
        """The logical ``PlanNode`` tree built so far (unoptimized)."""
        return self.plan

    def _config(self) -> opt.OptimizerConfig:
        """Session-bound builders plan for the session's worker count, so
        explain()/optimized() show the plan collect() actually executes."""
        if self._session is not None:
            return self._session.optimizer_config()
        return opt.DEFAULT_CONFIG

    def optimized(self, config: Optional[opt.OptimizerConfig] = None
                  ) -> P.PlanNode:
        """The plan after the rule-based optimizer pipeline (including
        exchange placement when the bound session is distributed)."""
        return opt.optimize(self.plan, self._catalog,
                            config=config or self._config())

    def explain(self, analyze: bool = False) -> str:
        """Plan tree before and after the optimizer pipeline.

        A session-bound builder delegates to ``Session.explain``, so
        ``analyze=True`` also executes the plan and appends the executor's
        stats (EXPLAIN ANALYZE). An unbound builder gives the before/after
        text, and ``analyze=True`` raises: there is no session to run on.
        """
        if self._session is not None:
            return self._session.explain(self.plan, analyze=analyze)
        if analyze:
            raise RuntimeError(
                "explain(analyze=True) needs a session-bound builder; "
                "build via session.table(...) or session.sql(...)")
        return opt.explain_before_after(self.plan, self._catalog,
                                        config=self._config())

    def collect(self, optimize: bool = True, options=None):
        """Optimize and execute; requires a session-bound builder
        (``session.table(...)`` / ``session.sql(...)``). Optimization uses
        the session's worker count. ``options`` (an ``ExecutionOptions``)
        overrides the worker count and ``optimize`` for this call; when
        omitted, options attached by ``session.sql(..., options=...)``
        apply."""
        if self._session is None:
            raise RuntimeError(
                "collect() needs a session-bound builder; build via "
                "session.table(...) or execute to_plan()/optimized() yourself")
        opts = options if options is not None else self._options
        if opts is not None and opts.optimize is not None:
            optimize = opts.optimize
        sess = self._session._with_options(opts)
        plan = sess.optimize(self.plan) if optimize else self.plan
        return sess.execute(plan)

    execute = collect

    def submit(self, priority: int = 0, options=None):
        """Schedule this query concurrently; returns a ``QueryHandle``.

        Routes through the session's ``QueryScheduler`` (admission control,
        plan/result caches, batching); requires a session-bound builder::

            h = session.table("orders").limit(10).submit()
            rows = h.result()

        ``options`` (an ``ExecutionOptions``) overrides priority, worker
        count, optimize and batching for this query; SQL-born builders
        also key the scheduler's caches by their SQL text.
        """
        if self._session is None:
            raise RuntimeError(
                "submit() needs a session-bound builder; build via "
                "session.table(...) or submit the plan to a session yourself")
        return self._session.submit(self, priority=priority, options=options)

    def __repr__(self):
        return (f"QueryBuilder[{_fmt_cols(self.schema)}]\n"
                + opt.explain(self.plan))


class GroupedBuilder:
    """Intermediate ``group_by`` state; ``agg`` produces the aggregation."""

    def __init__(self, parent: QueryBuilder, keys: Sequence[str]):
        self._parent = parent
        self._keys = tuple(keys)

    def agg(self, **aggs: Tuple[str, Optional[str]]) -> QueryBuilder:
        """Each kwarg is ``out_name=(kind, in_column)``; ``count`` takes
        ``None`` as its input column."""
        if not aggs:
            raise SchemaError("agg: no aggregations given")
        parent, schema = self._parent, self._parent.schema
        specs: List[Tuple[str, str, Optional[str]]] = []
        out_schema = {k: schema[k] for k in self._keys}
        for name, spec in aggs.items():
            if not isinstance(spec, tuple) or len(spec) != 2:
                raise SchemaError(
                    f"agg({name}): expected (kind, column) tuple, got {spec!r}")
            kind, in_col = spec
            if kind not in _AGG_KINDS:
                raise SchemaError(
                    f"agg({name}): unknown kind '{kind}'; "
                    f"one of {_AGG_KINDS}")
            if kind == "count":
                if in_col is not None:
                    raise SchemaError(
                        f"agg({name}): count takes None as its input column")
                out_schema[name] = dt.INT32
            else:
                if in_col not in schema:
                    raise SchemaError(
                        f"agg({name}): unknown column '{in_col}'; "
                        f"available: [{_fmt_cols(schema)}]")
                t = schema[in_col]
                if kind in ("sum", "avg") and not (t.is_numeric
                                                   or t.name == "bool"):
                    raise SchemaError(
                        f"agg({name}): {kind} over non-numeric column "
                        f"'{in_col}' of type {t}")
                if kind in ("min", "max") and t.name == "bytes":
                    raise SchemaError(
                        f"agg({name}): {kind} over bytes column '{in_col}' "
                        f"is unsupported")
                out_schema[name] = dt.FLOAT32 if kind == "avg" else t
            specs.append((name, kind, in_col))
        return parent._derive(
            P.Aggregation(parent.plan, list(self._keys), specs), out_schema)


def table(catalog, name: str,
          columns: Optional[Sequence[str]] = None) -> QueryBuilder:
    """Catalog-bound builder entry point (no session needed to build)."""
    return QueryBuilder.scan(catalog, name, columns)
