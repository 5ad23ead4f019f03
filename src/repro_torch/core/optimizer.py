"""Rule-based logical optimizer (the port's copy of ``repro.core.optimizer``):
the paper's "driver adaptation" planner.

Presto's coordinator adapts logical plans for device execution (paper §3.1):
it chooses join distributions, prunes and pushes work into connectors, and
sizes operators from catalog statistics. This module reproduces that step as
a pass pipeline over ``PlanNode`` trees:

* ``push_filters``      -- merge Filter nodes into ``TableScan.filter`` (and
                           through pure-rename Projects), so predicates run
                           fused inside the scan and data skipping can use
                           chunk min/max stats.
* ``prune_columns``     -- scan only columns referenced downstream.
* ``reorder_joins``     -- with a feedback store, swap a join's build and
                           probe sides when observation shows the probe
                           side much smaller (a no-op cold).
* ``choose_join_distribution``
                        -- broadcast vs partitioned per join, from catalog
                           row counts, or observed ones warm (replaces
                           hand-set ``distribution=``).
* ``derive_capacities`` -- static-shape capacity hints (``max_groups``,
                           ``max_matches``) from catalog stats + key
                           uniqueness, replacing the ad-hoc ``Sizes``
                           threading the queries used to do by hand.
* ``place_exchanges``   -- lower the logical plan to a *distributed
                           fragment plan*: the join-distribution hint and
                           the Aggregation/Distinct auto modes become
                           explicit ``Repartition``/``Broadcast`` exchange
                           nodes (the paper's plan fragments separated by
                           exchanges), placed only where the planner can
                           prove the input is still worker-partitioned.
                           Runs only when ``config.num_workers > 1``.

``optimize(plan, catalog)`` runs the default pipeline; ``explain(plan)``
pretty-prints a plan tree (with row bounds when a catalog is given).

Capacity hints are *sound upper bounds*: a too-small ``max_groups`` or
``max_matches`` silently drops rows, so every derivation here bounds the
true cardinality from above (table row counts, dictionary domain sizes,
provable build-key uniqueness).

With a runtime-feedback store (``OptimizerConfig.feedback``, a
``core.feedback.FeedbackStore``) the plan is *warm*: cardinalities observed
on a prior run override the static bounds, downward only and only under the
table versions they were measured on. Without one every feedback branch is
inert, so cold plans fingerprint exactly like the reference's. Warm plans
fingerprint like the reference's warm plans from the same observations.
``estimate_memory_breakdown`` is the device-memory estimate the scheduler
admits queries by (``core.scheduler``); warm, it prices observed footprints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, List, Optional, Sequence, Set

from . import dtypes as dt
from . import plan as P
from .expr import BinaryOp, ColumnRef, Expr

# max_groups/max_matches are static array capacities; when the provable
# bound exceeds this budget the optimizer leaves the hand-set hint alone
# instead of deriving something absurd (or silently unsound).
MAX_CAPACITY = 1 << 24

# build sides bounded above this many rows are exchanged (partitioned join)
# instead of replicated to every worker (broadcast join)
BROADCAST_ROW_LIMIT = 1 << 16
# slack added before rounding group capacities to a power of two
GROUP_SLACK = 8


def _pow2(n: int) -> int:
    return max(int(2 ** math.ceil(math.log2(max(n, 2)))), 2)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """What the planner is told about the execution it plans for."""

    # planned worker count: >1 makes ``place_exchanges`` lower distribution
    # hints into explicit Repartition/Broadcast exchange nodes
    num_workers: int = 1
    # runtime-feedback store (core.feedback.FeedbackStore). Set, observed
    # cardinalities from prior executions override the static catalog row
    # bounds: join distribution and orientation follow observed sizes, and
    # ``derive_capacities`` tightens max_groups/build_rows/max_matches, the
    # sizes of the card's group-by accumulators, hash tables and expansion
    # rows. None = plan statically (the cold path).
    feedback: Optional[object] = None
    # multiplicative headroom on observed group counts before re-rounding
    # to a power of two (drift tolerance between runs)
    feedback_slack: float = 1.25


DEFAULT_CONFIG = OptimizerConfig()


# ---------------------------------------------------------------------------
# runtime-feedback lookups
# ---------------------------------------------------------------------------

def observed_rows(node: P.PlanNode, catalog,
                  config: OptimizerConfig) -> Optional[int]:
    """Observed output cardinality of ``node`` from a prior execution, or
    None when no feedback store is configured / nothing was recorded for
    this plan shape (worker count and table versions must match; see
    ``FeedbackStore.key_for``)."""
    fb = config.feedback
    if fb is None:
        return None
    return fb.rows(fb.key_for(node, catalog, config.num_workers))


def estimated_rows(node: P.PlanNode, catalog,
                   config: OptimizerConfig = DEFAULT_CONFIG) -> int:
    """The row estimate the planner believes: observed cardinality when the
    feedback store has one, the static ``row_bound`` otherwise."""
    obs = observed_rows(node, catalog, config)
    return int(obs) if obs is not None else int(row_bound(node, catalog))


def feedback_estimates(plan: P.PlanNode, catalog,
                       config: OptimizerConfig) -> Dict[str, int]:
    """Per-node planner estimates for an optimized plan, keyed by feedback
    store key: the "producing estimates" a plan-cache entry is filed
    under. After execution the scheduler compares them against the fresh
    observations: a q-error past its threshold invalidates the cached
    plan, so the next submission re-plans from the better numbers."""
    fb = config.feedback
    if fb is None:
        return {}
    out: Dict[str, int] = {}

    def visit(node: P.PlanNode) -> None:
        for c in node.children():
            visit(c)
        if isinstance(node, (P.Repartition, P.Broadcast, P.Exchange)):
            return                       # keyed through to their child
        try:
            est = row_bound(node, catalog)
        except TypeError:
            return
        key = fb.key_for(node, catalog, config.num_workers)
        entry = fb.get(key)
        out[key] = int(entry.rows) if entry is not None else int(est)

    visit(plan)
    return out


# ---------------------------------------------------------------------------
# tree plumbing
# ---------------------------------------------------------------------------

def replace_children(node: P.PlanNode,
                     new_children: Sequence[P.PlanNode]) -> P.PlanNode:
    """Rebuild ``node`` with ``new_children`` (in ``node.children()`` order)."""
    kids = iter(new_children)
    updates = {}
    for f in dataclasses.fields(node):
        if isinstance(getattr(node, f.name), P.PlanNode):
            updates[f.name] = next(kids)
    return dataclasses.replace(node, **updates) if updates else node


def rewrite_refs(e: Expr, rename: Dict[str, str]) -> Expr:
    """Rebuild an expression with column references renamed."""
    if isinstance(e, ColumnRef):
        return ColumnRef(rename.get(e.name, e.name))
    if dataclasses.is_dataclass(e):
        updates = {f.name: rewrite_refs(getattr(e, f.name), rename)
                   for f in dataclasses.fields(e)
                   if isinstance(getattr(e, f.name), Expr)}
        if updates:
            return dataclasses.replace(e, **updates)
    return e


# ---------------------------------------------------------------------------
# schema inference
# ---------------------------------------------------------------------------

def infer_schema(node: P.PlanNode, catalog) -> Dict[str, dt.DType]:
    """Output schema (ordered name -> DType) of a plan node."""
    if isinstance(node, P.TableScan):
        src = catalog.get(node.table).schema
        cols = list(node.columns) if node.columns is not None else list(src)
        return {c: src[c] for c in cols}
    if isinstance(node, P.InMemorySource):
        return dict(node.schema)
    if isinstance(node, (P.Filter, P.Limit, P.OrderBy, P.Exchange,
                         P.Repartition, P.Broadcast)):
        return infer_schema(node.child, catalog)
    if isinstance(node, P.Project):
        child = infer_schema(node.child, catalog)
        return {name: e.out_dtype(child) for name, e in node.projections}
    if isinstance(node, P.Aggregation):
        child = infer_schema(node.child, catalog)
        out = {k: child[k] for k in node.group_keys}
        for name, kind, col_ in node.aggs:
            if kind == "count":
                out[name] = dt.INT32
            elif kind == "avg":
                if node.mode == "partial":
                    # partial phase emits mergeable sum+count state
                    out[f"{name}__sum"] = child[col_]
                    out[f"{name}__cnt"] = dt.INT32
                else:
                    out[name] = dt.FLOAT32
            elif node.mode == "final" and col_ not in child:
                # final phase consumes partial state named by the output
                out[name] = child[name]
            else:
                out[name] = child[col_]
        return out
    if isinstance(node, P.Distinct):
        child = infer_schema(node.child, catalog)
        return {k: child[k] for k in node.keys}
    if isinstance(node, P.Join):
        probe = infer_schema(node.probe, catalog)
        if node.join_type in ("left_semi", "left_anti"):
            return probe
        build = infer_schema(node.build, catalog)
        out = dict(probe)
        for name in node.build_payload:
            out[name] = build[name]
        if node.join_type == "left_outer":
            out["__matched"] = dt.BOOL
        return out
    if isinstance(node, P.ScalarBroadcast):
        out = dict(infer_schema(node.child, catalog))
        scalar = infer_schema(node.scalar, catalog)
        for name in node.columns:
            out[name] = scalar[name]
        return out
    raise TypeError(f"cannot infer schema for {type(node).__name__}")


# ---------------------------------------------------------------------------
# cardinality bounds
# ---------------------------------------------------------------------------

def row_bound(node: P.PlanNode, catalog) -> int:
    """Upper bound on the number of valid output rows."""
    if isinstance(node, P.TableScan):
        return int(catalog.get(node.table).num_rows())
    if isinstance(node, P.InMemorySource):
        vals = list(node.data.values())
        return len(vals[0]) if vals else 0
    if isinstance(node, (P.Filter, P.Project, P.ScalarBroadcast, P.Exchange,
                         P.Repartition)):
        return row_bound(node.children()[0], catalog)
    if isinstance(node, P.Broadcast):
        # every worker holds a replica: W copies of each valid row
        return row_bound(node.child, catalog) * max(node.num_workers, 1)
    if isinstance(node, (P.Aggregation, P.Distinct)):
        keys = node.group_keys if isinstance(node, P.Aggregation) else node.keys
        if not keys:
            return 1
        child_bound = row_bound(node.child, catalog)
        dom = _domain_bound(keys, infer_schema(node.child, catalog))
        return min(child_bound, dom) if dom is not None else child_bound
    if isinstance(node, P.OrderBy):
        b = row_bound(node.child, catalog)
        return min(b, node.limit) if node.limit is not None else b
    if isinstance(node, P.Limit):
        return min(row_bound(node.child, catalog), node.n)
    if isinstance(node, P.Join):
        probe = row_bound(node.probe, catalog)
        if node.join_type in ("left_semi", "left_anti"):
            return probe
        if _build_side_unique(node, catalog):
            # every probe row matches at most one build row (left_outer keeps
            # each probe row exactly once: matched or padded)
            return probe
        out = probe * max(node.max_matches, 1)
        return out + probe if node.join_type == "left_outer" else out
    raise TypeError(f"cannot bound rows for {type(node).__name__}")


def _domain_bound(keys: Sequence[str],
                  schema: Dict[str, dt.DType]) -> Optional[int]:
    """Product of key-domain sizes, when every key has a finite domain."""
    prod = 1
    for k in keys:
        d = schema[k]
        if d.name == "dict32" and d.dictionary is not None:
            prod *= max(len(d.dictionary), 1)
        elif d.name == "bool":
            prod *= 2
        else:
            return None
    return prod


def unique_sets(node: P.PlanNode, catalog) -> List[FrozenSet[str]]:
    """Column sets proven to uniquely identify output rows (key inference).

    Sources declare primary keys via ``TableSource.unique_keys``; grouping
    and distinct make their keys unique; joins against a unique build side
    preserve probe-side uniqueness.
    """
    if isinstance(node, P.TableScan):
        src = catalog.get(node.table)
        cols = set(node.columns) if node.columns is not None else set(src.schema)
        return [frozenset(u) for u in getattr(src, "unique_keys", ())
                if set(u) <= cols]
    if isinstance(node, (P.Filter, P.Limit, P.OrderBy, P.Exchange,
                         P.ScalarBroadcast, P.Repartition, P.Broadcast)):
        # Repartition permutes rows; Broadcast replicates *across* workers
        # but each worker's slice stays duplicate-free, which is what the
        # per-worker join build uniqueness (max_matches) relies on.
        return unique_sets(node.children()[0], catalog)
    if isinstance(node, P.Project):
        # translate through pure column renames
        out_names: Dict[str, List[str]] = {}
        for name, e in node.projections:
            if isinstance(e, ColumnRef):
                out_names.setdefault(e.name, []).append(name)
        translated = []
        for u in unique_sets(node.child, catalog):
            if all(c in out_names for c in u):
                translated.append(frozenset(out_names[c][0] for c in u))
        return translated
    if isinstance(node, P.Aggregation):
        return [frozenset(node.group_keys)] if node.group_keys else []
    if isinstance(node, P.Distinct):
        return [frozenset(node.keys)]
    if isinstance(node, P.Join):
        if node.join_type in ("left_semi", "left_anti"):
            return unique_sets(node.probe, catalog)
        if _build_side_unique(node, catalog):
            return unique_sets(node.probe, catalog)
        return []
    return []


def _build_side_unique(node: P.Join, catalog) -> bool:
    """True when the build keys provably identify at most one build row."""
    bk = set(node.build_keys)
    return any(u <= bk for u in unique_sets(node.build, catalog))


def _exact_key(node: P.Join, catalog) -> bool:
    """Mirror of HashJoin's exact-key rule: single int-like key column."""
    if len(node.build_keys) != 1:
        return False
    build = infer_schema(node.build, catalog)
    return build[node.build_keys[0]].name in ("int32", "date32", "dict32")


# ---------------------------------------------------------------------------
# rule 1: predicate pushdown
# ---------------------------------------------------------------------------

def push_filters(node: P.PlanNode, catalog,
                 config: OptimizerConfig = DEFAULT_CONFIG) -> P.PlanNode:
    """Merge Filter nodes into TableScan.filter, through pure renames."""
    if isinstance(node, P.Filter):
        child = push_filters(node.child, catalog, config)
        if isinstance(child, P.Filter):
            merged = P.Filter(child.child,
                              BinaryOp("and", child.predicate, node.predicate),
                              compact=node.compact or child.compact)
            return push_filters(merged, catalog, config)
        if isinstance(child, P.TableScan):
            pred = (node.predicate if child.filter is None
                    else BinaryOp("and", child.filter, node.predicate))
            return dataclasses.replace(child, filter=pred)
        if isinstance(child, P.Project):
            rename = {name: e.name for name, e in child.projections
                      if isinstance(e, ColumnRef)}
            if node.predicate.references() <= set(rename):
                pushed = push_filters(
                    P.Filter(child.child,
                             rewrite_refs(node.predicate, rename),
                             compact=node.compact),
                    catalog, config)
            else:
                return dataclasses.replace(
                    node, child=dataclasses.replace(
                        child, child=push_filters(child.child, catalog, config)))
            return dataclasses.replace(child, child=pushed)
        return dataclasses.replace(node, child=child)
    return replace_children(
        node, [push_filters(c, catalog, config) for c in node.children()])


# ---------------------------------------------------------------------------
# rule 2: projection pruning
# ---------------------------------------------------------------------------

def prune_columns(node: P.PlanNode, catalog,
                  config: OptimizerConfig = DEFAULT_CONFIG) -> P.PlanNode:
    """Restrict every TableScan to the columns referenced downstream."""
    return _prune(node, set(infer_schema(node, catalog)), catalog)


def _prune(node: P.PlanNode, required: Set[str], catalog) -> P.PlanNode:
    if isinstance(node, P.TableScan):
        src = catalog.get(node.table).schema
        need = set(required)
        if node.filter is not None:
            need |= node.filter.references()
        cols = [c for c in src if c in need]
        if not cols:                     # keep one column to carry row count
            cols = [next(iter(src))]
        return dataclasses.replace(node, columns=cols)
    if isinstance(node, P.InMemorySource):
        return node
    if isinstance(node, P.Filter):
        return dataclasses.replace(
            node, child=_prune(node.child,
                               required | node.predicate.references(), catalog))
    if isinstance(node, P.Project):
        keep = [(n, e) for n, e in node.projections if n in required]
        if not keep:
            keep = list(node.projections)[:1]
        need: Set[str] = set()
        for _, e in keep:
            need |= e.references()
        return P.Project(_prune(node.child, need, catalog), keep)
    if isinstance(node, P.Aggregation):
        need = set(node.group_keys) | {c for _, _, c in node.aggs
                                       if c is not None}
        return dataclasses.replace(node,
                                   child=_prune(node.child, need, catalog))
    if isinstance(node, P.Distinct):
        return dataclasses.replace(
            node, child=_prune(node.child, set(node.keys), catalog))
    if isinstance(node, P.Join):
        probe_out = set(infer_schema(node.probe, catalog))
        if node.join_type in ("left_semi", "left_anti"):
            probe_req = (required & probe_out) | set(node.probe_keys)
            build_req = set(node.build_keys)
        else:
            probe_req = ((required - set(node.build_payload) - {"__matched"})
                         & probe_out) | set(node.probe_keys)
            build_req = set(node.build_keys) | set(node.build_payload)
        return dataclasses.replace(
            node,
            probe=_prune(node.probe, probe_req, catalog),
            build=_prune(node.build, build_req, catalog))
    if isinstance(node, P.OrderBy):
        return dataclasses.replace(
            node, child=_prune(node.child, required | set(node.keys), catalog))
    if isinstance(node, P.Limit):
        return dataclasses.replace(node,
                                   child=_prune(node.child, required, catalog))
    if isinstance(node, (P.Exchange, P.Repartition)):
        return dataclasses.replace(
            node, child=_prune(node.child, required | set(node.keys), catalog))
    if isinstance(node, P.Broadcast):
        return dataclasses.replace(
            node, child=_prune(node.child, required, catalog))
    if isinstance(node, P.ScalarBroadcast):
        return dataclasses.replace(
            node,
            child=_prune(node.child, required - set(node.columns), catalog),
            scalar=_prune(node.scalar, set(node.columns), catalog))
    raise TypeError(f"cannot prune {type(node).__name__}")


# ---------------------------------------------------------------------------
# rule 3a: feedback-driven join orientation (build-side selection)
# ---------------------------------------------------------------------------

def reorder_joins(node: P.PlanNode, catalog,
                  config: OptimizerConfig = DEFAULT_CONFIG) -> P.PlanNode:
    """Swap a join's build/probe orientation when observation says the
    probe side is the (much) smaller one: build-side selection from
    observed rather than declared sizes.

    A swap is taken only when it is provably safe: inner join, no hand-set
    'local' co-partitioning, disjoint column names across the sides, and
    the swapped orientation's build keys (the old probe keys) cover a
    declared unique set (the engine's ``max_matches`` contract silently
    truncates many-to-many overflow, so an unprovable orientation is never
    produced). The swapped join carries the old probe's columns as payload
    and is wrapped in a schema-restoring Project, so downstream operators
    (and the plan's output) are unchanged. No-op without a feedback store.
    """
    if config.feedback is None:
        return node
    new = replace_children(
        node, [reorder_joins(c, catalog, config) for c in node.children()])
    if (not isinstance(new, P.Join) or new.join_type != "inner"
            or new.distribution == "local"):
        return new
    obs_build = observed_rows(new.build, catalog, config)
    obs_probe = observed_rows(new.probe, catalog, config)
    if obs_build is None or obs_probe is None or 2 * obs_probe >= obs_build:
        return new
    probe_schema = infer_schema(new.probe, catalog)
    build_schema = infer_schema(new.build, catalog)
    if set(probe_schema) & set(build_schema):
        return new       # colliding names: payload would shadow columns
    swapped = P.Join(
        probe=new.build, build=new.probe,
        probe_keys=list(new.build_keys), build_keys=list(new.probe_keys),
        build_payload=list(probe_schema), join_type="inner")
    if not _build_side_unique(swapped, catalog):
        return new       # cannot prove the old probe side joins uniquely
    out_schema = infer_schema(new, catalog)
    return P.Project(swapped,
                     [(name, ColumnRef(name)) for name in out_schema])


# ---------------------------------------------------------------------------
# rule 3: join distribution selection
# ---------------------------------------------------------------------------

def choose_join_distribution(node: P.PlanNode, catalog,
                             config: OptimizerConfig = DEFAULT_CONFIG
                             ) -> P.PlanNode:
    """Broadcast small build sides, exchange (partition) large ones.

    Mirrors Presto's stats-based join-distribution decision: replicating a
    small build side avoids exchanging the (large) probe side; once the
    build side outgrows ``BROADCAST_ROW_LIMIT`` rows, replicating it to all
    workers costs more than hash-exchanging both sides on the join keys.
    Hand-set ``'local'`` (already co-partitioned) is preserved. With a
    feedback store, the observed build cardinality from a prior run
    replaces the static bound: a build side whose declared bound forced a
    partitioned join can come back as a broadcast join once observation
    shows it small.
    """
    new = replace_children(
        node, [choose_join_distribution(c, catalog, config)
               for c in node.children()])
    if isinstance(new, P.Join) and new.distribution != "local":
        obs = observed_rows(new.build, catalog, config)
        build_rows = obs if obs is not None else row_bound(new.build, catalog)
        dist = ("partitioned" if build_rows > BROADCAST_ROW_LIMIT
                else "broadcast")
        new = dataclasses.replace(new, distribution=dist)
    return new


# ---------------------------------------------------------------------------
# rule 4: capacity hints (max_groups / max_matches) from catalog stats
# ---------------------------------------------------------------------------

def derive_capacities(node: P.PlanNode, catalog,
                      config: OptimizerConfig = DEFAULT_CONFIG) -> P.PlanNode:
    """Size static-capacity operators from sound cardinality upper bounds.

    * Aggregation/Distinct ``max_groups``: min(input row bound, product of
      finite key domains), with slack, rounded up to a power of two.
    * Join ``max_matches``: 1 when a single exact key provably hits a unique
      build key; a small collision-headroom constant when the (unique) key
      is hashed/composite; otherwise the hand-set value is kept -- the
      optimizer never *lowers* a capacity it cannot prove.
    * Join ``build_rows``: the build side's row bound, which sizes the
      open-addressing table.

    With a feedback store, observed cardinalities tighten these further
    (only ever downward, and only under the table versions they were
    measured on):

    * ``max_groups`` from the aggregate's *own* observed output (that IS
      the group count), with ``feedback_slack`` headroom: the accumulator
      every segmented reduction and merge on the card is sized by;
    * ``build_rows`` from the observed build cardinality: an undersized
      bound fails the hash table's occupancy check and takes the counted
      sorted-key ``fallback_probe`` path, never a wrong result, so the
      exact observation is safe;
    * ``max_matches`` from the observed build-key multiplicity, but only
      for single exact int-like keys where equality has no hash
      collisions (the driver records nothing otherwise).
    """
    new = replace_children(
        node, [derive_capacities(c, catalog, config) for c in node.children()])

    if isinstance(new, (P.Aggregation, P.Distinct)):
        keys = new.group_keys if isinstance(new, P.Aggregation) else new.keys
        if not keys:
            return dataclasses.replace(new, max_groups=1)
        bound = row_bound(new.child, catalog)
        dom = _domain_bound(keys, infer_schema(new.child, catalog))
        if dom is not None:
            bound = min(bound, dom)
        candidates = []
        mg = _pow2(bound + GROUP_SLACK)
        if mg <= MAX_CAPACITY:
            candidates.append(mg)
        obs = observed_rows(new, catalog, config)
        if obs is not None:
            # the aggregate's own observed output is its group count (a
            # W-fold over-count at worst for distributed partials, still
            # an upper bound on true groups)
            warm = _pow2(int(math.ceil(obs * config.feedback_slack))
                         + GROUP_SLACK)
            if warm <= MAX_CAPACITY:
                candidates.append(warm)
        if not candidates:
            # no in-budget bound provable: never lower a hand-set capacity
            return new
        return dataclasses.replace(new, max_groups=min(candidates))

    if isinstance(new, P.Join):
        obs_build = observed_rows(new.build, catalog, config)
        if obs_build is not None and (new.build_rows is None
                                      or obs_build < new.build_rows):
            # tightening is sound: a bound smaller than the actual build
            # fails the occupancy check into the sorted-key fallback
            new = dataclasses.replace(new, build_rows=max(int(obs_build), 1))
        elif new.build_rows is None:
            # build-side row bound: sizes the kernel backend's
            # open-addressing probe table (2x slots for load factor 1/2).
            # Hand-set hints are kept -- the planner never overrides a
            # bound the caller asserted.
            try:
                br = row_bound(new.build, catalog)
            except TypeError:
                br = None
            if br is not None and br <= MAX_CAPACITY:
                new = dataclasses.replace(new, build_rows=br)
        if new.join_type in ("left_semi", "left_anti"):
            return new
        try:
            br_static = row_bound(new.build, catalog)
        except TypeError:
            br_static = None       # exchange-wrapped subtree

        def clamp(mm: int) -> int:
            # a probe row cannot match more rows than the build side can
            # hold on any probe path (hash collisions included — only that
            # many rows exist), so the *static* build bound caps the
            # expansion capacity. Never clamp by the feedback-tightened
            # build_rows: its safety net (the occupancy-check fallback)
            # protects table sizing, not match capacity.
            if br_static is not None and mm > br_static:
                return max(int(br_static), 1)
            return mm

        if _build_side_unique(new, catalog):
            # exact unique key: exactly one candidate row per probe row.
            # hashed (composite/multi-column) unique key: matches beyond the
            # first are hash collisions, filtered by the verify pass -- a
            # small constant of headroom suffices.
            mm = 1 if _exact_key(new, catalog) else clamp(4)
            return dataclasses.replace(new, max_matches=mm)
        if config.feedback is not None and _exact_key(new, catalog):
            # uniqueness unprovable statically, but the driver measured the
            # exact-key build multiplicity (collision-free equality): it
            # bounds matches per probe row for the recorded table versions
            mm_obs = config.feedback.max_matches(
                config.feedback.key_for(new, catalog, config.num_workers))
            if mm_obs is not None and mm_obs < new.max_matches:
                return dataclasses.replace(new, max_matches=max(mm_obs, 1))
        if clamp(new.max_matches) != new.max_matches:
            return dataclasses.replace(new,
                                       max_matches=clamp(new.max_matches))
        # uniqueness unprovable: keep the hand-set capacity

    return new


# ---------------------------------------------------------------------------
# rule 5: physical exchange placement (distributed fragment plans)
# ---------------------------------------------------------------------------

def infer_distribution(node: P.PlanNode) -> str:
    """Planner-visible distribution of a node's output across workers.

    Mirrors the driver's runtime stream tracking: ``'partitioned'`` (each
    worker holds a disjoint row slice) or ``'replicated'`` (every worker
    holds all rows). Blocking global operators (OrderBy/Limit) and explicit
    Broadcast nodes replicate; sources and hash exchanges partition.
    """
    if isinstance(node, P.OrderBy) and node.local:
        return infer_distribution(node.child)
    if isinstance(node, (P.OrderBy, P.Limit, P.Broadcast)):
        return "replicated"
    if isinstance(node, (P.TableScan, P.InMemorySource, P.Exchange,
                         P.Repartition)):
        return "partitioned"
    if isinstance(node, P.Join):
        return infer_distribution(node.probe)
    kids = node.children()
    return infer_distribution(kids[0]) if kids else "partitioned"


def _shuffle_key_position(keys: Sequence[str],
                          schema: Dict[str, dt.DType]) -> Optional[int]:
    """Position of a single stand-in shuffle key, or None to keep all keys.

    Hash-partitioning on any non-empty key subset keeps equal full keys on
    one worker, so when the key list drags byte-matrix columns through the
    hash, a single int/date column can stand in for all of them. The
    subset is taken only when it actually removes byte hashing: without
    per-column cardinality stats a lone low-cardinality int key could skew
    the shuffle, so key lists that are already cheap to hash (ints, dicts)
    are kept whole — the full composite hash spreads at least as well.
    """
    if not any(schema[k].name == "bytes" for k in keys):
        return None
    return next((i for i, k in enumerate(keys)
                 if schema[k].name in ("int32", "date32")), None)


def _shuffle_keys(keys: Sequence[str],
                  schema: Dict[str, dt.DType]) -> List[str]:
    """Minimal co-location-preserving shuffle key subset (see
    ``_shuffle_key_position``)."""
    pos = _shuffle_key_position(keys, schema)
    return [keys[pos]] if pos is not None else list(keys)


def place_exchanges(node: P.PlanNode, catalog,
                    config: OptimizerConfig = DEFAULT_CONFIG) -> P.PlanNode:
    """Lower distribution hints to explicit exchange nodes (physical plan).

    With ``config.num_workers > 1`` the stats-driven join-distribution
    decision stops being a hint the driver interprets and becomes plan
    structure: a 'partitioned' join gets ``Repartition`` nodes on both
    sides (hash-exchange on the join keys), a 'broadcast' join gets a
    ``Broadcast`` around its build side, auto Aggregations lower to
    partial -> Repartition/Broadcast -> final fragments, Distinct lowers to
    partial-dedup -> Repartition -> final-dedup, and the inputs of global
    operators (OrderBy/Limit, scalar subqueries) are broadcast. Exchanges
    are placed only where the child is provably still worker-partitioned
    (``infer_distribution``) — exchanging an already-replicated input would
    duplicate rows. The rule is idempotent: lowered joins are 'local',
    lowered aggregations carry explicit partial/final modes, and replicated
    inputs are never re-wrapped.
    """
    w = config.num_workers
    if w <= 1:
        return node
    new = replace_children(
        node, [place_exchanges(c, catalog, config) for c in node.children()])

    if isinstance(new, P.Join) and new.distribution != "local":
        probe_dist = infer_distribution(new.probe)
        if new.distribution == "broadcast" or probe_dist == "replicated":
            # replicate the build side; a replicated probe forces this shape
            # (repartitioning replicas would multiply rows W-fold)
            if infer_distribution(new.build) == "partitioned":
                return dataclasses.replace(
                    new, build=P.Broadcast(new.build, w), distribution="local")
            return dataclasses.replace(new, distribution="local")
        # both sides must shuffle on the same key positions; a single
        # cheap position stands in for byte-heavy composite keys (see
        # _shuffle_key_position for the skew rationale)
        pos = _shuffle_key_position(new.build_keys,
                                    infer_schema(new.build, catalog))
        probe_keys = ([new.probe_keys[pos]] if pos is not None
                      else list(new.probe_keys))
        build_keys = ([new.build_keys[pos]] if pos is not None
                      else list(new.build_keys))
        build = new.build
        if infer_distribution(build) == "partitioned":
            build = P.Repartition(build, build_keys)
        return dataclasses.replace(
            new, build=build,
            probe=P.Repartition(new.probe, probe_keys),
            distribution="local")

    if (isinstance(new, P.Aggregation) and new.mode == "auto"
            and infer_distribution(new.child) == "partitioned"):
        partial = dataclasses.replace(new, mode="partial")
        if new.group_keys:
            keys = _shuffle_keys(new.group_keys,
                                 infer_schema(new.child, catalog))
            shuffle = P.Repartition(partial, keys)
        else:
            shuffle = P.Broadcast(partial, w)
        return dataclasses.replace(new, child=shuffle, mode="final")

    if (isinstance(new, P.Distinct) and new.mode == "auto"
            and infer_distribution(new.child) == "partitioned"):
        partial = dataclasses.replace(new, mode="partial")
        keys = _shuffle_keys(new.keys, infer_schema(new.child, catalog))
        return dataclasses.replace(
            new, child=P.Repartition(partial, keys), mode="final")

    if isinstance(new, P.OrderBy) and not new.local:
        if infer_distribution(new.child) == "partitioned":
            child = new.child
            if new.limit is not None:
                # distributed top-N: per-worker local top-limit first, so
                # the gather moves W*limit candidate rows, not everything
                child = dataclasses.replace(new, local=True)
            return dataclasses.replace(new, child=P.Broadcast(child, w))
    elif isinstance(new, P.Limit):
        if infer_distribution(new.child) == "partitioned":
            return dataclasses.replace(new, child=P.Broadcast(new.child, w))

    if isinstance(new, P.ScalarBroadcast):
        if infer_distribution(new.scalar) == "partitioned":
            return dataclasses.replace(new, scalar=P.Broadcast(new.scalar, w))

    return new


# ---------------------------------------------------------------------------
# device-memory footprint estimation (admission control input)
# ---------------------------------------------------------------------------

def row_width(schema: Dict[str, dt.DType]) -> int:
    """Bytes per row of a schema (+1 byte/row for the validity mask)."""
    width = 1
    for d in schema.values():
        itemsize = int(d.np_dtype().itemsize)
        width += itemsize * d.width if d.name == "bytes" else itemsize
    return width


@dataclasses.dataclass(frozen=True)
class MemoryEstimate:
    """Per-operator device-memory footprint breakdown for one plan.

    ``per_node`` lists ``(label, bytes)`` in plan-walk order; ``total`` is
    their sum (``estimate_memory``'s return value). The breakdown travels
    with admission decisions so a ``QueryRejected`` is explainable from the
    message alone.
    """

    total: int
    per_node: tuple    # ((label, bytes), ...)

    def spill_cost(self, device_budget: int,
                   host_budget: int = 1 << 31) -> Dict[str, object]:
        """Bytes expected to cross each memory tier when this plan runs
        under ``device_budget``, plus a coarse slowdown multiplier: the
        excess over the device budget lands in host buffers first and
        overflows to disk past ``host_budget``; each spilled byte is priced
        at the transfers it implies (host ~2x the in-memory touch, disk
        ~8x)."""
        excess = max(0, self.total - max(device_budget, 1))
        host_bytes = min(excess, max(host_budget, 0))
        disk_bytes = excess - host_bytes
        denom = max(self.total, 1)
        slowdown = 1.0 + 2.0 * host_bytes / denom + 8.0 * disk_bytes / denom
        return {"excess_bytes": excess, "host_tier_bytes": host_bytes,
                "disk_tier_bytes": disk_bytes,
                "est_slowdown": round(slowdown, 2)}

    def describe(self, device_budget: Optional[int] = None,
                 host_budget: int = 1 << 31) -> str:
        """Human-readable footprint breakdown (one line per operator),
        optionally followed by the spill-cost estimate for a budget."""
        lines = [f"estimated footprint: {self.total} B"]
        for label, nbytes in self.per_node:
            lines.append(f"  {label}: {nbytes} B")
        if device_budget is not None:
            cost = self.spill_cost(device_budget, host_budget)
            lines.append(
                f"  spill cost @ budget {device_budget} B: "
                f"{cost['host_tier_bytes']} B host tier, "
                f"{cost['disk_tier_bytes']} B disk tier, "
                f"~{cost['est_slowdown']}x est. slowdown")
        return "\n".join(lines)


def estimate_memory(plan: P.PlanNode, catalog, num_workers: int = 1,
                    batch_rows: int = 8192, prefetch_depth: int = 2,
                    feedback=None) -> int:
    """Estimated peak device-memory footprint of executing ``plan``, in
    bytes: the sum of the device-resident state each node pins.

    * ``TableScan``     -- ``prefetch_depth + 1`` in-flight morsel steps
                           (the bounded prefetch queue plus the one
                           computing), capped at the table's total size.
    * ``Aggregation`` / ``Distinct``
                        -- ``max_groups`` slots per worker (doubled when
                           the two-phase lowering materializes partials).
    * ``Join``          -- the materialized build side (replicated to every
                           worker under a broadcast distribution) plus one
                           ``max_matches``-expanded probe output batch.
    * ``OrderBy`` / ``Limit`` / ``Exchange`` / ``Repartition`` /
      ``Broadcast``     -- the child materialized (these are blocking).

    An upper-bound-flavored estimate, byte for byte the reference's for
    the same plan and store.

    With ``feedback`` (a ``core.feedback.FeedbackStore``), warm entries are
    priced from *observed* footprints: recorded cardinalities replace the
    declared row bounds for materialized intermediates, and zone-map skip
    fractions discount scans, so a warm query admits (and is given a spill
    budget) at what it actually pins.
    """
    return estimate_memory_breakdown(plan, catalog, num_workers, batch_rows,
                                     prefetch_depth, feedback).total


def estimate_memory_breakdown(plan: P.PlanNode, catalog,
                              num_workers: int = 1, batch_rows: int = 8192,
                              prefetch_depth: int = 2,
                              feedback=None) -> MemoryEstimate:
    """``estimate_memory`` with the per-operator breakdown retained
    (admission control attaches it to rejections)."""
    parts: List = []
    w = max(num_workers, 1)

    def observed(node: P.PlanNode) -> Optional[int]:
        if feedback is None:
            return None
        return feedback.rows(feedback.key_for(node, catalog, w))

    def static_rows(node: P.PlanNode) -> int:
        try:
            return min(row_bound(node, catalog), 1 << 40)
        except TypeError:
            return 1 << 20

    def bounded_rows(node: P.PlanNode) -> int:
        obs = observed(node)
        if obs is not None:
            return max(int(obs), 1)
        return static_rows(node)

    def visit(node: P.PlanNode) -> None:
        if isinstance(node, P.TableScan):
            width = row_width(infer_schema(node, catalog))
            in_flight = batch_rows * w * (prefetch_depth + 1)
            total_rows = static_rows(node)
            if feedback is not None:
                # the recorded zone-map skip fraction discounts chunks the
                # scan prunes before they ever reach device memory (the
                # observed *row* count is post-filter and would under-price
                # the in-flight morsels, so only the skip rate is used)
                sf = feedback.skip_fraction(
                    feedback.key_for(node, catalog, w))
                if sf:
                    total_rows = max(int(total_rows * (1.0 - sf)), 1)
            parts.append((f"TableScan({node.table})",
                          width * min(in_flight,
                                      max(total_rows, batch_rows))))
        elif isinstance(node, P.InMemorySource):
            width = row_width(infer_schema(node, catalog))
            parts.append(("InMemorySource", width * bounded_rows(node)))
        elif isinstance(node, (P.Aggregation, P.Distinct)):
            width = row_width(infer_schema(node, catalog))
            phases = 2 if (isinstance(node, P.Aggregation)
                           and node.mode in ("auto", "two_phase")
                           and w > 1) else 1
            key_cols = (node.group_keys if isinstance(node, P.Aggregation)
                        else node.keys)
            keys = ",".join(key_cols) if key_cols else "<global>"
            parts.append((f"{type(node).__name__}({keys})",
                          width * node.max_groups * w * phases))
        elif isinstance(node, P.Join):
            build_width = row_width(infer_schema(node.build, catalog))
            build_rows = bounded_rows(node.build)
            repl = w if node.distribution == "broadcast" else 1
            out_width = row_width(infer_schema(node, catalog))
            keys = ",".join(node.build_keys)
            parts.append((f"Join({keys}) build", build_width * build_rows
                          * repl))
            parts.append((f"Join({keys}) probe-out",
                          out_width * batch_rows
                          * max(node.max_matches, 1) * w))
        elif isinstance(node, (P.OrderBy, P.Limit, P.Exchange)):
            width = row_width(infer_schema(node.children()[0], catalog))
            parts.append((type(node).__name__,
                          width * bounded_rows(node.children()[0])))
        elif isinstance(node, P.Repartition):
            # blocking: the child materialized for the send, then received
            # into same-sized buffers
            width = row_width(infer_schema(node.child, catalog))
            parts.append(("Repartition",
                          2 * width * bounded_rows(node.child)))
        elif isinstance(node, P.Broadcast):
            # every worker pins a replica of all rows, plus the input
            width = row_width(infer_schema(node.child, catalog))
            repl = max(node.num_workers, w)
            parts.append(("Broadcast",
                          width * bounded_rows(node.child) * (repl + 1)))
        for c in node.children():
            visit(c)

    visit(plan)
    return MemoryEstimate(total=sum(n for _, n in parts),
                          per_node=tuple(parts))


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

DEFAULT_RULES = (push_filters, prune_columns, reorder_joins,
                 choose_join_distribution, derive_capacities, place_exchanges)


def optimize(plan: P.PlanNode, catalog, rules=DEFAULT_RULES,
             config: OptimizerConfig = DEFAULT_CONFIG) -> P.PlanNode:
    """Run the rule pipeline; the input tree is never mutated."""
    for rule in rules:
        plan = rule(plan, catalog, config)
    return plan


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------

def explain(plan: P.PlanNode, catalog=None) -> str:
    """Pretty-print a plan tree; adds row bounds when a catalog is given."""
    lines: List[str] = []
    _explain_into(plan, catalog, 0, lines)
    return "\n".join(lines)


def explain_before_after(plan: P.PlanNode, catalog,
                         config: OptimizerConfig = DEFAULT_CONFIG) -> str:
    """Plan tree before and after the optimizer pipeline."""
    return (f"== logical plan ==\n{explain(plan, catalog)}\n"
            f"== optimized plan ==\n"
            f"{explain(optimize(plan, catalog, config=config), catalog)}")


def _explain_into(node: P.PlanNode, catalog, depth: int,
                  lines: List[str]) -> None:
    suffix = ""
    if catalog is not None:
        try:
            suffix = f"  [<= {row_bound(node, catalog)} rows]"
        except TypeError:
            pass
        if isinstance(node, P.TableScan):
            suffix += _scan_storage_note(node, catalog)
    lines.append("  " * depth + _describe(node) + suffix)
    for c in node.children():
        _explain_into(c, catalog, depth + 1, lines)


def _scan_storage_note(node: P.TableScan, catalog) -> str:
    """Storage-side annotation: chunk count and whether the pushed-down
    predicate is eligible for zone-map data skipping on this source."""
    src = catalog.get(node.table)
    chunks = getattr(src, "num_chunks", None)
    if chunks is None:
        return ""
    note = f"  [chunks={chunks}"
    if getattr(src, "skip_with_stats", False) and node.filter is not None:
        note += ", zone-map skip"
    return note + "]"


def _describe(node: P.PlanNode) -> str:
    if isinstance(node, P.TableScan):
        cols = "*" if node.columns is None else ", ".join(node.columns)
        f = f", filter={node.filter}" if node.filter is not None else ""
        return f"TableScan({node.table}: {cols}{f})"
    if isinstance(node, P.InMemorySource):
        return f"InMemorySource({node.name}: {', '.join(node.schema)})"
    if isinstance(node, P.Filter):
        return f"Filter({node.predicate})"
    if isinstance(node, P.Project):
        parts = [name if isinstance(e, ColumnRef) and e.name == name
                 else f"{name}={e}" for name, e in node.projections]
        return f"Project({', '.join(parts)})"
    if isinstance(node, P.Aggregation):
        aggs = ", ".join(f"{n}={k}({c})" if c else f"{n}={k}()"
                         for n, k, c in node.aggs)
        keys = ", ".join(node.group_keys)
        return (f"Aggregation(keys=[{keys}], aggs=[{aggs}], "
                f"max_groups={node.max_groups}, mode={node.mode})")
    if isinstance(node, P.Distinct):
        return (f"Distinct(keys=[{', '.join(node.keys)}], "
                f"max_groups={node.max_groups}, mode={node.mode})")
    if isinstance(node, P.Join):
        pay = (f", payload=[{', '.join(node.build_payload)}]"
               if node.build_payload else "")
        return (f"Join({node.join_type}, {list(node.probe_keys)} = "
                f"{list(node.build_keys)}{pay}, "
                f"distribution={node.distribution}, "
                f"max_matches={node.max_matches})")
    if isinstance(node, P.OrderBy):
        desc = node.descending or [False] * len(node.keys)
        keys = ", ".join(k + (" desc" if d else "")
                         for k, d in zip(node.keys, desc))
        lim = f", limit={node.limit}" if node.limit is not None else ""
        loc = ", local" if node.local else ""
        return f"OrderBy(keys=[{keys}]{lim}{loc})"
    if isinstance(node, P.Limit):
        return f"Limit({node.n})"
    if isinstance(node, P.ScalarBroadcast):
        return f"ScalarBroadcast(columns=[{', '.join(node.columns)}])"
    if isinstance(node, P.Exchange):
        return f"Exchange(keys=[{', '.join(node.keys)}])"
    if isinstance(node, P.Repartition):
        return f"Repartition(keys=[{', '.join(node.keys)}])"
    if isinstance(node, P.Broadcast):
        return f"Broadcast(num_workers={node.num_workers})"
    return type(node).__name__
