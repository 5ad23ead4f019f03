"""Logical query plans (the port's copy of ``repro.core.plan``).

Node classes and field names are the reference's, so ``fingerprint`` gives
the same key for the same plan in both engines. ``AggSpec`` lives here: the
reference imports it from ``operators``.

A plan is a tree of PlanNodes. The Presto coordinator's role (split the plan
into stages at exchange boundaries, hand fragments to workers) is played by
``driver.Driver``; the "driver adaptation" step (push predicates into scans,
choose join distributions, derive operator capacities) is played by the
rule pipeline in ``optimizer.py``, the port's copy of the reference's.

``fingerprint`` produces a canonical string key for a plan tree — two
structurally identical queries fingerprint identically regardless of
list/tuple spelling — which the scheduler's plan and result caches key on.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .expr import Expr

AggSpec = Tuple[str, str, Optional[str]]   # (out_name, kind, in_column)


@dataclasses.dataclass
class PlanNode:
    """Base of the logical-plan tree; ``children()`` lists subtrees."""

    def children(self) -> List["PlanNode"]:
        return []


@dataclasses.dataclass
class TableScan(PlanNode):
    """Scan a catalog table. ``columns=None`` reads every column."""
    table: str
    columns: Optional[Sequence[str]] = None
    # pushed-down predicate evaluated inside the scan (data skipping uses
    # chunk min/max metadata against it when the storage layer has stats)
    filter: Optional[Expr] = None


@dataclasses.dataclass
class Filter(PlanNode):
    """Keep rows where ``predicate`` holds (marks the rest invalid;
    ``compact=True`` additionally stream-compacts survivors, §3.3.2)."""

    child: PlanNode
    predicate: Expr
    compact: bool = False

    def children(self):
        return [self.child]


@dataclasses.dataclass
class Project(PlanNode):
    """Compute output columns as named expressions over the child."""

    child: PlanNode
    projections: Sequence[Tuple[str, Expr]]

    def children(self):
        return [self.child]


@dataclasses.dataclass
class Aggregation(PlanNode):
    """mode 'auto' lowers to partial -> exchange -> final when distributed."""
    child: PlanNode
    group_keys: Sequence[str]
    aggs: Sequence[AggSpec]
    max_groups: int = 4096
    mode: str = "auto"          # auto | partial | final | single

    def children(self):
        return [self.child]


@dataclasses.dataclass
class Distinct(PlanNode):
    """Unique rows over ``keys`` (grouped dedup, static capacity).

    mode 'auto' lets the driver insert the cross-worker dedup exchange at
    runtime; the optimizer's exchange placement lowers it to an explicit
    'partial' (worker-local dedup) -> Repartition -> 'final' fragment pair.
    """

    child: PlanNode
    keys: Sequence[str]
    max_groups: int = 4096
    mode: str = "auto"          # auto | partial | final

    def children(self):
        return [self.child]


@dataclasses.dataclass
class Join(PlanNode):
    """Hash join; ``build`` is materialized, ``probe`` streams.

    distribution:
      'broadcast'   build side replicated to all workers (small build)
      'partitioned' both sides exchanged on the join keys (large-large)
      'local'       sides are already co-partitioned
    """
    probe: PlanNode
    build: PlanNode
    probe_keys: Sequence[str]
    build_keys: Sequence[str]
    build_payload: Sequence[str] = ()
    join_type: str = "inner"
    max_matches: int = 1
    distribution: str = "broadcast"
    # planner's upper bound on valid build-side rows (derive_capacities);
    # sizes the pallas backend's open-addressing probe table
    build_rows: Optional[int] = None

    def children(self):
        return [self.probe, self.build]


@dataclasses.dataclass
class OrderBy(PlanNode):
    """Global sort (optionally top-``limit``); blocking operator.

    ``local=True`` sorts each worker's slice independently (no gather) —
    the planner's distributed top-N lowering places a local OrderBy below
    the exchange so only ``W * limit`` candidate rows are broadcast.
    """

    child: PlanNode
    keys: Sequence[str]
    descending: Optional[Sequence[bool]] = None
    limit: Optional[int] = None
    local: bool = False

    def children(self):
        return [self.child]


@dataclasses.dataclass
class Limit(PlanNode):
    """First ``n`` valid rows of the child."""

    child: PlanNode
    n: int

    def children(self):
        return [self.child]


@dataclasses.dataclass
class ScalarBroadcast(PlanNode):
    """Attach columns of a 1-row subquery result to every row of child."""
    child: PlanNode
    scalar: PlanNode
    columns: Sequence[str]

    def children(self):
        return [self.child, self.scalar]


@dataclasses.dataclass
class Exchange(PlanNode):
    """Explicit repartition on ``keys`` (hash exchange across workers)."""
    child: PlanNode
    keys: Sequence[str]

    def children(self):
        return [self.child]


@dataclasses.dataclass
class Repartition(PlanNode):
    """Physical exchange: hash-partition the child's rows on ``keys`` so
    equal keys land on the same worker. Placed by the optimizer's
    ``place_exchanges`` rule (partitioned joins, two-phase aggregation);
    executed through the session's ``ExchangeProtocol``."""
    child: PlanNode
    keys: Sequence[str]

    def children(self):
        return [self.child]


@dataclasses.dataclass
class Broadcast(PlanNode):
    """Physical exchange: replicate every worker's valid rows to all
    ``num_workers`` workers (broadcast-join build sides, global-aggregation
    partials, scalar subqueries). Carries the planned worker count so plans
    placed for different cluster sizes fingerprint differently."""
    child: PlanNode
    num_workers: int = 1

    def children(self):
        return [self.child]


@dataclasses.dataclass
class InMemorySource(PlanNode):
    """Source backed by host numpy dict (tests / intermediate results)."""
    name: str
    data: Dict[str, Any]
    schema: Dict[str, Any]


# ---------------------------------------------------------------------------
# canonical plan keys
# ---------------------------------------------------------------------------

def _canon(v: Any, node_fn=None) -> str:
    """Canonical string for a plan-node field value.

    Normalizes list/tuple spelling (builders produce lists, hand-written
    plans often tuples), sorts dict keys, and digests numpy buffers so an
    ``InMemorySource`` keys on its actual data, not its object identity.
    ``node_fn`` is the recursion used for nested PlanNodes (``fingerprint``
    by default; ``feedback_key`` for capacity-normalized keys).
    """
    if node_fn is None:
        node_fn = fingerprint
    if isinstance(v, PlanNode):
        return node_fn(v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        inner = ",".join(
            f"{f.name}={_canon(getattr(v, f.name), node_fn)}"
            for f in dataclasses.fields(v))
        return f"{type(v).__name__}({inner})"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_canon(x, node_fn) for x in v) + "]"
    if isinstance(v, dict):
        items = sorted(v.items(), key=lambda kv: str(kv[0]))
        return ("{" + ",".join(f"{k}:{_canon(x, node_fn)}"
                               for k, x in items) + "}")
    if hasattr(v, "tobytes") and hasattr(v, "dtype"):      # numpy array
        h = hashlib.sha1()
        h.update(str(v.dtype).encode())
        h.update(str(getattr(v, "shape", ())).encode())
        h.update(v.tobytes())
        return f"ndarray:{h.hexdigest()}"
    return repr(v)


def fingerprint(node: PlanNode) -> str:
    """Canonical cache key for a logical plan tree.

    Structurally identical plans (same node types, expressions, columns,
    capacities) produce identical fingerprints; the scheduler's plan cache
    and result cache both key on this::

        >>> a = TableScan("lineitem", columns=["l_quantity"])
        >>> b = TableScan("lineitem", columns=("l_quantity",))
        >>> fingerprint(a) == fingerprint(b)
        True
    """
    inner = ",".join(
        f"{f.name}={_canon(getattr(node, f.name))}"
        for f in dataclasses.fields(node))
    return f"{type(node).__name__}({inner})"


# fields the optimizer derives (and runtime feedback re-derives): two plans
# that differ only in these describe the same logical computation, so the
# feedback store must give them the same key
_FEEDBACK_SKIP = {
    "Aggregation": frozenset({"max_groups", "mode"}),
    "Distinct": frozenset({"max_groups", "mode"}),
    "Join": frozenset({"max_matches", "build_rows", "distribution"}),
}

# physical exchange placement is worker-count plumbing, not logic: the store
# keys through it so a pre-`place_exchanges` node being planned matches the
# exchange-wrapped node the driver observed on the previous run
_FEEDBACK_TRANSPARENT = ("Repartition", "Broadcast", "Exchange")


def feedback_key(node: PlanNode) -> str:
    """Capacity-normalized plan key for the runtime-feedback store.

    Like ``fingerprint`` but (a) skips optimizer-derived capacity fields
    (``max_groups``/``mode``, ``max_matches``/``build_rows``/
    ``distribution``) so a node keys the same before and after
    ``derive_capacities`` rewrites it (cold and warm plans of one query
    share feedback entries), and (b) looks through physical exchange
    nodes (``Repartition``/``Broadcast``/``Exchange``) so distributed
    fragment plans key onto their logical shape. Worker count still
    matters for observed cardinalities (partial aggregates emit per-worker
    groups), so ``FeedbackStore`` buckets entries per ``num_workers`` on
    top of this key.
    """
    while type(node).__name__ in _FEEDBACK_TRANSPARENT:
        node = node.child
    skip = _FEEDBACK_SKIP.get(type(node).__name__, frozenset())
    inner = ",".join(
        f"{f.name}={_canon(getattr(node, f.name), feedback_key)}"
        for f in dataclasses.fields(node) if f.name not in skip)
    return f"{type(node).__name__}({inner})"
