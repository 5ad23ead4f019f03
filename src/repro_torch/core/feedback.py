"""Runtime-feedback statistics: observed cardinalities fed back to the planner.

The optimizer plans once from static catalog row counts, but the executor
measures the truth: per-operator output cardinalities, join key
multiplicities, zone-map skip fractions. This module closes that loop
(ROADMAP "Adaptive execution"): ``FeedbackStore`` records per-plan-node
observations after every execution, keyed by the capacity-normalized
``plan.feedback_key`` (bucketed per worker count and per catalog table
versions, so stale observations can never resize an operator for data
they were not measured on), with q-error tracking per entry.

Consumers:

* ``optimizer.choose_join_distribution`` / ``derive_capacities`` override
  declared row bounds with observed ones — tighter ``build_rows`` /
  ``max_groups`` / ``max_matches`` shrink the hash tables, the
  group-by accumulators and the expansion probe's rows the card's kernels
  are sized by;
* ``optimizer.estimate_memory_breakdown`` prices warm plans from observed
  footprints, raising admission throughput;
* ``scheduler.QueryScheduler`` invalidates plan-cache entries whose
  producing estimates diverge from observation (q-error past a threshold),
  so the next submission re-plans warm.

Soundness: capacities are only tightened where an overflow degrades to the
counted sorted-key ``fallback_probe`` path (``build_rows``) or where the observation is an exact count
for the recorded table versions (``max_groups`` from the aggregate's own
output, ``max_matches`` from exact-key build multiplicity); any catalog
``register`` bumps the version and the warm entry stops matching.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from . import plan as P


def qerror(estimated: float, observed: float) -> float:
    """Multiplicative estimation error ``max(est/obs, obs/est)``.

    Both inputs are floored at 1 row so empty results and zero estimates
    stay finite; the result is symmetric (over- and under-estimation by
    the same factor score identically) and >= 1, with 1.0 meaning exact.
    """
    est = max(float(estimated), 1.0)
    obs = max(float(observed), 1.0)
    return max(est / obs, obs / est)


def referenced_sources(node: P.PlanNode) -> Tuple[str, ...]:
    """Sorted catalog table names scanned anywhere under ``node``."""
    names: set = set()
    stack: List[P.PlanNode] = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, P.TableScan):
            names.add(n.table)
        stack.extend(n.children())
    return tuple(sorted(names))


@dataclasses.dataclass
class FeedbackEntry:
    """One plan node's observed runtime statistics.

    ``rows`` is the latest observed valid output cardinality;
    ``estimated`` the static planner bound in force when it was recorded,
    and ``qerror`` their multiplicative divergence. ``max_matches`` is the
    maximum build-key multiplicity seen on an exact-key join build (an
    exact per-probe-row match bound); ``skip_fraction`` the zone-map chunk
    skip rate of a scan. ``updates``/``hits`` count store writes and
    planner reads.
    """

    rows: int
    estimated: Optional[int] = None
    qerror: float = 1.0
    max_matches: Optional[int] = None
    skip_fraction: Optional[float] = None
    updates: int = 0
    hits: int = 0


class FeedbackStore:
    """Thread-safe map from normalized plan-node keys to observations.

    One store typically lives on a ``Session`` (``Session(feedback=True)``)
    and is shared by every query the session runs, directly or through
    the scheduler (whose worker threads share it under the one lock), so the second execution of a plan shape re-plans from
    what the first one measured.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, FeedbackEntry] = {}

    def key_for(self, node: P.PlanNode, catalog, num_workers: int) -> str:
        """Store key for ``node``: capacity-normalized fingerprint bucketed
        by worker count and by the catalog versions of every table the
        subtree scans (a ``register`` invalidates dependent entries by
        construction)."""
        names = referenced_sources(node)
        try:
            versions = tuple(catalog.versions(names)) if names else ()
        except (AttributeError, KeyError):
            versions = ()
        return f"w{num_workers}|{versions!r}|{P.feedback_key(node)}"

    def record(self, key: str, rows: int, estimated: Optional[int] = None,
               max_matches: Optional[int] = None,
               skip_fraction: Optional[float] = None) -> FeedbackEntry:
        """Record one observation; the latest ``rows`` wins, side stats
        (``max_matches``/``skip_fraction``) only overwrite when provided."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = FeedbackEntry(rows=int(rows))
            entry.rows = int(rows)
            if estimated is not None:
                entry.estimated = int(estimated)
                entry.qerror = qerror(estimated, rows)
            if max_matches is not None:
                entry.max_matches = int(max_matches)
            if skip_fraction is not None:
                entry.skip_fraction = float(skip_fraction)
            entry.updates += 1
            return entry

    def get(self, key: str) -> Optional[FeedbackEntry]:
        """The full entry for ``key`` (no hit accounting), or None."""
        with self._lock:
            return self._entries.get(key)

    def rows(self, key: str) -> Optional[int]:
        """Observed output rows for ``key`` (counts a planner hit)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            entry.hits += 1
            return entry.rows

    def max_matches(self, key: str) -> Optional[int]:
        """Observed exact-key build multiplicity for ``key``, if any."""
        with self._lock:
            entry = self._entries.get(key)
            return None if entry is None else entry.max_matches

    def skip_fraction(self, key: str) -> Optional[float]:
        """Observed zone-map skip fraction for ``key``, if any."""
        with self._lock:
            entry = self._entries.get(key)
            return None if entry is None else entry.skip_fraction

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        """Drop every observation (tests; catalog swaps)."""
        with self._lock:
            self._entries.clear()

    def summary(self) -> Dict[str, object]:
        """Aggregate view for ``executor_stats()['feedback']``: entry and
        update/hit counts plus the mean and max q-error across entries."""
        with self._lock:
            n = len(self._entries)
            qerrors = [e.qerror for e in self._entries.values()
                       if e.estimated is not None]
            return {
                "entries": n,
                "updates": sum(e.updates for e in self._entries.values()),
                "hits": sum(e.hits for e in self._entries.values()),
                "max_qerror": max(qerrors) if qerrors else 1.0,
                "mean_qerror": (sum(qerrors) / len(qerrors)
                                if qerrors else 1.0),
            }
