"""Zone-map data skipping (the port of ``repro.storage.zonemap``):
tri-state predicate evaluation over min/max stats.

Both storage formats keep per-chunk (column-chunk format) or per-row-group
(paged format) min/max ranges. The optimizer pushes predicates into
``TableScan.filter``; the scan asks this module whether a chunk *may*
contain matching rows before reading it. A skipped chunk is never read
from storage and never copied to the device.

Evaluation is conservative: ``eval_range`` returns True (every row matches),
False (no row can match: safe to skip), or None (unknown). Only a provable
False skips data, so skipping on and off give identical results.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from ..core.expr import BinaryOp, ColumnRef, Expr, Literal

# get_range(column) -> (min, max) of the zone, or None when unavailable
RangeLookup = Callable[[str], Optional[Tuple[float, float]]]

# "lit OP col" is evaluated as "col FLIP(OP) lit"
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def eval_range(e: Expr, get_range: RangeLookup) -> Optional[bool]:
    """Tri-state (True/False/None=unknown) evaluation of a predicate against
    a zone's min/max ranges. Unknown expression shapes return None."""
    if not isinstance(e, BinaryOp):
        return None
    if e.op == "and":
        l, r = eval_range(e.lhs, get_range), eval_range(e.rhs, get_range)
        if l is False or r is False:
            return False
        return True if (l is True and r is True) else None
    if e.op == "or":
        l, r = eval_range(e.lhs, get_range), eval_range(e.rhs, get_range)
        if l is True or r is True:
            return True
        return False if (l is False and r is False) else None
    lhs, rhs, op = e.lhs, e.rhs, e.op
    if isinstance(lhs, Literal) and isinstance(rhs, ColumnRef):
        if op not in _FLIP:
            return None
        lhs, rhs, op = rhs, lhs, _FLIP[op]
    if not (isinstance(lhs, ColumnRef) and isinstance(rhs, Literal)):
        return None
    rng = get_range(lhs.name)
    if rng is None:
        return None
    lo, hi = rng
    try:
        v = float(rhs.value)
    except (TypeError, ValueError):
        return None
    if op == "lt":
        return True if hi < v else (False if lo >= v else None)
    if op == "le":
        return True if hi <= v else (False if lo > v else None)
    if op == "gt":
        return True if lo > v else (False if hi <= v else None)
    if op == "ge":
        return True if lo >= v else (False if hi < v else None)
    if op == "eq":
        return False if (v < lo or v > hi) else None
    return None


def may_match(e: Optional[Expr], get_range: RangeLookup) -> bool:
    """False only when the zone provably contains no matching row."""
    if e is None:
        return True
    return eval_range(e, get_range) is not False
