"""Expression trees (the port's copy of ``repro.core.expr``).

Node classes, field names and operator sugar are the reference's, so a plan
built here fingerprints exactly like the reference's plan. ``evaluate`` runs
eagerly on tensors and reproduces the reference's type promotion for the
physical dtypes (bool, int32, float32): int32 op float32 is float32, and
``div`` casts an integer numerator to float32 first.

String predicates over fixed-width byte columns (``BytesMatch``), ``Year``
and ``PrefixCode`` evaluate with plain tensor operations, as the reference's
evaluate them with jnp outside any kernel; the fused kernel takes
``PrefixCode`` (``core/fused.py``).

``ParamRef`` is the placeholder that inter-query batching (``core.batch``)
puts where a filter literal was. It lives here, not in ``core.batch`` as in
the reference, so that ``core.fused`` can lower it without importing the
batching layer; ``core.batch`` re-exports it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator, Sequence, Tuple

import numpy as np
import torch

from . import dtypes as dt


class Expr:
    """Base class. Build with col()/lit() and python operators."""

    def _bin(self, op, other) -> "Expr":
        return BinaryOp(op, self, _wrap(other))

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return BinaryOp("add", _wrap(o), self)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return BinaryOp("sub", _wrap(o), self)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return BinaryOp("mul", _wrap(o), self)
    def __truediv__(self, o): return self._bin("div", o)
    def __eq__(self, o): return self._bin("eq", o)          # type: ignore
    def __ne__(self, o): return self._bin("ne", o)          # type: ignore
    def __lt__(self, o): return self._bin("lt", o)
    def __le__(self, o): return self._bin("le", o)
    def __gt__(self, o): return self._bin("gt", o)
    def __ge__(self, o): return self._bin("ge", o)
    def __and__(self, o): return self._bin("and", o)
    def __or__(self, o): return self._bin("or", o)
    def __invert__(self): return UnaryOp("not", self)
    def __neg__(self): return UnaryOp("neg", self)
    def __hash__(self):  # __eq__ overload breaks default hash
        return id(self)

    def isin(self, values: Sequence[Any]) -> "Expr":
        """SQL ``IN``: true where the value equals any of ``values``."""
        return IsIn(self, tuple(values))

    def between(self, lo, hi) -> "Expr":
        """SQL ``BETWEEN``: inclusive range predicate."""
        return (self >= lo) & (self <= hi)

    def contains(self, *parts: str) -> "Expr":
        """LIKE '%a%b%' over a bytes column (ordered substring match)."""
        return BytesMatch(self, tuple(parts), "contains")

    def startswith(self, prefix: str) -> "Expr":
        """LIKE 'prefix%' over a bytes column."""
        return BytesMatch(self, (prefix,), "startswith")

    def endswith(self, suffix: str) -> "Expr":
        """LIKE '%suffix' over a (space-padded) bytes column."""
        return BytesMatch(self, (suffix,), "endswith")

    def evaluate(self, table) -> torch.Tensor:
        """Value of this expression over a ``TorchTable`` batch."""
        raise NotImplementedError

    def out_dtype(self, schema) -> dt.DType:
        """Result dtype given an input ``name -> DType`` schema."""
        raise NotImplementedError

    def references(self) -> set:
        """Set of column names this expression reads."""
        raise NotImplementedError


def _wrap(v) -> "Expr":
    return v if isinstance(v, Expr) else Literal(v)


def promote(a: torch.Tensor, b: torch.Tensor):
    """Cast two operands to the reference's common type: float32 if either
    is floating, else int32 if either is an integer, else bool."""
    if a.dtype == b.dtype:
        return a, b
    if a.is_floating_point() or b.is_floating_point():
        return a.to(torch.float32), b.to(torch.float32)
    return a.to(torch.int32), b.to(torch.int32)


@dataclasses.dataclass(eq=False)
class ColumnRef(Expr):
    """Reference to an input column by name (``col("l_quantity")``)."""

    name: str

    def evaluate(self, table):
        return table.columns[self.name]

    def out_dtype(self, schema):
        return schema[self.name]

    def references(self):
        return {self.name}

    def __repr__(self):
        return f"col({self.name})"


@dataclasses.dataclass(eq=False)
class Literal(Expr):
    """Constant scalar; dtype inferred from the python value if absent."""

    value: Any
    dtype: dt.DType = None  # inferred if None

    def __post_init__(self):
        if self.dtype is None:
            if isinstance(self.value, bool):
                self.dtype = dt.BOOL
            elif isinstance(self.value, (int, np.integer)):
                self.dtype = dt.INT32
            elif isinstance(self.value, float):
                self.dtype = dt.FLOAT32
            else:
                raise TypeError(f"cannot infer literal dtype for {self.value!r}")

    def evaluate(self, table):
        """A 0-d tensor of the literal's physical dtype."""
        return torch.tensor(self.value, dtype=self.dtype.torch_dtype(),
                            device=table.device)

    def out_dtype(self, schema):
        return self.dtype

    def references(self):
        return set()

    def __repr__(self):
        return f"lit({self.value})"


_CMP = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
        "gt": torch.gt, "ge": torch.ge}
_ARITH = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
          "div": torch.div}
_BOOLOP = {"and": torch.logical_and, "or": torch.logical_or}


@dataclasses.dataclass(eq=False)
class BinaryOp(Expr):
    """Arithmetic/comparison/boolean operator over two subexpressions."""

    op: str
    lhs: Expr
    rhs: Expr

    def evaluate(self, table):
        a = self.lhs.evaluate(table)
        b = self.rhs.evaluate(table)
        if self.op in _BOOLOP:
            return _BOOLOP[self.op](a, b)
        if self.op == "div":
            return torch.div(a.to(torch.float32), b.to(torch.float32))
        a, b = promote(a, b)
        if self.op in _CMP:
            return _CMP[self.op](a, b)
        return _ARITH[self.op](a, b)

    def out_dtype(self, schema):
        if self.op in _CMP or self.op in _BOOLOP:
            return dt.BOOL
        lt_ = self.lhs.out_dtype(schema)
        rt_ = self.rhs.out_dtype(schema)
        if self.op == "div" or "float" in (lt_.name, rt_.name) \
                or lt_.name.startswith("float") or rt_.name.startswith("float"):
            return dt.FLOAT32 if "float64" not in (lt_.name, rt_.name) else dt.FLOAT64
        # wider int wins
        return lt_ if lt_.np_dtype().itemsize >= rt_.np_dtype().itemsize else rt_

    def references(self):
        return self.lhs.references() | self.rhs.references()

    def __repr__(self):
        return f"({self.lhs} {self.op} {self.rhs})"


@dataclasses.dataclass(eq=False)
class UnaryOp(Expr):
    """``not`` / ``neg`` over one subexpression."""

    op: str
    operand: Expr

    def evaluate(self, table):
        v = self.operand.evaluate(table)
        return torch.logical_not(v) if self.op == "not" else torch.neg(v)

    def out_dtype(self, schema):
        return dt.BOOL if self.op == "not" else self.operand.out_dtype(schema)

    def references(self):
        return self.operand.references()


@dataclasses.dataclass(eq=False)
class IsIn(Expr):
    """Membership against a small literal set (SQL ``IN``)."""

    operand: Expr
    values: Tuple[Any, ...]

    def evaluate(self, table):
        v = self.operand.evaluate(table)
        out = torch.zeros(v.shape, dtype=torch.bool, device=v.device)
        for val in self.values:
            out = out | (v == val)
        return out

    def out_dtype(self, schema):
        return dt.BOOL

    def references(self):
        return self.operand.references()


def _pattern(text: str, device) -> torch.Tensor:
    return torch.tensor(list(text.encode()), dtype=torch.uint8, device=device)


@dataclasses.dataclass(eq=False)
class BytesMatch(Expr):
    """Substring predicates over fixed-width uint8 columns.

    contains('a','b') implements SQL LIKE '%a%b%': the parts must appear in
    order, non-overlapping. Sliding-window equality over the row bytes, as
    the reference evaluates it.
    """

    operand: Expr
    parts: Tuple[str, ...]
    mode: str  # contains | startswith | endswith

    def evaluate(self, table):
        data = self.operand.evaluate(table)  # uint8[N, W]
        n, width = data.shape
        if self.mode == "startswith":
            pat = _pattern(self.parts[0], data.device)
            return (data[:, :len(pat)] == pat).all(dim=1)
        if self.mode == "endswith":
            pat = _pattern(self.parts[0], data.device)
            # rows are space padded; match against the trimmed end per row
            lengths = _row_lengths(data)
            idx = (lengths[:, None] - len(pat)
                   + torch.arange(len(pat), device=data.device)[None, :])
            ok = idx >= 0
            gathered = torch.gather(data, 1, idx.clamp(0, width - 1))
            return ((gathered == pat) & ok).all(dim=1)
        # ordered multi-part contains
        earliest = torch.zeros(n, dtype=torch.int32, device=data.device)
        found_all = torch.ones(n, dtype=torch.bool, device=data.device)
        for part in self.parts:
            hits = _find_first(data, _pattern(part, data.device), earliest)
            found_all = found_all & (hits >= 0)
            earliest = torch.where(hits >= 0, hits + len(part), earliest)
        return found_all

    def out_dtype(self, schema):
        return dt.BOOL

    def references(self):
        return self.operand.references()


def _row_lengths(data: torch.Tensor) -> torch.Tensor:
    """Length of each space-padded row = 1 + last non-space position."""
    pos = torch.arange(1, data.shape[1] + 1, dtype=torch.int32,
                       device=data.device)
    return torch.where(data != ord(" "), pos[None, :], 0).amax(dim=1)


def _find_first(data: torch.Tensor, pat: torch.Tensor,
                earliest: torch.Tensor) -> torch.Tensor:
    """First index >= earliest where ``pat`` occurs in each row, else -1."""
    n, width = data.shape
    m = pat.shape[0]
    if m > width:
        return torch.full((n,), -1, dtype=torch.int32, device=data.device)
    nwin = width - m + 1
    windows = data.unfold(1, m, 1)                          # [N, nwin, m]
    match = (windows == pat).all(dim=2)
    starts = torch.arange(nwin, dtype=torch.int32, device=data.device)
    match = match & (starts[None, :] >= earliest[:, None])
    first = torch.argmax(match.to(torch.uint8), dim=1).to(torch.int32)
    return torch.where(match.any(dim=1), first, -1)


# day number of each 1 January, 1970 to 2039 (the reference's table)
_YEAR_STARTS = np.array(
    [(np.datetime64(f"{y}-01-01") - np.datetime64("1970-01-01"))
     .astype("timedelta64[D]").astype(np.int32) for y in range(1970, 2040)],
    dtype=np.int32)


@dataclasses.dataclass(eq=False)
class Year(Expr):
    """EXTRACT(YEAR FROM date32) via searchsorted on year-start days."""

    operand: Expr

    def evaluate(self, table):
        days = self.operand.evaluate(table).to(torch.int32)
        starts = torch.from_numpy(_YEAR_STARTS).to(days.device)
        idx = torch.searchsorted(starts, days, right=True) - 1
        return (idx + 1970).to(torch.int32)

    def out_dtype(self, schema):
        return dt.INT32

    def references(self):
        return self.operand.references()


@dataclasses.dataclass(eq=False)
class PrefixCode(Expr):
    """First ``n`` bytes of a bytes column, decoded as a base-10 integer
    (SQL: cast(substring(col, 1, n) as int); used by Q22 country codes)."""

    operand: Expr
    n: int

    def evaluate(self, table):
        data = self.operand.evaluate(table)   # uint8[N, W]
        out = torch.zeros(data.shape[0], dtype=torch.int32,
                          device=data.device)
        for i in range(self.n):
            out = out * 10 + (data[:, i].to(torch.int32) - ord("0"))
        return out

    def out_dtype(self, schema):
        return dt.INT32

    def references(self):
        return self.operand.references()


_PARAMS = threading.local()


@contextlib.contextmanager
def param_values(values: Sequence[Any]) -> Iterator[None]:
    """Install one batch member's parameter values (one per slot) for the
    ``ParamRef``s evaluated on this thread inside the scope."""
    prev = getattr(_PARAMS, "values", None)
    _PARAMS.values = tuple(values)
    try:
        yield
    finally:
        _PARAMS.values = prev


@dataclasses.dataclass(eq=False)
class ParamRef(Expr):
    """Placeholder for a filter literal in a shared batch program.

    Evaluates to the current member's scalar from the thread-local
    parameter environment that ``param_values`` installs, so one program
    serves every member of every batch of its shape whatever the literal
    values."""

    idx: int
    dtype: dt.DType

    def evaluate(self, table):
        values = getattr(_PARAMS, "values", None)
        if values is None:
            raise RuntimeError(
                "ParamRef evaluated outside a batched program body")
        return torch.as_tensor(values[self.idx], device=table.device).to(
            self.dtype.torch_dtype())

    def out_dtype(self, schema):
        return self.dtype

    def references(self):
        return set()

    def __repr__(self):
        return f"par({self.idx}:{self.dtype.name})"


def year(e: Expr) -> Year:
    """EXTRACT(YEAR) from a date32 expression."""
    return Year(e)


def prefix_code(e: Expr, n: int) -> PrefixCode:
    """Integer decode of the first ``n`` bytes of a bytes column."""
    return PrefixCode(e, n)


def col(name: str) -> ColumnRef:
    """Reference a column by name: ``col("l_quantity") * 2.0``."""
    return ColumnRef(name)


def lit(value, dtype: dt.DType = None) -> Literal:
    """Literal scalar (dtype inferred from the python type if omitted)."""
    return Literal(value, dtype)


def date_lit(iso: str) -> Literal:
    """Date literal from 'YYYY-MM-DD', as int32 days since epoch."""
    return Literal(dt.date_to_i32(iso), dt.DATE32)
