"""Fused per-morsel pipeline (the port of ``repro.core.fused``).

``fused_morsel_program`` runs a run of FilterProject stages over one morsel
in one launch. The reference traced the stages' expression trees into one
Pallas kernel; the port lowers them on the host (``lower_stages``) into a
flat program of typed instructions over 32-bit registers, and a fixed CUDA
kernel (``kernels/csrc/fused_morsel.cu``) interprets that program one
instruction at a time over a tile of 1024 rows held in shared memory
(``assign_slots`` lays the tile out on the host). The kernel is built once
from the repository's source: no query writes or compiles CUDA code.

The probe variant ends the program with the join's single-match probe:
the program computes the probe key from the post-stage registers (the raw
int column, or the injective composite pack), and the kernel probes the
join's table (``kernels/csrc/hash_probe.cuh``) and stores ``found`` and
``bidx`` beside the stage outputs.

A fixed-width bytes column (uint8[N, W]) enters the program through
``PrefixCode`` (its input slot carries the row width, and a LOADB
instruction reads one byte of the row) and through ``BytesMatch`` (a
BYTESMATCH instruction matches the row against a pattern held in the
program's byte ``pool``). A bytes column that a stage only carries passes
through: the output column is the input tensor, which the kernel never
loads. ``Year`` is the YEAR instruction, exact against the reference's
table of year starts (1969 before 1970, 2039 from 2039 on).

``apply_stages`` (with ``kernels.hash_probe.hash_probe_plain`` for the
probe) is the plain version, and it is what a CPU tensor runs. The lowering
raises ``NotImplementedError`` for any node it cannot express (a bytes
column stored or compared, a computed value matched, ...); it never runs
the stages unfused instead. A run too large for the kernel's limits
(registers, instructions, columns, shared memory) raises
``KernelLimitError``; ``lower_split`` then cuts the run into consecutive
programs that fit, each its own launch.

``fused_batch_program`` is the inter-query batched variant (the port of the
reference's ``fused_batch_program``): B stacked queries share the stages'
projections, and each filter ANDs one predicate lane per member into a
``[B, n]`` mask stack instead of narrowing the validity. Its filters carry
``ParamRef``s where the members' literals differ. The same lowering
(``lower_stages(..., batch=True)``) turns each filter into a lane loop whose
body reads the lane's parameters (PARAM), and ``kernels/csrc/fused_batch.cu``
runs it with the interpreter it shares with the fused kernel
(``fused_interp.cuh``). ``apply_batched_stages`` is its plain version.

Under ``launch.roofline.count_program`` each launch reports the work of
its program on the morsel's n rows (``program_work``), the reckoning of
rows 1 and 9's bounds in ``PERF.md`` (row 1p's counts the table sectors
the keys' runs touch, which a count on ``meta`` cannot see): bytes ``n (sum_in size * (width
or 1) + 1 + sum_stored size + 1)`` (each input column read once, a bytes
column's row whole, the validity read, each stored output and the output
validity written) and ``n`` operations an instruction from FILTER on; a
probe adds 5 bytes a row (``found``, ``bidx``), ``min(8 T, 64 n)`` of
table and 8 operations a row (as ``kernels.hash_probe``'s probe); a batch
launch of L lanes writes L mask bytes a row in place of the validity and
counts an operation for every instruction, a lane loop's body L times. A
CPU table is lowered to count it as the card would run it.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels import build
from ..kernels import hash_probe as hp
from ..kernels import ops as kernel_ops
from . import dtypes as dt
from . import relational as rel
from .expr import (BinaryOp, BytesMatch, ColumnRef, Expr, IsIn, Literal,
                   ParamRef, PrefixCode, UnaryOp, Year, param_values)
from .plan import _canon
from .table import TorchTable

# one fused stage = one FilterProject's (filter_expr, projections)
Stage = Tuple[object, Optional[Tuple[Tuple[str, object], ...]]]

# opcode numbers and limits, mirrored from kernels/csrc/fused_interp.cuh
OPS = {
    "LOAD32": 0, "LOAD8": 1, "CONST": 2, "STORE32": 3, "STORE8": 4,
    "FILTER": 5,
    "ADD_I32": 6, "SUB_I32": 7, "MUL_I32": 8, "NEG_I32": 9,
    "ADD_F32": 10, "SUB_F32": 11, "MUL_F32": 12, "DIV_F32": 13,
    "NEG_F32": 14,
    "EQ_I32": 15, "NE_I32": 16, "LT_I32": 17, "LE_I32": 18, "GT_I32": 19,
    "GE_I32": 20,
    "EQ_F32": 21, "NE_F32": 22, "LT_F32": 23, "LE_F32": 24, "GT_F32": 25,
    "GE_F32": 26,
    "AND": 27, "OR": 28, "NOT": 29, "I32_TO_F32": 30, "PROBE": 31,
    "LOADB": 32, "PARAM": 33, "LOOP": 34, "LFILTER": 35, "YEAR": 36,
    "BYTESMATCH": 37,
}
LIMITS = {"kMaxInstr": 160, "kMaxCols": 24, "kMaxRegs": 48, "kMaxLanes": 64,
          # the pattern pool's bytes (BYTESMATCH); a pattern record is
          # (mode, parts, then each part's length and bytes)
          "kMaxPool": 256,
          # the tile kernels: 256 threads, four rows each, over a tile of
          # 1024 rows; uniform slots from kUniformBase; two load stages when
          # they fit in the block's shared memory (kMaxSmem, sm_90); an
          # operand is (kind << kKindShift) | byte offset or uniform index
          "kThreads": 256, "kRowsPerThread": 4, "kTileRows": 1024,
          "kUniformBase": 64, "kStages": 2, "kMaxSmem": 232448,
          "kKindShift": 24, "kKindComp": 0, "kKindRing32": 1,
          "kKindRing8": 2, "kKindUniform": 3, "kPlanHeader": 8}

_LIB = "fused_morsel"
# (plan, plan_len, in_ptrs, in_widths, n_in, out_ptrs, n_out, valid_in,
#  valid_out, n, tk, tv, table_size, max_probes, empty_key, found, bidx,
#  stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_BATCH_LIB = "fused_batch"
# (plan, plan_len, in_ptrs, in_widths, n_in, out_ptrs, n_out, params,
#  n_slots, lanes, valid_in, masks, n, stream)
_BATCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
_CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")
_ARITH_OPS = ("add", "sub", "mul")
# register kinds: 'i32' (int32 bits), 'f32' (float32 bits), 'b' (0 or 1)
_KIND = {torch.int32: "i32", torch.float32: "f32", torch.bool: "b"}
_KIND_DTYPE = {"i32": torch.int32, "f32": torch.float32, "b": torch.bool}
# BYTESMATCH modes, as the kernel reads them from a pattern record
_MATCH_MODES = {"contains": 0, "startswith": 1, "endswith": 2}


class KernelLimitError(NotImplementedError):
    """A run of stages that the fused kernels could run, but not as one
    program: it passes a register, instruction, column or shared-memory
    limit (``lower_split`` cuts it)."""


def apply_stages(table: TorchTable, stages: Sequence[Stage]) -> TorchTable:
    """Replay a run of FilterProject stages on ``table`` -- the per-stage
    semantics of ``operators.FilterProject`` without compaction. The plain
    version of the fused kernel."""
    for filter_expr, projections in stages:
        if filter_expr is not None:
            table = table.filter(filter_expr.evaluate(table))
        if projections is not None:
            cols, schema = {}, {}
            for out_name, e in projections:
                v = e.evaluate(table)
                if v.dim() == 0:   # literal: broadcast to rows
                    v = v.expand(table.capacity)
                cols[out_name] = v
                schema[out_name] = e.out_dtype(table.schema)
            table = TorchTable(cols, table.validity, schema)
    return table


def probe_key(table: TorchTable, key_names, pack, empty_key: int
              ) -> torch.Tensor:
    """Single-lane probe key: the raw int key, or the injective composite
    pack (``relational.packed_key``) when ``pack`` is set."""
    cols = [table.columns[k] for k in key_names]
    if pack is not None:
        return rel.packed_key(cols, pack, empty_key=empty_key)
    key, exact = rel.join_key(cols)
    if not exact:
        raise NotImplementedError(
            f"probe_key: {tuple(key_names)} is a hashed key; the table "
            "takes exact keys, and a hashed one probes the sorted-key join")
    return key


def apply_probe(table: TorchTable, probe: dict):
    """Plain version of the fused probe on the post-stage ``table`` ->
    ``(found, bidx)``; ``found`` is masked by validity and by probe keys
    equal to the empty sentinel, as the kernel stores it."""
    key = probe_key(table, probe["probe_keys"], probe["pack"],
                    probe["empty_key"])
    found, bidx = hp.hash_probe_plain(probe["tk"], probe["tv"], key,
                                      probe["empty_key"], probe["max_probes"])
    return found & table.validity & (key != probe["empty_key"]), bidx


@dataclasses.dataclass(frozen=True)
class Program:
    """A lowered run of stages: ``code`` is int32[n_instr, 4] on the host,
    rows of (op, dst, a, b); ``in_names`` are the input columns in load-slot
    order, with the ``in_dtypes`` the program reads them as and their
    ``in_widths`` (the row width of a bytes column, else 0); outputs are
    ``out_names`` with their physical ``out_dtypes``. With ``probe`` set
    the program ends in a PROBE of the key register it computed.

    A ``batch`` program (``lower_stages(..., batch=True)``) has lane loops
    instead of FILTERs; ``param_dtypes`` holds each parameter slot's dtype
    (None for a slot it never reads). ``out_alias`` names, for each
    output, the input column it passes through unchanged (the kernel does
    not store it) or None (the kernel stores it, in output order): in a
    batch program every pass-through, in another only a bytes column's.
    ``pool`` holds the BYTESMATCH instructions' pattern records.

    ``lower_registers`` numbers the registers 0..n_regs-1, one definition
    each; ``assign_slots`` (which ``lower_stages`` applies last) renumbers
    them into the kernels' slots, ``n_vec`` vector slots from 0 and
    ``n_uniform`` uniform slots from ``kUniformBase``, and lays out the
    kernels' ``plan``."""

    code: torch.Tensor
    in_names: Tuple[str, ...]
    in_dtypes: Tuple[torch.dtype, ...]
    in_widths: Tuple[int, ...]
    out_names: Tuple[str, ...]
    out_dtypes: Tuple[torch.dtype, ...]
    out_schema: Dict[str, object]
    n_regs: int
    probe: bool = False
    batch: bool = False
    param_dtypes: Tuple[Optional[torch.dtype], ...] = ()
    out_alias: Tuple[Optional[str], ...] = ()
    pool: bytes = b""
    n_vec: int = 0
    n_uniform: int = 0
    plan: Optional["TilePlan"] = None


def _has_param(e) -> bool:
    if isinstance(e, ParamRef):
        return True
    return any(_has_param(c) for c in _children(e))


def _children(e) -> List[Expr]:
    if not dataclasses.is_dataclass(e):
        return []
    return [getattr(e, f.name) for f in dataclasses.fields(e)
            if isinstance(getattr(e, f.name), Expr)]


class _Lowering:
    """Expression trees -> register program (one instance per program)."""

    def __init__(self, table: TorchTable, batch: bool = False):
        self.table = table
        self.batch = batch
        self.code: List[Tuple[int, int, int, int]] = []
        self.n_regs = 0
        self.in_slots: Dict[str, int] = {}
        self.loaded: Dict[str, Tuple[int, str]] = {}
        # register -> the input column a LOAD32/LOAD8 put there unchanged
        self.load_of: Dict[int, str] = {}
        self.memo: Dict[str, Tuple[int, str]] = {}
        self.consts: Dict[Tuple[str, int], int] = {}
        # parameter slot -> the dtype its ParamRef reads
        self.params: Dict[int, torch.dtype] = {}
        # the BYTESMATCH pattern records, and each one's offset in it
        self.pool = bytearray()
        self.patterns: Dict[bytes, int] = {}

    # -- emission ------------------------------------------------------------
    def reg(self) -> int:
        r = self.n_regs
        self.n_regs += 1
        if self.n_regs > LIMITS["kMaxRegs"]:
            raise KernelLimitError(
                f"fused lowering: more than {LIMITS['kMaxRegs']} registers")
        return r

    def emit(self, op: str, dst: int = 0, a: int = 0, b: int = 0) -> int:
        self.code.append((OPS[op], dst, a, b))
        return dst

    def const(self, bits: int, kind: str) -> Tuple[int, str]:
        bits = int(np.int64(bits).astype(np.int32))  # as a signed int32 field
        key = (kind, bits)
        if key not in self.consts:
            self.consts[key] = self.emit("CONST", self.reg(), bits)
        return self.consts[key], kind

    def slot(self, name: str) -> int:
        slot = self.in_slots.setdefault(name, len(self.in_slots))
        if slot >= LIMITS["kMaxCols"]:
            raise KernelLimitError("fused lowering: too many columns")
        return slot

    def column(self, name: str) -> Tuple[int, str]:
        if name not in self.loaded:
            t = self.table.columns[name]
            kind = _KIND.get(t.dtype)
            if t.dim() != 1 or kind is None:
                raise NotImplementedError(
                    f"fused lowering: column {name!r} of dtype {t.dtype} and "
                    f"shape {tuple(t.shape)} (a bytes column enters the "
                    "program only through PrefixCode)")
            op = "LOAD8" if kind == "b" else "LOAD32"
            r = self.emit(op, self.reg(), self.slot(name))
            self.loaded[name] = (r, kind)
            self.load_of[r] = name
        return self.loaded[name]

    def bytes_column(self, e, env, what: str) -> str:
        """The input bytes column (uint8[n, W]) that ``e`` names."""
        src = env[e.name] if isinstance(e, ColumnRef) else None
        if not isinstance(src, str):
            raise NotImplementedError(
                f"fused lowering: {what} of a computed value")
        t = self.table.columns[src]
        if t.dim() != 2 or t.dtype != torch.uint8:
            raise NotImplementedError(
                f"fused lowering: {what} of column {src!r} of dtype "
                f"{t.dtype} and shape {tuple(t.shape)}")
        return src

    def pattern(self, e: BytesMatch) -> int:
        """The pool offset of ``e``'s pattern record: the mode, the number
        of parts, then each part's length and bytes (startswith and
        endswith read the first part alone, as the reference does)."""
        parts = [p.encode() for p in (e.parts if e.mode == "contains"
                                      else e.parts[:1])]
        if e.mode not in _MATCH_MODES or not parts or any(
                len(p) > 255 for p in parts):
            raise NotImplementedError(
                f"fused lowering: BytesMatch {e.mode!r} of {len(parts)} "
                "parts (a part is at most 255 bytes)")
        rec = bytes([_MATCH_MODES[e.mode], len(parts)]) + b"".join(
            bytes([len(p)]) + p for p in parts)
        if rec not in self.patterns:
            if len(self.pool) + len(rec) > LIMITS["kMaxPool"]:
                raise KernelLimitError(
                    f"fused lowering: more than {LIMITS['kMaxPool']} bytes "
                    "of patterns")
            self.patterns[rec] = len(self.pool)
            self.pool += rec
        return self.patterns[rec]

    def value(self, v) -> Tuple[int, str]:
        """The register of an env entry: an input column's name is loaded
        on first use."""
        return self.column(v) if isinstance(v, str) else v

    def byte(self, name: str, i: int) -> int:
        """Register holding byte ``i`` of the row of bytes column ``name``
        (zero-extended)."""
        key = f"{name}[{i}]"
        if key not in self.loaded:
            t = self.table.columns[name]
            if t.dim() != 2 or t.dtype != torch.uint8 or i >= t.shape[1]:
                raise NotImplementedError(
                    f"fused lowering: byte {i} of column {name!r} of dtype "
                    f"{t.dtype} and shape {tuple(t.shape)}")
            self.loaded[key] = (self.emit("LOADB", self.reg(), self.slot(name),
                                          i), "i32")
        return self.loaded[key][0]

    # -- conversions -----------------------------------------------------------
    def to_f32(self, v):
        r, kind = v
        if kind == "f32":
            return v
        return self.emit("I32_TO_F32", self.reg(), r), "f32"

    def truth(self, v):
        r, kind = v
        if kind == "b":
            return v
        zero = self.const(0, kind)[0]
        return self.emit("NE_F32" if kind == "f32" else "NE_I32", self.reg(),
                         r, zero), "b"

    def literal(self, value, kind: str):
        if kind == "f32":
            return self.const(np.float32(value).view(np.int32), "f32")
        return self.const(int(value), kind)

    # -- lane loops (batch programs) -------------------------------------------
    def hoist(self, e, env, stage: int) -> None:
        """Emit every lane-invariant subtree of ``e`` (no ``ParamRef``
        below it) before the lane loop, so the loop body recomputes only
        what depends on the lane's parameters."""
        if not _has_param(e):
            self.expr(e, env, stage)
            return
        for c in _children(e):
            self.hoist(c, env, stage)

    def lane_filter(self, e, env, stage: int) -> None:
        """LOOP, the body that evaluates ``e`` for one lane, LFILTER. The
        kernel skips the body for lanes (or rows) already dead, so every
        register the body defined is forgotten after it: nothing outside
        the loop reads one."""
        self.hoist(e, env, stage)
        loop = len(self.code)
        self.emit("LOOP")
        first = self.n_regs
        pred = self.truth(self.expr(e, env, stage))
        self.emit("LFILTER", 0, pred[0])
        self.code[loop] = (OPS["LOOP"], 0, len(self.code) - 1 - loop, 0)
        self.memo = {k: v for k, v in self.memo.items() if v[0] < first}
        self.consts = {k: r for k, r in self.consts.items() if r < first}
        self.loaded = {k: v for k, v in self.loaded.items() if v[0] < first}

    # -- expressions -----------------------------------------------------------
    def expr(self, e, env, stage: int):
        key = f"{stage}:{_canon(e)}"
        if key not in self.memo:
            self.memo[key] = self._expr(e, env, stage)
        return self.memo[key]

    def _expr(self, e, env, stage):
        if isinstance(e, ParamRef):
            # the register kind its dtype gives, as a Literal's does
            kind = _param_kind(e)
            if not self.batch or kind is None:
                raise NotImplementedError(
                    f"fused lowering: {e!r} outside a batch program")
            self.params[e.idx] = e.dtype.torch_dtype()
            return self.emit("PARAM", self.reg(), e.idx), kind
        if isinstance(e, ColumnRef):
            return self.value(env[e.name])
        if isinstance(e, Literal):
            if e.dtype.name in ("float32", "float64"):
                return self.literal(e.value, "f32")
            if e.dtype.name == "bool":
                return self.literal(bool(e.value), "b")
            if e.dtype.name in ("int32", "int64", "date32", "dict32"):
                return self.literal(np.int64(e.value).astype(np.int32), "i32")
            raise NotImplementedError(f"fused lowering: literal {e!r}")
        if isinstance(e, BinaryOp):
            a = self.expr(e.lhs, env, stage)
            b = self.expr(e.rhs, env, stage)
            if e.op in ("and", "or"):
                a, b = self.truth(a), self.truth(b)
                return self.emit(e.op.upper(), self.reg(), a[0], b[0]), "b"
            if e.op == "div":
                a, b = self.to_f32(a), self.to_f32(b)
                return self.emit("DIV_F32", self.reg(), a[0], b[0]), "f32"
            # the reference's promotion: float32 if either side is a float,
            # else int32 (bools compare as 0/1)
            kinds = (a[1], b[1])
            if "f32" in kinds:
                a, b, kind = self.to_f32(a), self.to_f32(b), "f32"
            else:
                kind = "i32"
            op = f"{e.op.upper()}_{kind.upper()}"
            if e.op in _CMP_OPS:
                return self.emit(op, self.reg(), a[0], b[0]), "b"
            if e.op in _ARITH_OPS and kinds != ("b", "b"):
                return self.emit(op, self.reg(), a[0], b[0]), kind
            raise NotImplementedError(
                f"fused lowering: {e.op!r} on {kinds[0]} and {kinds[1]}")
        if isinstance(e, UnaryOp):
            v = self.expr(e.operand, env, stage)
            if e.op == "not":
                return self.emit("NOT", self.reg(), self.truth(v)[0]), "b"
            if e.op == "neg" and v[1] in ("i32", "f32"):
                op = "NEG_F32" if v[1] == "f32" else "NEG_I32"
                return self.emit(op, self.reg(), v[0]), v[1]
            raise NotImplementedError(f"fused lowering: {e.op!r} on {v[1]}")
        if isinstance(e, Year):
            v = self.expr(e.operand, env, stage)
            if v[1] != "i32":
                raise NotImplementedError(f"fused lowering: Year of {v[1]}")
            return self.emit("YEAR", self.reg(), v[0]), "i32"
        if isinstance(e, BytesMatch):
            src = self.bytes_column(e.operand, env, "BytesMatch")
            return self.emit("BYTESMATCH", self.reg(), self.slot(src),
                             self.pattern(e)), "b"
        if isinstance(e, PrefixCode):
            # the reference's decode in wrapping int32:
            # out = out * 10 + (byte - '0'), byte by byte
            src = self.bytes_column(e.operand, env, "PrefixCode")
            ten = self.const(10, "i32")[0]
            zero = self.const(ord("0"), "i32")[0]
            acc = self.const(0, "i32")[0]
            for i in range(e.n):
                digit = self.emit("SUB_I32", self.reg(),
                                  self.byte(src, i), zero)
                acc = self.emit("ADD_I32", self.reg(),
                                self.emit("MUL_I32", self.reg(), acc, ten),
                                digit)
            return acc, "i32"
        if isinstance(e, IsIn):
            v = self.expr(e.operand, env, stage)
            acc = self.const(0, "b")
            for val in e.values:
                # python scalars compare as the reference's weak types: a
                # float against an integer column compares in float32
                if isinstance(val, (bool, int, np.integer)) and v[1] != "f32":
                    lhs, rhs = v, self.literal(int(val), "i32")
                    op = "EQ_I32"
                elif isinstance(val, (bool, int, float, np.integer,
                                      np.floating)):
                    lhs, rhs = self.to_f32(v), self.literal(float(val), "f32")
                    op = "EQ_F32"
                else:
                    raise NotImplementedError(
                        f"fused lowering: IN value {val!r}")
                hit = self.emit(op, self.reg(), lhs[0], rhs[0])
                acc = self.emit("OR", self.reg(), acc[0], hit), "b"
            return acc
        raise NotImplementedError(
            f"fused lowering: no instruction for {type(e).__name__}")


def _param_kind(e: ParamRef) -> Optional[str]:
    name = e.dtype.name
    if name in ("float32", "float64"):
        return "f32"
    if name == "bool":
        return "b"
    if name in ("int32", "int64", "date32", "dict32"):
        return "i32"
    return None


def lower_stages(table: TorchTable, stages: Sequence[Stage],
                 probe_keys: Optional[Sequence[str]] = None,
                 pack=None, empty_key: int = -1,
                 batch: bool = False) -> Program:
    """Lower a run of FilterProject stages over ``table``'s columns into a
    program for the fused kernels (``lower_registers``, then
    ``assign_slots``). Raises ``NotImplementedError`` for any expression,
    dtype or size the kernels do not take."""
    return assign_slots(lower_registers(table, stages, probe_keys, pack,
                                        empty_key, batch))


def lower_split(table: TorchTable, stages: Sequence[Stage],
                probe_keys: Optional[Sequence[str]] = None,
                pack=None, empty_key: int = -1
                ) -> Tuple[Tuple[Tuple[Stage, ...], Program], ...]:
    """Lower a run of stages into consecutive programs, each within the
    kernel's limits: ``((stages, program), ...)``, run one launch each,
    the probe (if any) in the last. A run that fits is one program.

    One that does not is first cut into a stage a filter conjunct (a
    filter ANDs into the validity and nothing compacts, so the cut changes
    no result), then cut greedily: each program takes the longest run of
    the remaining stages that lowers. A filter that does not fit even
    alone, a disjunction (an ``IsIn`` of many values, an OR chain), is
    evaluated term by term into a bool column that each stage carries
    with the other columns (``_split_disjunction``), and filtered on at the
    end. Raises ``NotImplementedError`` when a node has no instruction,
    ``KernelLimitError`` when a stage still does not fit."""
    try:
        return ((tuple(stages), lower_stages(table, stages, probe_keys, pack,
                                             empty_key)),)
    except KernelLimitError:
        pass
    flat: List[Stage] = []
    for filter_expr, projections in stages:
        flat.extend((f, None) for f in _conjuncts(filter_expr))
        if projections is not None:
            flat.append((None, projections))
    runs, cur, i = [], table, 0
    while i < len(flat):
        program = None
        for j in range(len(flat), i, -1):
            try:
                program = lower_stages(
                    cur, flat[i:j], probe_keys if j == len(flat) else None,
                    pack, empty_key)
                break
            except KernelLimitError:
                if j > i + 1:
                    continue
                parts = _split_disjunction(cur, flat[i])
                if parts is None:
                    raise
                flat[i:i + 1] = parts
        if program is None:
            continue          # the stage at i was cut into smaller ones
        runs.append((tuple(flat[i:j]), program))
        cur, i = _shape_table(cur, program), j
    return tuple(runs)


def _conjuncts(e) -> List[object]:
    """The terms of a chain of ANDs (a filter of None has none)."""
    if e is None:
        return []
    if isinstance(e, BinaryOp) and e.op == "and":
        return _conjuncts(e.lhs) + _conjuncts(e.rhs)
    return [e]


def _disjuncts(e, chunk: int) -> List[object]:
    """The terms of a chain of ORs, an ``IsIn`` cut into ``IsIn``s of at
    most ``chunk`` values."""
    if isinstance(e, BinaryOp) and e.op == "or":
        return _disjuncts(e.lhs, chunk) + _disjuncts(e.rhs, chunk)
    if isinstance(e, IsIn) and len(e.values) > chunk:
        vals = tuple(e.values)
        return [IsIn(e.operand, vals[k:k + chunk])
                for k in range(0, len(vals), chunk)]
    return [e]


# the bool column a split disjunction accumulates into
_SPLIT_OR = "__split_or"


def _split_disjunction(table: TorchTable, stage: Stage):
    """A filter stage too large for one program, as stages that each fit:
    the first computes ``__split_or`` from the first term, each next one
    ORs one more term into it, and the last filters on it; each carries
    the table's columns through. The terms are as large as still lets
    every stage lower alone. None when the filter is no disjunction that
    such a cut makes fit."""
    filter_expr, projections = stage
    if filter_expr is None or projections is not None:
        return None
    carry = tuple((n, ColumnRef(n)) for n in table.column_names)
    acc = ColumnRef(_SPLIT_OR)
    with_acc = TorchTable(
        dict(table.columns, **{_SPLIT_OR: torch.empty(0, dtype=torch.bool)}),
        torch.empty(0, dtype=torch.bool),
        dict(table.schema, **{_SPLIT_OR: dt.BOOL}))
    chunk = max((len(t.values) for t in _disjuncts(filter_expr, 1 << 30)
                 if isinstance(t, IsIn)), default=1)
    while True:
        terms = _disjuncts(filter_expr, chunk)
        if len(terms) >= 2:
            stages = [(None, carry + ((_SPLIT_OR, terms[0]),))] + [
                (None, carry + ((_SPLIT_OR, BinaryOp("or", acc, t)),))
                for t in terms[1:]] + [(acc, carry)]
            try:
                lower_registers(table, stages[:1])
                for st in stages[1:]:
                    lower_registers(with_acc, [st])
                return stages
            except KernelLimitError:
                pass
        if chunk == 1:
            return None
        chunk = (chunk + 1) // 2


def _shape_table(table: TorchTable, program: Program) -> TorchTable:
    """A table of no rows with the columns ``program`` outputs (dtypes and
    row widths): what the next program of a split run lowers against."""
    alias = program.out_alias or (None,) * len(program.out_names)
    cols = {n: (table.columns[a][:0] if a is not None
                else torch.empty(0, dtype=d))
            for n, d, a in zip(program.out_names, program.out_dtypes, alias)}
    return TorchTable(cols, torch.empty(0, dtype=torch.bool),
                      dict(program.out_schema))


def lower_registers(table: TorchTable, stages: Sequence[Stage],
                    probe_keys: Optional[Sequence[str]] = None,
                    pack=None, empty_key: int = -1,
                    batch: bool = False) -> Program:
    """Lower a run of FilterProject stages over ``table``'s columns into a
    register program, one register a definition; with ``probe_keys`` the
    program ends in the probe of the key they make (packed by ``pack`` if
    set). With ``batch`` the program is for ``fused_batch_program``: each
    filter becomes a lane loop (``ParamRef``s read the lane's parameters)
    and outputs that pass an input column through unchanged alias it;
    without, only a bytes column passes through. Raises
    ``NotImplementedError`` for any expression or dtype the kernels do not
    take, ``KernelLimitError`` past their limits."""
    if batch and probe_keys is not None:
        raise ValueError("lower_stages: a batch program has no probe")
    lw = _Lowering(table, batch=batch)
    # env: column name -> (register, kind), or the name of the input
    # column it is, loaded on first use
    env: Dict[str, Union[str, Tuple[int, str]]] = {
        n: n for n in table.column_names}
    schema = dict(table.schema)
    for stage, (filter_expr, projections) in enumerate(stages):
        if filter_expr is not None and batch:
            lw.lane_filter(filter_expr, env, stage)
        elif filter_expr is not None:
            pred = lw.truth(lw.expr(filter_expr, env, stage))
            lw.emit("FILTER", 0, pred[0])
        if projections is not None:
            new_env, new_schema = {}, {}
            for out_name, e in projections:
                if (isinstance(e, ColumnRef) and _passes(table, env[e.name],
                                                         batch)):
                    # a pass-through: no load, the output aliases the input
                    new_env[out_name] = env[e.name]
                else:
                    new_env[out_name] = lw.expr(e, env, stage)
                new_schema[out_name] = e.out_dtype(schema)
            env, schema = new_env, new_schema
    if probe_keys is not None:
        key = _lower_probe_key(lw, env, probe_keys, pack, empty_key)
        lw.emit("PROBE", 0, key)
    out_names, out_dtypes, out_alias = [], [], []
    n_store = 0
    for name, v in env.items():
        # an input column passed through unchanged: the kernel stores
        # nothing, the output is the input tensor (as the plain version's
        # ColumnRef evaluates to it)
        alias = v if _passes(table, v, batch) else None
        if batch and alias is None and not isinstance(v, str):
            alias = lw.load_of.get(v[0])
        out_names.append(name)
        out_alias.append(alias)
        if alias is not None:
            out_dtypes.append(table.columns[alias].dtype)
            continue
        r, kind = lw.value(v)
        lw.emit("STORE8" if kind == "b" else "STORE32", n_store, r)
        n_store += 1
        out_dtypes.append(_KIND_DTYPE[kind])
    if n_store > LIMITS["kMaxCols"]:
        raise KernelLimitError("fused lowering: too many output columns")
    if len(lw.code) > LIMITS["kMaxInstr"]:
        raise KernelLimitError(
            f"fused lowering: {len(lw.code)} instructions, more than "
            f"{LIMITS['kMaxInstr']}")
    code = torch.tensor(lw.code, dtype=torch.int32).reshape(-1, 4)
    in_names = tuple(lw.in_slots)
    in_dtypes = tuple(table.columns[n].dtype for n in in_names)
    in_widths = tuple(table.columns[n].shape[1] if table.columns[n].dim() == 2
                      else 0 for n in in_names)
    n_params = max(lw.params, default=-1) + 1
    return Program(code, in_names, in_dtypes, in_widths, tuple(out_names),
                   tuple(out_dtypes), schema, lw.n_regs,
                   probe=probe_keys is not None, batch=batch,
                   param_dtypes=tuple(lw.params.get(i)
                                      for i in range(n_params)),
                   out_alias=tuple(out_alias), pool=bytes(lw.pool))


def _passes(table: TorchTable, v, batch: bool) -> bool:
    """Whether the env entry ``v`` is an input column that passes through
    to an output untouched: any input column in a batch program, a bytes
    column in another (the kernel never loads one whole)."""
    return isinstance(v, str) and (batch or table.columns[v].dim() == 2)


# -- slots and the tile kernels' plan ------------------------------------------

_ALU = frozenset(range(OPS["ADD_I32"], OPS["I32_TO_F32"] + 1)) | {
    OPS["YEAR"]}
_UNARY = frozenset(OPS[k] for k in ("NEG_I32", "NEG_F32", "NOT",
                                    "I32_TO_F32", "YEAR"))
_LOADS = frozenset((OPS["LOAD32"], OPS["LOAD8"]))
# instructions whose field a is a register (the ALU ops' b too)
_READS_A = frozenset((OPS["STORE32"], OPS["STORE8"], OPS["FILTER"],
                      OPS["PROBE"], OPS["LFILTER"])) | _ALU
# LOADB and BYTESMATCH read an input column from device memory: their
# fields a (the column) and b (the byte, or the pattern's pool offset) are
# no registers
_GLOBAL = frozenset((OPS["LOADB"], OPS["BYTESMATCH"]))
_DEFINES = _ALU | _LOADS | _GLOBAL | frozenset((OPS["CONST"], OPS["PARAM"]))


def _reads(op: int) -> Tuple[int, ...]:
    """The fields (2: a, 3: b) of an instruction that name registers."""
    if op in _ALU and op not in _UNARY:
        return (2, 3)
    return (2,) if op in _READS_A else ()


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """What the tile kernels run, laid out on the host (``assign_slots``).

    A CTA's dynamic shared memory holds, in order: the tile code
    (``16 * len(code)`` bytes), the pattern pool (``pool_bytes`` rounded
    up to 16), the computed vector slots (``comp_bytes``,
    4 KB a slot: ``[slot][kTileRows]`` uint32), ``stages`` load stages of
    ``stage_bytes`` each (the tile's validity at offset 0, 1 KB, then each
    loaded column at its offset: 1 KB a bool column, 4 KB a 32-bit one)
    and the uniform table (``lanes * n_uniform`` words). ``code`` is the
    program without its loads and uniform instructions, operands encoded
    as ``kind << kKindShift | offset`` (``operand``); ``uniform`` the
    CONST, PARAM and uniform ALU instructions, which the kernel evaluates
    once per CTA and lane into the uniform table; ``loads`` (column,
    width, offset) each loaded column's copy. ``packed`` is the int32
    array the kernels' entry points take: the header (its last word the
    pool's length), the tile and uniform code, the loads, then the pool in
    16-byte groups."""

    code: Tuple[Tuple[int, int, int, int], ...]
    uniform: Tuple[Tuple[int, int, int, int], ...]
    loads: Tuple[Tuple[int, int, int], ...]
    n_uniform: int
    stages: int
    stage_bytes: int
    comp_bytes: int
    packed: torch.Tensor
    pool_bytes: int = 0

    def smem_bytes(self, lanes: int = 1) -> int:
        """Dynamic shared memory of a CTA running ``lanes`` lanes."""
        return (16 * len(self.code) + _pool16(self.pool_bytes)
                + self.comp_bytes + self.stages * self.stage_bytes
                + 4 * lanes * self.n_uniform)


def _pool16(n: int) -> int:
    """The pool's bytes in shared memory: ``n`` rounded up to 16."""
    return -(-n // 16) * 16


def _dead_after(code) -> Dict[int, int]:
    """Register -> the index of the instruction after which it is dead:
    its last read, or the LFILTER of a lane loop whose body reads it when it
    was defined before the loop (the body runs once a lane)."""
    defined: Dict[int, int] = {}
    dead: Dict[int, int] = {}
    loop = None
    for k, row in enumerate(code):
        op = row[0]
        if op == OPS["LOOP"]:
            loop = (k, k + row[2])
        for f in _reads(op):
            r = row[f]
            outer = loop is not None and defined[r] < loop[0]
            dead[r] = max(dead.get(r, -1), loop[1] if outer else k)
        if op in _DEFINES:
            defined[row[1]] = k
        if op == OPS["LFILTER"]:
            loop = None
    return dead


def assign_slots(program: Program) -> Program:
    """Renumber a ``lower_registers`` program's registers into the tile
    kernels' slots and lay out their ``plan``.

    A register is uniform (one word for the whole tile) when its one
    definition is a CONST, a PARAM, or an ALU instruction whose operands
    are all uniform; every other register is a vector slot (one word a
    row). Uniform slots are numbered from ``kUniformBase``, vector slots
    from 0. A computed vector slot is reused once its register is dead
    (``_dead_after``; an instruction may write the slot of an operand it
    reads last), but a lane loop's body takes no slot freed before the
    loop and frees its own at its LFILTER: a body's slots are its own,
    and a kernel that skips the body leaves no other register stale.
    Loaded columns keep their slots (they live in the load stage). Raises
    ``NotImplementedError`` if the plan does not fit in a CTA's shared
    memory even with one load stage."""
    base = LIMITS["kUniformBase"]
    raw = program.code.tolist()
    dead = _dead_after(raw)
    slot: Dict[int, int] = {}
    computed = set()          # registers in computed vector slots
    free: List[int] = []      # computed slots free for reuse
    held: List[int] = []      # the free slots of before an open loop
    n_vec = n_uniform = 0
    code = []
    for k, row in enumerate(raw):
        op = row[0]
        fields = _reads(op)
        for r in {row[f] for f in fields}:
            if r in computed and dead[r] == k:
                free.append(slot[r])
        for f in fields:
            row[f] = slot[row[f]]
        if op in _UNARY:
            row[3] = 0
        if op == OPS["LOOP"]:
            held, free = free, []
        elif op == OPS["LFILTER"]:
            free = held + free
        if op in _DEFINES:
            if op in (OPS["CONST"], OPS["PARAM"]) or (
                    op in _ALU and all(row[f] >= base for f in fields)):
                s, n_uniform = base + n_uniform, n_uniform + 1
            elif op not in _LOADS and free:
                s = free.pop()
                computed.add(row[1])
            else:
                s, n_vec = n_vec, n_vec + 1
                if op not in _LOADS:
                    computed.add(row[1])
            slot[row[1]] = row[1] = s
        code.append(tuple(row))
    plan = _tile_plan(code, n_vec, n_uniform, program.batch, program.pool)
    return dataclasses.replace(
        program, code=torch.tensor(code, dtype=torch.int32).reshape(-1, 4),
        n_vec=n_vec, n_uniform=n_uniform, plan=plan)


def _tile_plan(code, n_vec: int, n_uniform: int, batch: bool,
               pool: bytes = b"") -> TilePlan:
    """The shared-memory layout and the encoded tile and uniform code of a
    slot-numbered program (``assign_slots``)."""
    base, shift = LIMITS["kUniformBase"], LIMITS["kKindShift"]
    rows = LIMITS["kTileRows"]
    width = {}          # loaded vector slot -> (column, bytes a row)
    for op, dst, a, _ in code:
        if op in _LOADS:
            width[dst] = (a, 4 if op == OPS["LOAD32"] else 1)
    # the stage: validity, then the bool columns, then the 32-bit ones, so
    # every offset is a multiple of 1 KB
    ring, off = {}, rows
    for w in (1, 4):
        for s in sorted(width):
            if width[s][1] == w:
                ring[s], off = off, off + rows * w
    stage_bytes = off
    comp = {s: 4 * rows * k for k, s in enumerate(
        s for s in range(n_vec) if s not in width)}
    comp_bytes = 4 * rows * len(comp)

    def operand(s: int) -> int:
        if s >= base:
            return (LIMITS["kKindUniform"] << shift) | (s - base)
        if s in comp:
            return (LIMITS["kKindComp"] << shift) | comp[s]
        kind = "kKindRing32" if width[s][1] == 4 else "kKindRing8"
        return (LIMITS[kind] << shift) | ring[s]

    tile, uniform, loop = [], [], None
    for op, dst, a, b in code:
        if op in _LOADS:
            continue
        if op in (OPS["CONST"], OPS["PARAM"]):
            uniform.append((op, dst - base, a, 0))
        elif op in _ALU and dst >= base:
            uniform.append((op, dst - base, a - base,
                            (a if op in _UNARY else b) - base))
        elif op in _ALU:
            tile.append((op, operand(dst), operand(a),
                         operand(a if op in _UNARY else b)))
        elif op in _GLOBAL:
            tile.append((op, operand(dst), a, b))
        elif op == OPS["LOOP"]:
            loop = len(tile)
            tile.append((op, 0, 0, 0))
        elif op == OPS["LFILTER"]:
            tile[loop] = (OPS["LOOP"], 0, len(tile) - loop, 0)
            tile.append((op, 0, operand(a), 0))
        else:   # STORE32, STORE8 (dst: the output), FILTER, PROBE
            tile.append((op, dst, operand(a), 0))
    loads = tuple((width[s][0], width[s][1], ring[s]) for s in sorted(
        ring, key=ring.get))
    lanes = LIMITS["kMaxLanes"] if batch else 1
    fixed = (16 * len(tile) + _pool16(len(pool)) + comp_bytes
             + 4 * lanes * n_uniform)
    stages = LIMITS["kStages"]
    if fixed + stages * stage_bytes > LIMITS["kMaxSmem"]:
        stages = 1
    if fixed + stage_bytes > LIMITS["kMaxSmem"]:
        raise KernelLimitError(
            f"fused lowering: {fixed + stage_bytes} bytes of shared memory, "
            f"more than {LIMITS['kMaxSmem']}")
    header = [len(tile), len(uniform), len(loads), n_uniform, stages,
              stage_bytes, comp_bytes, len(pool)]
    words = np.frombuffer(bytes(pool).ljust(_pool16(len(pool)), b"\0"),
                          dtype="<i4").tolist()
    flat = header + [x for r in tile + uniform for x in r] + [
        x for c, w, o in loads for x in (c, w, o, 0)] + words
    return TilePlan(tuple(tile), tuple(uniform), loads, n_uniform, stages,
                    stage_bytes, comp_bytes,
                    torch.tensor(flat, dtype=torch.int32), len(pool))


def _lower_probe_key(lw: _Lowering, env, probe_keys, pack,
                     empty_key: int) -> int:
    """Emit the probe key (``probe_key``'s arithmetic) from the post-stage
    registers; returns its register. The pack folds ``key * span + (c -
    lo)`` in wrapping int32 and then selects ``empty_key`` where a column
    is outside its window, as ``(key - empty) * ok + empty``: where every
    column is inside, no term wraps and the key equals the clipped one of
    ``relational.packed_key``."""
    regs = []
    for name in probe_keys:
        r, kind = lw.value(env[name])
        if kind != "i32":
            raise NotImplementedError(
                f"fused lowering: probe key {name!r} is not an integer "
                "column (a hashed key probes the sorted-key join, which "
                "does not fuse)")
        regs.append(r)
    if pack is None:
        if len(regs) != 1:
            raise NotImplementedError(
                "fused lowering: a multi-column key needs a pack")
        return regs[0]
    key = lw.const(0, "i32")[0]
    ok = lw.const(1, "b")[0]
    for r, (lo, span) in zip(regs, pack):
        lo_r = lw.const(lo, "i32")[0]
        inside = lw.emit("AND", lw.reg(),
                         lw.emit("GE_I32", lw.reg(), r, lo_r),
                         lw.emit("LE_I32", lw.reg(), r,
                                 lw.const(lo + span - 1, "i32")[0]))
        ok = lw.emit("AND", lw.reg(), ok, inside)
        scaled = lw.emit("MUL_I32", lw.reg(), key,
                         lw.const(span, "i32")[0])
        key = lw.emit("ADD_I32", lw.reg(), scaled,
                      lw.emit("SUB_I32", lw.reg(), r, lo_r))
    empty = lw.const(empty_key, "i32")[0]
    shifted = lw.emit("SUB_I32", lw.reg(), key, empty)
    return lw.emit("ADD_I32", lw.reg(),
                   lw.emit("MUL_I32", lw.reg(), shifted, ok), empty)


def program_work(program: Program, n: int, lanes: int = 0,
                 table_size: int = 0):
    """(operations, bytes) of one launch of ``program`` over ``n`` rows:
    the closed form in the module's docstring (``lanes`` for a batch
    launch, ``table_size`` for a probe)."""
    nbytes = sum(torch.empty((), dtype=d).element_size() * (w or 1)
                 for d, w in zip(program.in_dtypes, program.in_widths)) + 1
    alias = program.out_alias or (None,) * len(program.out_names)
    nbytes += sum(torch.empty((), dtype=d).element_size()
                  for d, a in zip(program.out_dtypes, alias) if a is None)
    rows = program.code.tolist()
    code = [r[0] for r in rows]
    if not lanes:
        ops = sum(1 for op in code if op >= OPS["FILTER"])
        nbytes = n * (nbytes + 1)
        if program.probe:
            ops += 8
            nbytes += 5 * n + min(8 * table_size, 64 * n)
        return n * ops, nbytes
    ops, pc = 0, 0
    while pc < len(code):
        if code[pc] == OPS["LOOP"]:
            body = rows[pc][2]
            ops += body * lanes
            pc += body + 1
            continue
        ops += 1
        pc += 1
    return n * ops, n * (nbytes + lanes)


def _report_morsel(table, stages, probe, program) -> None:
    """Report each launch of a ``fused_morsel_program`` call."""
    with kernel_ops.hidden_work():
        runs = [program] if program is not None else [
            p for _, p in lower_split(
                table, stages,
                probe_keys=None if probe is None else probe["probe_keys"],
                pack=None if probe is None else probe["pack"],
                empty_key=-1 if probe is None else probe["empty_key"])]
    size = 0 if probe is None else probe["tk"].shape[0]
    for i, part in enumerate(runs):
        last = i == len(runs) - 1
        name = ("fused_morsel_probe" if last and probe is not None
                else "fused_morsel_program")
        kernel_ops.report_work(name, *program_work(
            part, table.capacity, table_size=size if last else 0))


def fused_morsel_program(table: TorchTable, stages: Sequence[Stage],
                         probe: Optional[dict] = None,
                         program: Optional[Program] = None):
    """Run ``stages`` (and optionally a single-match hash probe) over
    ``table`` in one launch; returns ``(out_table, found, bidx)``.

    ``probe``, when given, is a dict with ``tk``/``tv`` (the join's table),
    ``probe_keys`` (post-stage column names), ``pack`` (composite-key
    windows or None), ``empty_key`` and ``max_probes``; ``found`` comes
    back masked by validity and by keys equal to ``empty_key``, ``bidx``
    raw (0 where no slot matched). Without a probe both are None.

    For a CUDA table this launches the fused kernel with ``program`` (or
    the stages lowered now by ``lower_split``, one launch a program); for
    a CPU table it runs ``apply_stages`` and ``apply_probe``.
    """
    kernel_ops.mark_kernel("fused")
    if kernel_ops.counting_work():
        _report_morsel(table, stages, probe, program)
        with kernel_ops.hidden_work():
            return fused_morsel_program(table, stages, probe, program)
    if not table.validity.is_cuda:
        out = apply_stages(table, stages)
        if probe is None:
            return out, None, None
        return (out,) + apply_probe(out, probe)
    if program is None:
        runs = lower_split(
            table, stages,
            probe_keys=None if probe is None else probe["probe_keys"],
            pack=None if probe is None else probe["pack"],
            empty_key=-1 if probe is None else probe["empty_key"])
        for _, part in runs[:-1]:
            table = _launch(part, table, None)[0]
        program = runs[-1][1]
    if program.probe != (probe is not None):
        raise ValueError("fused_morsel_program: the program and the call "
                         "disagree on the probe")
    return _launch(program, table, probe)


def _packed(program: Program, what: str) -> torch.Tensor:
    """The kernels' int32 plan of a program (``assign_slots``)."""
    if program.plan is None:
        raise ValueError(f"{what}: the program has no slots "
                         "(lower_stages, or assign_slots after "
                         "lower_registers)")
    return program.plan.packed


def _launch(program: Program, table: TorchTable, probe: Optional[dict]):
    dev = table.device
    n = table.capacity
    if table.validity.dtype != torch.bool or table.validity.dim() != 1:
        raise TypeError("fused_morsel_program: validity must be bool[n]")
    ins = []
    for name, dtype, width in zip(program.in_names, program.in_dtypes,
                                  program.in_widths):
        t = table.columns[name]
        shape = (n, width) if width else (n,)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"fused_morsel_program: column {name!r} is {t.dtype}"
                f"{tuple(t.shape)} on {t.device}; the program reads "
                f"{dtype}{list(shape)} on {dev}")
        ins.append(t.contiguous())
    alias = program.out_alias or (None,) * len(program.out_names)
    for name, a in zip(program.out_names, alias):
        if a is not None and a not in table.columns:
            raise ValueError(f"fused_morsel_program: output {name!r} passes "
                             f"through column {a!r}, which the table lacks")
    valid_in = table.validity.contiguous()
    outs = [torch.empty(n, dtype=d, device=dev)
            for d, a in zip(program.out_dtypes, alias) if a is None]
    valid_out = torch.empty(n, dtype=torch.bool, device=dev)
    found = bidx = None
    tk = tv = None
    table_size = max_probes = 0
    empty_key = -1
    if probe is not None:
        tk, tv = probe["tk"].contiguous(), probe["tv"].contiguous()
        table_size = tk.shape[0]
        for a in (tk, tv):
            if a.dtype != torch.int32 or a.device != dev or a.dim() != 1:
                raise TypeError("fused_morsel_program: the table must be "
                                f"int32[T] on {dev}")
        if tv.shape != tk.shape or table_size & (table_size - 1):
            raise ValueError("fused_morsel_program: the table's keys and "
                             "values must share one power-of-two size")
        max_probes = min(int(probe["max_probes"]), table_size)
        empty_key = int(probe["empty_key"])
        found = torch.empty(n, dtype=torch.bool, device=dev)
        bidx = torch.empty(n, dtype=torch.int32, device=dev)
    if n > 0:
        fn = build.function(_LIB, "fused_morsel_run", _ARGTYPES, device=dev)
        in_ptrs = (ctypes.c_uint64 * max(len(ins), 1))(
            *[t.data_ptr() for t in ins])
        in_widths = (ctypes.c_int * max(len(ins), 1))(*program.in_widths)
        out_ptrs = (ctypes.c_uint64 * max(len(outs), 1))(
            *[t.data_ptr() for t in outs])
        plan = _packed(program, "fused_morsel_program")

        def ptr(t):
            return None if t is None else t.data_ptr()

        rc = fn(plan.data_ptr(), plan.shape[0], in_ptrs, in_widths, len(ins),
                out_ptrs, len(outs), valid_in.data_ptr(),
                valid_out.data_ptr(), n, ptr(tk), ptr(tv), table_size,
                max_probes, empty_key, ptr(found), ptr(bidx),
                torch.cuda.current_stream(dev).cuda_stream)
        name = ("fused_morsel_probe" if probe is not None
                else "fused_morsel_program")
        build.check(_LIB, rc, name)
        kernel_ops.count_launch(name)
        count_instructions(name, program)
    it = iter(outs)
    cols = {name: (table.columns[a] if a is not None else next(it))
            for name, a in zip(program.out_names, alias)}
    out = TorchTable(cols, valid_out, dict(program.out_schema))
    return out, found, bidx


def count_instructions(kernel: str, program: Program) -> None:
    """One launch of ``kernel`` for each of YEAR and BYTESMATCH that
    ``program`` holds (``kernels.ops.instruction_launches``)."""
    ops = set(program.code[:, 0].tolist())
    for name in kernel_ops.INSTRUCTIONS:
        if OPS[name] in ops:
            kernel_ops.count_instruction_launch(kernel, name)


# ---------------------------------------------------------------------------
# inter-query batching: B member lanes over one morsel
# ---------------------------------------------------------------------------

def apply_batched_stages(table: TorchTable, stages: Sequence[Stage],
                         params: Tuple, n_members: int):
    """Evaluate the shared stage chain once plus one predicate lane per
    member -- the plain version of ``fused_batch_program``. Filters AND
    into per-member masks instead of narrowing the shared validity
    (``TorchTable.filter`` only touches validity and projections are
    validity-blind, so the shared table stays correct for every member);
    projections run once for all members. ``params`` holds one ``[B]``
    tensor per parameter slot; member ``b``'s ``ParamRef``s read element
    ``b`` of each. Returns ``(projected table, bool masks [B, capacity])``.
    """
    masks = [table.validity] * n_members
    cur = table
    for filter_expr, projections in stages:
        if filter_expr is not None:
            for b in range(n_members):
                with param_values(tuple(p[b] for p in params)):
                    m = filter_expr.evaluate(cur)
                masks[b] = masks[b] & m
        if projections is not None:
            cols, schema = {}, {}
            for out_name, e in projections:
                v = e.evaluate(cur)
                if v.dim() == 0:   # literal: broadcast to rows
                    v = v.expand(cur.capacity)
                cols[out_name] = v
                schema[out_name] = e.out_dtype(cur.schema)
            cur = TorchTable(cols, cur.validity, schema)
    return cur, torch.stack(masks)


def fused_batch_program(table: TorchTable, stages: Sequence[Stage],
                        params: Tuple, n_members: int,
                        program: Optional[Program] = None):
    """Run ``n_members`` stacked queries' predicate lanes plus their shared
    projections over one morsel in one launch; returns ``(out_table,
    masks bool[n_members, capacity])``. ``out_table``'s validity is the
    input's, and columns the stages pass through are the input tensors.

    ``stages`` are the batch program's (filters carry ``ParamRef``s);
    ``params`` is a tuple of ``[n_members]`` tensors, one per parameter
    slot, on the table's device. For a CUDA table this launches
    ``kernels/csrc/fused_batch.cu`` with ``program`` (or the stages lowered
    now with ``lower_stages(..., batch=True)``) once for each run of at most
    ``kMaxLanes`` (64) lanes, the kernel's lane word; for a CPU table it
    runs ``apply_batched_stages``. Any ``n_members >= 1`` is taken.
    """
    kernel_ops.mark_kernel("fused_batch")
    if kernel_ops.counting_work():
        with kernel_ops.hidden_work():
            lowered = program or lower_stages(table, stages, batch=True)
        width = LIMITS["kMaxLanes"]
        for lo in range(0, n_members, width):
            kernel_ops.report_work("fused_batch_program", *program_work(
                lowered, table.capacity, min(width, n_members - lo)))
        with kernel_ops.hidden_work():
            return fused_batch_program(table, stages, params, n_members,
                                       program)
    if not table.validity.is_cuda:
        return apply_batched_stages(table, stages, params, n_members)
    if program is None:
        program = lower_stages(table, stages, batch=True)
    if not program.batch:
        raise ValueError("fused_batch_program: the program is not a batch "
                         "program (lower_stages(..., batch=True))")
    return _launch_batch(program, table, params, n_members)


def _param_bits(program: Program, params: Tuple, n_members: int,
                dev: torch.device) -> Optional[torch.Tensor]:
    """The kernel's parameter array: int32[slots, B], slot-major; int32,
    date32 and bool values as int32, float32 values as their bits."""
    if len(params) < len(program.param_dtypes):
        raise ValueError(f"fused_batch_program: {len(params)} parameter "
                         f"slots, the program reads "
                         f"{len(program.param_dtypes)}")
    rows = []
    for slot, want in enumerate(program.param_dtypes):
        p = params[slot]
        if tuple(p.shape) != (n_members,) or p.device != dev:
            raise ValueError(
                f"fused_batch_program: parameter slot {slot} is "
                f"{tuple(p.shape)} on {p.device}; the call wants "
                f"[{n_members}] on {dev}")
        if want is not None and p.dtype != want:
            raise TypeError(f"fused_batch_program: parameter slot {slot} is "
                            f"{p.dtype}; the program reads {want}")
        rows.append(p.view(torch.int32) if p.dtype == torch.float32
                    else p.to(torch.int32))
    return torch.stack(rows).contiguous() if rows else None


def _launch_batch(program: Program, table: TorchTable, params: Tuple,
                  n_members: int):
    dev = table.device
    n = table.capacity
    if n_members < 1:
        raise ValueError(f"fused_batch_program: {n_members} lanes; it "
                         "takes at least one")
    if table.validity.dtype != torch.bool or table.validity.dim() != 1:
        raise TypeError("fused_batch_program: validity must be bool[n]")
    ins = []
    for name, dtype, width in zip(program.in_names, program.in_dtypes,
                                  program.in_widths):
        t = table.columns[name]
        shape = (n, width) if width else (n,)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"fused_batch_program: column {name!r} is {t.dtype}"
                f"{tuple(t.shape)} on {t.device}; the program reads "
                f"{dtype}{list(shape)} on {dev}")
        ins.append(t.contiguous())
    for name, alias in zip(program.out_names, program.out_alias):
        if alias is not None and alias not in table.columns:
            raise ValueError(f"fused_batch_program: output {name!r} passes "
                             f"through column {alias!r}, which the table "
                             "lacks")
    bits = _param_bits(program, params, n_members, dev)
    stored = [torch.empty(n, dtype=d, device=dev)
              for d, a in zip(program.out_dtypes, program.out_alias)
              if a is None]
    valid_in = table.validity.contiguous()
    masks = torch.empty((n_members, n), dtype=torch.bool, device=dev)
    if n > 0:
        fn = build.function(_BATCH_LIB, "fused_batch_run", _BATCH_ARGTYPES,
                            device=dev)
        in_ptrs = (ctypes.c_uint64 * max(len(ins), 1))(
            *[t.data_ptr() for t in ins])
        in_widths = (ctypes.c_int * max(len(ins), 1))(*program.in_widths)
        out_ptrs = (ctypes.c_uint64 * max(len(stored), 1))(
            *[t.data_ptr() for t in stored])
        plan = _packed(program, "fused_batch_program")
        stream = torch.cuda.current_stream(dev).cuda_stream
        # one launch per run of at most kMaxLanes lanes, each with its
        # slice of the parameters and its rows of the masks; every launch
        # computes the lane-invariant stored columns and writes the same
        # values, so any one of them leaves them right
        width = LIMITS["kMaxLanes"]
        for lo in range(0, n_members, width):
            lanes = min(width, n_members - lo)
            part = None if bits is None else \
                bits[:, lo:lo + lanes].contiguous()
            rc = fn(plan.data_ptr(), plan.shape[0], in_ptrs, in_widths,
                    len(ins), out_ptrs, len(stored),
                    None if part is None else part.data_ptr(),
                    len(program.param_dtypes), lanes, valid_in.data_ptr(),
                    masks[lo:lo + lanes].data_ptr(), n, stream)
            build.check(_BATCH_LIB, rc, "fused_batch_program")
            kernel_ops.count_launch("fused_batch_program")
            count_instructions("fused_batch_program", program)
    it = iter(stored)
    cols = {name: (table.columns[alias] if alias is not None else next(it))
            for name, alias in zip(program.out_names, program.out_alias)}
    return (TorchTable(cols, table.validity, dict(program.out_schema)),
            masks)
