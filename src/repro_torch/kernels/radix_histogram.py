"""Radix histogram (the exchange's metadata phase): the port of
``repro/kernels/radix_histogram.py``.

``partition_histogram(key_cols_per_source, validity_per_source, W)`` is the
metadata phase of a repartition over W source tables in one pass: each
row's partition id (the reference's ``relational.partition_ids``, W for a
dead row) and the ``[W_src, W_dst]`` row counts. ``radix_histogram(pids,
P)`` counts the ids equal to each ``p`` in ``[0, P)`` as int32[P]; ids
outside that range, negatives too, are ignored. For CUDA tensors each
launches its kernel in ``csrc/radix_histogram.cu`` (its header says what
bounds them); for CPU tensors each runs its plain version: the
exchange's former torch code for the first, the reference's one-hot sum
(``repro/kernels/ref.py``) for the second.

Under ``launch.roofline.count_program`` ``radix_histogram`` of N ids
reports N operations and ``4 N + 4 P`` bytes (each id read once, the
counts written once: row 8s's bound in ``PERF.md``), and
``partition_histogram`` of sources of ``n_s`` rows and C key columns
reports ``10 C sum(n_s)`` operations and ``4 W^2 + sum(n_s) (5 + k)``
bytes, ``k`` the key bytes of a row as the kernel reads them (4 an int32
column, the row width a bytes column). Row 8's bound counts the key
sectors of the live rows alone, which a count on ``meta`` cannot see, so
the count is that bound with every row live.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ops

_LIB = "radix_histogram"
# (ids, n, num_bins, counts, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]
# (keys, strides, widths, num_cols, valid, n, num_sources, pids, counts,
#  stream): the per-source arrays are host arrays the launcher copies into
# the kernel's parameters
_PARTITION_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
_MAX_SOURCES = 8
_MAX_KEY_COLS = 16
_INT32_MAX = 2 ** 31 - 1
_ONE_HOT_ENTRIES = 1 << 24


def radix_histogram_plain(pids: torch.Tensor,
                          num_partitions: int) -> torch.Tensor:
    """Plain version: the one-hot ``[N, P]`` matrix of the ids, summed over
    the rows (an out-of-range id has an all-zero row), built ``2^24``
    entries at a time."""
    bins = torch.arange(num_partitions, dtype=pids.dtype, device=pids.device)
    counts = torch.zeros(num_partitions, dtype=torch.int32,
                         device=pids.device)
    step = max(1, _ONE_HOT_ENTRIES // num_partitions)
    for lo in range(0, pids.shape[0], step):
        counts += (pids[lo:lo + step, None] == bins).sum(0, dtype=torch.int32)
    return counts


def radix_histogram_work(pids, num_partitions):
    """(operations, bytes) of one call: the closed form in the module's
    docstring."""
    n = pids.shape[0]
    return n, 4 * n + 4 * num_partitions


@ops.reports("radix_histogram", radix_histogram_work)
def radix_histogram(pids: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """pids int32[N] -> counts int32[num_partitions]."""
    ops.mark_kernel("partition")
    if not pids.is_cuda:
        return radix_histogram_plain(pids, num_partitions)
    if pids.dtype != torch.int32 or pids.dim() != 1:
        raise TypeError(f"radix_histogram: wants int32[N], got "
                        f"{pids.dtype}{tuple(pids.shape)}")
    if not 0 < num_partitions <= _INT32_MAX:
        raise ValueError(f"radix_histogram: {num_partitions} partitions")
    dev = pids.device
    if pids.shape[0] == 0:
        return torch.zeros(num_partitions, dtype=torch.int32, device=dev)
    pids = pids.contiguous()
    counts = torch.empty(num_partitions, dtype=torch.int32, device=dev)
    fn = build.function(_LIB, "radix_histogram_run", _ARGTYPES, device=dev)
    rc = fn(pids.data_ptr(), pids.shape[0], num_partitions, counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(_LIB, rc, "radix_histogram")
    ops.count_launch("radix_histogram")
    return counts


def _int_keys(cols):
    """The key columns as the kernel reads them: a 1-D column of another
    dtype cast to int32, as the plain ``hash_combine`` casts it (one
    ``partition_cast`` dispatch a cast column)."""
    out = []
    for c in cols:
        if c.dim() == 1 and c.dtype != torch.int32:
            c = c.to(torch.int32)
            ops.count_dispatch("partition_cast")
        out.append(c)
    return out


def partition_histogram_plain(key_cols_per_source, validity_per_source,
                              num_partitions: int):
    """Plain version: each source's ``relational.partition_ids``, a dead
    row's id set to W, the bins ``source * W + id`` (dead rows in the
    dropped bin W * W) counted by ``radix_histogram_plain``."""
    from ..core import relational as rel
    w = num_partitions
    pids, bins = [], []
    for src, (cols, valid) in enumerate(zip(key_cols_per_source,
                                            validity_per_source)):
        pid = rel.partition_ids(list(cols), valid, w)
        pid = torch.where(valid, pid, torch.full_like(pid, w))
        pids.append(pid)
        bins.append(torch.where(pid < w, pid + src * w,
                                torch.full_like(pid, w * w)))
    counts = radix_histogram_plain(torch.cat(bins), w * w)
    return torch.cat(pids), counts.reshape(w, w)


def partition_histogram_work(key_cols_per_source, validity_per_source,
                             num_partitions):
    """(operations, bytes) of one call: the closed form in the module's
    docstring."""
    ops_, nbytes = 0, 4 * num_partitions ** 2
    for cols, v in zip(key_cols_per_source, validity_per_source):
        n = v.shape[0]
        ops_ += 10 * len(cols) * n
        nbytes += n * (5 + sum(4 if c.dim() == 1 else c.shape[1]
                               for c in cols))
    return ops_, nbytes


@ops.reports("radix_histogram", partition_histogram_work)
def partition_histogram(key_cols_per_source, validity_per_source,
                        num_partitions: int):
    """The metadata phase of a repartition over W = ``num_partitions``
    sources: ``key_cols_per_source[s]`` are source s's key columns (1-D, or
    2-D uint8 bytes columns), ``validity_per_source[s]`` its bool[n_s]
    validity -> ``(pids int32[sum n_s], counts int32[W, W])``: each row's
    destination (the reference's ``partition_ids``; W for a dead row), the
    sources' rows laid end to end, and the live rows of each (source,
    destination). A 1-D key column other than int32 is cast to int32
    first, as ``hash_combine`` casts it."""
    w = num_partitions
    if len(key_cols_per_source) != w or len(validity_per_source) != w:
        raise ValueError(f"partition_histogram: {len(key_cols_per_source)} "
                         f"key sets and {len(validity_per_source)} validities"
                         f" for {w} sources")
    keys = [_int_keys(cols) for cols in key_cols_per_source]
    if not validity_per_source[0].is_cuda:
        return partition_histogram_plain(keys, validity_per_source, w)
    ncols = len(keys[0])
    if not 1 <= w <= _MAX_SOURCES or not 1 <= ncols <= _MAX_KEY_COLS:
        raise ValueError(f"partition_histogram: {w} sources and {ncols} key "
                         f"columns; the kernel takes 1-{_MAX_SOURCES} and "
                         f"1-{_MAX_KEY_COLS}")
    dev = validity_per_source[0].device
    widths = [0 if c.dim() == 1 else c.shape[1] for c in keys[0]]
    # the tensors whose pointers the launch takes stay referenced here
    # until it is queued
    ptrs, strides, valid, n, keep = [], [], [], [], []
    for cols, v in zip(keys, validity_per_source):
        if v.dtype != torch.bool or v.dim() != 1 or v.device != dev:
            raise TypeError(f"partition_histogram: validity must be bool[n] "
                            f"on {dev}, got {v.dtype}{tuple(v.shape)} on "
                            f"{v.device}")
        if len(cols) != ncols:
            raise ValueError("partition_histogram: sources differ in their "
                             "key columns")
        for c, width in zip(cols, widths):
            shape_ok = (c.shape[0] == v.shape[0]
                        and (c.dim() == 1 if width == 0
                             else c.dim() == 2 and c.shape[1] == width))
            if c.device != dev or not shape_ok or (
                    width and c.dtype != torch.uint8):
                raise TypeError(f"partition_histogram: a key column of "
                                f"{c.dtype}{tuple(c.shape)} on {c.device} for "
                                f"{v.shape[0]} rows on {dev}")
        cols = [c if c.stride(-1) == 1 and (c.dim() == 1 or c.stride(0) > 0)
                else c.contiguous() for c in cols]
        v = v.contiguous()
        keep += cols + [v]
        ptrs += [c.data_ptr() for c in cols]
        strides += [c.stride(0) * c.element_size() for c in cols]
        valid.append(v.data_ptr())
        n.append(v.shape[0])
    pids = torch.empty(sum(n), dtype=torch.int32, device=dev)
    counts = torch.empty((w, w), dtype=torch.int32, device=dev)
    fn = build.function(_LIB, "partition_histogram_run", _PARTITION_ARGTYPES,
                        device=dev)
    rc = fn((ctypes.c_uint64 * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(strides))(*strides),
            (ctypes.c_int * ncols)(*widths), ncols,
            (ctypes.c_uint64 * w)(*valid), (ctypes.c_longlong * w)(*n), w,
            pids.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(_LIB, rc, "partition_histogram")
    ops.count_launch("radix_histogram")
    return pids, counts
