"""Radix histogram (the exchange's metadata phase): the port of
``repro/kernels/radix_histogram.py``.

``radix_histogram(pids, P)`` counts the ids equal to each ``p`` in
``[0, P)`` as int32[P]; ids outside that range, negatives too, are
ignored. For a CUDA tensor it launches the kernel in
``csrc/radix_histogram.cu`` (its header says what bounds it); for a CPU
tensor it runs the plain version, the reference's one-hot sum
(``repro/kernels/ref.py``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ops

_LIB = "radix_histogram"
# (ids, n, num_bins, counts, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]
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


def radix_histogram(pids: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """pids int32[N] -> counts int32[num_partitions]."""
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
    fn = build.function(_LIB, "radix_histogram_run", _ARGTYPES)
    rc = fn(pids.data_ptr(), pids.shape[0], num_partitions, counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(_LIB, rc, "radix_histogram")
    ops.count_launch("radix_histogram")
    return counts
