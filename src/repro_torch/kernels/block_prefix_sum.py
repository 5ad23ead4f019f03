"""Stream-compaction addresses: the port of
``repro/kernels/block_prefix_sum.py``.

``block_prefix_sum(mask)`` returns each row's exclusive prefix count of set
rows (int32[N]) and the total (a 0-d int32 tensor on the mask's device, not
synchronised). For a CUDA tensor it launches the one-pass decoupled
look-back scan in ``csrc/block_prefix_sum.cu`` (its header says what bounds
it); for a CPU tensor it runs the plain version, ``cumsum - mask``.

Under ``launch.roofline.count_program`` a call of N rows reports N
operations and ``5 N + 4`` bytes (the mask read once, the positions and
the total written once), the reckoning of row 5's bound in ``PERF.md``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ops

_LIB = "block_prefix_sum"
# (mask, n, pos, total, scratch, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_TILE_ROWS = 16384    # kTileRows in the source: one status word a tile


def block_prefix_sum_plain(mask: torch.Tensor):
    """Plain version: ``cumsum(mask) - mask`` and the last inclusive sum."""
    m = mask.to(torch.int32)
    incl = torch.cumsum(m, 0, dtype=torch.int32)
    total = (incl[-1] if m.numel() else
             torch.zeros((), dtype=torch.int32, device=m.device))
    return incl - m, total.reshape(())


def block_prefix_sum_work(mask):
    """(operations, bytes) of one call: the closed form in the module's
    docstring."""
    n = mask.shape[0]
    return n, 5 * n + 4


@ops.reports("block_prefix_sum", block_prefix_sum_work)
def block_prefix_sum(mask: torch.Tensor):
    """mask bool[N] -> (exclusive positions int32[N], total int32 0-d)."""
    ops.mark_kernel("compact")
    if not mask.is_cuda:
        return block_prefix_sum_plain(mask)
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise TypeError(f"block_prefix_sum: wants bool[N], got "
                        f"{mask.dtype}{tuple(mask.shape)}")
    n = mask.shape[0]
    if n > 2 ** 31 - 1:
        raise ValueError(f"block_prefix_sum: {n} rows is more than int32 "
                         "positions")
    dev = mask.device
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    mask = mask.contiguous()
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    # the tile counter, then one status word a tile (the C function
    # zeroes them)
    scratch = torch.empty(-(-n // _TILE_ROWS) + 1, dtype=torch.int64,
                          device=dev)
    fn = build.function(_LIB, "block_prefix_sum_run", _ARGTYPES, device=dev)
    rc = fn(mask.data_ptr(), n, pos.data_ptr(), total.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(_LIB, rc, "block_prefix_sum")
    ops.count_launch("block_prefix_sum")
    return pos, total
