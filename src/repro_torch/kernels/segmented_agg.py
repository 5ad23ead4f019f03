"""Segmented sums: the port of ``repro/kernels/segmented_agg.py``.

``segmented_sum`` (float32) and ``segmented_int_sum`` (int32, wrapping at
2^31) sum ``values`` per group id; ids outside ``[0, num_groups)`` are
dropped. For a CUDA tensor each launches the kernel in
``csrc/segmented_agg.cu`` (its header says what bounds it and how it is
built); for a CPU tensor each runs its plain PyTorch version,
``index_add_`` into a ``num_groups + 1`` buffer whose last slot takes the
dropped rows. ``segmented_minmax`` comes with the slice whose queries need
it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ops

_LIB = "segmented_agg"
# (gids, values, n, num_groups, out, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


def segmented_sum_plain(gids: torch.Tensor, values: torch.Tensor,
                        num_groups: int) -> torch.Tensor:
    """Plain float32 version: ``zeros(G + 1).index_add_`` and a slice."""
    return _plain(gids, values.to(torch.float32), num_groups)


def segmented_int_sum_plain(gids: torch.Tensor, values: torch.Tensor,
                            num_groups: int) -> torch.Tensor:
    """Plain int32 version (wraps at 2^31 like the int32 reference)."""
    return _plain(gids, values.to(torch.int32), num_groups)


def _plain(gids, values, num_groups):
    seg = torch.where((gids >= 0) & (gids < num_groups), gids, num_groups)
    out = torch.zeros(num_groups + 1, dtype=values.dtype, device=values.device)
    out.index_add_(0, seg.long(), values)
    return out[:num_groups]


def segmented_sum(gids: torch.Tensor, values: torch.Tensor,
                  num_groups: int) -> torch.Tensor:
    """gids int32[N], values float32[N] -> float32[num_groups]."""
    if not gids.is_cuda:
        return segmented_sum_plain(gids, values, num_groups)
    return _launch("segmented_sum", "segmented_sum_f32", gids, values,
                   num_groups, torch.float32)


def segmented_int_sum(gids: torch.Tensor, values: torch.Tensor,
                      num_groups: int) -> torch.Tensor:
    """gids int32[N], values int32[N] -> int32[num_groups] (exact; overflow
    wraps like the int32 reference)."""
    if not gids.is_cuda:
        return segmented_int_sum_plain(gids, values, num_groups)
    return _launch("segmented_int_sum", "segmented_sum_i32", gids, values,
                   num_groups, torch.int32)


def _launch(name, symbol, gids, values, num_groups, dtype):
    if gids.dtype != torch.int32 or values.dtype != dtype:
        raise TypeError(f"{name}: wants int32 ids and {dtype} values, got "
                        f"{gids.dtype} and {values.dtype}")
    if gids.dim() != 1 or values.shape != gids.shape:
        raise ValueError(f"{name}: wants two 1-D tensors of one length, got "
                         f"{tuple(gids.shape)} and {tuple(values.shape)}")
    if values.device != gids.device:
        raise ValueError(f"{name}: ids on {gids.device}, values on "
                         f"{values.device}")
    if not (0 <= num_groups < 2 ** 31):
        raise ValueError(f"{name}: num_groups {num_groups} out of range")
    gids, values = gids.contiguous(), values.contiguous()
    out = torch.zeros(num_groups, dtype=dtype, device=gids.device)
    n = gids.numel()
    if n == 0 or num_groups == 0:
        return out
    fn = build.function(_LIB, symbol, _ARGTYPES)
    stream = torch.cuda.current_stream(gids.device).cuda_stream
    rc = fn(gids.data_ptr(), values.data_ptr(), n, num_groups, out.data_ptr(),
            stream)
    build.check(_LIB, rc, name)
    ops.count_launch(name)
    return out
