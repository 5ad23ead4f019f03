"""Blocked flash attention (forward): the port of
``repro/kernels/flash_attention.py``, with the oracle's semantics from
``repro/kernels/ref.py``.

``flash_attention(q, k, v, causal)`` maps ``[B, H, S, D]`` query, key and
value tensors of one dtype (float32, bfloat16 or float16) to the softmax
attention output of the same shape and dtype. For a CUDA tensor it
launches the kernels in ``csrc/flash_attention.cu`` (its header says what
bounds them), which pick their own tiles, split a small grid over K on
their own (a second launch combines the splits; one call counts one
launch) and take ``D`` up to 256; for a CPU tensor it runs the plain
version. ``block_q`` and ``block_k`` are validated
as the reference validates them, so both devices refuse the same inputs,
and change nothing else: the result depends on them only through float
order.

Without blocks any ``S >= 1`` is taken, which the reference, whose
default blocks are 128, refuses where 128 does not divide S: the kernels
cover S with their own tiles, load the rows past S as zeros, write no row
past S and mask the keys past S to ``-1e30``, so a key past S weighs
nothing whether the call is causal or not (a zero-padded key would score
0 without the causal mask). The encoder's self-attention takes any number
of frames this way, and a causal prefill any prompt length.

Under ``launch.roofline.count_program`` a call reports ``4 B H S^2 D``
operations (half of them when ``causal``) and ``4 B H S D`` elements of
bytes (q, k and v read once, the output written once), the reckoning of
row 10's bound in ``PERF.md``; on ``meta`` it returns the output's shape
and computes nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ops

_LIB = "flash_attention"
# (q, k, v, o, bh, s, d, dtype, causal, scale, scratch, scratch_bytes,
# stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p]
# (bh, s, d, dtype) -> bytes of the split over K's partials
_SCRATCH_ARGTYPES = [ctypes.c_int] * 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
MAX_HEAD_DIM = 256   # the CUDA kernel's widest tile; the plain version takes any
# score entries the plain version materialises at a time (256 MiB of float32)
_SCORE_ENTRIES = 1 << 26
# the card checks' limit on ``scaled_error``, every dtype: twice the largest
# reading of the CUDA kernel on random inputs (0.061 at D = 1, where a
# row's one output can cancel; 0.021-0.036 at D >= 64) and under a fifth of
# the smallest reading of a planted fault (PERF.md)
SCALED_ERROR_TOL = 2.0 ** -3


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain version, ``ref.flash_attention``: scores ``q @ k^T`` in float32
    times ``D ** -0.5``, ``-inf`` above the diagonal when ``causal``, a
    softmax, the probabilities cast to ``q.dtype``, then ``@ v``. It works
    through the ``B * H`` heads and the query rows in pieces of at most
    ``2^26`` scores; each row's softmax is whole in its piece."""
    b, h, s, d = q.shape
    scale = d ** -0.5
    qf, kf, vf = (x.reshape(b * h, s, d) for x in (q, k, v))
    out = torch.empty_like(qf)
    heads = max(1, _SCORE_ENTRIES // max(s * s, 1))
    rows = max(1, min(s, _SCORE_ENTRIES // max(heads * s, 1)))
    cols = torch.arange(s, device=q.device)
    for h0 in range(0, b * h, heads):
        kt, vh = kf[h0:h0 + heads].transpose(1, 2), vf[h0:h0 + heads]
        for r0 in range(0, s, rows):
            scores = torch.matmul(qf[h0:h0 + heads, r0:r0 + rows],
                                  kt).float() * scale
            if causal:
                above = cols[None, :] > cols[r0:r0 + rows, None]
                scores = scores.masked_fill(above, float("-inf"))
            probs = torch.softmax(scores, dim=-1)
            out[h0:h0 + heads, r0:r0 + rows] = torch.matmul(
                probs.to(q.dtype), vh)
    return out.reshape(b, h, s, d)


def scaled_error(got: torch.Tensor, want: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> float:
    """How far an output ``got`` is from the plain version's ``want`` on the
    same inputs (``v`` the values), in units of each row's own size: the
    largest ``(|got - want| - ulp) / scale`` over the elements, or 0.
    ``ulp`` is the output dtype's spacing at ``want``, at most ``eps *
    max(|want|, tiny)`` of its ``finfo``, since the two outputs round
    separately. ``scale`` is the larger of the row's
    RMS and ``rms(v) / sqrt(n)``, the size of an average of the ``n`` values
    the row sees (its index + 1 when ``causal``, else ``S``); the second
    keeps the measure finite for a row near 0, as at ``D = 1``. A fixed
    absolute tolerance cannot do this: a row of a 32k causal head that sees
    most keys has outputs near 0.01, while row 0 copies a value row."""
    s = want.shape[-2]
    n = (torch.arange(1, s + 1, device=want.device, dtype=torch.float32)
         if causal else torch.full((s,), float(s), device=want.device))
    gotf, wantf = got.float(), want.float()
    floor = v.float().pow(2).mean().sqrt() / n.sqrt()
    scale = torch.maximum(wantf.pow(2).mean(-1), floor.square()).sqrt()
    fi = torch.finfo(want.dtype)
    excess = (gotf - wantf).abs() - fi.eps * wantf.abs().clamp_min(fi.tiny)
    return max(0.0, float((excess / scale[..., None]).max()))


def _validate(q, k, v, block_q, block_k) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k and v must be one [B, H, S, "
                         f"D] shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k and v must be one of "
                        f"float32, bfloat16 and float16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k and v on {q.device}, "
                         f"{k.device}, {v.device}")
    s = q.shape[2]
    if s < 1:
        raise ValueError("flash_attention: S = 0")
    if block_q is None and block_k is None:
        return
    bq = min(DEFAULT_BLOCK_Q if block_q is None else block_q, s)
    bk = min(DEFAULT_BLOCK_K if block_k is None else block_k, s)
    if bq < 1 or bk < 1 or s % bq or s % bk:
        raise ValueError(f"flash_attention: S = {s} must divide by the "
                         f"blocks ({bq}, {bk})")


def flash_attention_work(q, k, v, causal: bool = True, block_q=None,
                         block_k=None):
    """(operations, bytes) of one call: the closed form in the module's
    docstring."""
    b, h, s, d = q.shape
    flops = 4 * b * h * s * s * d // (2 if causal else 1)
    return flops, 4 * b * h * s * d * q.element_size()


@ops.reports("flash_attention", flash_attention_work)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """q, k, v: [B, H, S, D] of one dtype -> [B, H, S, D] of that dtype.
    Any ``S >= 1`` without blocks; with either block given, ``S`` must
    divide by both (128 where not given) after they are clipped to ``S``,
    as the reference requires."""
    _validate(q, k, v, block_q, block_k)
    if q.device.type == "meta":     # contiguous, as both versions return it
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal)
    b, h, s, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d}; the CUDA kernel "
                         f"takes at most {MAX_HEAD_DIM}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    dtype = _DTYPES[q.dtype]
    # float32 partials when the 16-bit kernel splits its CTAs over K
    nbytes = build.function(_LIB, "flash_attention_scratch_bytes",
                            _SCRATCH_ARGTYPES, ctypes.c_longlong,
                            device=q.device)(
                                b * h, s, d, dtype)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=q.device)
               if nbytes else None)
    fn = build.function(_LIB, "flash_attention_run", _ARGTYPES,
                        device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            s, d, dtype, int(bool(causal)), d ** -0.5,
            None if scratch is None else scratch.data_ptr(), nbytes,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(_LIB, rc, "flash_attention")
    ops.count_launch("flash_attention")
    return out
