"""Mamba-1 selective SSM block (jamba's token mixer): the port of
``repro/models/mamba.py``.

The reference nests ``lax.scan`` over chunks of ``CHUNK`` steps only to
bound memory and recompute in the backward; its arithmetic is the plain
recurrence ``h = exp(dt a) h + (dt x) B; y = h C`` in float32 on ``[B, DI,
N]``. No TPU kernel computes it, so the port runs it (``_selective_scan``)
as a Python loop over the steps of each chunk of ``CHUNK``: the chunk's
``exp(dt a)`` and ``(dt x) B`` are computed at once (``[B, CHUNK, DI,
N]``), each step is one ``addcmul``, and the chunk's outputs are one
product with C. The reference reshapes S into equal chunks and fails
where they do not divide it (S 129, S 200); the loop takes any S.

``softplus`` is ``F.softplus``, which returns x past 20 where the
reference's ``jax.nn.softplus`` is ``logaddexp(x, 0)``; they differ there
below float32's resolution.

Decode is the O(1) recurrent step on (conv window, ssm state). Its conv
is the forward's ``_conv`` at the window's last position, so decode rounds
as the forward does; the reference's decode sums the window by an einsum,
which rounds once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import DTYPE, _init

CHUNK = 64


def d_inner(cfg) -> int:
    return cfg.mamba_expand * cfg.d_model


def dt_rank(cfg) -> int:
    return math.ceil(cfg.d_model / 16)


def init_mamba(cfg, generator, device) -> dict:
    d, di, n, r = cfg.d_model, d_inner(cfg), cfg.mamba_d_state, dt_rank(cfg)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": _init((d, 2 * di), d, generator, device),
        "conv_w": _init((cfg.mamba_d_conv, di), cfg.mamba_d_conv, generator,
                        device),
        "conv_b": torch.zeros((di,), dtype=DTYPE, device=device),
        "x_proj": _init((di, r + 2 * n), di, generator, device),
        "dt_proj": _init((r, di), r, generator, device),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=device),
        "a_log": torch.log(a).expand(di, n).contiguous(),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": _init((di, d), di, generator, device),
    }


def _ssm_params(params, xc, cfg):
    """xc [..., DI] -> (dt [...,DI], B [...,N], C [...,N]) selective params,
    float32."""
    n, r = cfg.mamba_d_state, dt_rank(cfg)
    proj = xc @ params["x_proj"]
    dt = F.softplus((proj[..., :r] @ params["dt_proj"]).float()
                    + params["dt_bias"])
    b = proj[..., r: r + n].float()
    c = proj[..., r + n:].float()
    return dt, b, c


def _conv(params, x, cfg):
    """Causal depthwise conv over seq. x [B, S, DI]."""
    kw = cfg.mamba_d_conv
    pad = F.pad(x, (0, 0, kw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(kw):   # small static unroll (kw = 4)
        out = out + pad[:, i: i + x.shape[1], :] * params["conv_w"][i]
    return out + params["conv_b"]


def _read(h, c):
    """y = h C: h [..., DI, N], c [..., N] -> [..., DI] (float32)."""
    return (h * c[..., None, :]).sum(dim=-1)


def _selective_scan(dt, xc, bmat, cmat, a):
    """The recurrence over S, float32: dt, xc [B, S, DI], bmat, cmat [B,
    S, N], a [DI, N] -> (y = h C [B, S, DI], the final h [B, DI, N])."""
    bsz, s, di = xc.shape
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                    device=xc.device)
    ys = []
    for t0 in range(0, s, CHUNK):
        t1 = min(t0 + CHUNK, s)
        dtk = dt[:, t0:t1]
        da = torch.exp(dtk[..., None] * a)             # [B, c, DI, N]
        dbx = (dtk * xc[:, t0:t1])[..., None] * bmat[:, t0:t1, None, :]
        hs = []
        for t in range(t1 - t0):
            h = torch.addcmul(dbx[:, t], da[:, t], h)
            hs.append(h)
        ys.append(_read(torch.stack(hs, dim=1), cmat[:, t0:t1]))
    return torch.cat(ys, dim=1), h


def _scan(params, x, cfg):
    """The forward's pieces: (output [B, S, D], the pre-conv activations xr
    [B, S, DI], the final ssm state h [B, DI, N])."""
    xr, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    xc = F.silu(_conv(params, xr, cfg))
    dt, bmat, cmat = _ssm_params(params, xc, cfg)
    xc_f32 = xc.float()
    y, h = _selective_scan(dt, xc_f32, bmat, cmat,
                           -torch.exp(params["a_log"]))
    y = y + xc_f32 * params["d_skip"]
    y = y.to(DTYPE) * F.silu(z)
    return y @ params["out_proj"], xr, h


def mamba_forward(params, x, cfg):
    """Train/prefill: x [B, S, D] -> [B, S, D]."""
    return _scan(params, x, cfg)[0]


class MambaState(NamedTuple):
    conv: torch.Tensor   # [B, d_conv-1, DI] rolling conv window
    ssm: torch.Tensor    # [B, DI, N]


def init_mamba_state(cfg, batch: int, device) -> MambaState:
    di, n = d_inner(cfg), cfg.mamba_d_state
    return MambaState(
        torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=DTYPE,
                    device=device),
        torch.zeros((batch, di, n), dtype=torch.float32, device=device))


def mamba_decode(params, x, cfg, state: MambaState):
    """One-token step. x [B, 1, D] -> ([B, 1, D], new state)."""
    xr, z = (x @ params["in_proj"]).chunk(2, dim=-1)   # [B,1,DI]
    window = torch.cat([state.conv, xr], dim=1)        # [B, kw, DI]
    # the forward's conv at the window's last position: the same roundings
    xc = F.silu(_conv(params, window, cfg)[:, -1:])   # [B,1,DI]
    dt, bmat, cmat = _ssm_params(params, xc, cfg)
    a = -torch.exp(params["a_log"])
    da = torch.exp(dt[:, 0, :, None] * a)              # [B,DI,N]
    xc_f32 = xc[:, 0].float()
    h = da * state.ssm + (dt[:, 0] * xc_f32)[:, :, None] \
        * bmat[:, 0][:, None, :]
    y = _read(h, cmat[:, 0])
    y = y + xc_f32 * params["d_skip"]
    out = (y[:, None, :].to(DTYPE) * F.silu(z)) @ params["out_proj"]
    return out, MambaState(window[:, 1:], h)
