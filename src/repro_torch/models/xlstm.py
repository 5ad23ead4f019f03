"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory): the port
of ``repro/models/xlstm.py``, exponential gating with max-state
stabilization (arXiv:2405.04517).

Plain functions on tensors, as ``mamba.py``: no TPU kernel computes them
in the reference, whose ``lax.scan`` over chunks of ``CHUNK`` steps (under
``jax.checkpoint``, which only bounds its backward's memory) becomes a
Python loop. The dtypes and cast points are the reference's: q, k and v are
bfloat16 products cast to float32 (q and k scaled by ``dh ** -0.5``), the
gates float32 products of ``xr`` in float32 with float32 ``gate_i`` and
``gate_f``, the recurrences float32, and ``h`` cast to bfloat16 before
``h * silu(z)``; sLSTM runs wholly in float32. A stabilizer state ``m``
starts at ``-1e30``, where ``exp(m + b - m_new)`` is an exact 0.

The reference refuses some lengths: its chunkwise mLSTM asserts that 64
divides S once S > 64, and its sLSTM reshapes S into equal chunks of about
64 steps. Here both take any S: the chunkwise form runs chunks of
``CHUNK`` and a last partial chunk, and sLSTM's steps are one loop.

``_mlstm_chunkwise`` masks the decay matrix's entries above the diagonal
to ``-inf`` before ``exp``, where the reference zeroes them after it: the
same values, and an exponential that overflows above the diagonal cannot
make a NaN gradient. sLSTM's input projection ``x @ wx + bias`` does not
depend on the state, so it is one product over all S steps ahead of the
loop (``_slstm_scan``), where the reference computes it step by step.

Decode is ``mlstm_forward`` / ``slstm_forward`` at S = 1, the O(1)
recurrent step on the state the prefill handed over.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import DTYPE, _init

CHUNK = 64


def d_inner(cfg) -> int:
    return cfg.mamba_expand * cfg.d_model      # projection factor 2


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(cfg, generator, device) -> dict:
    d, di, nh = cfg.d_model, d_inner(cfg), cfg.n_heads
    return {
        "up_proj": _init((d, 2 * di), d, generator, device),
        "wq": _init((di, di), di, generator, device),
        "wk": _init((di, di), di, generator, device),
        "wv": _init((di, di), di, generator, device),
        "gate_i": _init((di, nh), di, generator, device).float(),
        "gate_f": _init((di, nh), di, generator, device).float(),
        "down_proj": _init((di, d), di, generator, device),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor   # [B, NH, DH, DH]
    n: torch.Tensor   # [B, NH, DH]
    m: torch.Tensor   # [B, NH]


def init_mlstm_state(cfg, batch: int, device) -> MLSTMState:
    nh = cfg.n_heads
    dh = d_inner(cfg) // nh
    f32 = torch.float32
    return MLSTMState(
        torch.zeros((batch, nh, dh, dh), dtype=f32, device=device),
        torch.zeros((batch, nh, dh), dtype=f32, device=device),
        torch.full((batch, nh), -1e30, dtype=f32, device=device))


def _mlstm_step(state: MLSTMState, qkvif):
    """One step: q, k, v [B, NH, DH] and the gates ig, fg [B, NH] ->
    (the new state, h [B, NH, DH])."""
    q, k, v, ig, fg = qkvif
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + state.m, ig)
    i_p = torch.exp(ig - m_new)[..., None]
    f_p = torch.exp(logf + state.m - m_new)[..., None]
    c = f_p[..., None] * state.c + i_p[..., None] * (k[..., :, None]
                                                     * v[..., None, :])
    n = f_p * state.n + i_p * k
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                          torch.exp(-m_new))[..., None]
    h = torch.einsum("bhde,bhd->bhe", c, q) / denom
    return MLSTMState(c, n, m_new), h


# 'recurrent' streams the matrix state through every token; 'chunkwise'
# runs a chunk's contribution as a masked decay-weighted q @ k^T product,
# the [DH, DH] state crossing only the chunk boundaries
MLSTM_MODE = "chunkwise"          # chunkwise | recurrent


def mlstm_forward(params, x, cfg, state: MLSTMState = None,
                  mode: str = None):
    """x [B, S, D] -> [B, S, D] (and the final state if one was passed)."""
    b, s, _ = x.shape
    di, nh = d_inner(cfg), cfg.n_heads
    dh = di // nh
    xr, z = (x @ params["up_proj"]).chunk(2, dim=-1)
    q = (xr @ params["wq"]).reshape(b, s, nh, dh).float() * dh ** -0.5
    k = (xr @ params["wk"]).reshape(b, s, nh, dh).float() * dh ** -0.5
    v = (xr @ params["wv"]).reshape(b, s, nh, dh).float()
    xf = xr.float()
    ig = xf @ params["gate_i"]                         # [B, S, NH]
    fg = xf @ params["gate_f"]

    s0 = state if state is not None else init_mlstm_state(cfg, b, x.device)
    mode = mode or MLSTM_MODE
    if mode == "chunkwise" and s > 1:
        s1, h = _mlstm_chunkwise(q, k, v, ig, fg, s0)
    else:
        s1, h = _mlstm_recurrent(q, k, v, ig, fg, s0)
    h = h.reshape(b, s, di).to(DTYPE)
    out = (h * F.silu(z)) @ params["down_proj"]
    return (out, s1) if state is not None else out


def _mlstm_recurrent(q, k, v, ig, fg, s0: MLSTMState):
    """The recurrence step by step: q, k, v [B, S, NH, DH], ig, fg [B, S,
    NH] -> (the final state, h [B, S, NH, DH])."""
    st, hs = s0, []
    for t in range(q.shape[1]):
        st, h = _mlstm_step(st, (q[:, t], k[:, t], v[:, t], ig[:, t],
                                 fg[:, t]))
        hs.append(h)
    return st, torch.stack(hs, dim=1)


def _mlstm_chunkwise(q, k, v, ig, fg, s0: MLSTMState):
    """Stabilized chunkwise-parallel mLSTM over chunks of ``CHUNK`` steps
    (a last partial chunk where CHUNK does not divide S). Within a chunk,
    with b_t = cumsum(log f) and chunk-entry state (C0, n0, m0):

        m_t   = max(m0 + b_t, max_{s<=t}(b_t - b_s + i_s))
        num_t = sum_{s<=t} e^{b_t-b_s+i_s-m_t} (q_t.k_s) v_s
                + e^{m0+b_t-m_t} q_t @ C0
        den_t = sum_{s<=t} e^{b_t-b_s+i_s-m_t} (q_t.k_s)
                + e^{m0+b_t-m_t} q_t.n0
        h_t   = num_t / max(|den_t|, e^{-m_t})

    and the chunk-exit state is the same expansion at the chunk's end.
    Same arguments and result as ``_mlstm_recurrent``."""
    b, s, nh, dh = q.shape
    c0, n0, m0 = s0
    hs = []
    for t0 in range(0, s, CHUNK):
        t1 = min(t0 + CHUNK, s)
        # [B, NH, L, ...]
        qk, kk, vk = (a[:, t0:t1].transpose(1, 2) for a in (q, k, v))
        ik, fk = (a[:, t0:t1].transpose(1, 2) for a in (ig, fg))
        (c0, n0, m0), h = _mlstm_chunk(c0, n0, m0, qk, kk, vk, ik, fk)
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2)          # [B, S, NH, DH]
    return MLSTMState(c0, n0, m0), h


def _mlstm_chunk(c0, n0, m0, qk, kk, vk, ik, fk):
    """One chunk of L steps: the entry state, q, k, v [B, NH, L, DH] and
    the gates [B, NH, L] -> (the exit state, h [B, NH, L, DH])."""
    L = qk.shape[2]
    lf = F.logsigmoid(fk)
    bcum = torch.cumsum(lf, dim=-1)                            # b_t
    # running max over s <= t of (b_t - b_s + i_s) = b_t + cummax(i_s - b_s)
    run = bcum + torch.cummax(ik - bcum, dim=-1).values
    m = torch.maximum(m0[..., None] + bcum, run)               # [B,NH,L]
    # decay matrix W[t, s] = exp(b_t - b_s + i_s - m_t), s <= t
    expo = (bcum[..., :, None] - bcum[..., None, :]
            + ik[..., None, :] - m[..., :, None])              # [B,NH,L,L]
    above = torch.ones((L, L), dtype=torch.bool,
                       device=qk.device).triu(1)
    w = torch.exp(expo.masked_fill(above, float("-inf")))
    gw = (qk @ kk.transpose(-1, -2)) * w
    inter = torch.exp(m0[..., None] + bcum - m)                # [B,NH,L]
    num = gw @ vk + inter[..., None] * (qk @ c0)
    den = gw.sum(dim=-1) + inter * (qk @ n0[..., None])[..., 0]
    h = num / torch.maximum(den.abs(), torch.exp(-m))[..., None]

    # the chunk-exit state: the expansion at t = L
    b_l = bcum[..., -1]                                        # [B,NH]
    m_exit = torch.maximum(m0 + b_l,
                           (b_l[..., None] - bcum + ik).amax(dim=-1))
    wexit = torch.exp(b_l[..., None] - bcum + ik - m_exit[..., None])
    decay = torch.exp(m0 + b_l - m_exit)
    kw = kk * wexit[..., None]                                 # [B,NH,L,DH]
    c1 = decay[..., None, None] * c0 + kw.transpose(-1, -2) @ vk
    n1 = decay[..., None] * n0 + kw.sum(dim=2)
    return (c1, n1, m_exit), h


def mlstm_decode(params, x, cfg, state: MLSTMState):
    return mlstm_forward(params, x, cfg, state)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(cfg, generator, device) -> dict:
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    return {
        "wx": _init((d, 4 * d), d, generator, device).float(),
        "rh": _init((nh, dh, 4 * dh), dh, generator, device).float(),
        "bias": torch.zeros((4 * d,), dtype=torch.float32, device=device),
    }


class SLSTMState(NamedTuple):
    h: torch.Tensor   # [B, NH, DH]
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


def init_slstm_state(cfg, batch: int, device) -> SLSTMState:
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    z = torch.zeros((batch, nh, dh), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z + 1e-6, torch.full_like(z, -1e30))


def _slstm_cell(params, state: SLSTMState, pre_x):
    """One step from the step's input projection ``pre_x = x_t @ wx +
    bias`` [B, NH, 4 DH] -> (the new state, h [B, NH, DH])."""
    pre = pre_x + torch.einsum("bhd,hde->bhe", state.h, params["rh"])
    zg, ig, fg, og = pre.chunk(4, dim=-1)
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + state.m, ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(logf + state.m - m_new)
    c = f_p * state.c + i_p * torch.tanh(zg)
    n = f_p * state.n + i_p
    h = torch.sigmoid(og) * c / torch.clamp(n, min=1e-6)
    return SLSTMState(h, c, n, m_new), h


def _slstm_step(params, cfg, state: SLSTMState, xt):
    """xt [B, D] float32 -> (the new state, h [B, NH, DH]): the
    reference's step, its input projection included."""
    nh = cfg.n_heads
    pre_x = (xt @ params["wx"] + params["bias"]).reshape(
        xt.shape[0], nh, -1)
    return _slstm_cell(params, state, pre_x)


def _slstm_scan(params, pre_x, s0: SLSTMState):
    """The loop over S steps: pre_x [B, S, NH, 4 DH] -> (the final state,
    h [B, S, NH, DH])."""
    st, hs = s0, []
    for t in range(pre_x.shape[1]):
        st, h = _slstm_cell(params, st, pre_x[:, t])
        hs.append(h)
    return st, torch.stack(hs, dim=1)


def slstm_forward(params, x, cfg, state: SLSTMState = None):
    """x [B, S, D] -> [B, S, D] in bfloat16 (and the final state if one was
    passed)."""
    b, s, d = x.shape
    s0 = state if state is not None else init_slstm_state(cfg, b, x.device)
    pre_x = (x.float() @ params["wx"] + params["bias"]).reshape(
        b, s, cfg.n_heads, -1)
    s1, h = _slstm_scan(params, pre_x, s0)
    out = h.reshape(b, s, d).to(DTYPE)
    return (out, s1) if state is not None else out


def slstm_decode(params, x, cfg, state: SLSTMState):
    return slstm_forward(params, x, cfg, state)
