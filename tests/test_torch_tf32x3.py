"""The float32 attention kernel's arithmetic (``attn_tf32x3_kernel`` in
``csrc/flash_attention.cu``), emulated in torch on the CPU, against the
reference's oracle and the port's plain version.

The kernel runs float32 attention on the tensor cores by 3xTF32: every
operand ``x`` of ``Q K^T`` and of ``P V`` is split once into TF32 parts,
``big = rna(x)`` and ``small = rna(x - big)`` (``cvt.rna.tf32.f32``:
10 mantissa bits, to nearest, ties away from zero), and every product is
``small * big + big * small + big * big`` in that order, accumulated in
float32 (``mma.sync m16n8k8`` with float32 accumulators; Q K^T keeps the
small products in accumulators of their own, added at the tile's end);
``small * small`` is left out. The emulation follows the kernel's tiles:
64 query rows, 32-key tiles up to the diagonal when causal, k-steps of 8
over the head dim and over the keys, the online softmax in the log2
domain with ``-1e30`` masks, and P V's keys in the kernel's order within
each step (``k = t`` is key ``2 t``, ``k = t + 4`` key ``2 t + 1``, so
that the score accumulator serves as P's A fragment). It must hold the
float32 tolerance of the reference's tests (2e-5), and one TF32 product
(``big * big`` alone) must miss it, so that the tolerance tells the two
apart.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref

from repro_torch.kernels.flash_attention import (SCALED_ERROR_TOL,
                                                 flash_attention_plain,
                                                 scaled_error)

ROWS, BK, STEP = 64, 32, 8
NEG_INF = -1e30
# k-step order of P V: position k reads key _PERM[k] of the 8-key step
_PERM = [0, 2, 4, 6, 1, 3, 5, 7]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the int32 view: add half of the 13 dropped
    bits' unit, then clear them (ties go away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mma(c, cs, a, b, products):
    """``(c, cs)`` plus ``a @ b`` for one k-step of 8, as the kernel issues
    it: ``3`` products (small * big and big * small into ``cs``, then big *
    big into ``c``; ``cs`` is ``None`` where the kernel adds them into
    ``c`` too) or ``1`` (big * big, one TF32 product)."""
    ab, as_ = split(a)
    bb, bs = split(b)
    if products == 3:
        small = (c if cs is None else cs) + as_ @ bb
        small = small + ab @ bs
        if cs is None:
            c = small
        else:
            cs = small
    return c + ab @ bb, cs


def emulate(q, k, v, causal, products=3):
    """The kernel's output for float32 ``[B, H, S, D]`` inputs (no split
    over K: a split only regroups the same sums)."""
    b, h, s, d = q.shape
    dp = -(-d // STEP) * STEP
    sp = -(-s // ROWS) * ROWS

    def pad(x):
        out = torch.zeros(b * h, sp, dp)
        out[:, :s, :d] = x.reshape(b * h, s, d)
        return out

    qf, kf, vf = pad(q), pad(k), pad(v)
    scale_log2 = torch.tensor(d ** -0.5, dtype=torch.float32) * \
        torch.tensor(math.log2(math.e), dtype=torch.float32)
    out = torch.zeros(b * h, sp, dp)
    cols = torch.arange(BK)
    for q0 in range(0, s, ROWS):
        qt = qf[:, q0:q0 + ROWS]
        rows = torch.arange(q0, q0 + ROWS)
        m = torch.full((b * h, ROWS), NEG_INF)
        l = torch.zeros(b * h, ROWS)
        acc = torch.zeros(b * h, ROWS, dp)
        last = ((min(q0 + ROWS, s) - 1) // BK + 1 if causal
                else -(-s // BK))
        for kt in range(last):
            k0 = kt * BK
            kb = torch.zeros(b * h, BK, dp)
            vb = torch.zeros(b * h, BK, dp)
            n = min(BK, sp - k0)
            kb[:, :n], vb[:, :n] = kf[:, k0:k0 + n], vf[:, k0:k0 + n]
            # Q K^T's small products in accumulators of their own
            sc = torch.zeros(b * h, ROWS, BK)
            sl = torch.zeros_like(sc)
            for kk in range(0, dp, STEP):
                sc, sl = mma(sc, sl, qt[..., kk:kk + STEP],
                             kb[..., kk:kk + STEP].transpose(1, 2), products)
            x = (sc + sl) * scale_log2
            col = k0 + cols
            dead = ((col[None, :] >= s)
                    | (causal & (col[None, :] > rows[:, None])))
            x = x.masked_fill(dead[None], NEG_INF)
            mn = torch.maximum(m, x.max(-1).values)
            alpha = torch.exp2(m - mn)
            p = torch.exp2(x - mn[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None]
            for j in range(0, BK, STEP):
                keys = [j + i for i in _PERM]
                acc, _ = mma(acc, None, p[..., keys], vb[:, keys], products)
            m = mn
        out[:, q0:q0 + ROWS] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out[:, :s, :d].reshape(b, h, s, d)


def _inputs(s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 2, s, d), dtype=np.float32)
            for _ in range(3)]


_CASES = [(s, d, causal) for s in (128, 256) for d in (64, 160, 192)
          for causal in (True, False)]


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10               # a TF32 value: kept
    half_up = 1.0 + 2.0 ** -11           # the tie above 1: away from zero
    below = 1.0 + 2.0 ** -11 - 2.0 ** -23
    x = torch.tensor([one, half_up, -half_up, below, 3.0], dtype=torch.float32)
    want = torch.tensor([one, one, -one, 1.0, 3.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    big, small = split(torch.tensor([math.pi], dtype=torch.float32))
    assert abs(float(big + small) - math.pi) < 2 ** -21 * math.pi


@pytest.mark.parametrize("s,d,causal", _CASES)
def test_3xtf32_matches_reference_and_plain(s, d, causal):
    host = _inputs(s, d, 7 * s + d + causal)
    q, k, v = (torch.from_numpy(a) for a in host)
    got = emulate(q, k, v, causal)
    want_ref = np.asarray(ref.flash_attention(*(jnp.asarray(a) for a in host),
                                              causal=causal))
    want = flash_attention_plain(q, k, v, causal)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=0, atol=2e-5)
    assert float((got - want).abs().max()) <= 2e-5
    assert scaled_error(got, want, v, causal) <= SCALED_ERROR_TOL


@pytest.mark.parametrize("d", [64, 160, 192])
def test_one_tf32_product_misses_the_tolerance(d):
    """``big * big`` alone (about 5e-4 relative an operand) is more than
    2e-5 from the plain version, so the float32 tolerance catches a kernel
    that drops the small parts."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(256, d, 3 + d))
    want = flash_attention_plain(q, k, v, True)
    three = float((emulate(q, k, v, True) - want).abs().max())
    one = float((emulate(q, k, v, True, products=1) - want).abs().max())
    assert three <= 2e-5 < one, (three, one)
