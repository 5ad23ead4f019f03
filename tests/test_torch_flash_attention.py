"""Flash attention in the PyTorch port against the JAX reference.

The same inputs, drawn with numpy from a seed, go through the reference's
Pallas kernel in interpret mode (``repro.kernels.flash_attention``), its
oracle (``repro.kernels.ref.flash_attention``) and the port's
``flash_attention`` on CPU tensors (the plain version): the reference's
test grid (``tests/test_kernels.py``), its block sweep through the port's
block validation, and the wider head dims of the repository's configs.

Tolerances: the reference's own, 2e-5 for float32 and 2e-2 for bfloat16,
and 2e-2 for float16, the CUDA kernel's third dtype (the scores and the
softmax run in float32 in every version; they differ in the order of the
sums and, in 16 bits, in where the scores round).
"""

import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as ref_flash

from repro_torch import kernels
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import (SCALED_ERROR_TOL,
                                                 flash_attention,
                                                 flash_attention_plain,
                                                 scaled_error)

_DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2),
           "float16": (jnp.float16, torch.float16, 2e-2)}


def _inputs(shape, dtype, seed):
    """q, k, v drawn from ``seed``: (jax arrays, torch CPU tensors)."""
    rng = np.random.default_rng(seed)
    host = [rng.normal(0, 1, shape).astype(np.float32) for _ in range(3)]
    jdt, tdt, _ = _DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in host],
            [torch.from_numpy(a).to(tdt) for a in host])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("b,h,s,d", [(1, 1, 128, 64), (2, 2, 256, 64),
                                     (1, 2, 256, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(b, h, s, d, dtype, causal):
    (jq, jk, jv), (q, k, v) = _inputs((b, h, s, d), dtype, 0)
    tol = _DTYPES[dtype][2]
    got = flash_attention(q, k, v, causal=causal)
    assert got.shape == q.shape and got.dtype == q.dtype
    _close(got, ref_flash(jq, jk, jv, causal=causal, block_q=128,
                          block_k=128, interpret=True), tol)
    _close(got, ref.flash_attention(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128),
                                   (256, 256)])
def test_flash_attention_block_shape_sweep(bq, bk):
    (jq, jk, jv), (q, k, v) = _inputs((1, 1, 256, 64), "float32", 1)
    want = ref.flash_attention(jq, jk, jv)
    _close(flash_attention(q, k, v, block_q=bq, block_k=bk), want, 2e-5)
    _close(flash_attention(q, k, v, block_q=bq, block_k=bk), ref_flash(
        jq, jk, jv, block_q=bq, block_k=bk, interpret=True), 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d", [160, 192])
def test_flash_attention_wide_head_dims(d, dtype):
    """pixtral_12b's and xlstm_125m's head dims (D = 160, 192)."""
    (jq, jk, jv), (q, k, v) = _inputs((1, 2, 128, d), dtype, d)
    tol = _DTYPES[dtype][2]
    got = flash_attention(q, k, v)
    _close(got, ref_flash(jq, jk, jv, interpret=True), tol)
    _close(got, ref.flash_attention(jq, jk, jv), tol)


def test_plain_version_in_pieces_equals_whole(monkeypatch):
    """The plain version works through heads and rows in pieces of at most
    ``_SCORE_ENTRIES`` scores: a piece of a few rows gives the whole-matrix
    result, causal and full."""
    # the module (the package's attribute of that name is the function)
    mod = importlib.import_module("repro_torch.kernels.flash_attention")
    _, (q, k, v) = _inputs((2, 3, 64, 32), "float32", 5)
    for causal in (True, False):
        whole = flash_attention_plain(q, k, v, causal)
        monkeypatch.setattr(mod, "_SCORE_ENTRIES", 64 * 5)
        pieces = flash_attention_plain(q, k, v, causal)
        monkeypatch.undo()
        torch.testing.assert_close(pieces, whole, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,bq,bk", [(192, 128, 128), (256, 96, 128),
                                     (256, 128, 48), (0, 128, 128)])
def test_flash_attention_rejects_non_dividing_blocks(s, bq, bk):
    q = torch.zeros((1, 1, s, 64))
    with pytest.raises(ValueError):
        flash_attention(q, q, q, block_q=bq, block_k=bk)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_flash_attention_rejects_other_dtypes(dtype):
    q = torch.zeros((1, 1, 128, 64), dtype=dtype)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)


def test_flash_attention_rejects_mixed_dtypes():
    q = torch.zeros((1, 1, 128, 64))
    with pytest.raises(TypeError):
        flash_attention(q, q, q.to(torch.bfloat16))


def test_flash_attention_rejects_mismatched_shapes():
    q = torch.zeros((1, 2, 128, 64))
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :1], q)
    with pytest.raises(ValueError):
        flash_attention(q[0], q[0], q[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_scaled_error_passes_rounding_and_catches_stale_values(dtype):
    """The card checks' error measure: 0 for outputs one unit in the last
    place apart; far above its limit when every row past 576 reads value
    rows 512-575 in place of its own later ones (a kernel that stops loading
    V tiles after tile 8 of 64 rows)."""
    _, (q, k, v) = _inputs((1, 2, 1024, 64), dtype, 9)
    want = flash_attention_plain(q, k, v)
    assert scaled_error(want, want, v, True) == 0
    # one unit up in magnitude: the bit pattern + 1 (sign and magnitude)
    bits = torch.int32 if want.dtype == torch.float32 else torch.int16
    bumped = (want.view(bits) + 1).view(want.dtype)
    assert bool((bumped != want).all())
    assert scaled_error(bumped, want, v, True) == 0
    stale = v.clone()
    stale[:, :, 576:] = v[:, :, 512:576].repeat(1, 1, 7, 1)
    bad = flash_attention_plain(q, k, stale)
    assert scaled_error(bad, want, v, True) > 8 * SCALED_ERROR_TOL


def test_ops_flash_attention_records_attention_kind():
    _, (q, k, v) = _inputs((1, 1, 128, 64), "float32", 2)
    counts = {}
    with ops.collect_dispatches(counts):
        out = ops.table_op(lambda a, b, c: ops.flash_attention(a, b, c))(
            q, k, v)
    assert counts == {"attention": 1}
    torch.testing.assert_close(out, flash_attention_plain(q, k, v),
                               rtol=0, atol=0)
    assert kernels.flash_attention is flash_attention


def test_flash_attention_kernel_is_registered():
    assert "flash_attention" in ops.KERNELS
    assert "flash_attention" in ops.launch_counts()
    src = build.sources()["flash_attention"]
    assert src == (Path(build.CSRC) / "flash_attention.cu")
    text = src.read_text()
    assert 'extern "C" int flash_attention_run(' in text
    assert 'extern "C" const char* flash_attention_error_string(' in text


def test_cpu_tensor_launches_nothing():
    _, (q, k, v) = _inputs((1, 1, 128, 64), "float32", 3)
    ops.reset_launch_counts()
    flash_attention(q, k, v)
    ops.flash_attention(q, k, v, causal=False)
    assert ops.launch_counts()["flash_attention"] == 0
