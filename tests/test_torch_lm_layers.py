"""The port's LM layers (``repro_torch.models.layers`` / ``attention``),
configs and specs against the reference ``repro.models`` on the CPU: the
same numpy inputs through both, with the tolerances stated beside each
check. Prefill attention runs through ``kernels.ops.flash_attention``
(its plain version on the CPU) and equals the reference's inline softmax
attention bit for bit at qwen2's SMOKE config."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import blocks as rblocks  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_plain  # noqa: E402
from repro_torch.models import attention, blocks, layers, model  # noqa: E402

DENSE = ("qwen2_1_5b", "phi4_mini_3_8b", "granite_3_8b", "granite_34b",
         "pixtral_12b")
PORTED = DENSE + ("dbrx_132b", "deepseek_moe_16b", "jamba_v0_1_52b",
                  "xlstm_125m", "seamless_m4t_large_v2")
# one bfloat16 ulp, relative
BF16_RTOL = 2.0 ** -7


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _pair(arr, dtype):
    """(jax array, torch tensor) of one float32 numpy array, in ``dtype``
    ("float32" or "bfloat16")."""
    return (jnp.asarray(arr, getattr(jnp, dtype)),
            torch.from_numpy(arr).to(getattr(torch, dtype)))


# -- layers ------------------------------------------------------------------

def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 5, 64)).astype(np.float32)
    scale = rng.normal(1, 0.2, (64,)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        rx, tx = _pair(x, dtype)
        want = rlayers.rms_norm(rx, jnp.asarray(scale), 1e-5)
        got = layers.rms_norm(tx, torch.from_numpy(scale), 1e-5)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL
                                   if dtype == "bfloat16" else 1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_past_zero_matches_reference(dtype):
    """Interleaved pairs at positions 0..4096 (rope theta 1e6 and 1e4)."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4097, (2, 7), dtype=np.int32)
    pos[0, 0] = 0
    for theta in (1e6, 1e4):
        rx, tx = _pair(x, dtype)
        want = rlayers.apply_rope(rx, jnp.asarray(pos), theta)
        got = layers.apply_rope(tx, torch.from_numpy(pos), theta)
        np.testing.assert_allclose(
            _np(got), _np(want), atol=2e-5 if dtype == "float32" else 1e-2,
            rtol=BF16_RTOL if dtype == "bfloat16" else 1e-5)
    assert np.array_equal(layers.rope_freqs(16, 1e6),
                          rlayers.rope_freqs(16, 1e6))


@pytest.mark.parametrize("gelu", [False, True], ids=["swiglu", "gelu_tanh"])
def test_mlp_matches_reference(gelu):
    """SwiGLU (w1, w3, w2) and the 2-matrix tanh-GeLU of granite-34b, in
    bfloat16; rtol = atol = 2e-2."""
    params = rlayers.init_mlp(jax.random.key(3), 64, 96, gelu)
    tparams = {k: torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
               for k, v in params.items()}
    x = np.random.default_rng(2).normal(0, 1, (2, 9, 64)).astype(np.float32)
    rx, tx = _pair(x, "bfloat16")
    want = _np(rlayers.mlp(params, rx))
    got = _np(layers.mlp(tparams, tx))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    if gelu:   # torch's default (erf) GeLU is not the reference's
        erf = torch.nn.functional.gelu(tx @ tparams["w1"]) @ tparams["w2"]
        assert not np.array_equal(_np(erf), got)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (2, 6, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 6), dtype=np.int32)
    mask = (rng.random((2, 6)) > 0.4).astype(np.float32) if masked else None
    want = rlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- prefill attention through the kernel's entry point ----------------------

def _reference_prefill_attention(q, k, v, cfg):
    """The reference's inline prefill attention (``blocks.apply_prefill``),
    before ``@ wo``: [B, S, H * dh]."""
    b, s = q.shape[:2]
    scores = rattn._gqa_scores(q, k, cfg).astype(jnp.float32)
    maskv = jnp.tril(jnp.ones((s, s), dtype=bool))
    scores = jnp.where(maskv[None, None, None], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    ctx = jnp.einsum("bkgst,btkd->bskgd", probs, v)
    return ctx.reshape(b, s, -1)


def _qkv_inputs(arch, s, seed=0):
    """The reference's q, k, v of one attention layer (qwen2's SMOKE
    config, B 2) over a random hidden state, and their torch copies."""
    cfg = rconfigs.get_config(arch, smoke=True)
    p = rattn.init_attention(jax.random.key(1), cfg)
    x = np.random.default_rng(seed).normal(0, 1, (2, s, cfg.d_model))
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (2, s))
    q, k, v = rattn._qkv(p, jnp.asarray(x, jnp.bfloat16), cfg, pos)
    return cfg, (q, k, v), [torch.from_numpy(np.asarray(t, np.float32))
                            .bfloat16() for t in (q, k, v)]


def test_prefill_attention_bit_exact_at_qwen2_smoke():
    """Through ``ops.flash_attention`` with the KV heads expanded by
    ``repeat_interleave``: equal to the reference bit for bit (B 2, S 64).
    Tiling the heads (``repeat``) pairs query heads with the wrong KV
    heads, and this check sees it."""
    cfg, (q, k, v), (tq, tk, tv) = _qkv_inputs("qwen2_1_5b", 64)
    want = _np(_reference_prefill_attention(q, k, v, cfg))
    tcfg = configs.get_config("qwen2_1_5b", smoke=True)
    ops.reset_launch_counts()
    got = attention.self_attention(tq, tk, tv, tcfg)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got), want)
    g = cfg.n_heads // cfg.n_kv
    tiled = flash_attention_plain(
        tq.transpose(1, 2), tk.transpose(1, 2).repeat(1, g, 1, 1),
        tv.transpose(1, 2).repeat(1, g, 1, 1)).transpose(1, 2)
    assert np.abs(_np(tiled.reshape(got.shape)) - want).max() > 0.5


def test_prefill_attention_padding_path_s200():
    """S = 200 does not divide by 128: the attention takes it as it is,
    with no padded rows (the kernel masks the keys past S). Float32
    inputs: within 1e-6 of the plain version at S 200; bfloat16: within
    one ulp of it and within 2e-2 of the reference."""
    cfg, (q, k, v), (tq, tk, tv) = _qkv_inputs("qwen2_1_5b", 200, seed=5)
    tcfg = configs.get_config("qwen2_1_5b", smoke=True)
    g = cfg.n_heads // cfg.n_kv
    for dtype, atol in ((torch.float32, 1e-6), (torch.bfloat16, 0.0)):
        xq, xk, xv = (t.to(dtype) for t in (tq, tk, tv))
        got = attention.self_attention(xq, xk, xv, tcfg)
        plain = flash_attention_plain(
            xq.transpose(1, 2), xk.transpose(1, 2).repeat_interleave(g, 1),
            xv.transpose(1, 2).repeat_interleave(g, 1)).transpose(1, 2)
        np.testing.assert_allclose(
            _np(got), _np(plain.reshape(got.shape)), atol=atol,
            rtol=BF16_RTOL if dtype == torch.bfloat16 else 1e-6)
    want = _np(_reference_prefill_attention(q, k, v, cfg))
    np.testing.assert_allclose(_np(got), want, rtol=2e-2, atol=2e-2)


def test_decode_attention_matches_reference_mask():
    """One decode step at pos 37 of a 64-slot cache: the slice to pos + 1
    against the reference's whole-cache mask; the cache is written in
    place at pos. bfloat16, rtol = atol = 2e-2."""
    cfg = rconfigs.get_config("qwen2_1_5b", smoke=True)
    tcfg = configs.get_config("qwen2_1_5b", smoke=True)
    p = rattn.init_attention(jax.random.key(2), cfg)
    tp = {k: torch.from_numpy(np.asarray(w, np.float32)).bfloat16()
          for k, w in p.items()}
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
    kc = rng.normal(0, 1, (2, 64, cfg.n_kv, cfg.head_dim)).astype(np.float32)
    vc = rng.normal(0, 1, kc.shape).astype(np.float32)
    pos = 37
    rx, tx = _pair(x, "bfloat16")
    want, rcache = rattn.decode_attention(
        p, rx, cfg, rattn.KVCache(jnp.asarray(kc, jnp.bfloat16),
                                  jnp.asarray(vc, jnp.bfloat16)),
        jnp.int32(pos))
    cache = attention.KVCache(torch.from_numpy(kc).bfloat16(),
                              torch.from_numpy(vc).bfloat16())
    got, out = attention.decode_attention(tp, tx, tcfg, cache, pos)
    assert out.k is cache.k and out.v is cache.v
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(cache.k), _np(rcache.k), rtol=2e-2,
                               atol=2e-2)
    assert np.array_equal(_np(cache.v[:, pos + 1:]), _np(rcache.v[:, pos + 1:]))


# -- configs, specs, batches -------------------------------------------------

@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_configs_equal_reference(arch):
    for smoke in (False, True):
        got = configs.get_config(arch, smoke=smoke)
        want = rconfigs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.head_dim == want.head_dim
        assert configs.applicable_shapes(got) == \
            rconfigs.applicable_shapes(want)
        for i in range(got.n_layers):
            assert blocks.layer_kind(got, i) == rblocks.layer_kind(want, i)
    assert configs.ARCH_IDS == rconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}


def _spec(t):
    return tuple(t.shape), str(t.dtype).rpartition(".")[2]


@pytest.mark.parametrize("arch", PORTED)
def test_specs_equal_reference(arch):
    """input_specs and cache_specs at the full CONFIG, every shape, as
    meta tensors (nothing allocated): the reference's ShapeDtypeStructs'
    shapes and dtypes, its stacked caches (layer i is ``pos{i % period}``
    of group ``i // period``) one ``KVCache``, ``MambaState``,
    ``MLSTMState`` or ``SLSTMState`` a layer; an encoder-decoder's dict of
    the stacked self caches and cross K/V as the reference's."""
    cfg = configs.get_config(arch)
    m = model.build_model(cfg, device="meta")
    ref = rmodel.build_model(rconfigs.get_config(arch))
    for name, shape in configs.SHAPES.items():
        got = m.input_specs(shape)
        want = ref.input_specs(rconfigs.SHAPES[name])
        assert all(t.device.type == "meta" for t in got.values())
        assert list(got) == list(want)
        assert {k: _spec(t) for k, t in got.items()} == \
            {k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()}
        caches = m.cache_specs(shape)
        rc = ref.cache_specs(rconfigs.SHAPES[name])
        if cfg.family == "encdec":
            assert list(caches) == list(rc)
            assert type(caches["self"]).__name__ == "KVCache"
            for got, want in ((caches["self"].k, rc["self"].k),
                              (caches["self"].v, rc["self"].v),
                              (caches["cross_k"], rc["cross_k"]),
                              (caches["cross_v"], rc["cross_v"])):
                assert got.device.type == "meta"
                assert _spec(got) == (tuple(want.shape), str(want.dtype))
            continue
        assert len(caches) == cfg.n_layers
        for i, c in enumerate(caches):
            rci = rc[f"pos{i % cfg.block_period}"]
            assert type(c).__name__ == type(rci).__name__
            assert rci[0].shape[0] == cfg.n_layers // cfg.block_period
            for t, s in zip(c, rci):
                assert t.device.type == "meta"
                assert _spec(t) == (tuple(s.shape[1:]), str(s.dtype))


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "pixtral_12b"])
def test_synthetic_batch_equals_reference(arch):
    m = model.build_model(configs.get_config(arch, smoke=True), device="cpu")
    ref = rmodel.build_model(rconfigs.get_config(arch, smoke=True))
    for kind in ("train", "prefill", "decode"):
        shape = configs.ShapeSpec(f"s_{kind}", 24, 3, kind)
        got = model.synthetic_batch(m, shape, seed=7)
        want = rmodel.synthetic_batch(ref, rconfigs.ShapeSpec(
            f"s_{kind}", 24, 3, kind), seed=7)
        assert list(got) == list(want)
        for k in want:
            assert got[k].device.type == "cpu"
            assert np.array_equal(_np(got[k]), _np(want[k]))


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_build_model_builds_every_config(arch):
    """Every family builds at its full CONFIG on ``meta`` (no allocation),
    with as many parameters as the reference's pytree has elements."""
    cfg = configs.get_config(arch)
    m = model.build_model(cfg, device="meta")
    assert m.is_encdec == (cfg.family == "encdec")
    assert all(p.device.type == "meta" for p in m.parameters())
    ref = jax.eval_shape(lambda: rmodel.build_model(
        rconfigs.get_config(arch)).init(jax.random.key(0)))
    assert sum(p.numel() for p in m.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(ref))


def test_block_period_must_divide_the_layers():
    cfg = dataclasses.replace(configs.get_config("jamba_v0_1_52b",
                                                 smoke=True), n_layers=12)
    with pytest.raises(ValueError, match="block_period 8"):
        model.build_model(cfg, device="meta")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA box runs it")
def test_build_model_without_device_needs_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.build_model(configs.get_config("qwen2_1_5b", smoke=True))
