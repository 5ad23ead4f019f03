"""The port's MoE (``repro_torch.models.moe`` and ``moe_a2a``) and its MoE
LMs against the reference ``repro.models`` on the CPU, at dbrx-132B's and
deepseek-moe-16B's SMOKE configs: the reference's weights carried across
by ``models.convert.load_reference``, the same numpy inputs through both.

Tolerances, with the largest errors seen:
- The routing on identical bfloat16 inputs, without and with capacity
  drops: ``topi``, ``slot_tok`` and the kept copies equal; ``slot_w``
  within one bfloat16 ulp; ``y`` within rtol = atol = 2e-2 (the
  reference's own, ``tests/test_moe_dispatch.py``); ``aux`` within 1e-5.
- The gradients of ``sum(y * r) + aux`` through the routing weights, the
  gather and the combine: each leaf within 2e-2 of its largest |value|.
- The models (B 2, S 32, 4 decode steps) run on the reference's routing
  (``tests/torch_lm_routing.py``): every choice of the port's own that
  differs is a near tie, its reference-side gap between the k-th and
  (k+1)-th probability below ``MARGIN`` = 1e-3 (seen 3.8e-4, in dbrx's
  forward; deepseek's 8 experts average 0.125); logits and K/V caches as
  ``tests/test_torch_lm_model.py`` holds them, rtol = atol = 2e-2; the
  loss within 2e-3; aux within 1e-5.
- One train step at deepseek's SMOKE config, on the reference's routing,
  within ``tests/test_torch_train.py``'s tolerances for qwen2.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_lm_routing import models, routed  # noqa: E402
from torch_routing import decode_on_forward_routing  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import moe_a2a as ref_a2a  # noqa: E402
from repro.models.model import synthetic_batch as rsynthetic  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model, moe, moe_a2a  # noqa: E402
from repro_torch.models.convert import load_reference  # noqa: E402
from repro_torch.models.model import synthetic_batch  # noqa: E402

MOE = ("dbrx_132b", "deepseek_moe_16b")
RTOL = ATOL = 2e-2
MARGIN = 1e-3
B, S, STEPS = 2, 32, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes on the
    machine's cores, and torch's threads a process would oversubscribe
    them (as ``tests/test_torch_train.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _moe_params(arch, seed):
    """(config, the reference's ``init_moe`` params, their torch copies)."""
    cfg = configs.get_config(arch, smoke=True)
    p = rmoe.init_moe(jax.random.key(seed), rconfigs.get_config(arch,
                                                                 smoke=True))
    tp = {k: _t(v, torch.float32 if v.dtype == jnp.float32 else
                torch.bfloat16) for k, v in p.items()}
    return cfg, p, tp


def _x(cfg, n, seed):
    x = np.random.default_rng(seed).normal(0, 1, (n, cfg.d_model))
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x.astype(np.float32)).bfloat16())


# -- the module ---------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_capacity_and_init_match_reference(arch):
    cfg, p, tp = _moe_params(arch, 0)
    rcfg = rconfigs.get_config(arch, smoke=True)
    for n in (1, 2, 8, 64, 100, 4096, 4097, 100_000):
        for factor in (None, 0.5, 1.0, 2.0):
            assert moe._capacity(n, cfg, factor) == \
                rmoe._capacity(n, rcfg, factor)
    assert (moe.CAPACITY_FACTOR, moe.MOE_DISPATCH) == \
        (rmoe.CAPACITY_FACTOR, rmoe.MOE_DISPATCH)
    mine = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    assert list(mine) == list(p)
    for k, v in p.items():
        assert tuple(mine[k].shape) == v.shape
        assert str(mine[k].dtype)[6:] == str(v.dtype)
    assert mine["router"].dtype == torch.float32
    assert abs(float(mine["router"].std()) - 0.02) < 2e-3


def _ref_route(flat, params, cfg, cap):
    """``moe_a2a.py:36-71`` at ``e_lo`` 0 over every expert, line for line:
    (topi, slot_tok, slot_w, the output of its experts and combine)."""
    n, d = flat.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax(flat.astype(jnp.float32) @ params["router"], -1)
    topw, topi = jax.lax.top_k(probs, k)
    topw = topw / jnp.sum(topw, axis=-1, keepdims=True)
    eid = topi.reshape(-1)
    tok = jnp.repeat(jnp.arange(n, dtype=jnp.int32), k)
    w = topw.reshape(-1).astype(jnp.bfloat16)
    order = jnp.argsort(eid, stable=True).astype(jnp.int32)
    sorted_rel = jnp.take(eid, order)
    first = jnp.searchsorted(sorted_rel, jnp.arange(e + 1, dtype=jnp.int32),
                             side="left")
    rank = jnp.arange(n * k, dtype=jnp.int32) - jnp.take(first, sorted_rel)
    keep = rank < cap
    slot = jnp.where(keep, sorted_rel * cap + rank, e * cap)
    slot_tok = jnp.zeros((e * cap,), jnp.int32).at[slot].set(
        jnp.take(tok, order), mode="drop")
    slot_w = jnp.zeros((e * cap,), jnp.bfloat16).at[slot].set(
        jnp.take(w, order), mode="drop")
    buckets = jnp.take(flat, slot_tok, axis=0).reshape(e, cap, d)
    buckets = buckets * (slot_w.reshape(e, cap, 1) != 0)
    h = jax.nn.silu(jnp.einsum("ecd,edf->ecf", buckets, params["experts_w1"]))
    h = h * jnp.einsum("ecd,edf->ecf", buckets, params["experts_w3"])
    y = jnp.einsum("ecf,efd->ecd", h, params["experts_w2"])
    y_flat = y.reshape(e * cap, d) * slot_w[:, None]
    out = jnp.zeros((n, d), jnp.bfloat16).at[slot_tok].add(y_flat)
    return topi, slot_tok, slot_w, out


# (tokens, capacity): the call's own capacity, and one far below the
# copies an expert receives (dbrx: ~256 of 512 x 2 / 4; deepseek ~192)
_ROUTE_CASES = {"no_drop": (64, None), "drop": (512, 128)}


@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
@pytest.mark.parametrize("arch", MOE)
def test_routing_matches_reference(arch, case):
    """Identical bfloat16 inputs: the same experts a token, the same token
    in every slot and the same copies kept (``drop`` drops some)."""
    cfg, p, tp = _moe_params(arch, 1)
    n, cap = _ROUTE_CASES[case]
    cap = cap or moe._capacity(n, cfg)
    rx, tx = _x(cfg, n, 2)
    topi, slot_tok, slot_w, out = jax.jit(_ref_route, static_argnums=(
        2, 3))(rx, p, cfg, cap)
    want, raux = jax.jit(ref_a2a._local_moe, static_argnums=(2, 4, 5))(
        rx, p, cfg, jnp.int32(0), cfg.n_experts, cap)
    assert np.array_equal(_np(out), _np(want))     # the transcription
    r = moe_a2a._route(tx, tp, cfg, 0, cfg.n_experts, cap)
    assert np.array_equal(r.topi.numpy(), np.asarray(topi))
    assert np.array_equal(r.slot_tok.numpy(), np.asarray(slot_tok))
    kept = np.asarray(slot_w) != 0
    assert np.array_equal((r.slot_w != 0).numpy(), kept)
    dropped = n * cfg.top_k - int(kept.sum())
    assert (dropped > 0) == (case == "drop"), dropped
    w = _np(slot_w)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert (np.abs(_np(r.slot_w) - w) <= ulp).all()
    got, aux = moe_a2a._local_moe(tx, tp, cfg, 0, cfg.n_experts, cap)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


@pytest.mark.parametrize("path", ["gspmd", "a2a", "moe_ffn_a2a"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, path, monkeypatch):
    """``moe_ffn`` under both ``MOE_DISPATCH`` values and ``moe_ffn_a2a``
    against the reference's same path, shared experts included."""
    cfg, p, tp = _moe_params(arch, 3)
    rx, tx = _x(cfg, B * S, 4)
    rx, tx = rx.reshape(B, S, -1), tx.reshape(B, S, -1)
    if path == "moe_ffn_a2a":
        want, raux = ref_a2a.moe_ffn_a2a(p, rx, cfg)
        got, aux = moe_a2a.moe_ffn_a2a(tp, tx, cfg)
    else:
        monkeypatch.setattr(rmoe, "MOE_DISPATCH", path)
        monkeypatch.setattr(moe, "MOE_DISPATCH", path)
        want, raux = rmoe.moe_ffn(p, rx, cfg)
        got, aux = moe.moe_ffn(tp, tx, cfg)
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.bfloat16
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


def test_moe_gradients_match_reference():
    """d(sum(y * r) + aux) at deepseek's SMOKE config (shared experts)
    through the top-k weights, the weight scatter, the gather and the
    combine: every leaf and the input within 2e-2 of its largest |value|."""
    cfg, p, tp = _moe_params("deepseek_moe_16b", 5)
    rx, tx = _x(cfg, B * S, 6)
    rx, tx = rx.reshape(B, S, -1), tx.reshape(B, S, -1)
    r = np.random.default_rng(7).normal(0, 1, (B, S, cfg.d_model))

    def f(params, x):
        y, aux = rmoe.moe_ffn(params, x, cfg)
        return jnp.sum(y.astype(jnp.float32) * r) + aux

    want_p, want_x = jax.jit(jax.grad(f, argnums=(0, 1)))(p, rx)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    y, aux = moe.moe_ffn(leaves, x, cfg)
    (torch.sum(y.float() * torch.from_numpy(r).float()) + aux).backward()
    for name, got, want in [(k, leaves[k].grad, want_p[k]) for k in tp] + [
            ("x", x.grad, want_x)]:
        w = _np(want)
        assert got is not None and got.dtype == leaves.get(name, x).dtype
        err = np.abs(_np(got) - w).max()
        assert err <= 2e-2 * np.abs(w).max() and np.abs(w).max() > 0, (
            name, err, np.abs(w).max())


def test_load_reference_carries_moe_leaves():
    """Every parameter of deepseek's SMOKE model (router, experts, shared
    experts) equals the reference's leaf; the router stays float32."""
    ref, params, port = models("deepseek_moe_16b")
    names = dict(port.named_parameters())
    assert {"layers.1.ffn.router", "layers.1.ffn.experts_w2",
            "layers.0.ffn.shared_w3"} <= set(names)
    assert names["layers.1.ffn.router"].dtype == torch.float32
    for name, p in names.items():
        i = int(name.split(".")[1]) if name.startswith("layers.") else None
        node = params
        if i is None:
            node = params[name]
        else:
            node = params["blocks"]["pos0"]
            for key in name.split(".")[2:]:
                node = node[key]
            node = node[i]
        assert np.array_equal(_np(p.detach()), _np(node)), name


# -- the models ---------------------------------------------------------------

def _close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _close_rows(got, want, what):
    """A K/V cache: each element within ``ATOL + RTOL`` times its head
    row's largest |entry| (``tests/test_torch_lm_model.py``)."""
    g, w = _np(got), _np(want)
    row = np.abs(w).max(axis=-1, keepdims=True)
    assert (np.abs(g - w) <= ATOL + RTOL * row).all(), what


def _tokens(cfg, s, seed):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (B, s),
                                               dtype=np.int32)
    return {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}


@functools.lru_cache(maxsize=None)
def _forward(arch):
    """(reference logits and aux, the port's on its routing)."""
    ref, params, port = models(arch)
    rb, tb = _tokens(port.cfg, S, 1)
    with routed(port.cfg.top_k) as rec:
        want, raux = jax.jit(ref.forward)(params, rb)
        with torch.no_grad():
            got, aux = port.forward(tb)
    rec.check(MARGIN, f"{arch} forward")
    return want, got, float(raux), float(aux)


@functools.lru_cache(maxsize=None)
def _serve(arch):
    """Prefill of S then STEPS decode steps on both, each fed the
    reference's greedy token, the port on the reference's routing:
    [((reference logits, caches), (port logits, caches)) a step, prefill
    first], and the port's prefill's attention calls."""
    ref, params, port = models(arch)
    rb, tb = _tokens(port.cfg, S, 0)
    calls = []
    real = ops.flash_attention
    ops.flash_attention = lambda *a, **k: calls.append(a) or real(*a, **k)
    try:
        with routed(port.cfg.top_k) as rec:
            rl, rc = jax.jit(ref.prefill, static_argnums=2)(params, rb,
                                                            S + STEPS)
            tl, tc = port.prefill(tb, S + STEPS)
    finally:
        ops.flash_attention = real
    rec.check(MARGIN, f"{arch} prefill")
    steps = [((rl, rc), (tl, [type(c)(*(t.clone() for t in c))
                              for c in tc]))]
    decode = jax.jit(ref.decode_step)
    for t in range(STEPS):
        nxt = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)[:, None]
        with routed(port.cfg.top_k) as rec:
            rl, rc = decode(params, jnp.asarray(nxt), rc, jnp.int32(S + t))
            tl, tc = port.decode_step(torch.from_numpy(nxt), tc, S + t)
        rec.check(MARGIN, f"{arch} decode step {t}")
        steps.append(((rl, rc), (tl, tc)))
    return steps, len(calls)


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits(arch):
    want, got, raux, aux = _forward(arch)
    assert got.shape == (B, S, configs.get_config(arch, smoke=True).vocab)
    assert got.dtype == torch.bfloat16
    _close(got, want, f"{arch} forward")
    np.testing.assert_allclose(aux, raux, rtol=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_logits_and_caches(arch):
    steps, launches = _serve(arch)
    (rl, rc), (tl, tc) = steps[0]
    cfg = configs.get_config(arch, smoke=True)
    assert tl.shape == (B, 1, cfg.vocab)
    assert launches == cfg.n_layers        # one attention call a layer
    _close(tl, rl, f"{arch} prefill logits")
    assert len(tc) == cfg.n_layers
    for i, c in enumerate(tc):
        _close_rows(c.k, rc["pos0"].k[i], f"{arch} layer {i} K cache")
        _close_rows(c.v, rc["pos0"].v[i], f"{arch} layer {i} V cache")
        assert not c.k[:, S:].any() and not c.v[:, S:].any()


@pytest.mark.parametrize("arch", MOE)
def test_decode_steps(arch):
    steps, _ = _serve(arch)
    for t, ((rl, rc), (tl, tc)) in enumerate(steps[1:]):
        _close(tl, rl, f"{arch} decode step {t}")
    for i, c in enumerate(tc):
        _close_rows(c.k, rc["pos0"].k[i], f"{arch} layer {i} K cache after "
                    "decode")


@pytest.mark.parametrize("arch", MOE)
def test_loss_matches_reference(arch):
    """The loss holds 0.01 aux: within 2e-3, as the dense models'."""
    ref, params, port = models(arch)
    shape = configs.ShapeSpec("smoke_train", 16, 2, "train")
    with routed(port.cfg.top_k) as rec:
        want = jax.jit(ref.loss)(params, rsynthetic(ref, rconfigs.ShapeSpec(
            "smoke_train", 16, 2, "train")))
        with torch.no_grad():
            got = port.loss(synthetic_batch(port, shape))
    rec.check(MARGIN, f"{arch} loss")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=2e-3)


# -- tests/test_arch_smoke.py's four, on the port -----------------------------

SMOKE_SHAPE = configs.ShapeSpec("smoke_train", 64, 2, "train")


@pytest.mark.parametrize("arch", MOE)
def test_forward_shapes_and_finite(arch):
    model = build_model(configs.get_config(arch, smoke=True), device="cpu")
    batch = synthetic_batch(model, SMOKE_SHAPE)
    with torch.no_grad():
        logits, aux = model.forward(batch)
    assert logits.shape == (2, 64, model.cfg.vocab)
    assert torch.isfinite(logits.float()).all() and torch.isfinite(aux)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE)
def test_train_step_reduces_loss_and_finite_grads(arch):
    """The reference's plain SGD nudge (w - 0.3 g) on one batch."""
    model = build_model(configs.get_config(arch, smoke=True), device="cpu",
                        generator=torch.Generator().manual_seed(1))
    batch = synthetic_batch(model, SMOKE_SHAPE)
    loss0 = model.loss(batch)
    grads = torch.autograd.grad(loss0, list(model.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p -= 0.3 * g.to(p.dtype)
        loss1 = model.loss(batch)
    assert float(loss1) < float(loss0.detach()), (float(loss0.detach()),
                                                  float(loss1))


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_consistent_with_forward(arch):
    """Decode from empty caches, one token at a time, on the forward's
    routing, reproduces the last position of ``forward`` within rtol =
    atol = 0.15 (the reference's)."""
    model = build_model(configs.get_config(arch, smoke=True), device="cpu",
                        generator=torch.Generator().manual_seed(2))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab, (2, 32), dtype=np.int32))
    full, logits, rec = decode_on_forward_routing(model, tok)
    rec.check(MARGIN, f"{arch} decode against forward")
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, -1]),
                               rtol=0.15, atol=0.15)


@pytest.mark.parametrize("arch", MOE)
def test_param_count_full_config_matches_family(arch):
    """The analytic count at the full config, and the port's own count of
    its meta parameters equal to the reference's shapes'."""
    cfg = configs.get_config(arch)
    lo, hi = {"dbrx_132b": (110e9, 145e9),
              "deepseek_moe_16b": (13e9, 20e9)}[arch]
    assert lo <= cfg.param_count() <= hi
    meta = build_model(cfg, device="meta")
    n = sum(p.numel() for p in meta.parameters())
    ref = jax.eval_shape(lambda: rbuild(rconfigs.get_config(arch)).init(
        jax.random.key(0)))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref))


# -- training -----------------------------------------------------------------

def test_train_step_matches_reference():
    """deepseek's SMOKE config: the step of ``tests/test_torch_train.py``
    (B 4, S 32, from step 150 at base lr 1e-2, 2 microbatches) within its
    tolerances; the routing under the near-tie rule."""
    import test_torch_train as tt
    from repro.train import make_train_step as rmake
    from repro.train import optimizer as ropt
    from repro.train import train_state_init as rinit
    from repro.train.train_step import TrainState as RTrainState
    from repro_torch.models.convert import (reference_leaf,
                                            train_state_from_reference)
    from repro_torch.train import make_train_step

    arch = "deepseek_moe_16b"
    rmodel = rbuild(rconfigs.get_config(arch, smoke=True))
    state = rinit(rmodel, jax.random.key(0))
    rng = np.random.default_rng(7)
    m = jax.tree.map(lambda p: jnp.asarray(rng.normal(0, 1e-3, p.shape),
                                           jnp.float32), state.params)
    v = jax.tree.map(lambda p: jnp.asarray(
        1e-6 * rng.uniform(0.5, 1.5, p.shape), jnp.float32), state.params)
    rstate = RTrainState(state.params,
                         ropt.AdamWState(jnp.int32(tt.MID_STEP), m, v))
    tok = rng.integers(0, rmodel.cfg.vocab, (tt.B, tt.S + 1), dtype=np.int32)
    port = build_model(configs.get_config(arch, smoke=True), device="cpu")
    pstate = train_state_from_reference(port, rstate)
    batch = {"tokens": torch.from_numpy(tok[:, :-1].copy()),
             "labels": torch.from_numpy(tok[:, 1:].copy())}
    with routed(port.cfg.top_k) as rec:
        rnew, rmetrics = jax.jit(rmake(rmodel, microbatches=2,
                                       base_lr=tt.BASE_LR))(
            rstate, {"tokens": jnp.asarray(tok[:, :-1]),
                     "labels": jnp.asarray(tok[:, 1:])})
        # a microbatch's forward, then its layers again in reverse,
        # recomputed by the backward of the reference's remat; the port
        # routes each microbatch's forward once
        n = port.cfg.n_layers
        assert len(rec.ref) == 4 * n
        fwd = []
        for mb in range(2):
            calls = rec.ref[2 * n * mb:2 * n * (mb + 1)]
            assert all(np.array_equal(a, b)
                       for a, b in zip(calls[:n], calls[n:][::-1]))
            fwd += calls[:n]
        rec.ref[:] = fwd
        new, metrics = make_train_step(port, microbatches=2,
                                       base_lr=tt.BASE_LR)(pstate, batch)
    rec.check(MARGIN, "train step")
    np.testing.assert_allclose(float(metrics["loss"]), float(rmetrics["loss"]),
                               rtol=tt.RTOL_LOSS)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(rmetrics["grad_norm"]),
                               rtol=tt.RTOL_GNORM)
    lr = float(rmetrics["lr"])
    for name, p in new.params.items():
        want = np.asarray(reference_leaf(rnew.params, name, 1), np.float32)
        err = np.abs(p.float().numpy() - want)
        assert (err <= tt.PARAM_LR_TOL * lr + tt._ulp_bf16(want)).all(), (
            f"{name}: max error {err.max():.3g}, lr {lr:.3g}")
        for what, tree, got in (("m", rnew.opt.m, new.opt.m),
                                ("v", rnew.opt.v, new.opt.v)):
            tt._close(got[name], reference_leaf(tree, name, 1),
                      tt.MOMENT_TOL, f"{what} {name}")
