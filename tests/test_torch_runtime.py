"""The port's training runtime (``repro_torch.data``, ``checkpoint`` and
``runtime``) against the reference's on the CPU: batches, the checkpoint
format, the fault-tolerant loop and its recovery.

The loop's 12 losses at qwen2's SMOKE config (B 2, S 32, base lr 1e-3,
the reference's initial weights carried across) stay within ``RTOL_LOSS``
= 1e-4 of the reference ``TrainLoop``'s (largest seen 4.5e-5); recovery
from injected failures equals the uninterrupted run within atol 1e-6, as
the reference's test demands.
"""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as RCheckpointManager  # noqa: E402
from repro.data import TokenPipeline as RTokenPipeline  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.runtime import TrainLoop as RTrainLoop  # noqa: E402
from repro.train import make_train_step as rmake_train_step  # noqa: E402
from repro.train import train_state_init as rtrain_state_init  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, restore_latest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import train_state_from_reference  # noqa: E402
from repro_torch.runtime import (FailureInjector, StragglerMonitor,  # noqa: E402
                                 TrainLoop)
from repro_torch.train import make_train_step, train_state_init  # noqa: E402
from repro_torch.train.optimizer import AdamWState  # noqa: E402
from repro_torch.train.train_step import TrainState  # noqa: E402

RTOL_LOSS = 1e-4
STEPS, CKPT_EVERY = 12, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes on the
    machine's cores, and torch's threads a process would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_pipeline_batches_equal_reference_and_resume():
    corpus = np.arange(100_000, dtype=np.int32)
    ref = RTokenPipeline(corpus, batch=4, seq_len=32)
    port = TokenPipeline(corpus, batch=4, seq_len=32, device="cpu")
    batches = []
    for _ in range(7):
        want, got = next(ref), next(port)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        batches.append(got)
    assert port.state_dict() == {"step": 7, "seed": 0}
    # resume from step 5 must reproduce batches 5, 6
    resumed = TokenPipeline.from_state(corpus, 4, 32, {"step": 5, "seed": 0},
                                       device="cpu")
    for want in batches[5:]:
        got = next(resumed)
        assert torch.equal(got["tokens"], want["tokens"])
        assert torch.equal(got["labels"], want["labels"])


def test_pipeline_labels_shifted():
    corpus = np.arange(10_000, dtype=np.int32)
    b = next(TokenPipeline(corpus, batch=2, seq_len=16, device="cpu"))
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_runs_on_the_card_by_default():
    corpus = np.arange(1_000, dtype=np.int32)
    if torch.cuda.is_available():
        assert TokenPipeline(corpus, 2, 16).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TokenPipeline(corpus, 2, 16)
    with pytest.raises(ValueError, match="too small"):
        TokenPipeline(corpus, 100, 16, device="cpu")


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def _state(seed=0):
    """A TrainState with bfloat16, float32 and int32 leaves."""
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(16, 8, generator=gen).bfloat16(),
              "scale": torch.randn(8, generator=gen),
              "ids": torch.randint(-2**31, 2**31 - 1, (5,), generator=gen,
                                   dtype=torch.int32)}
    m = {k: torch.randn(p.shape, generator=gen) for k, p in params.items()}
    v = {k: torch.rand(p.shape, generator=gen) for k, p in params.items()}
    return TrainState(params, AdamWState(torch.tensor(17, dtype=torch.int32),
                                         m, v))


def _flat(state):
    return [state.opt.step] + [t for tree in (state.params, state.opt.m,
                                              state.opt.v)
                               for t in tree.values()]


def test_checkpoint_roundtrip_bit_exact(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(5, state, {"next_step": 6})
    template = _state(seed=1)
    got_step, got, extra = restore_latest(str(tmp_path), template)
    assert got_step == 5 and extra == {"next_step": 6}
    assert isinstance(got, TrainState) and isinstance(got.opt, AdamWState)
    assert list(got.params) == list(state.params)
    for a, b in zip(_flat(state), _flat(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.reshape(-1).view(torch.uint8).numpy().tobytes() == \
            b.reshape(-1).view(torch.uint8).numpy().tobytes()


def test_checkpoint_keeps_latest_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(), {"next_step": s + 1})
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(1, _state(), {"next_step": 2})
    mgr.wait()
    assert [d for d in os.listdir(tmp_path) if d.startswith(".tmp")] == []
    assert os.listdir(tmp_path) == ["step_1"]


@functools.lru_cache(maxsize=None)
def _ref():
    model = rbuild(rconfigs.get_config("qwen2_1_5b", smoke=True))
    state = rtrain_state_init(model, jax.random.key(0))
    corpus = np.random.default_rng(0).integers(
        0, model.cfg.vocab, 40_000).astype(np.int32)
    return model, state, corpus


def _port_state():
    port = build_model(get_config("qwen2_1_5b", smoke=True), device="cpu")
    return port, train_state_from_reference(port, _ref()[1])


def _ref_path(path):
    """The reference's key string of a port leaf path: a layer's parameter
    lies in its group's stacked leaf."""
    head, _, name = path.partition("['")
    name = name[:-2]
    if not name.startswith("layers."):
        return path
    parts = name.split(".")
    return head + "['blocks']['pos0']" + "".join(f"['{k}']" for k in parts[2:])


def test_checkpoint_manifest_laid_out_as_reference(tmp_path):
    """The same state saved by both engines: the manifest's keys, each
    leaf's keys, its dtype name and the stored npy dtype (bfloat16 as
    float32) are the reference's; a layer's shape is its group's without
    the stacking axis."""
    _, rstate, _ = _ref()
    _, state = _port_state()
    RCheckpointManager(str(tmp_path / "ref"), async_save=False).save(
        3, rstate, {"next_step": 4})
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        3, state, {"next_step": 4})
    manifests = {}
    for which in ("ref", "port"):
        with open(tmp_path / which / "step_3" / "MANIFEST.json") as f:
            manifests[which] = json.load(f)
    ref, port = manifests["ref"], manifests["port"]
    assert set(port) == set(ref) == {"step", "extra", "leaves"}
    assert port["step"] == 3 and port["extra"] == ref["extra"]
    by_path = {m["path"]: m for m in ref["leaves"]}
    assert len(port["leaves"]) == len(_flat(state))
    for i, leaf in enumerate(port["leaves"]):
        assert set(leaf) == {"path", "file", "shape", "dtype"}
        assert leaf["file"] == f"leaf_{i:05d}.npy"
        want = by_path[_ref_path(leaf["path"])]
        assert leaf["dtype"] == want["dtype"], leaf["path"]
        stacked = want["shape"][1:] if "layers." in leaf["path"] \
            else want["shape"]
        assert leaf["shape"] == stacked, leaf["path"]
        for which, m in (("port", leaf), ("ref", want)):
            arr = np.load(tmp_path / which / "step_3" / m["file"])
            assert str(arr.dtype) == ("float32" if m["dtype"] == "bfloat16"
                                      else m["dtype"])


# ---------------------------------------------------------------------------
# fault-tolerant training loop
# ---------------------------------------------------------------------------

def _loop(path, state, model, injector=None, ref=False):
    _, _, corpus = _ref()
    if ref:
        step = jax.jit(rmake_train_step(model, base_lr=1e-3))

        def factory(start_step):
            return RTokenPipeline(corpus, batch=2, seq_len=32,
                                  start_step=start_step)
        return RTrainLoop(step, state, factory, str(path),
                          ckpt_every=CKPT_EVERY, injector=injector)
    step = make_train_step(model, base_lr=1e-3)

    def factory(start_step):
        return TokenPipeline(corpus, batch=2, seq_len=32,
                             start_step=start_step, device="cpu")
    return TrainLoop(step, state, factory, str(path), ckpt_every=CKPT_EVERY,
                     injector=injector)


def test_training_recovers_from_injected_failures(tmp_path):
    model, state = _port_state()
    clean = _loop(tmp_path / "clean", state, model)
    clean_state = clean.run(STEPS)
    faulty = _loop(tmp_path / "faulty", state, model,
                   FailureInjector(fail_at_steps=[3, 9]))
    faulty_state = faulty.run(STEPS)
    assert faulty.restarts == 2 and clean.restarts == 0
    # deterministic recovery: same final params as the uninterrupted run
    assert int(faulty_state.opt.step) == int(clean_state.opt.step) == STEPS
    for name, a in clean_state.params.items():
        np.testing.assert_allclose(a.float().numpy(),
                                   faulty_state.params[name].float().numpy(),
                                   atol=1e-6, err_msg=name)
    # the failure at 3 restarted from the initial state, which it left as
    # it was; the one at 9 from the checkpoint of step 8
    assert [m["step"] for m in faulty.metrics] == \
        [0, 1, 2] + list(range(STEPS))[:9] + list(range(8, STEPS))
    for name, p in train_state_init(model).params.items():
        assert torch.equal(state.params[name], p)


def test_loop_losses_match_reference_loop(tmp_path):
    rmodel, rstate, _ = _ref()
    want = _loop(tmp_path / "ref", rstate, rmodel, ref=True)
    want.run(STEPS)
    model, state = _port_state()
    got = _loop(tmp_path / "port", state, model)
    got.run(STEPS)
    np.testing.assert_allclose([m["loss"] for m in got.metrics],
                               [m["loss"] for m in want.metrics],
                               rtol=RTOL_LOSS)


def test_straggler_detection_and_reassignment():
    mon = StragglerMonitor(num_workers=4, factor=3.0, window=4)
    for step in range(6):
        for w in range(4):
            mon.record(w, 1.0 if w != 2 else 10.0)   # worker 2 is slow
    assert mon.detect() == [2]
    assert mon.healthy_workers() == [0, 1, 3]
    assert mon.detect() == []                      # flagged once
