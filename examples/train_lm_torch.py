"""Train an LM on the port with the whole training stack: the data pipeline,
AdamW, checkpoints and the fault-tolerant loop (one injected failure and
its recovery), the counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]

Runs on the CUDA device by default and fails when there is none; ``--device
cpu`` runs the plain versions. The default is a reduced model (4 layers,
d_model 128, vocab 2,048); ``--full-100m`` takes the reference's ~100M
setting for real hardware (12 layers, d_model 768, vocab 32,000).
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime import FailureInjector, TrainLoop
from repro_torch.train import make_train_step, train_state_init


def make_config(full: bool) -> ArchConfig:
    if full:   # ~100M params (xlstm-125m-class dense sibling)
        return ArchConfig(name="demo_100m", family="dense", n_layers=12,
                          d_model=768, n_heads=12, n_kv=4, d_ff=2048,
                          vocab=32_000, tie_embeddings=True)
    return ArchConfig(name="demo_small", family="dense", n_layers=4,
                      d_model=128, n_heads=4, n_kv=2, d_ff=512,
                      vocab=2_048, tie_embeddings=True)


def make_corpus(cfg: ArchConfig, n: int = 2_000_000) -> np.ndarray:
    """A synthetic corpus with learnable structure (periodic + noise), the
    reference's, drawn from seed 0."""
    rng = np.random.default_rng(0)
    base = np.arange(n) % 97
    return ((base * 21 + rng.integers(0, 3, n)) % cfg.vocab).astype(np.int32)


def train(cfg: ArchConfig, corpus: np.ndarray, *, steps: int, batch: int,
          seq: int, device, ckpt_dir: str, fail_at=(), ckpt_every: int = 50):
    """``steps`` steps of ``cfg``'s model (weights from seed 0) through a
    ``TrainLoop`` that checkpoints every ``ckpt_every`` steps into
    ``ckpt_dir`` and fails once at each step of ``fail_at`` -> (the loop,
    the final state)."""
    device = resolve_device(device)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device).manual_seed(0))
    step = make_train_step(model, base_lr=3e-4, total_steps=steps)

    def pipeline_factory(start_step):
        return TokenPipeline(corpus, batch=batch, seq_len=seq,
                             start_step=start_step, device=device)

    loop = TrainLoop(step, train_state_init(model), pipeline_factory,
                     ckpt_dir, ckpt_every=ckpt_every,
                     injector=FailureInjector(fail_at_steps=fail_at))
    return loop, loop.run(steps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = make_config(args.full_100m)
    device = resolve_device(args.device)
    print(f"model {cfg.name}: {cfg.param_count() / 1e6:.1f}M params on "
          f"{device}")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        loop, state = train(cfg, make_corpus(cfg), steps=args.steps,
                            batch=args.batch, seq=args.seq, device=device,
                            ckpt_dir=ckpt_dir, fail_at=[args.steps // 2])
    losses = [m["loss"] for m in loop.metrics]
    step_ms = 1e3 * float(np.median([m["seconds"] for m in loop.metrics]))
    print(f"restarts survived: {loop.restarts}")
    print(f"loss: step0={losses[0]:.3f} mid={losses[len(losses) // 2]:.3f} "
          f"final={losses[-1]:.3f}; median step {step_ms:.2f} ms on "
          f"{device.type}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training did not reduce loss")
    print("OK: loss decreased through a mid-run failure + recovery")
    return {"loop": loop, "state": state, "losses": losses}


if __name__ == "__main__":
    main()
