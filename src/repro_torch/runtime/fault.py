"""Fault-tolerant training loop: checkpoint/restart, failure injection,
straggler detection with data reassignment; the port of
``repro/runtime/fault.py`` (host logic, copied).

``FailureInjector`` raises ``WorkerFailure`` deterministically so the
recovery path (restore the latest checkpoint -> rebuild the pipeline at
the exact step -> continue) is tested end to end. Recovery is exact
because the pipeline position and the optimizer state are pure functions
of the checkpointed step, the checkpoint is bit for bit, and the train
step computes the same bits on the same inputs (on the CPU and on the
H100 alike, with no op forced into a deterministic mode).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..checkpoint.ckpt import CheckpointManager, restore_latest


class WorkerFailure(RuntimeError):
    """A (simulated) worker/chip failure surfaced during a step."""


class FailureInjector:
    """Raises WorkerFailure at the given global steps, once each."""

    def __init__(self, fail_at_steps: List[int] = ()):
        self.remaining = set(fail_at_steps)

    def check(self, step: int):
        if step in self.remaining:
            self.remaining.discard(step)
            raise WorkerFailure(f"injected failure at step {step}")


class StragglerMonitor:
    """Flags workers whose step time exceeds ``factor`` x the fleet median.

    Mitigation at this layer is *data reassignment*: a flagged worker's
    input shard is redistributed to healthy workers (the pipeline's window
    order makes this a pure re-partitioning). The monitor records events so
    the report layer can show detection latency.
    """

    def __init__(self, num_workers: int, factor: float = 3.0, window: int = 8):
        self.num_workers = num_workers
        self.factor = factor
        self.window = window
        self.history: Dict[int, List[float]] = {w: [] for w in range(num_workers)}
        self.flagged: List[int] = []

    def record(self, worker: int, seconds: float):
        h = self.history[worker]
        h.append(seconds)
        if len(h) > self.window:
            h.pop(0)

    def detect(self) -> List[int]:
        med = np.median([np.mean(h) for h in self.history.values() if h])
        out = []
        for w, h in self.history.items():
            if h and np.mean(h) > self.factor * med and w not in self.flagged:
                out.append(w)
                self.flagged.append(w)
        return out

    def healthy_workers(self) -> List[int]:
        return [w for w in range(self.num_workers) if w not in self.flagged]


class TrainLoop:
    """Checkpoint-and-restart training loop.

    run() executes ``num_steps`` steps; WorkerFailure triggers restore from
    the newest checkpoint and a clean continue. Any step not covered by a
    checkpoint is recomputed — standard restart semantics. A restored state
    lands on the devices of ``init_state``'s leaves.
    """

    def __init__(self, train_step: Callable, init_state, pipeline_factory,
                 ckpt_dir: str, ckpt_every: int = 10,
                 injector: Optional[FailureInjector] = None,
                 max_restarts: int = 10):
        self.train_step = train_step
        self.init_state = init_state
        self.pipeline_factory = pipeline_factory   # (start_step) -> iterator
        self.ckpt = CheckpointManager(ckpt_dir, keep=2)
        self.ckpt_every = ckpt_every
        self.injector = injector or FailureInjector()
        self.max_restarts = max_restarts
        self.restarts = 0
        self.metrics: List[dict] = []

    def _bootstrap(self):
        step, state, extra = restore_latest(self.ckpt.dir, self.init_state)
        if state is None:
            return 0, self.init_state
        return extra["next_step"], state

    def run(self, num_steps: int):
        while True:
            start_step, state = self._bootstrap()
            pipe = self.pipeline_factory(start_step)
            try:
                for step in range(start_step, num_steps):
                    batch = next(pipe)
                    self.injector.check(step)
                    t0 = time.perf_counter()
                    state, m = self.train_step(state, batch)
                    self.metrics.append(
                        {"step": step, "loss": float(m["loss"]),
                         "seconds": time.perf_counter() - t0})
                    if (step + 1) % self.ckpt_every == 0:
                        self.ckpt.save(step, state,
                                       {"next_step": step + 1})
                self.ckpt.wait()
                return state
            except WorkerFailure:
                self.restarts += 1
                self.ckpt.wait()           # never restore a half-written save
                if self.restarts > self.max_restarts:
                    raise
                continue
