"""The training data pipeline: the port of ``repro/data/pipeline.py``.

Batches are windows of a token array (an int32 column, e.g. what a query of
the engine returned), copied straight to the device with ``prefetch``
batches in flight, so the copy of the next batch overlaps the step on the
current one.

Deterministic and stateful: the window order is ``default_rng(seed)
.permutation`` of the windows and a batch is a pure function of ``step``,
as in the reference, so batches equal the reference's array for array and
a pipeline rebuilt at a checkpoint's step resumes the exact sequence.

``device`` takes the place of the reference's ``sharding``: ``None`` means
``"cuda"`` (which raises without a card), ``"cpu"`` keeps the batches on
the host. On a card each batch is copied from a pinned host buffer of its
own by a non-blocking copy. A buffer is never refilled: it goes back to
torch's pinned-memory cache when its batch is dropped, and the cache hands
it out again only once the copy that reads it has completed.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator

import numpy as np
import torch

from ..device import resolve_device


class TokenPipeline:
    def __init__(self, tokens: np.ndarray, batch: int, seq_len: int,
                 start_step: int = 0, device=None, prefetch: int = 2,
                 seed: int = 0):
        self.tokens = np.asarray(tokens, dtype=np.int32)
        self.batch = batch
        self.seq = seq_len
        self.step = start_step
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.seed = seed
        n_windows = len(self.tokens) // (seq_len + 1)
        if n_windows < batch:
            raise ValueError("TokenPipeline: corpus too small for one batch")
        self._n_windows = n_windows
        rng = np.random.default_rng(seed)
        self._order = rng.permutation(n_windows)
        self._buf: collections.deque = collections.deque()

    # position is a pure function of step -> deterministic resume
    def _host_batch(self, step: int) -> Dict[str, np.ndarray]:
        idx = (step * self.batch + np.arange(self.batch)) % self._n_windows
        windows = self._order[idx]
        toks = np.stack([
            self.tokens[w * (self.seq + 1): w * (self.seq + 1) + self.seq + 1]
            for w in windows])
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}

    def _device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        host = {k: torch.from_numpy(v) for k, v in self._host_batch(step).items()}
        if self.device.type != "cuda":
            return {k: v.to(self.device) for k, v in host.items()}
        return {k: v.pin_memory().to(self.device, non_blocking=True)
                for k, v in host.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        # keep `prefetch` batches in flight so the host-to-device copy
        # overlaps the device step (torch's launches are asynchronous)
        while len(self._buf) < self.prefetch:
            self._buf.append(self._device_batch(self.step + len(self._buf)))
        out = self._buf.popleft()
        self.step += 1
        return out

    # -- checkpoint integration ----------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    @classmethod
    def from_state(cls, tokens, batch, seq_len, state: dict, **kw):
        return cls(tokens, batch, seq_len, start_step=state["step"],
                   seed=state["seed"], **kw)
