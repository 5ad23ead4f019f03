"""Checkpointing: async, atomic, latest-k; the port of
``repro/checkpoint/ckpt.py``, in the reference's on-disk format.

Layout: ``<dir>/step_<n>/`` with one ``leaf_<i>.npy`` per leaf of the state
plus ``MANIFEST.json`` (``step``, ``extra`` and, per leaf, its ``path``,
``file``, ``shape`` and ``dtype``). A leaf's path is the reference's key
string: ``.field`` for a NamedTuple field, ``['key']`` for a dict key
(keys in sorted order, as ``jax.tree`` flattens a dict), ``[i]`` for a
list or tuple item. bfloat16 leaves are stored as exact float32 (npy has no
bfloat16) under the dtype name ``bfloat16``. Writes go to a tmp directory
renamed into place, so a crash mid-save never corrupts the restore target,
and only the latest ``keep`` steps stay.

``save`` snapshots every leaf to the host synchronously (one copy a leaf,
as ``device_get`` is) and writes the files in a background thread.
``restore`` lands each leaf on the template leaf's device in its dtype,
bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(key string, leaf) of every leaf of a tree of NamedTuples, dicts,
    lists and tuples, in the reference's order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(template, leaves):
    """A tree shaped like ``template`` whose leaves are taken in order
    from the iterator ``leaves``."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, dict):
        done = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: done[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None):
        # snapshot to host synchronously (cheap vs. serialization), write
        # in a background thread (async checkpointing)
        host = [(path, x.detach().to("cpu", copy=True))
                for path, x in _flatten(state)]
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}))
            self._thread.start()
        else:
            self._write(step, host, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, leaves, extra: Dict[str, Any]):
        tmp = os.path.join(self.dir, f".tmp_step_{step}_{time.time_ns()}")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for i, (path, x) in enumerate(leaves):
            fname = f"leaf_{i:05d}.npy"
            dtype = _dtype_name(x.dtype)
            if x.dtype == torch.bfloat16:   # npy has no bf16: store exact f32
                x = x.float()
            arr = x.numpy()
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"path": path, "file": fname, "shape": list(arr.shape),
                 "dtype": dtype})
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, template):
        """Restore into the structure of ``template``: each leaf on the
        template leaf's device, in its dtype -> (state, extra)."""
        final = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(final, "MANIFEST.json")) as f:
            manifest = json.load(f)
        t_leaves = _flatten(template)
        if len(t_leaves) != len(manifest["leaves"]):
            raise ValueError(f"restore: {len(manifest['leaves'])} leaves "
                             f"stored, the template has {len(t_leaves)}")
        by_path = {m["path"]: m for m in manifest["leaves"]}
        tensors = []
        for path, t_leaf in t_leaves:
            m = by_path[path]
            arr = np.load(os.path.join(final, m["file"]))
            if tuple(arr.shape) != tuple(t_leaf.shape):
                raise ValueError(f"{path}: {arr.shape} vs {tuple(t_leaf.shape)}")
            tensors.append(torch.from_numpy(arr).to(t_leaf.device,
                                                    t_leaf.dtype))
        return _unflatten(template, iter(tensors)), manifest["extra"]


def restore_latest(directory: str, template):
    mgr = CheckpointManager(directory)
    steps = mgr.all_steps()
    if not steps:
        return None, None, None
    state, extra = mgr.restore(steps[-1], template)
    return steps[-1], state, extra
