"""int8 error-feedback gradient compression for the data-parallel all-reduce:
the port of ``repro/train/compression.py``.

Gradients are quantized to int8 with one float32 scale a tensor before
they cross between workers, and the quantization error is carried into the
next step, so the compression is unbiased over time. ``quantize`` rounds
half to even, as ``jnp.round`` does, so its payloads and scales equal the
reference's bit for bit.

A tree is a tensor or a dict of tensors keyed by parameter name. The
reference's ``allreduce_compressed`` is a ``psum``/``pmax`` inside
``shard_map``; the port's workers live in one process (``launch.mesh
.EngineMesh``), so ``allreduce_compressed`` takes the W workers' trees as
a list, each on its worker's device, sums the int8 payloads as int32 on
the first worker's device, takes the largest scale, dequantizes, divides
by W and hands each worker its copy. No train step calls it, as in the
reference. Under ``launch.roofline.count_program`` it reports W times the
bytes of a worker's result (each leaf's int32 sums and float32 largest
scale), as an HLO parse counts the reference's ``psum`` and ``pmax`` in
each device's program.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..kernels import ops


def _map(fn, *trees):
    """``fn`` over the leaves of equally shaped trees; a tuple-returning
    ``fn`` gives a tuple of trees."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    out = {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    first = next(iter(out.values()), None)
    if isinstance(first, tuple):
        return tuple({k: r[i] for k, r in out.items()}
                     for i in range(len(first)))
    return out


def _leaves(tree) -> List[torch.Tensor]:
    return [tree] if isinstance(tree, torch.Tensor) else list(tree.values())


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float -> (int8 payload, 0-d float32 scale)."""
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_init(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def compress_tree(grads, error):
    """(grads + carried error) -> (int8 tree, scales, new error)."""
    def one(g, e):
        target = g.float() + e
        q, s = quantize(target)
        return q, s, target - dequantize(q, s)
    return _map(one, grads, error)


def allreduce_compressed(grads: list, errors: list):
    """The compressed mean over W workers: ``grads`` and ``errors`` are W
    trees, worker w's on its device -> (W mean trees, each on its worker's
    device, and the W new errors). Each leaf's int8 payloads are summed as
    int32 (the wire format: W int8 values need log2(W) more bits) and
    dequantized with the largest scale, the reference's ``psum``/``pmax``
    formula."""
    parts = [compress_tree(g, e) for g, e in zip(grads, errors)]
    n = len(parts)
    ops.report_work("allreduce_compressed", collective_bytes=n * sum(
        4 * g.numel() + 4 for g in _leaves(grads[0])))
    home = _leaves(grads[0])[0].device

    def reduce_one(*qs_and_ss):
        qs, ss = qs_and_ss[:n], qs_and_ss[n:]
        total = sum(q.to(home, torch.int32) for q in qs)
        smax = torch.stack([s.to(home) for s in ss]).max()
        return dequantize(total, smax) / n

    mean = _map(reduce_one, *(q for q, _, _ in parts), *(s for _, s, _ in parts))
    outs = [_map(lambda x, g: x.to(g.device), mean, g) for g in grads]
    return outs, [e for _, _, e in parts]


def compressed_bytes(grads) -> int:
    """Wire bytes with compression (int8 payload + one float32 scale a
    tensor)."""
    return sum(g.numel() + 4 for g in _leaves(grads))


def raw_bytes(grads) -> int:
    return sum(g.numel() * 4 for g in _leaves(grads))
