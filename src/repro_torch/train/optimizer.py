"""AdamW with float32 moments, a cosine schedule and global-norm clipping:
the port of ``repro/train/optimizer.py``.

Parameters, gradients and moments are dicts of tensors keyed by parameter
name. The moments are float32 whatever the parameter's dtype, and the
update is computed in float32 and cast once to the parameter's dtype, as
the reference does (``torch.optim.AdamW`` keeps its moments in the
parameter's dtype and decays the parameter before the update, so it is a
different result). Weight decay applies to every leaf, norm scales too.

The step counter, the lr, the clip scale and the bias corrections are
0-d tensors on the parameters' device, so an update never reads a value
back to the host. ``adamw_update`` is functional: it returns new tensors
and leaves its inputs as they were (a training loop may restart from a
state it already stepped). The elementwise work runs as ``torch._foreach``
ops over groups of leaves of at most ``_GROUP_ELEMS`` elements, which
bounds the float32 temporaries a group needs.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch

# elements of one group of leaves in the update (1 GiB of float32)
_GROUP_ELEMS = 1 << 28


class AdamWState(NamedTuple):
    step: torch.Tensor                 # 0-d int32 on the parameters' device
    m: Dict[str, torch.Tensor]         # float32, keyed by parameter name
    v: Dict[str, torch.Tensor]


def adamw_init(params: Dict[str, torch.Tensor]) -> AdamWState:
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device), zeros,
                      {k: z.clone() for k, z in zeros.items()})


def lr_schedule(step: torch.Tensor, base_lr: float = 3e-4, warmup: int = 100,
                total: int = 10_000) -> torch.Tensor:
    """Linear warmup to ``base_lr``, then a cosine down to a tenth of it,
    as a float32 tensor on ``step``'s device."""
    step = step.float()
    warm = step / warmup
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    return base_lr * torch.where(step < warmup, warm, 0.1 + 0.9 * cos)


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                   for g in tree.values()]).sum())


def _groups(keys: List[str], sizes: List[int]) -> List[List[str]]:
    """``keys`` in order, cut into runs of at most ``_GROUP_ELEMS``
    elements (a larger leaf is a run of its own)."""
    out, run, n = [], [], 0
    for k, size in zip(keys, sizes):
        if run and n + size > _GROUP_ELEMS:
            out.append(run)
            run, n = [], 0
        run.append(k)
        n += size
    return out + [run] if run else out


def _update_group(ps, gs, ms, vs, scale, lr, mhat_c, vhat_c, *, b1, b2, eps,
                  weight_decay):
    """One group's new (params, m, v), each product rounded as the
    reference rounds it: ``b1 * m + (1 - b1) * g``, ``b2 * v + (1 - b2) *
    g * g``, ``(m * mhat_c) / (sqrt(v * vhat_c) + eps) + wd * p``."""
    g = torch._foreach_mul([x.float() for x in gs], scale)
    m = torch._foreach_mul(ms, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    g2 = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(g2, g)
    v = torch._foreach_mul(vs, b2)
    torch._foreach_add_(v, g2)
    del g, g2
    u = torch._foreach_mul(m, mhat_c)
    den = torch._foreach_mul(v, vhat_c)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(u, den)
    del den
    pf = [p.float() for p in ps]
    torch._foreach_add_(u, torch._foreach_mul(pf, weight_decay))
    torch._foreach_mul_(u, lr)
    new = torch._foreach_sub(pf, u)
    return [x.to(p.dtype) for x, p in zip(new, ps)], m, v


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, base_lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip: float = 1.0,
                 warmup: int = 100, total_steps: int = 10_000):
    """-> (new params, new ``AdamWState``, {"lr", "grad_norm"}), all on the
    parameters' device."""
    step = state.step + 1
    lr = lr_schedule(step, base_lr, warmup, total_steps)
    gnorm = global_norm(grads)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    t = step.float()
    mhat_c = 1.0 / (1 - b1 ** t)
    vhat_c = 1.0 / (1 - b2 ** t)
    keys = list(params)
    new_p, new_m, new_v = {}, {}, {}
    for group in _groups(keys, [params[k].numel() for k in keys]):
        ps, m, v = _update_group(
            [params[k] for k in group], [grads[k] for k in group],
            [state.m[k] for k in group], [state.v[k] for k in group],
            scale, lr, mhat_c, vhat_c, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay)
        new_p.update(zip(group, ps))
        new_m.update(zip(group, m))
        new_v.update(zip(group, v))
    return new_p, AdamWState(step, new_m, new_v), {"lr": lr,
                                                  "grad_norm": gnorm}
