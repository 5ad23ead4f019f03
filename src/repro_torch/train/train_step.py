"""train_step: loss -> grads -> AdamW, with microbatch gradient accumulation;
the port of ``repro/train/train_step.py``.

A ``TrainState`` holds the parameters as a dict of tensors keyed by the
model's parameter names, apart from the model's own ``nn.Parameter``s: the
step runs the model through ``torch.func.functional_call`` on the state's
tensors and takes the gradients with ``torch.autograd.grad``, so a step
writes nothing in place and a state stays valid after it was stepped (the
training loop restarts from one). Gradients come from autograd through the
model's plain-torch forward, the counterpart of the reference's jnp
autodiff: no Pallas kernel of the reference has a backward.

With ``microbatches > 1`` each microbatch's gradients (in the parameter's
dtype, bfloat16 for the weights) are added into float32 sums, which are
multiplied by ``1 / microbatches`` once, as the reference's scan does; the
loss is the mean of the microbatches' losses. Everything a step returns
stays on the device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..models import transformer
from ..models.model import LMModel
from .optimizer import AdamWState, adamw_init, adamw_update


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt: AdamWState


def train_state_init(model: LMModel) -> TrainState:
    """The model's current weights (detached views of its parameters, which
    no step writes) and zero moments."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    return TrainState(params, adamw_init(params))


def make_train_step(model: LMModel, *, microbatches: int = 1,
                    base_lr: float = 3e-4, total_steps: int = 10_000):
    """Returns train_step(state, batch) -> (state, metrics), metrics
    ``loss``, ``lr`` and ``grad_norm`` as 0-d float32 device tensors."""

    def value_and_grad(params, batch):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            logits, aux = torch.func.functional_call(model, leaves, (batch,))
            loss = transformer.loss_of(logits, aux, batch)
            # a leaf the loss does not read (the embedding of a model fed
            # embeddings) gets zeros, as the reference's jax.grad gives it
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), dict(zip(leaves, grads))

    def grads_of(params, batch):
        if microbatches == 1:
            return value_and_grad(params, batch)
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"make_train_step: a batch of {b} does not split "
                             f"into {microbatches} microbatches")
        size = b // microbatches
        loss_sum = None
        g_sum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        for i in range(microbatches):
            mb = {k: x[i * size:(i + 1) * size] for k, x in batch.items()}
            loss, g = value_and_grad(params, mb)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            torch._foreach_add_(list(g_sum.values()), list(g.values()))
            del g
        inv = 1.0 / microbatches
        torch._foreach_mul_(list(g_sum.values()), inv)
        return loss_sum * inv, g_sum

    def train_step(state: TrainState, batch):
        loss, grads = grads_of(state.params, batch)
        params, opt, info = adamw_update(state.params, grads, state.opt,
                                         base_lr=base_lr,
                                         total_steps=total_steps)
        return TrainState(params, opt), {"loss": loss, **info}

    return train_step
