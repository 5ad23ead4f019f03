"""The near-tie rule for top-k routing, within the port (no JAX): a run
of the port with each MoE call's experts set to another run's, recording
the experts it would have chosen itself.

Top-k routing is discrete. Two runs that round bfloat16 differently (the
reference and the port, the card and the CPU, decode and ``forward``)
may send a token whose k-th and (k+1)-th router probabilities are nearly
equal to other experts, and its hidden state then differs by O(1), as do
those of the later tokens that attend to it. So the second run takes the
first's experts at every MoE call (``forced``, through
``moe_a2a._gate``: its weights are still its own probabilities) and
records its own choices. Every choice of its own that differs must be a
near tie: the first run's gap between the k-th and (k+1)-th probability
below the test's margin (``Routed.check``). The outputs then compare at
every position. ``tests/torch_lm_routing.py`` runs the reference first;
``chip_smoke.py`` runs the card on the CPU's routing, and decode on the
forward's.
"""

import contextlib

import numpy as np
import torch

from repro_torch.models import moe_a2a


class Routed:
    """``ref``: the first run's router probabilities [N, E] a call, in
    call order; ``own``: the experts [N, k] the second run chose itself a
    call; ``used``: the second run's calls so far; ``drift``: the largest
    difference between the two runs' router probabilities."""

    def __init__(self, k, ref=()):
        self.k, self.ref, self.own, self.used = k, list(ref), [], 0
        self.drift = 0.0

    def ref_topi(self, i):
        """The first run's experts at call i: the heavier first, the lower
        index first on a tie (``lax.top_k``'s order)."""
        return np.argsort(-self.ref[i], axis=-1, kind="stable")[:, :self.k]

    def flips(self):
        """(tokens whose own experts differ, the largest such reference
        gap between the k-th and (k+1)-th probability)."""
        n, worst = 0, 0.0
        for i, own in enumerate(self.own):
            want = np.sort(self.ref_topi(i), axis=-1)
            flip = (want != np.sort(own, axis=-1)).any(-1)
            sp = np.sort(self.ref[i], axis=-1)[:, ::-1]
            gap = sp[:, self.k - 1] - sp[:, self.k]
            n += int(flip.sum())
            worst = max([worst] + [float(g) for g in gap[flip]])
        return n, worst

    def failure(self, margin, what):
        """What breaks the rule, or None."""
        if not self.used == len(self.ref) == len(self.own) > 0:
            return (f"{what}: {len(self.ref)} MoE calls recorded, "
                    f"{self.used} forced")
        n, worst = self.flips()
        if not worst < margin:
            return (f"{what}: {n} routing choices differ, one with a gap of "
                    f"{worst:.3g} >= the near-tie margin {margin}")
        return None

    def check(self, margin, what):
        msg = self.failure(margin, what)
        assert msg is None, msg

    def summary(self, margin) -> str:
        n, worst = self.flips()
        tokens = sum(len(own) for own in self.own)
        return (f"routing on the first run's: {n} of {tokens} token choices "
                f"of its own differ, largest gap {worst:.3g} (margin "
                f"{margin}), router probabilities within {self.drift:.3g}")


@contextlib.contextmanager
def recorded():
    """While entered, records the router probabilities [N, E] of each of
    the port's MoE calls: yields the list."""
    probs = []
    gate = moe_a2a._gate

    def record(flat, router, k):
        out = gate(flat, router, k)
        probs.append(out[0].detach().cpu().numpy())
        return out

    moe_a2a._gate = record
    try:
        yield probs
    finally:
        moe_a2a._gate = gate


@contextlib.contextmanager
def forced(rec):
    """While entered, the port's i-th MoE call takes ``rec.ref_topi(i)``
    as its experts and records its own in ``rec.own``."""
    port_gate = moe_a2a._gate

    def port_gate_forced(flat, router, k):
        probs, _, own = port_gate(flat, router, k)
        rec.own.append(own.detach().cpu().numpy())
        rec.drift = max(rec.drift, float(np.abs(
            probs.detach().cpu().numpy() - rec.ref[rec.used]).max()))
        topi = torch.from_numpy(rec.ref_topi(rec.used)).to(own.device)
        rec.used += 1
        topw = probs.gather(-1, topi)
        return probs, topw / topw.sum(dim=-1, keepdim=True), topi

    moe_a2a._gate = port_gate_forced
    try:
        yield rec
    finally:
        moe_a2a._gate = port_gate


def decode_on_forward_routing(model, tok):
    """The port's ``forward`` over ``tok`` [B, S], then its decode from
    empty caches one token at a time on the forward's routing (which the
    decode's own choices must match but for near ties, ``Routed.check``):
    (forward logits [B, S, V], the last step's logits [B, 1, V], the
    ``Routed``)."""
    b, s = tok.shape
    with recorded() as probs, torch.no_grad():
        full, _ = model.forward({"tokens": tok})
    rec = Routed(model.cfg.top_k)
    rec.ref = [p.reshape(b, s, -1)[:, t] for t in range(s) for p in probs]
    caches = model.init_caches(b, s)
    with forced(rec):
        for pos in range(s):
            logits, caches = model.decode_step(tok[:, pos:pos + 1], caches,
                                               pos)
    return full, logits, rec
