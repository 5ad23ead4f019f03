"""Roofline terms of a program on the card: the port of
``repro/launch/roofline.py``.

Terms per program, in seconds::

    compute    = FLOPs            / (chips * PEAK_FLOPS)   dense bfloat16
    memory     = bytes accessed   / (chips * HBM_BW)
    collective = collective bytes / (chips * LINK_BW)      NVLink, a direction

The peaks are the H100 SXM 80GB data sheet's; ``peaks(name)`` gives the
entry of another card by its ``torch.cuda.get_device_name()`` (the first
entry whose key is in the name; the last entry's key, "", is in every
name, and is the H100 SXM's).

``count_program(fn, *args)`` counts one call: a ``TorchDispatchMode`` sees
every ATen op that runs, whatever the device (``meta`` included), and adds

* FLOPs by ``torch.utils.flop_counter``'s formulas (the matrix products
  and convolutions; an elementwise op counts none),
* bytes as each op's tensor operands plus its tensor results, as
  ``repro/launch/hloparse.py`` counts a surface op (an op whose results
  are views of its operands, ``_unsafe_view``, or an ``empty`` allocation,
  moves nothing and counts nothing).

A Python loop runs its body once a trip, so it is counted once a trip: the
job that ``hloparse`` does for the trip counts of ``while`` bodies. A
hand-written kernel is launched through ``ctypes``, which no dispatch mode
sees: each kernel wrapper reports its own work to the count
(``kernels.ops.report_work``; each module's docstring states its closed
form) and runs its body hidden, so the ATen ops of its plain version are
not counted and a program counts the same on ``meta``, on the CPU and on
the card. The port's collectives report their bytes the same way: the
all-reduce of ``models.moe_a2a``'s path across tp positions and
``train.compression.allreduce_compressed``. This replaces the reference's
``cost_analysis()`` and HLO parser; the port has no HLO, so the
reference's ``collective_bytes(hlo_text)`` has no counterpart.

``measure_program(fn, *args)`` holds the counted bound against the call's
measured time: by CUDA events when the program's tensors are on the card,
by ``time.perf_counter`` when the caller chose the CPU::

    from repro_torch.launch import roofline
    rec = roofline.measure_program(lambda b: model.prefill(b), batch)
    rec["achieved_fraction"], rec["dominant"]
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class Peaks:
    """A card's data-sheet rates: dense bfloat16 / float16 tensor-core
    (``bf16``), dense TF32 tensor-core (``tf32``) and float32 outside the
    tensor cores (``f32``), in operations/s; HBM (``hbm``) and NVLink a
    direction (``link``) in bytes/s."""
    key: str
    bf16: float
    tf32: float
    f32: float
    hbm: float
    link: float


# by card name, NVIDIA's data sheets (dense rates), first match wins: the
# PCIe part before the SXM part, whose figures close the table for any
# other name
CARDS = (
    Peaks("H100 PCIe", 756e12, 378e12, 51.2e12, 2.0e12, 300e9),
    Peaks("H200", 989.4e12, 494.7e12, 67e12, 4.8e12, 450e9),
    Peaks("H100", 989.4e12, 494.7e12, 67e12, 3.35e12, 450e9),
    Peaks("", 989.4e12, 494.7e12, 67e12, 3.35e12, 450e9),
)

PEAK_FLOPS = CARDS[-1].bf16       # dense bf16 FLOP/s, H100 SXM 80GB
HBM_BW = CARDS[-1].hbm            # bytes/s
LINK_BW = CARDS[-1].link          # NVLink bytes/s a direction


def peaks(name: str = None) -> Peaks:
    """The entry of the card named ``name`` (None: card 0's name when a
    card is visible, else the H100 SXM's)."""
    if name is None:
        name = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else "")
    return next(p for p in CARDS if p.key in name)


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int, card: Peaks = None) -> Dict[str, float]:
    card = card or CARDS[-1]
    return {
        "compute_s": flops / (chips * card.bf16),
        "memory_s": bytes_accessed / (chips * card.hbm),
        "collective_s": coll_bytes / (chips * card.link),
    }


def dominant(terms: Dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])


# ops that move no byte: allocations, and the view that a product's
# decomposition returns as a fresh tensor
_NO_TRAFFIC = frozenset(torch.ops.aten.__getattr__(n) for n in (
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_unsafe_view"))


def _moves_data(func) -> bool:
    if func.overloadpacket in _NO_TRAFFIC:
        return False
    # a view returns an alias of an operand that it does not write
    return not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(x.numel() * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))


class _Count(TorchDispatchMode):
    """The counts of one ``count_program`` call."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.ops: Dict[str, Dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in flop_registry:
            # a composite (reached as itself under inference mode) is
            # counted by the ops it decomposes into, as outside it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if kernel_ops.work_hidden() or not _moves_data(func):
            return out
        nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        count = flop_registry.get(func.overloadpacket)
        flops = 0 if count is None else int(count(*args, **kwargs,
                                                  out_val=out))
        self.bytes += nbytes
        self.flops += flops
        k = self.ops.setdefault(str(func), {"calls": 0, "flops": 0,
                                            "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        return out

    def report(self, name, flops, nbytes, collective_bytes) -> None:
        self.flops += int(flops)
        self.bytes += int(nbytes)
        self.collective += int(collective_bytes)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0,
                                           "collective_bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        k["collective_bytes"] += int(collective_bytes)


def count_program(fn, *args, **kwargs) -> Dict[str, object]:
    """Count one call of ``fn(*args, **kwargs)`` -> ``{"flops",
    "bytes_accessed", "collective_bytes", "kernels", "ops"}``: the first
    three totals over the call, ``kernels`` each reporting wrapper's (or
    collective's) ``calls``, ``flops``, ``bytes`` and
    ``collective_bytes``, ``ops`` each counted ATen op's ``calls``,
    ``flops`` and ``bytes``."""
    mode = _Count()
    with kernel_ops.collect_work(mode.report), mode:
        fn(*args, **kwargs)
    return {"flops": mode.flops, "bytes_accessed": mode.bytes,
            "collective_bytes": mode.collective, "kernels": mode.kernels,
            "ops": mode.ops}


def _device_of(args) -> torch.device:
    leaves, _ = tree_flatten(args)
    return next((x.device for x in leaves if isinstance(x, torch.Tensor)),
                torch.device("cpu"))


def _time_s(fn, args, kwargs, device, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn(*args, **kwargs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    return (time.perf_counter() - t0) / iters


def measure_program(fn, *args, warmup: int = 1, iters: int = 3,
                    chips: int = 1, **kwargs) -> Dict[str, object]:
    """Roofline against measured time for one program at one shape: the
    reference's keys (``flops``, ``bytes_accessed``, ``collective_bytes``,
    ``roofline_bound_s``, ``measured_s``, ``dominant``,
    ``achieved_fraction``: the bound over the measured time, 1.0 at the
    card's ceiling for the dominant term) and the count's ``kernels`` and
    ``ops``.
    The first tensor among ``args`` picks the clock and, on a card, its
    peaks (the CPU's clock when there is none)."""
    counts = count_program(fn, *args, **kwargs)
    device = _device_of(args)
    card = (peaks(torch.cuda.get_device_name(device))
            if device.type == "cuda" else CARDS[-1])
    terms = roofline_terms(counts["flops"], counts["bytes_accessed"],
                           counts["collective_bytes"], chips, card)
    bound_s = max(terms.values())
    measured_s = _time_s(fn, args, kwargs, device, warmup, iters)
    return {
        "flops": counts["flops"],
        "bytes_accessed": counts["bytes_accessed"],
        "collective_bytes": counts["collective_bytes"],
        "roofline_bound_s": bound_s,
        "measured_s": measured_s,
        "dominant": dominant(terms),
        "achieved_fraction": bound_s / measured_s if measured_s else 0.0,
        "kernels": counts["kernels"],
        "ops": counts["ops"],
    }


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train (fwd+bwd), 2*N*D prefill,
    2*N_active*B decode (one token per sequence)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch
