"""Kernel dispatch accounting and launch counters.

The port has no backend switch: it always takes the code path that the
reference takes under ``kernel_backend="pallas"``. Each kernel wrapper
launches its CUDA kernel for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor.

Two kinds of counts are kept:

* **Dispatch accounting** (``collect_dispatches`` / ``table_op``), as the
  reference's ``kernels/ops.py`` keeps it: each operator call adds one per
  kernel *kind* it used, whichever device it ran on,
  so ``executor_stats()['kernel_dispatch']`` compares with the reference's
  ``pallas`` run (kinds ``fused``, ``fused_batch``, ``agg``, ``build``,
  ``probe``, ``compact``).
* **Launch counters** (``count_launch`` / ``launch_counts``): one plain
  integer per kernel wrapper, raised only where a CUDA kernel is actually
  launched. A run on the card reads them to show that its main path went
  through the kernels.
* **Work reports** (``reports`` / ``report_work``): under
  ``launch.roofline.count_program`` each wrapper reports the operations
  and bytes of its kernel (its module's closed form) and runs its body
  hidden from the count (``hidden_work``), whichever device it runs on.

``flash_attention`` is the public entry point of the attention kernel, as
the reference's ``ops.flash_attention`` is: it records the kind
``attention`` and forwards to ``kernels.flash_attention``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, Iterator, Set

_tls = threading.local()

# ---------------------------------------------------------------------------
# dispatch accounting (per operator call, per kind)
# ---------------------------------------------------------------------------


def _stack(name: str) -> list:
    s = getattr(_tls, name, None)
    if s is None:
        s = []
        setattr(_tls, name, s)
    return s


@contextlib.contextmanager
def collect_dispatches(counts: Dict[str, int]) -> Iterator[None]:
    """Accumulate kernel-dispatch counts into ``counts`` (kind -> calls)
    for the duration of the scope; the driver wraps each query with this."""
    stack = _stack("counter_stack")
    stack.append(counts)
    try:
        yield
    finally:
        stack.pop()


def count_dispatch(kind: str, n: int = 1) -> None:
    """Report ``n`` calls of kernel ``kind`` to every active
    ``collect_dispatches`` scope on this thread (no-op outside one)."""
    for counts in _stack("counter_stack"):
        counts[kind] = counts.get(kind, 0) + n


@contextlib.contextmanager
def record_kernels(used: Set[str]) -> Iterator[None]:
    """While active, every kernel wrapper call adds its kind to ``used``."""
    stack = _stack("record_stack")
    stack.append(used)
    try:
        yield
    finally:
        stack.pop()


def mark_kernel(kind: str) -> None:
    """Record that the running operator call used a kernel of ``kind``."""
    for used in _stack("record_stack"):
        used.add(kind)


def table_op(fn):
    """Count one dispatch per kernel kind per call of the operator body
    ``fn`` (the reference's ``table_op`` replays its traced kernel set per
    call; the port runs eagerly, so it records the set as it runs)."""

    @functools.wraps(fn)
    def wrapper(*args):
        used: Set[str] = set()
        with record_kernels(used):
            out = fn(*args)
        for kind in sorted(used):
            count_dispatch(kind)
        return out

    return wrapper


# ---------------------------------------------------------------------------
# launch counters (per CUDA kernel wrapper)
# ---------------------------------------------------------------------------

KERNELS = ("fused_morsel_program", "segmented_sum", "segmented_int_sum",
           "build_table", "hash_probe", "fused_morsel_probe",
           "segmented_minmax", "block_prefix_sum", "hash_probe_multi",
           "radix_histogram", "fused_batch_program", "flash_attention")
_launches: Dict[str, int] = {k: 0 for k in KERNELS}
_launch_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to ``name``'s counter; called right after its CUDA launch."""
    with _launch_lock:
        _launches[name] += 1


# the fused kernels' instructions whose launches are counted on their own,
# per kernel: one for each launch of a program that holds the instruction,
# under "kernel.INSTRUCTION"
INSTRUCTIONS = ("YEAR", "BYTESMATCH")
_FUSED = ("fused_morsel_program", "fused_morsel_probe", "fused_batch_program")
_instr_launches: Dict[str, int] = {f"{k}.{i}": 0 for k in _FUSED
                                   for i in INSTRUCTIONS}


def count_instruction_launch(kernel: str, name: str) -> None:
    """Add one to ``kernel.name``'s counter: a launch of fused kernel
    ``kernel`` ran instruction ``name``."""
    with _launch_lock:
        _instr_launches[f"{kernel}.{name}"] += 1


def instruction_launches() -> Dict[str, int]:
    """``kernel.INSTRUCTION`` -> the launches of that fused kernel that ran
    the instruction since the last reset."""
    with _launch_lock:
        return dict(_instr_launches)


def reset_launch_counts() -> None:
    """Set every kernel's and instruction's launch counter to 0."""
    with _launch_lock:
        for k in _launches:
            _launches[k] = 0
        for k in _instr_launches:
            _instr_launches[k] = 0


def launch_counts() -> Dict[str, int]:
    """Kernel name -> CUDA launches since the last reset."""
    with _launch_lock:
        return dict(_launches)


# ---------------------------------------------------------------------------
# public kernel entry points
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, causal=True, **kw):
    """Blocked flash attention: [B, H, S, D] -> [B, H, S, D]; ``kw`` are
    ``block_q`` and ``block_k`` (see ``kernels.flash_attention``)."""
    from .flash_attention import flash_attention as _flash
    mark_kernel("attention")
    return _flash(q, k, v, causal=causal, **kw)


# ---------------------------------------------------------------------------
# work reports (``launch.roofline.count_program``)
# ---------------------------------------------------------------------------
#
# A kernel launched through ctypes is invisible to a dispatch mode, so each
# wrapper reports the work its kernel does (the closed form in its module's
# docstring: the reckoning of its row's bound in PERF.md) to every active
# count, and runs its body hidden: a count then ignores the ATen ops of the
# plain version (on the CPU or ``meta``) and of the wrapper's own
# allocations, and a program counts the same on every device. The counts
# live here, not in ``launch``, so that ``kernels`` imports nothing above it.


@contextlib.contextmanager
def collect_work(sink) -> Iterator[None]:
    """While entered, ``report_work`` calls ``sink(name, flops, nbytes,
    collective_bytes)`` on this thread."""
    stack = _stack("work_stack")
    stack.append(sink)
    try:
        yield
    finally:
        stack.pop()


def counting_work() -> bool:
    """True when a count is active and its ops are not hidden."""
    return bool(_stack("work_stack")) and not work_hidden()


def work_hidden() -> bool:
    """True inside ``hidden_work``: an active count ignores the ATen ops."""
    return getattr(_tls, "hidden", 0) > 0


@contextlib.contextmanager
def hidden_work() -> Iterator[None]:
    """Hide the ATen ops of the block, and the reports of the wrappers it
    calls, from every active count (the reporting wrapper's report stands
    for them)."""
    _tls.hidden = getattr(_tls, "hidden", 0) + 1
    try:
        yield
    finally:
        _tls.hidden -= 1


def report_work(name: str, flops: float = 0, nbytes: float = 0,
                collective_bytes: float = 0) -> None:
    """Add a kernel's (or a collective's) work to every active count; a
    no-op outside one or inside ``hidden_work``."""
    if work_hidden():
        return
    for sink in _stack("work_stack"):
        sink(name, flops, nbytes, collective_bytes)


def reports(name: str, work):
    """Decorate a kernel wrapper: under an active count it reports
    ``work(*args, **kw)`` -> (flops, bytes) as ``name`` and runs hidden;
    otherwise it only runs."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not counting_work():
                return fn(*args, **kw)
            flops, nbytes = work(*args, **kw)
            report_work(name, flops, nbytes)
            with hidden_work():
                return fn(*args, **kw)

        return wrapper

    return deco
