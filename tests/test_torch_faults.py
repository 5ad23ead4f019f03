"""``chip_smoke.py``'s card-only tooling against the CUDA sources, on the
CPU: every planted fault of ``--faults`` must still find its text in the
source it edits (``csrc/flash_attention.cu``, ``csrc/hash_table.cu``,
``csrc/fused_interp.cuh``, ``csrc/segmented_agg.cu``,
``csrc/radix_histogram.cu`` or ``csrc/hash_probe.cuh``) as often as it
says, and every kernel symbol
that ``--profile``, phase 3
and phase 9 look for must name a ``__global__`` function of ``csrc/``. A
kernel edit that breaks either shows here, not at the next run on the
card."""

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _chip_smoke()


def _global_functions():
    """Names of the ``__global__`` functions of every ``csrc/*.cu``."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")
    return {m.group(1) for p in CSRC.glob("*.cu")
            for m in pat.finditer(p.read_text())}


@pytest.mark.parametrize("fault", sorted(chip_smoke._FAULTS))
def test_fault_edits_occur_as_often_as_they_say(fault):
    source, _ = chip_smoke.fault_target(fault)
    text = (ROOT / source).read_text()
    for old, new, count in chip_smoke._FAULTS[fault]:
        assert text.count(old) == count, (fault, old)
        assert old != new


@pytest.mark.parametrize("fault", sorted(chip_smoke._FAULT_CASES))
def test_fault_cases_name_phase_9_cases(fault):
    """A fault's cases are cases of the run that must catch it: phase 9's
    for the attention faults, the build checks' for the build's, the fused
    checks' for the fused kernels', the segmented sums' and min/max's
    cases for theirs, the two probes' cases for theirs, the metadata
    pass's and the standalone histogram's grace shapes for theirs."""
    assert fault in chip_smoke._FAULTS
    _, option = chip_smoke.fault_target(fault)
    cases = {"--attention": {c[0] for c in chip_smoke._ATTN_CASES},
             "--build": set(chip_smoke._BUILD_CASES),
             "--fused": set(chip_smoke._FUSED_CASES),
             "--segmented": (set(chip_smoke._SEG_CASES)
                             | set(chip_smoke._MINMAX_CASES)),
             "--probe": (set(chip_smoke._PROBE_CASES)
                         | set(chip_smoke._MULTI_CASES)),
             "--partition": (set(chip_smoke._PART_CASES)
                             | set(chip_smoke._HIST_CASES))}[option]
    assert set(chip_smoke._FAULT_CASES[fault]) <= cases


@pytest.mark.parametrize("symbol", sorted(
    {s for syms in chip_smoke._KERNEL_SYMBOLS.values() for s in syms}
    | set(chip_smoke._PORT_KERNELS)
    | {k for case in chip_smoke._ATTN_CASES for k in case[-1]}))
def test_kernel_symbol_names_a_global_function(symbol):
    assert symbol.partition("<")[0] in _global_functions(), symbol
