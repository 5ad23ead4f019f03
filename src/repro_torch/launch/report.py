"""Tables of the dry run's records: the port of ``repro/launch/report.py``,
over ``results/dryrun_torch/*.json`` (``launch.dryrun``) and
``results/perf_torch/*.json``, printed to stdout::

    PYTHONPATH=src python -m repro_torch.launch.report

The reference's ``--write`` into ``EXPERIMENTS.md`` has no counterpart:
the port's results are reported in ``PERF.md``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

HERE = os.path.dirname(__file__)
DRYRUN = os.path.join(HERE, "..", "..", "..", "results", "dryrun_torch")
PERF = os.path.join(HERE, "..", "..", "..", "results", "perf_torch")

ARCH_ORDER = ["seamless_m4t_large_v2", "qwen2_1_5b", "phi4_mini_3_8b",
              "granite_3_8b", "granite_34b", "pixtral_12b", "dbrx_132b",
              "deepseek_moe_16b", "xlstm_125m", "jamba_v0_1_52b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

MOVE_HINT = {
    "compute_s": "tensor-core kernels for the plain-torch products and "
                 "fewer redundant flops (recompute, attention masking)",
    "memory_s": "fusing the elementwise chains (norms, activations, casts) "
                "into the kernels to cut HBM round trips",
    "collective_s": "reducing exchanged volume over NVLink (compaction, "
                    "ZeRO stage, the a2a's one all-reduce)",
}


def _load(d: str) -> List[dict]:
    out = []
    if not os.path.isdir(d):
        return out
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                out.append(json.load(fh))
    return out


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x:.2e}"
    return f"{x:.4f}"


def _sig(x: float) -> str:
    return f"{x:.3g}"


def dryrun_section(cells: List[dict]) -> str:
    rows = ["### Count/fit summary (every cell, both meshes)", "",
            "| arch | shape | mesh | chips | count_s | params/chip | "
            "state/chip (train) | collective kinds present |",
            "|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            for mesh in ("16x16", "2x16x16"):
                rec = next((c for c in cells if c["arch"] == arch
                            and c["shape"] == shape and c["mesh"] == mesh),
                           None)
                if rec is None:
                    continue
                if "error" in rec:
                    rows.append(f"| {arch} | {shape} | {mesh} | - | FAILED: "
                                f"{rec['error'][:60]} | | | |")
                    continue
                # the reference's abbreviation of the one collective
                kinds = ("areduce" if rec.get("counted_collective_bytes")
                         else "")
                rows.append(
                    f"| {arch} | {shape} | {mesh} | {rec['chips']} | "
                    f"{rec['count_seconds']} | "
                    f"{rec['param_bytes_per_chip'] / 1e9:.2f} GB | "
                    f"{rec['state_bytes_per_chip'] / 1e9:.2f} GB | "
                    f"{kinds or '-'} |")
    return "\n".join(rows)


def roofline_section(cells: List[dict]) -> str:
    rows = ["### Roofline terms (single-pod 16x16, 256 chips; seconds/step)",
            "",
            "| arch | shape | compute | memory | collective | dominant | "
            "MODEL_FLOPS | useful/counted | next lever |",
            "|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            rec = next((c for c in cells if c["arch"] == arch
                        and c["shape"] == shape and c["mesh"] == "16x16"
                        and "error" not in c), None)
            if rec is None:
                continue
            t = rec["roofline"]
            ratio = rec.get("useful_flops_ratio")
            rows.append(
                f"| {arch} | {shape} | {_fmt_s(t['compute_s'])} | "
                f"{_fmt_s(t['memory_s'])} | {_fmt_s(t['collective_s'])} | "
                f"{rec['dominant'][:-2]} | {_sig(rec['model_flops'])} | "
                f"{ratio:.3f} | {MOVE_HINT[rec['dominant']]} |")
    return "\n".join(rows)


def perf_section(cells: List[dict]) -> str:
    rows = ["| cell | variant | compute | memory | collective | "
            "collective bytes | counted flops |",
            "|---|---|---|---|---|---|---|"]
    order = ["recurrent", "chunkwise", "zero3", "zero1", "zero3_remat",
             "gspmd_cap1.25", "gspmd_cap1.0", "explicit_a2a"]
    cells = sorted(cells, key=lambda c: (c["arch"],
                                         order.index(c["variant"])
                                         if c["variant"] in order else 99))
    for rec in cells:
        t = rec["roofline"]
        rows.append(
            f"| {rec['arch']}/{rec['shape']} | {rec['variant']} | "
            f"{_fmt_s(t['compute_s'])} | {_fmt_s(t['memory_s'])} | "
            f"{_fmt_s(t['collective_s'])} | "
            f"{_sig(rec['counted_collective_bytes'])} | "
            f"{_sig(rec['counted_flops'])} |")
    return "\n".join(rows)


def tables() -> Dict[str, str]:
    dr = _load(DRYRUN)
    pf = _load(PERF)
    return {"dryrun": dryrun_section(dr), "roofline": roofline_section(dr),
            "perf": perf_section(pf)}


if __name__ == "__main__":
    for k, v in tables().items():
        print(f"\n<!-- {k} -->\n{v}\n")
