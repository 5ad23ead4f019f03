#!/usr/bin/env python3
"""Device time and launches of the port's kernels, summed over the
per-query profiles that ``chip_smoke.py --profile DIR`` writes
(``profile_q<N>.json`` at one worker, ``profile_w4_q<N>.json`` at four).

Run from the repository root::

    python3 tools/profile_totals.py DIR

Prints one JSON line per kernel family, with its launches and device
microseconds at W=1, at W=4 and in all, the families in order of their
total, then one line with the device busy time of all kernels and copies
at each W. A family is the kernel symbols that one port kernel's calls
launch (``build_table``'s passes and rounds are one).
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys

# family -> the pattern its kernel symbols match, as torch.profiler names
# them
FAMILIES = {
    "segmented_sum_kernel<float, false>": r"segmented_sum_kernel<float, false>",
    "segmented_sum_kernel<int, false>": r"segmented_sum_kernel<int, false>",
    "segmented_sum_kernel<*, true>": r"segmented_sum_kernel<\w+, true>",
    "build_table": r"::(build_\w+|hash_build_\w+)_kernel\(",
    "hash_probe_kernel": r"::hash_probe_kernel\(",
    "fused_morsel_kernel": r"::fused_morsel_kernel\(",
    "radix_histogram": r"::histogram_(shared|global)_kernel\("
                       r"|partition_histogram_kernel<",
    "hash_probe_multi_kernel": r"::hash_probe_multi_(staged_|slots_)?"
                               r"kernel[<(]",
    # the fill and the reduction, and an earlier tree's key map-back
    # kernel, so that its profiles sum alike
    "segmented_minmax": r"segmented_minmax_kernel<|::fill_kernel\(int\*"
                        r"|::keys_to_f32_kernel\(",
    "block_prefix_sum_kernel": r"::block_prefix_sum_kernel\(",
    # torch's int64 arithmetic, bitwise and shift kernels (the exchange's
    # former partition hash ran some twenty of them a key column and
    # source); gathers and scatters with int64 indices are not among them
    "int64 elementwise (torch)": r"elementwise_kernel<(\d+, )?at::native::"
                                 r"(\w+Functor<long, long, long"
                                 r"|CUDAFunctor_add<long>)",
}


def totals(directory: str):
    """{family: {"w1": [launches, us], "w4": [...]}} and {"w1": busy us,
    "w4": ...} over the profiles in ``directory``."""
    out = {f: {"w1": [0, 0.0], "w4": [0, 0.0]} for f in FAMILIES}
    busy = {"w1": 0.0, "w4": 0.0}
    paths = glob.glob(os.path.join(directory, "profile_q*.json"))
    paths += glob.glob(os.path.join(directory, "profile_w4_q*.json"))
    if not paths:
        sys.exit(f"profile_totals: no profile_q*.json in {directory}")
    for path in paths:
        with open(path) as f:
            summary = json.load(f)
        w = "w4" if os.path.basename(path).startswith("profile_w4_") else "w1"
        busy[w] += summary["device_busy_us"]
        for name, count, us in summary["by_kernel"]:
            for family, pattern in FAMILIES.items():
                if re.search(pattern, name):
                    out[family][w][0] += count
                    out[family][w][1] += us
                    break
    return out, busy, len(paths)


def main() -> None:
    if len(sys.argv) != 2:
        sys.exit("usage: tools/profile_totals.py DIR")
    out, busy, n = totals(sys.argv[1])
    for family, by_w in sorted(out.items(),
                               key=lambda kv: -(kv[1]["w1"][1]
                                                + kv[1]["w4"][1])):
        print(json.dumps({"kernel": family,
                          "w1_launches": by_w["w1"][0],
                          "w1_us": round(by_w["w1"][1], 3),
                          "w4_launches": by_w["w4"][0],
                          "w4_us": round(by_w["w4"][1], 3),
                          "total_us": round(by_w["w1"][1] + by_w["w4"][1],
                                            3)}))
    print(json.dumps({"profiles": n, "w1_device_busy_us": round(busy["w1"], 3),
                      "w4_device_busy_us": round(busy["w4"], 3)}))


if __name__ == "__main__":
    main()
