#!/usr/bin/env python3
"""What a kernel's wrapper costs on the host, and the main path's walls,
read from saved ``chip_smoke.py`` outputs, one column per output.

Run from the repository root::

    python3 tools/wrapper_cost.py OLD.log NEW.log [...]

For each kernel case of the last ``{"kernels": ...}`` line it prints the
CUDA-event ``ms`` a call, the ``device_ms`` (the kernel's own profiler
time) where the case measured it, their difference in microseconds (the
host's share of a call: the wrapper, the device guard, the launch), and
the ``host_us`` the case printed. Then the sums over the 22 queries of
phase 5's median walls, at W=1 (``Q<n> SF ...: gpu [...]``) and at W=4
over ICI (``Q<n> SF ... W=4 ici: gpu [...]``).
"""

from __future__ import annotations

import json
import re
import statistics
import sys

_WALLS = {
    "W=1": re.compile(r"^Q(\d+) SF [\d.]+: gpu \[([^\]]*)\] s"),
    "W=4 ici": re.compile(r"^Q(\d+) SF [\d.]+ W=4 ici: gpu \[([^\]]*)\] s"),
}


def read(path: str):
    """(kernel name -> its entry of the kernels line, walls -> {query:
    median wall}) of one ``chip_smoke.py`` output."""
    kernels, walls = {}, {k: {} for k in _WALLS}
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith('{"kernels": '):
                kernels = {k["name"]: k for k in json.loads(line)["kernels"]}
            for kind, pat in _WALLS.items():
                m = pat.match(line)
                if m:
                    times = [float(x) for x in m.group(2).split(",")]
                    walls[kind][int(m.group(1))] = statistics.median(times)
    return kernels, walls


def main(paths) -> None:
    runs = [read(p) for p in paths]
    print("kernel\t" + "\t".join(paths))
    names = list(dict.fromkeys(n for k, _ in runs for n in k))
    for name in names:
        cells = []
        for kernels, _ in runs:
            k = kernels.get(name)
            if k is None:
                cells.append("-")
                continue
            cell = f"ms {k['ms']:.4f}"
            if "device_ms" in k:
                cell += (f" device {k['device_ms']:.4f} host "
                         f"{(k['ms'] - k['device_ms']) * 1e3:.1f} us")
            if "host_us" in k:
                cell += f" printed host_us {k['host_us']:.1f}"
            cells.append(cell)
        print(name + "\t" + "\t".join(cells))
    for kind in _WALLS:
        sums = [f"{sum(w[kind].values()):.4f} s over {len(w[kind])}"
                for _, w in runs]
        print(f"phase 5 {kind} sum of median walls\t" + "\t".join(sums))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
