"""Production-mesh dry run on ``meta``: the port of
``repro/launch/dryrun.py``.

For each (arch x shape x mesh) cell this builds the model's full CONFIG on
the ``meta`` device (no memory, no compile, no card), places its
parameters by the sharding policy on ``make_production_mesh`` (16 x 16 or
2 x 16 x 16 positions, all ``meta``), and counts one step under
``launch.roofline.count_program``: train is the loss, its backward and
``adamw_update``; prefill is ``prefill``; decode is one ``decode_step``
over a full cache (``pos = seq_len - 1``, the work of the reference's
traced position at its largest). The policy is active during the step, so
a MoE layer takes ``moe_a2a``'s path across the tp positions. The record
keeps the reference's keys where they mean the same thing and adds
``counted_flops`` / ``counted_bytes`` (the whole program's count, in
place of ``hlo_flops`` / ``hlo_bytes``), ``placed_param_bytes_per_chip``
(the largest position's parameter bytes under the policy: the real fit),
``count_seconds`` and ``counted_collective_bytes`` (the MoE all-reduce's).
``collective_bytes`` is null with its reason: no whole-model collective
runs in the port. The roofline terms divide the whole program's count by
the positions (the reference divides a per-device program's by one).

Records go to ``results/dryrun_torch/<cell>.json`` so the sweep resumes;
``python -m repro_torch.launch.dryrun --arch qwen2_1_5b --shape
decode_32k`` runs one cell, no flags every outstanding one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from ..configs.base import ARCH_IDS, SHAPES, applicable_shapes, get_config
from ..models import build_model
from ..models import sharding as shp
from ..train.train_step import make_train_step, train_state_init
from . import roofline as rf
from .mesh import axes_of, make_production_mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
NO_COLLECTIVES = ("the port runs a whole model on one process's devices; "
                  "no collective of a sharded step runs, so none is "
                  "counted")


def _cell_path(arch, shape, mesh_name):
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh_name}.json")


def _nbytes(tree) -> int:
    total = [0]
    shp.tree_map(lambda _, x: total.__setitem__(
        0, total[0] + x.numel() * x.element_size()), tree)
    return total[0]


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               zero_stage: int = 3):
    """Place and count one cell on ``meta``; returns the roofline
    record."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    axes = dataclasses.replace(axes_of(mesh), zero_stage=zero_stage)
    chips = mesh.size
    model = build_model(cfg, device="meta")
    state = train_state_init(model)
    p_shard = shp.params_shardings(state.params, axes, mesh)
    in_specs = model.input_specs(shape)

    with shp.use_axes(axes, mesh):
        if shape.kind == "train":
            step = make_train_step(model)

            def program():
                step(state, in_specs)
        elif shape.kind == "prefill":
            def program():
                model.prefill(in_specs)
        else:
            caches = model.cache_specs(shape)

            def program():
                model.decode_step(in_specs["tokens"], caches,
                                  shape.seq_len - 1)

        t0 = time.time()
        counts = rf.count_program(program)
        count_s = time.time() - t0

    flops, nbytes = counts["flops"], counts["bytes_accessed"]
    coll = counts["collective_bytes"]
    terms = rf.roofline_terms(flops, nbytes, coll, chips=chips)
    mf = rf.model_flops(cfg, shape)
    param_bytes = _nbytes(state.params)
    opt_bytes = 2 * sum(p.numel() * 4 for p in state.params.values())
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": int(chips),
        "kind": shape.kind,
        "count_seconds": round(count_s, 1),
        "counted_flops": flops,
        "counted_bytes": nbytes,
        "counted_collective_bytes": coll,
        "collective_bytes": None,
        "collective_bytes_reason": NO_COLLECTIVES,
        "roofline": terms,
        "dominant": rf.dominant(terms),
        "model_flops": mf,
        "model_flops_per_chip": mf / chips,
        "useful_flops_ratio": (mf / flops) if flops else None,
        "param_bytes_global": int(param_bytes),
        "param_bytes_per_chip": int(param_bytes / chips),
        "placed_param_bytes_per_chip": shp.placed_bytes(state.params,
                                                        p_shard),
        "state_bytes_per_chip": int((param_bytes + (opt_bytes if
                                     shape.kind == "train" else 0)) / chips),
    }


def run_cell(arch, shape_name, mesh_name, force=False):
    path = _cell_path(arch, shape_name, mesh_name)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f), True
    os.makedirs(RESULTS_DIR, exist_ok=True)
    try:
        rec = lower_cell(arch, shape_name, mesh_name == "2x16x16")
    except Exception as e:  # noqa: BLE001
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec, False


def all_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name in applicable_shapes(cfg):
            for mesh_name in ("16x16", "2x16x16"):
                yield arch, shape_name, mesh_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "16x16", "2x16x16"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    failures = 0
    for arch, shape_name, mesh_name in all_cells():
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape_name != args.shape:
            continue
        if args.mesh and mesh_name != args.mesh:
            continue
        t0 = time.time()
        rec, cached = run_cell(arch, shape_name, mesh_name, args.force)
        status = "cached" if cached else f"{time.time()-t0:.0f}s"
        if "error" in rec:
            failures += 1
            print(f"[FAIL {status}] {arch} {shape_name} {mesh_name}: "
                  f"{rec['error'][:200]}", flush=True)
        else:
            t = rec["roofline"]
            print(f"[ok {status}] {arch} {shape_name} {mesh_name} "
                  f"dom={rec['dominant'][:-2]} "
                  f"c={t['compute_s']:.3g} m={t['memory_s']:.3g} "
                  f"x={t['collective_s']:.3g}", flush=True)
    print(f"done, failures={failures}")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
