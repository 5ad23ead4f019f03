"""``repro_torch.launch.dryrun`` and ``launch.report`` on ``meta`` (the
counterpart of ``tests/test_dryrun.py``): the reference's two cells placed
and counted on the production meshes, the parameter bytes equal to the
reference's ``eval_shape`` sum (shape-only, no compile), a train cell's
count, the sweep's entry point, and the report's rows over two fixed
records equal to the reference's but for the hint text.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.launch import report as ref_report  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, report  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402


def _ref_param_bytes(arch) -> int:
    leaves = jax.tree.leaves(jax.eval_shape(
        lambda: rbuild(rconfigs.get_config(arch)).init(jax.random.key(0))))
    return sum(x.size * x.dtype.itemsize for x in leaves)


def test_single_cell_on_production_mesh():
    """xlstm-125M decode_32k on 16x16 and qwen2-1.5B decode_32k on
    2x16x16, as the reference's test lowers them."""
    rec = dryrun.lower_cell("xlstm_125m", "decode_32k", multi_pod=False)
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["counted_flops"] > 0
    assert rec["roofline"]["memory_s"] > 0
    assert rec["param_bytes_global"] == _ref_param_bytes("xlstm_125m")
    rec2 = dryrun.lower_cell("qwen2_1_5b", "decode_32k", multi_pod=True)
    assert rec2["chips"] == 512
    assert rec2["param_bytes_global"] == _ref_param_bytes("qwen2_1_5b")
    assert rec2["param_bytes_per_chip"] == rec2["param_bytes_global"] // 512
    # the policy's largest position: the replicated norms and the
    # unsharded dims keep it above an even split
    assert rec2["param_bytes_per_chip"] < rec2["placed_param_bytes_per_chip"] \
        < rec2["param_bytes_global"]
    assert rec2["collective_bytes"] is None and rec2["collective_bytes_reason"]
    assert rec2["counted_collective_bytes"] == 0
    assert rec2["roofline"]["collective_s"] == 0
    assert rec2["dominant"] == "memory_s"
    cfg = configs.get_config("qwen2_1_5b")
    assert rec2["model_flops"] == rf.model_flops(
        cfg, configs.SHAPES["decode_32k"])
    assert rec2["useful_flops_ratio"] == rec2["model_flops"] / \
        rec2["counted_flops"]
    for k in ("count_seconds", "model_flops_per_chip",
              "state_bytes_per_chip", "kind"):
        assert k in rec2


def test_train_cell_counts_backward_and_update():
    """A train cell counts the loss, its backward and the AdamW update: at
    least the 6 N tokens of MODEL_FLOPS; its state adds the moments."""
    rec = dryrun.lower_cell("qwen2_1_5b", "train_4k", multi_pod=False)
    assert rec["kind"] == "train"
    assert rec["counted_flops"] >= rec["model_flops"]
    assert rec["state_bytes_per_chip"] > rec["param_bytes_per_chip"]


def test_moe_cell_counts_the_a2a_all_reduce():
    """jamba-v0.1's long_500k decode (one sequence, which dp does not
    split) under the policy runs ``moe_a2a``'s path across the 16 tp
    positions at each of its 16 MoE layers: the all-reduce's result bytes
    at all 256 positions are counted."""
    rec = dryrun.lower_cell("jamba_v0_1_52b", "long_500k", multi_pod=False)
    cfg = configs.get_config("jamba_v0_1_52b")
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert rec["counted_collective_bytes"] == \
        moe_layers * 256 * cfg.d_model * 2
    assert rec["roofline"]["collective_s"] > 0
    assert rec["param_bytes_global"] == _ref_param_bytes("jamba_v0_1_52b")


def test_main_writes_records_and_report_reads_them(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(report, "DRYRUN", str(tmp_path))
    assert dryrun.main(["--arch", "qwen2_1_5b", "--shape", "decode_32k",
                        "--mesh", "16x16"]) == 0
    out = capsys.readouterr().out
    assert "[ok" in out and "done, failures=0" in out
    path = tmp_path / "qwen2_1_5b__decode_32k__16x16.json"
    rec = json.loads(path.read_text())
    assert rec["chips"] == 256
    rec2, cached = dryrun.run_cell("qwen2_1_5b", "decode_32k", "16x16")
    assert cached and rec2 == rec
    t = report.tables()
    assert "| qwen2_1_5b | decode_32k | 16x16 | 256 |" in t["dryrun"]
    assert "| qwen2_1_5b | decode_32k |" in t["roofline"]
    cells = list(dryrun.all_cells())
    assert len(cells) == 2 * sum(len(configs.applicable_shapes(
        configs.get_config(a))) for a in configs.ARCH_IDS)


def test_long_500k_only_for_subquadratic():
    runs_long = {a for a in configs.ARCH_IDS
                 if "long_500k" in configs.applicable_shapes(
                     configs.get_config(a))}
    assert runs_long == {"xlstm_125m", "jamba_v0_1_52b"}


_FIXED = (
    dict(arch="qwen2_1_5b", shape="decode_32k", mesh="16x16", chips=256,
         kind="decode", seconds=0.4, flops=1.1e12, nbytes=6.4e11,
         roofline={"compute_s": 4.4e-06, "memory_s": 7.5e-4,
                   "collective_s": 0.0}, dominant="memory_s",
         model_flops=3.95e11, ratio=0.354, params=6030476, state=6030476),
    dict(arch="granite_34b", shape="prefill_32k", mesh="16x16", chips=256,
         kind="prefill", seconds=2.0, flops=1.2e17, nbytes=1.4e14,
         roofline={"compute_s": 0.423, "memory_s": 0.166,
                   "collective_s": 0.0}, dominant="compute_s",
         model_flops=7.1e16, ratio=0.58, params=265000000, state=265000000),
)


def test_report_rows_match_reference_but_the_hint():
    """The two sections over two fixed records, each as the port's dry run
    writes it and as the reference's does: the same rows, the roofline
    rows but for the last cell (the hint names the card, not the MXU)."""
    mine, ref = [], []
    for f in _FIXED:
        common = dict(arch=f["arch"], shape=f["shape"], mesh=f["mesh"],
                      chips=f["chips"], kind=f["kind"],
                      roofline=f["roofline"], dominant=f["dominant"],
                      model_flops=f["model_flops"],
                      useful_flops_ratio=f["ratio"],
                      param_bytes_per_chip=f["params"],
                      state_bytes_per_chip=f["state"])
        mine.append(dict(common, count_seconds=f["seconds"],
                         counted_flops=f["flops"], counted_bytes=f["nbytes"],
                         counted_collective_bytes=0, collective_bytes=None))
        ref.append(dict(common, compile_seconds=f["seconds"],
                        hlo_flops=f["flops"], hlo_bytes=f["nbytes"],
                        collective_bytes={"all-gather": 0},
                        collective_bytes_total=0))

    def body(text):
        return [r for r in text.splitlines() if r.startswith("| ")
                and not r.startswith("| arch")]

    got = body(report.dryrun_section(mine))
    assert got == body(ref_report.dryrun_section(ref)) and len(got) == 2
    got = body(report.roofline_section(mine))
    want = body(ref_report.roofline_section(ref))
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.split(" | ")[:-1] == w.split(" | ")[:-1]
        assert g.split(" | ")[-1] != w.split(" | ")[-1]
    assert set(report.MOVE_HINT) == set(ref_report.MOVE_HINT)
