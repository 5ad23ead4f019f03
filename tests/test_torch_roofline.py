"""``repro_torch.launch.roofline`` on the CPU: the carry-over of
``tests/test_roofline.py::test_roofline_terms_math`` and
``::test_model_flops_definitions`` on the H100's peaks, and
``count_program``: a Python loop counted a trip at a time (the reference's
HLO tests' trip-count weighting), the count on ``meta`` equal to the
count on the CPU, and each kernel wrapper's report equal to the closed
form its module states, with none of its plain version's ATen ops
counted. Counts are exact integers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.configs.base import SHAPES as RSHAPES  # noqa: E402
from repro.launch import roofline as ref_rf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.core import dtypes as dt  # noqa: E402
from repro_torch.core import fused  # noqa: E402
from repro_torch.core.expr import ParamRef, col, lit  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.kernels import block_prefix_sum as bps  # noqa: E402
from repro_torch.kernels import hash_probe as hp  # noqa: E402
from repro_torch.kernels import radix_histogram as rh  # noqa: E402
from repro_torch.kernels import segmented_agg as seg  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import synthetic_batch  # noqa: E402
from repro_torch.train import compression  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")


def test_roofline_terms_math():
    """The H100 SXM 80GB data sheet's peaks; one second of each at 256
    chips; the card table by name, the PCIe part before the SXM part."""
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.LINK_BW) == (989.4e12, 3.35e12,
                                                      450e9)
    t = rf.roofline_terms(flops=rf.PEAK_FLOPS * 256,
                          bytes_accessed=rf.HBM_BW * 256,
                          coll_bytes=rf.LINK_BW * 256, chips=256)
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert abs(t["memory_s"] - 1.0) < 1e-9
    assert abs(t["collective_s"] - 1.0) < 1e-9
    assert rf.dominant({"compute_s": 3, "memory_s": 2, "collective_s": 1}) \
        == "compute_s"
    assert rf.dominant({"compute_s": 1, "memory_s": 2, "collective_s": 1}) \
        == ref_rf.dominant({"compute_s": 1, "memory_s": 2,
                            "collective_s": 1})
    sxm = rf.peaks("NVIDIA H100 80GB HBM3")
    assert (sxm.bf16, sxm.tf32, sxm.f32, sxm.hbm) == (989.4e12, 494.7e12,
                                                      67e12, 3.35e12)
    assert rf.peaks("NVIDIA H100 PCIe").hbm == 2.0e12
    assert rf.peaks("NVIDIA H200").hbm == 4.8e12
    assert rf.peaks("some other card") == rf.CARDS[-1]
    half = rf.roofline_terms(rf.PEAK_FLOPS, 0, 0, 1,
                             rf.peaks("NVIDIA H100 PCIe"))
    assert abs(half["compute_s"] - 989.4 / 756) < 1e-9


def test_model_flops_definitions():
    """Every arch x applicable shape: the reference's MODEL_FLOPS (6 N_active
    tokens train, 2 N_active tokens prefill, 2 N_active batch decode)."""
    for arch in configs.ARCH_IDS:
        cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
        assert configs.applicable_shapes(cfg) == rconfigs.applicable_shapes(
            rcfg)
        for s in configs.applicable_shapes(cfg):
            assert rf.model_flops(cfg, SHAPES[s]) == ref_rf.model_flops(
                rcfg, RSHAPES[s]), (arch, s)
    cfg = configs.get_config("deepseek_moe_16b")
    assert rf.model_flops(cfg, SHAPES["train_4k"]) == \
        6.0 * cfg.active_param_count() * SHAPES["train_4k"].tokens
    assert cfg.active_param_count() < 0.25 * cfg.param_count()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_python_loops_count_each_trip(device):
    """8 layers of ``tanh(x @ w)`` count 8 x 2mnk FLOPs and each product's
    and tanh's operands and results; a 3 x 5 nested loop 15 x 2mnk."""
    d, m = 128, 32
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(m, d, generator=gen).to(device)
    ws = torch.randn(8, d, d, generator=gen).to(device)

    def layers(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x

    c = rf.count_program(layers, x, ws)
    assert c["flops"] == 8 * 2 * m * d * d
    assert c["bytes_accessed"] == 8 * 4 * (m * d + d * d + m * d + 2 * m * d)
    assert c["ops"]["aten.mm.default"]["calls"] == 8
    assert c["kernels"] == {} and c["collective_bytes"] == 0

    def nested(x, ws):
        for g in range(3):
            for i in range(5):
                x = x @ ws[i]
        return x

    assert rf.count_program(nested, x, ws)["flops"] == 15 * 2 * m * d * d


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_meta_count_equals_cpu(arch):
    """Each SMOKE config's prefill (B 2, S 64) counts the same on ``meta``
    as on the CPU, the attention kernel's report standing for its plain
    version on both."""
    cfg = configs.get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    batch = synthetic_batch(model, ShapeSpec("p", 64, 2, "prefill"))
    meta = build_model(cfg, device="meta")
    mbatch = {k: v.to("meta") for k, v in batch.items()}
    with torch.no_grad():
        want = rf.count_program(model.prefill, batch)
        got = rf.count_program(meta.prefill, mbatch)
    assert got == want
    assert want["flops"] > 0 and want["bytes_accessed"] > 0
    attn = want["kernels"].get("flash_attention")
    layers = sum(1 for i in range(cfg.n_layers) if cfg.is_attn_layer(i))
    if cfg.family == "encdec":
        layers = cfg.n_enc_layers
    assert (attn or {"calls": 0})["calls"] == (
        0 if cfg.family == "ssm" else layers)


def _table():
    rng = np.random.default_rng(3)
    n = 1000
    data = {"a": rng.integers(0, 100, n).astype(np.int32),
            "b": rng.normal(0, 1, n).astype(np.float32),
            "k": rng.integers(0, 64, n).astype(np.int32)}
    schema = {"a": dt.INT32, "b": dt.FLOAT32, "k": dt.INT32}
    return TorchTable.from_numpy(data, schema, device="cpu")


def _kernel_cases():
    """(name, wrapper, args, the closed form's (operations, bytes))."""
    gen = torch.Generator().manual_seed(1)
    n, g = 5000, 77
    gids = torch.randint(-3, g + 3, (n,), generator=gen, dtype=torch.int32)
    f32 = torch.randn(n, generator=gen)
    i32 = torch.randint(-9, 9, (n,), generator=gen, dtype=torch.int32)
    q = torch.randn(2, 3, 64, 16, generator=gen).bfloat16()
    keys = torch.randint(0, 4000, (n,), generator=gen, dtype=torch.int32)
    vals = torch.arange(n, dtype=torch.int32)
    valid = torch.rand(n, generator=gen) < 0.8
    tk, tv = hp.build_table_plain(keys, vals, 1 << 14, -1, valid)
    probe = keys[:700]
    src = [[torch.randint(0, 99, (m,), generator=gen, dtype=torch.int32),
            torch.randint(0, 255, (m, 6), generator=gen, dtype=torch.uint8)]
           for m in (300, 0, 41)]
    vsrc = [torch.rand(c[0].shape[0], generator=gen) < 0.9 for c in src]
    table = _table()
    stages = [(col("a") < lit(50), (("a", col("a")), ("c", col("b") *
                                                       lit(2.0))))]
    bstages = [(col("a") < ParamRef(0, dt.INT32), (("a", col("a")),
                                                   ("b", col("b"))))]
    program = fused.lower_stages(table, stages)
    lowered = fused.lower_stages(table, bstages, batch=True)
    pstages = [(col("a") < lit(80), (("k", col("k")),))]
    ptk, ptv = hp.build_table_plain(vals[:64], vals[:64], 128)
    probe_arg = {"tk": ptk, "tv": ptv, "probe_keys": ("k",), "pack": None,
                 "empty_key": -1, "max_probes": 8}
    pprog = fused.lower_split(table, pstages, probe_keys=("k",), pack=None,
                              empty_key=-1)[-1][1]
    lanes = (torch.arange(70, dtype=torch.int32),)
    return [
        ("flash_attention", fa.flash_attention, (q, q, q, True),
         (4 * 6 * 64 * 64 * 16 // 2, 4 * 6 * 64 * 16 * 2)),
        ("flash_attention", fa.flash_attention, (q.float(), q.float(),
                                                 q.float(), False),
         (4 * 6 * 64 * 64 * 16, 4 * 6 * 64 * 16 * 4)),
        ("segmented_sum", seg.segmented_sum, (gids, f32, g),
         (n, 4 * n + 4 * (n + g))),
        ("segmented_int_sum", seg.segmented_int_sum, (gids, i32, g),
         (n, 4 * n + 4 * (n + g))),
        ("segmented_minmax", seg.segmented_minmax, (gids, f32, g, "max"),
         (n, 4 * n + 4 * (n + g))),
        ("block_prefix_sum", bps.block_prefix_sum, (valid,),
         (n, 5 * n + 4)),
        ("radix_histogram", rh.radix_histogram, (gids, g),
         (n, 4 * n + 4 * g)),
        ("radix_histogram", rh.partition_histogram, (src, vsrc, 3),
         (10 * 2 * 341, 4 * 9 + 341 * (5 + 4 + 6))),
        ("build_table", hp.build_table, (keys, vals, 1 << 14, -1, valid),
         (8 * n, 8 * n + 8 * (1 << 14) + n)),
        ("hash_probe", hp.hash_probe, (tk, tv, probe),
         (8 * 700, 9 * 700 + min(8 << 14, 64 * 700))),
        ("hash_probe_multi", hp.hash_probe_multi, (tk, tv, keys, 4),
         (8 * n, n * (8 + 16) + min(8 << 14, 64 * n))),
        ("fused_morsel_program", fused.fused_morsel_program, (table, stages),
         fused.program_work(program, 1000)),
        ("fused_morsel_probe", fused.fused_morsel_program,
         (table, pstages, probe_arg), fused.program_work(pprog, 1000,
                                                         table_size=128)),
        ("fused_batch_program", fused.fused_batch_program,
         (table, bstages, lanes, 70),
         tuple(a + b for a, b in zip(fused.program_work(lowered, 1000, 64),
                                     fused.program_work(lowered, 1000, 6)))),
    ]


def test_every_kernel_reports_its_closed_form():
    """Each wrapper on CPU tensors: one report of its closed form, no ATen
    op of its plain version or its allocations counted, the result the
    plain version's."""
    cases = _kernel_cases()
    names = set()
    for name, fn, args, (flops, nbytes) in cases:
        c = rf.count_program(fn, *args)
        assert c["kernels"][name]["calls"] >= 1, name
        assert (c["flops"], c["bytes_accessed"]) == (flops, nbytes), name
        assert c["ops"] == {}, (name, sorted(c["ops"]))
        names.add(name)
    from repro_torch.kernels import ops
    assert names == set(ops.KERNELS)
    # the fused batch program counts a launch a run of 64 lanes
    assert rf.count_program(fused.fused_batch_program, *cases[-1][2])[
        "kernels"]["fused_batch_program"]["calls"] == 2
    # the closed forms are what the modules' work functions give
    assert fa.flash_attention_work(*cases[0][2]) == cases[0][3]
    assert hp.hash_probe_work(*cases[9][2]) == cases[9][3]


def test_reports_outside_a_count_and_nested():
    """Outside a count a wrapper only runs; a wrapper called inside
    another's hidden body reports nothing of its own."""
    cases = _kernel_cases()
    _, fn, args, _ = cases[2]
    torch.testing.assert_close(fn(*args), seg.segmented_sum_plain(*args))

    def outer():
        from repro_torch.kernels import ops
        with ops.hidden_work():
            fn(*args)
            torch.ones(10) + 1

    assert rf.count_program(outer) == {"flops": 0, "bytes_accessed": 0,
                                       "collective_bytes": 0, "kernels": {},
                                       "ops": {}}


def test_compressed_allreduce_reports_its_bytes():
    """W workers' int32 sums and float32 max scales: each worker's result
    bytes, as an HLO parse counts psum and pmax in each device's
    program."""
    gen = torch.Generator().manual_seed(2)
    w = 3
    grads = [{"a": torch.randn(10, 4, generator=gen),
              "b": torch.randn(7, generator=gen)} for _ in range(w)]
    errors = [compression.ef_init(g) for g in grads]
    c = rf.count_program(compression.allreduce_compressed, grads, errors)
    assert c["collective_bytes"] == w * ((40 + 7) * 4 + 2 * 4)
    assert c["kernels"]["allreduce_compressed"]["calls"] == 1


def test_measure_program_on_the_cpu():
    """Every key of the reference's record; timed by ``perf_counter`` on
    the CPU; the bound is the largest term of the count."""
    x, w = torch.randn(64, 64), torch.randn(64, 64)
    rec = rf.measure_program(lambda a, b: torch.relu(a @ b), x, w,
                             warmup=1, iters=2)
    for k in ("flops", "bytes_accessed", "collective_bytes",
              "roofline_bound_s", "measured_s", "dominant",
              "achieved_fraction"):
        assert k in rec, k
    assert rec["flops"] == 2 * 64 ** 3
    terms = rf.roofline_terms(rec["flops"], rec["bytes_accessed"], 0, 1)
    assert rec["roofline_bound_s"] == max(terms.values())
    assert rec["dominant"] == rf.dominant(terms)
    assert rec["measured_s"] > 0
    assert rec["achieved_fraction"] == pytest.approx(
        rec["roofline_bound_s"] / rec["measured_s"])
