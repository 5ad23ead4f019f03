"""The port's examples (``examples/quickstart_torch.py``,
``examples/serve_queries_torch.py``,
``examples/distributed_tpch_torch.py``, ``examples/serve_lm_torch.py`` and
``examples/train_lm_torch.py``) run on the CPU with ``--device cpu``, and
their answers are the reference oracle's (the LM example's, its own model's
greedy tokens; the training example's, a loss that falls through a failure
and its recovery)."""

import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpch_util import assert_results_match  # noqa: E402

from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_on_cpu(capsys):
    out = _load("quickstart_torch").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "== optimized plan ==" in text and "TPC-H Q5" in text
    assert len(out["top"]["user"]) == 5
    spend = out["top"]["spend"]
    assert list(spend) == sorted(spend, reverse=True)
    assert_results_match(out["q5"], oracle.ORACLES[5](
        ref_dbgen.generate(sf=0.002)), 5)


def test_serve_queries_runs_on_cpu(capsys):
    mod = _load("serve_queries_torch")
    out = mod.main(["--device", "cpu", "--clients", "3"])
    assert "served 12 queries from 3 clients on cpu" in capsys.readouterr().out
    assert len(out["results"]) == 3 * len(mod.DASHBOARD)
    data = ref_dbgen.generate(sf=0.002)
    for q, res in out["results"]:
        assert_results_match(res, oracle.ORACLES[q](data), q)
    assert out["stats"]["rejected"] == 0 and out["stats"]["failed"] == 0


def test_distributed_tpch_runs_on_cpu(capsys):
    out = _load("distributed_tpch_torch").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "mesh=['cpu'] workers=4" in text
    data = ref_dbgen.generate(sf=0.002)
    for q in (1, 5, 9, 13):
        for proto in ("ICI", "Host"):
            run = out[(q, proto)]
            assert_results_match(run["result"], oracle.ORACLES[q](data), q)
            assert (run["staged_bytes"] > 0) == (proto == "Host")


def test_serve_lm_runs_on_cpu(capsys):
    """qwen2-1.5B's SMOKE config: 16 greedy tokens for each of 4 prompts;
    each prompt plus the first 15 through ``forward`` gives back the same
    greedy tokens wherever the top two logits are 0.05 apart."""
    import torch
    out = _load("serve_lm_torch").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "qwen2_1_5b_smoke on cpu" in text and "tok/s on cpu" in text
    model, gen = out["model"], out["tokens"]
    assert gen.shape == (4, 16)
    assert ((gen >= 0) & (gen < model.cfg.vocab)).all()
    seq = torch.cat([out["prompts"], torch.from_numpy(gen[:, :-1])], dim=1)
    with torch.no_grad():
        logits, _ = model.forward({"tokens": seq})
    tail = logits[:, out["prompts"].shape[1] - 1:].float()
    top2 = tail.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 0.05
    assert (tail.argmax(-1).numpy() == gen)[sure.numpy()].all()


def test_serve_lm_arch_runs_on_cpu(capsys):
    """``--arch`` serves the MoE family's SMOKE config (deepseek_moe_16b),
    the xLSTM's (xlstm_125m: tokens through each layer's recurrent state)
    and the encoder-decoder's (seamless_m4t_large_v2: random frames, then
    greedy decode from a drawn start token). For the last two, ``forward``
    over the prompt (or the frames) and the tokens fed gives back the same
    greedy tokens wherever its top two logits are 0.05 apart."""
    import torch
    for arch in ("deepseek_moe_16b", "xlstm_125m", "seamless_m4t_large_v2"):
        out = _load("serve_lm_torch").main(["--arch", arch, "--device",
                                            "cpu"])
        assert f"{arch}_smoke on cpu" in capsys.readouterr().out
        model, gen = out["model"], out["tokens"]
        assert gen.shape == (4, 16)
        assert ((gen >= 0) & (gen < model.cfg.vocab)).all()
        if arch == "deepseek_moe_16b":
            continue
        fed = torch.from_numpy(gen[:, :-1])
        with torch.no_grad():
            if model.is_encdec:
                seq = torch.cat([out["start"][:, None], fed], dim=1)
                logits, _ = model.forward({"frames": out["prompts"],
                                           "tokens": seq})
            else:
                seq = torch.cat([out["prompts"], fed], dim=1)
                logits, _ = model.forward({"tokens": seq})
                logits = logits[:, out["prompts"].shape[1] - 1:]
        top2 = logits.float().topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > 0.05
        assert (logits.float().argmax(-1).numpy() == gen)[sure.numpy()].all()
        assert int(sure.sum()) >= 16      # of the 64 positions


def test_train_lm_runs_on_cpu(capsys):
    """The small config for 40 steps of 4 x 64 tokens: one injected failure
    at step 20 (before the first checkpoint, so the loop restarts from the
    initial state), and a last loss below the first."""
    import torch
    mod = _load("train_lm_torch")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--steps", "2"])
    # one intra-op thread: the suite runs several test processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = mod.main(["--device", "cpu", "--steps", "40", "--batch", "4",
                        "--seq", "64"])
    finally:
        torch.set_num_threads(threads)
    text = capsys.readouterr().out
    assert "model demo_small: 1.2M params on cpu" in text
    assert "restarts survived: 1" in text and "OK: loss decreased" in text
    loop = out["loop"]
    assert [m["step"] for m in loop.metrics] == list(range(20)) + \
        list(range(40))
    assert out["losses"][-1] < out["losses"][0]
    assert int(out["state"].opt.step) == 40
