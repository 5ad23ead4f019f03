"""Serve a model with batched requests on the port: prefill + batched greedy
decode over the KV cache, the counterpart of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch ID] \
        [--device cpu] [--full]

Runs qwen2-1.5B's SMOKE config on the CUDA device by default and fails when
there is none; ``--arch`` takes any of the ten configs; ``--device cpu``
runs the plain versions, ``--full`` the full published config with random
weights (qwen2-1.5B: 28 layers, d_model 1536, vocab 151,936). Prefill's
attention runs through the port's flash attention kernel. xlstm_125m
serves tokens like the decoder LMs (its prefill hands each layer's
recurrent state to decode); seamless_m4t_large_v2 prefills random frames
(the audio frontend's stub, as in the reference) and decodes greedily from
a drawn start token.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--arch", default="qwen2_1_5b", choices=ARCH_IDS,
                        help="the config to serve (qwen2_1_5b by default)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--full", action="store_true",
                        help="the full config, not its SMOKE one")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(get_config(args.arch, smoke=not args.full),
                        device=device,
                        generator=torch.Generator(device).manual_seed(0))
    cfg = model.cfg

    batch, prompt_len, gen_len, max_len = 4, 24, 16, 64
    rng = np.random.default_rng(0)
    if model.is_encdec:
        # frames of the frontend stub; decode starts from a drawn token at
        # position 0
        prompts = torch.from_numpy(rng.standard_normal(
            (batch, prompt_len, cfg.d_model), dtype=np.float32)).to(
                device, torch.bfloat16)
        start = torch.from_numpy(rng.integers(
            0, cfg.vocab, (batch,), dtype=np.int32)).to(device)
    else:
        prompts = torch.from_numpy(
            rng.integers(0, cfg.vocab, (batch, prompt_len), dtype=np.int32)
        ).to(device)

    # prefill: one pass over the prompts fills every layer's cache (an
    # encoder-decoder's: the cross K/V of the encoded frames)
    t0 = time.perf_counter()
    if model.is_encdec:
        caches = model.prefill({"frames": prompts})
        logits, caches = model.decode_step(start[:, None], caches, 0)
        pos0 = 1
    else:
        logits, caches = model.prefill({"tokens": prompts}, max_len)
        pos0 = prompt_len
    next_tok = logits[:, -1].argmax(-1).to(torch.int32)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    # batched greedy decode
    out_tokens = [next_tok]
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        logits, caches = model.decode_step(next_tok[:, None], caches,
                                           pos0 + i)
        next_tok = logits[:, 0].argmax(-1).to(torch.int32)
        out_tokens.append(next_tok)
    _sync(device)
    t_decode = time.perf_counter() - t0

    gen = torch.stack(out_tokens, dim=1).cpu().numpy()
    print(f"{cfg.name} on {device}")
    print(f"prefill: {batch}x{prompt_len} "
          f"{'frames' if model.is_encdec else 'tokens'} in "
          f"{t_prefill * 1e3:.1f} ms")
    print(f"decode:  {gen_len} steps x {batch} seqs in "
          f"{t_decode * 1e3:.1f} ms "
          f"({gen_len * batch / t_decode:.0f} tok/s on {device.type})")
    for b in range(batch):
        print(f"  request {b}: {gen[b].tolist()}")
    out = {"model": model, "prompts": prompts, "tokens": gen,
           "prefill_s": t_prefill, "decode_s": t_decode}
    if model.is_encdec:
        out["start"] = start
    return out


if __name__ == "__main__":
    main()
