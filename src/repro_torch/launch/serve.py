"""Serving CLI: the continuous-batching engine over a reduced model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-76b --device cpu

Runs on the card unless ``--device cpu`` asks for the CPU.  Every arch of
the registry but whisper-base serves its reduced config: the dense ones
(deepseek-67b's head width 8 too), the MoE ones (qwen3-moe-30b-a3b,
mixtral-8x7b, whose window of 8 takes the ring-buffer caches and the
attention kernels' ``window=``), the ssm and hybrid ones (mamba2-780m,
zamba2-7b), whose chunk 16, state width 16 and head width 16 go to the SSD
kernel's chunk-serial design, and internvl2-76b text-only, as the
reference's engine passes no patches.  whisper-base needs frames, which
the engine does not pass: the CLI exits with the reference's message.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.models.registry import ALL_ARCHS, get_model
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    api = get_model(args.arch)
    cfg = api.reduced
    if cfg.family == "encdec":
        raise SystemExit("whisper-base serving needs frames input; see tests/test_models_smoke.py")
    device = torch.device(args.device)
    generator = torch.Generator(device=device).manual_seed(0)
    params = api.init(generator, cfg, device=device)
    engine = ServeEngine(api, cfg, params,
                         EngineConfig(max_slots=args.slots, max_len=args.max_len), device=device)
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab, size=int(rng.integers(4, 10))).astype(np.int32),
                max_new_tokens=args.new_tokens)
        for i in range(args.requests)
    ]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    engine.run_until_done()
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in reqs)
    print(f"{args.arch} on {device}: {len(reqs)} requests, {total} tokens, {total/dt:.1f} tok/s")


if __name__ == "__main__":
    main()
