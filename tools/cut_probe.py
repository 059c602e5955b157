"""Time the cuts that ``chip_smoke.py`` makes to stay within its time limit,
each before and after, on one card.

    python3 tools/cut_probe.py

The card-against-CPU checks of phases 7, 9 and 10 with the prompts (128,
1000) and with ``chip_smoke.CPU_CUT_PROMPTS``, in the order before, after,
after, before; then phase 17 with qwen3-moe-30b-a3b at 48 and mixtral-8x7b at
8 layers, and at ``chip_smoke.MOE_LAYERS`` and ``MIXTRAL_LAYERS``.  Prints the
card's name and power limit, then one JSON line of seconds.  About seven
minutes on an H100.
"""
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def main() -> int:
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"cut probe: {smi}", flush=True)
    _build.build()
    cuts = {"qwen2.5-3b": {"num_layers": 2}, "mamba2-780m": {"num_layers": 2},
            "zamba2-7b": {"num_layers": 2, "hybrid_period": 2}}
    times: dict[str, list[float]] = {}
    for order in ("before", "after", "after", "before"):
        for arch, cut in cuts.items():
            api = get_model(arch)
            t0 = time.perf_counter()
            chip_smoke._card_against_cpu(api, dataclasses.replace(api.config, **cut),
                                         (128, 1000) if order == "before" else chip_smoke.CPU_CUT_PROMPTS, 4)
            times.setdefault(f"{arch} card against CPU {order}", []).append(time.perf_counter() - t0)
            gc.collect()
            torch.cuda.empty_cache()
    for moe, mixtral in ((48, 8), (chip_smoke.MOE_LAYERS, chip_smoke.MIXTRAL_LAYERS)):
        t0 = time.perf_counter()
        chip_smoke.moe_phase(moe, mixtral)
        times[f"phase 17 at qwen3-moe {moe}, mixtral {mixtral} layers"] = [time.perf_counter() - t0]
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"cut_probe_s": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
