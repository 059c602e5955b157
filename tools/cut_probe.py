"""Time the cuts that ``chip_smoke.py`` makes to stay within its time limit,
each before and after, on one card.

    python3 tools/cut_probe.py [5 | 7 | 7d | 9 | 10 | 17 | 20 | 22 | 24 ...]

With no argument, every cut.  7: the card-against-CPU checks of phases 7, 9
and 10 with the prompts (128, 1000) and with ``chip_smoke.CPU_CUT_PROMPTS``,
in the order before, after, after, before.  7d: phase 7 with qwen2.5-3b
at 36 layers and at ``chip_smoke.QWEN_LAYERS``, in the same order.  9:
phase 9 with mamba2-780m at
48 layers and at ``chip_smoke.MAMBA_LAYERS``, in the same order.  10:
phase 10 with zamba2-7b at
12 layers (its depth before phase 25 (d) served it whole on four cards)
and at ``chip_smoke.ZAMBA_LAYERS``, in the same order.  17: phase 17 with
qwen3-moe-30b-a3b at 4 layers (likewise) and at ``chip_smoke.MOE_LAYERS``,
mixtral-8x7b at ``MIXTRAL_LAYERS``, in the same order.  20: phase 20 with
internvl2-76b at 8 layers and at ``chip_smoke.VLM["layers"]``.  5: phase
5's GA through the plain version at ``chip_smoke.GA``'s generations and at
``chip_smoke.GA_PLAIN``'s, in the order before, after, after, before.  22: phase
22's f32 cuts against the CPU at 2 layers and at
``chip_smoke.TRAIN_CPU_LAYERS``, in the order before, after, after, before.
24: phase 24's qwen2.5-3b on one card on (2, 2) and (1, 4), then on
``chip_smoke.SHARDED_ONE_CARD["meshes"]``.  Prints the
card's name and power limit, then one JSON line of seconds.  About seven
minutes on an H100 for 7, three for 7d and 17, two each for 9, 10 and 20,
four for 22, five for 24 and two for 5.
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


def timed(times: dict[str, list[float]], key: str, fn) -> None:
    t0 = time.perf_counter()
    fn()
    times.setdefault(key, []).append(time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()


def main(cuts: list[str]) -> int:
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"cut probe: {smi}", flush=True)
    _build.build()
    times: dict[str, list[float]] = {}
    if "7" in cuts:
        archs = {"qwen2.5-3b": {"num_layers": 2}, "mamba2-780m": {"num_layers": 2},
                 "zamba2-7b": {"num_layers": 2, "hybrid_period": 2}}
        for order in ("before", "after", "after", "before"):
            for arch, cut in archs.items():
                api = get_model(arch)
                timed(times, f"{arch} card against CPU {order}", lambda: chip_smoke._card_against_cpu(
                    api, dataclasses.replace(api.config, **cut),
                    (128, 1000) if order == "before" else chip_smoke.CPU_CUT_PROMPTS, 4))
    if "7d" in cuts:
        for layers in (36, chip_smoke.QWEN_LAYERS, chip_smoke.QWEN_LAYERS, 36):
            timed(times, f"phase 7 at qwen2.5-3b {layers} layers", lambda: chip_smoke.qwen_phase(layers))
    if "9" in cuts:
        for layers in (48, chip_smoke.MAMBA_LAYERS, chip_smoke.MAMBA_LAYERS, 48):
            timed(times, f"phase 9 at mamba2-780m {layers} layers", lambda: chip_smoke.mamba_phase(layers))
    if "10" in cuts:
        for layers in (12, chip_smoke.ZAMBA_LAYERS, chip_smoke.ZAMBA_LAYERS, 12):
            timed(times, f"phase 10 at zamba2-7b {layers} layers", lambda: chip_smoke.zamba_phase(layers))
    if "17" in cuts:
        for moe in (4, chip_smoke.MOE_LAYERS, chip_smoke.MOE_LAYERS, 4):
            mixtral = chip_smoke.MIXTRAL_LAYERS
            timed(times, f"phase 17 at qwen3-moe {moe}, mixtral {mixtral} layers",
                  lambda: chip_smoke.moe_phase(moe, mixtral))
    if "5" in cuts:  # phase 5's GA through the plain version at GA's generations and at GA_PLAIN's
        from repro_torch.core import build_problem, ga, synthetic_system, synthetic_workload

        table9 = build_problem(synthetic_system(500, seed=500), synthetic_workload(500, seed=500))
        for opts in (chip_smoke.GA, chip_smoke.GA_PLAIN, chip_smoke.GA_PLAIN, chip_smoke.GA):
            timed(times, f"phase 5 plain GA at {opts['generations']} generations",
                  lambda: ga(table9, backend="torch", device="cuda", seed=0, **opts))
    if "24" in cuts:  # qwen2.5-3b's one-card sharded step on (2, 2) and (1, 4), then on (2, 2) alone
        job = chip_smoke.SHARDED_ONE_CARD
        for meshes in ([[2, 2], [1, 4]], job["meshes"]):
            timed(times, f"phase 24 qwen2.5-3b on {meshes}", lambda: chip_smoke.sharded_report(
                {**job, "meshes": meshes}, chip_smoke.run_sharded({**job, "meshes": meshes}, 600), "one card"))
    if "22" in cuts:
        for layers in (2, chip_smoke.TRAIN_CPU_LAYERS, chip_smoke.TRAIN_CPU_LAYERS, 2):
            for arch in ("qwen2.5-3b", "mamba2-780m"):
                timed(times, f"phase 22 {arch} card against CPU at {layers} layers",
                      lambda: chip_smoke.train_card_against_cpu(arch, layers))
    if "20" in cuts:
        for layers in (8, chip_smoke.VLM["layers"]):
            timed(times, f"phase 20 at internvl2-76b {layers} layers", lambda: chip_smoke.internvl2_phase(layers))
    print(json.dumps({"cut_probe_s": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["5", "7", "7d", "9", "10", "17", "20", "22", "24"]))
