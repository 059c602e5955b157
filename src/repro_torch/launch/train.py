"""Training CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m --steps 20 --device cpu

Trains the reduced config by default; ``--full`` selects the full one.
Runs on the card unless ``--device cpu`` asks for the CPU.  The flags and
the printed line are the reference's (``repro/launch/train.py``), with
``--device`` added.  As in the reference, the stream yields tokens only, so
whisper-base and internvl2-76b stop with ``KeyError: 'frames'`` and
``KeyError: 'patches'``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.data.pipeline import DataConfig
from repro_torch.models.registry import ALL_ARCHS, get_model
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt_cli"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full", action="store_true", help="full (production) config")
    ap.add_argument("--f32", action="store_true", help="train in float32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    api = get_model(args.arch)
    cfg = api.config if args.full else api.reduced
    if args.f32:
        cfg = dataclasses.replace(cfg, dtype="float32")

    trainer = Trainer(
        api,
        cfg,
        adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1), total_steps=args.steps),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=0, mixture_components=2),
        TrainerConfig(steps=args.steps, checkpoint_every=args.checkpoint_every, checkpoint_dir=args.ckpt_dir,
                      microbatches=args.microbatches, resume=args.resume),
        device=args.device,
    )
    result = trainer.run()
    print(f"arch={args.arch} steps={result.final_step} "
          f"loss {result.losses[0]:.3f} -> {result.losses[-1]:.3f}"
          + (f" (resumed from {result.resumed_from})" if result.resumed_from else ""))


if __name__ == "__main__":
    main()
