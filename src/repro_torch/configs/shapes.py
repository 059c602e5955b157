"""The four input-shape suites (seq_len × global_batch), copied from the
reference's ``repro/configs/shapes.py``.

``train_*`` is a training step, ``prefill_*`` a serving prefill, and
``decode_*`` / ``long_*`` a serving step (one new token against a KV cache
of ``seq_len``).  The continuum's cost model (``core/autoshard.py``) reads
them."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSuite] = {
    "train_4k": ShapeSuite("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSuite("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSuite("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSuite("long_500k", "decode", 524288, 1),
}

# long_500k applies only to architectures with sub-quadratic or bounded-KV
# decode paths.
LONG_CONTEXT_ARCHS = frozenset(
    {"mamba2-780m", "zamba2-7b", "gemma2-2b", "mixtral-8x7b"}
)


def applicable_shapes(arch: str) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        out.append("long_500k")
    return out
