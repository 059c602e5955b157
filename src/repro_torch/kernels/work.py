"""The work of one kernel call, and the hook through which a counter sees it.

A hand-written kernel is one opaque call to PyTorch: an operation counter
(``launch/op_costs.py``) cannot see its products and its memory traffic.
So each kernel has **one** formula for its work here, the work its bound
counts (``PERF.md``): FLOPs (2 a multiply-add) and the HBM bytes of its
inputs read once and its outputs written once.  Where the work depends on
the data (the keys a decode row sees), it counts what the call's data needs;
on meta tensors, which hold no data, every decode row sees its whole cache.

Each wrapper runs its implementation, on any device (the kernel on the card,
the plain version on the CPU, a shape function on meta), inside
:func:`kernel_call`: every counter listening then gets one :class:`Work`
record per call, and does not count the operations inside the call (the
plain version's, or the wrapper's allocations).  With no counter listening
the record is never built.

:func:`collective` is the same hook for the exchanges between devices that
a sharded step makes (``distributed/program.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Callable, Iterator

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes


@dataclasses.dataclass(frozen=True)
class Work:
    """One kernel call: ``flops`` (2 a multiply-add), ``bytes`` (inputs read
    once, outputs written once), ``transcendentals`` (exp a score or step),
    and the dtype its products run in."""

    kernel: str
    flops: int
    bytes: int
    transcendentals: int
    dtype: torch.dtype


#: the counters listening (``launch/op_costs.py::OpCounter``), innermost last
LISTENERS: list = []


@contextlib.contextmanager
def kernel_call(work: Callable[[], Work]) -> Iterator[None]:
    """Run one kernel call: ``work()`` is built and handed to every listening
    counter, which ignores the operations inside the call."""
    if not LISTENERS:
        yield
        return
    record = work()
    listeners = list(LISTENERS)
    for c in listeners:
        c.enter_kernel(record)
    try:
        yield
    finally:
        for c in listeners:
            c.exit_kernel()


def collective(kind: str, nbytes: int, out=None) -> None:
    """Tell every listening counter of one exchange between devices: its
    kind (``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``collective-permute``, ``gather``), the bytes of its result on this
    device and, where given, the result itself, whose storage is live until
    it is freed."""
    for c in LISTENERS:
        c.collective(kind, nbytes, out)


def attention_visible(Sq: int, Skv: int, *, causal: bool, window: int | None) -> tuple[int, int]:
    """``(pairs, keys)`` of one (batch, head): the visible (query row, key)
    pairs of the attention mask (query rows at kv positions ``Skv - Sq ...``;
    :func:`~repro_torch.kernels.flash_attention.attention_mask`), and the
    keys that some row sees."""
    if Sq == 0 or Skv == 0:
        return 0, 0
    # numpy, not torch: a counter listening must not see these ops
    rows = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    lo = np.zeros_like(rows) if window is None else np.maximum(rows - window + 1, 0)
    hi = np.minimum(rows, Skv - 1) if causal else np.full_like(rows, Skv - 1)
    count = np.maximum(hi - lo + 1, 0)
    seen = count > 0
    keys = int(hi[seen].max() - lo[seen].min() + 1) if seen.any() else 0
    return int(count.sum()), keys


def attention_work(kernel: str, *, B: int, H: int, Hkv: int, D: int, q_rows: int, pairs: int,
                   kv_rows: int, dtype: torch.dtype) -> Work:
    """An attention call (flash or decode): ``pairs`` visible (query head,
    key) pairs at 4·D FLOPs each (QKᵀ and PV) and one exp each; q
    (``B·H·q_rows`` rows) read and the output written once, the ``kv_rows``
    rows of k and v that some pair touches read once."""
    size = dtype.itemsize
    nbytes = 2 * B * H * q_rows * D * size + 2 * kv_rows * D * size
    return Work(kernel, 4 * D * pairs, nbytes, pairs, dtype)


def flash_attention_work(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                         window: int | None) -> Work:
    """The flash kernel's work on ``q [B, H, Sq, D]`` against ``k [B, Hkv,
    Skv, D]`` (the mask depends on shapes alone)."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    pairs, keys = attention_visible(Sq, Skv, causal=causal, window=window)
    return attention_work("flash_attention", B=B, H=H, Hkv=Hkv, D=D, q_rows=Sq, pairs=B * H * pairs,
                          kv_rows=B * Hkv * keys, dtype=q.dtype)


def decode_attention_work(q: torch.Tensor, k_cache: torch.Tensor, lengths: torch.Tensor, *,
                          state: bool = False) -> Work:
    """The decode kernel's work on ``q [B, H, D]`` against a cache ``[B,
    Hkv, S, D]``: each row sees its first ``lengths[b]`` keys (cut at S), or,
    on meta, all S; with ``state`` it also writes each row's softmax state
    ``[B, H]`` f32."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if lengths.device.type == "meta":
        seen = B * S
    else:
        with _disable_current_modes():  # the copy to the host is the counter's, not the step's
            host = lengths.detach().cpu().numpy().astype(np.int64)
        seen = int(np.clip(host, 0, S).sum())
    out = attention_work("decode_attention", B=B, H=H, Hkv=Hkv, D=D, q_rows=1, pairs=H * seen,
                         kv_rows=Hkv * seen, dtype=q.dtype)
    return dataclasses.replace(out, bytes=out.bytes + 4 * B * H) if state else out


def ssd_scan_work(x: torch.Tensor, B_mat: torch.Tensor) -> Work:
    """The SSD scan's work on ``x [B, L, H, P]`` with B and C ``[B, L, G,
    N]``: the recurrence's 4·P·N FLOPs a (batch, step, head) (a multiply-add
    for the state update and one for the read of y) and one exp each; x, B,
    C, dt and A read once, y and the f32 final state written once."""
    Bsz, L, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    size = x.dtype.itemsize
    nbytes = (2 * Bsz * L * H * P * size + 2 * Bsz * L * G * N * size + Bsz * L * H * 4 + H * 4
              + Bsz * H * P * N * 4)
    return Work("ssd_scan", 4 * P * N * Bsz * L * H, nbytes, Bsz * L * H, x.dtype)
