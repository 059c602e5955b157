"""Stable k-th-smallest selection via comparison ranks — the core-selection
primitive of the schedule evaluators, in plain PyTorch.

List scheduling needs, per task step, the time at which ``c`` cores of the
assigned node are free at once: the ``c``-th smallest entry of the node's
core-free row, after which the ``c`` stably-smallest entries take the task's
finish time.  The comparison rank

    rank[m] = #{m' : row[m'] < row[m]  or  (row[m'] == row[m] and m' < m)}

is a permutation of ``0..C-1`` in stable ascending order, so ``rank == c-1``
picks the c-th smallest and ``rank < c`` masks the entries to overwrite.
The values written equal those of a stable sort, and the CUDA makespan
kernel computes the same ranks, so every evaluator agrees bit for bit.
Ranks are f32 (exact for C < 2²⁴), as in the reference.
"""

from __future__ import annotations

import torch


def stable_ranks(row: torch.Tensor) -> torch.Tensor:
    """``row [..., C]`` → ``ranks [..., C]`` (f32), a permutation of
    ``0..C-1`` matching stable ascending sort order."""
    c = row.shape[-1]
    idx = torch.arange(c, device=row.device)
    at_m = row[..., :, None]
    at_mp = row[..., None, :]
    before = (at_mp < at_m) | ((at_mp == at_m) & (idx[None, :] < idx[:, None]))
    return before.sum(dim=-1, dtype=torch.float32)


def kth_from_ranks(row: torch.Tensor, ranks: torch.Tensor, c) -> torch.Tensor:
    """Stable ``c``-th smallest (1-indexed) along the last axis; ``c``
    broadcasts against ``row``'s leading dims, ``1 <= c <= C``."""
    cf = torch.as_tensor(c, dtype=torch.float32, device=row.device)
    hit = ranks == (cf[..., None] - 1.0)
    return torch.where(hit, row, torch.zeros((), dtype=row.dtype, device=row.device)).sum(dim=-1)


def update_from_ranks(row: torch.Tensor, ranks: torch.Tensor, c, fill) -> torch.Tensor:
    """Replace the ``c`` stably-smallest entries of ``row`` with ``fill``."""
    cf = torch.as_tensor(c, dtype=torch.float32, device=row.device)
    fillf = torch.as_tensor(fill, dtype=row.dtype, device=row.device)
    return torch.where(ranks < cf[..., None], fillf[..., None], row)

