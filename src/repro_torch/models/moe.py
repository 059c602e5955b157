"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Ported from the reference's ``repro/models/moe.py``, step by step:

1. the router's logits in f32 on the f32-cast input (the router stays f32
   in a bf16 model; f32 products on the card run in full f32, since
   ``torch.backends.cuda.matmul.allow_tf32`` is left False: one flipped
   expert choice changes the tokens), a softmax, the top ``k`` with the
   reference's tie rule (``lax.top_k`` gives the lower index first, and
   ``torch.topk`` promises no order on ties, so the first ``k`` of a stable
   descending sort), and the gates renormalised;
2. the Switch load-balance loss (eq. 4-6) times ``aux_loss_coef``;
3. the (token, slot) pairs sorted by expert id, **stably**: which pairs a
   full expert drops depends on that order.  A pair's position in its
   expert is its sorted index minus its expert's segment start
   (``searchsorted``); pairs at position ``>= C`` are dropped;
4. the kept pairs copied into a zero ``[E * C, d]`` buffer (their slots are
   unique, so the copy is exact; the dropped pairs all go to one spare row,
   which is thrown away), the SwiGLU experts as batched products
   (``torch.bmm`` over ``[E, C, .]``, in the activation dtype), and the
   combine.

Each stage is a function of its own (:func:`route`, :func:`dispatch`,
:func:`scatter`, :func:`experts_ffn`, :func:`combine`), so that each can be
timed on the card; :func:`moe_ffn` runs them in order.

The combine is where the reference's order matters: ``.at[token].add``
adds a token's ``k`` gated outputs into a zero row in its pairs' sorted
order, which for one token is ascending expert id.  The port gathers them
``[T, k, d]``, orders them by expert id and adds them one at a time in the
activation dtype, so each sum is rounded as the reference's is.  It never
uses ``index_add_``, whose order on the card is unordered: a deterministic
combine also keeps a request's tokens the same alone and in a batch.

The expert FFN is plain PyTorch: the reference computes it outside any
Pallas kernel (XLA's batched matmul).

The weights, the block's input and output and the dispatch buffer pass
through ``distributed/program.py`` (the buffer also through
``hints.constrain_moe_buffer``, the reference's point): each returns its
input unless a sharded program is installed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import hints
from repro_torch.distributed import program as D
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class MoE(nn.Module):
    """``router`` (a :class:`~repro_torch.models.layers.Linear` ``[d, E]``,
    no bias, always f32), ``gate`` and ``up`` ``[E, d, f]``, ``down`` ``[E,
    f, d]`` in the model's dtype: the reference's ``moe_init`` pytree."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
        self.router = L.Linear(d, e, bias=False, dtype=torch.float32, device=device)
        self.gate = L.param(torch.empty(e, d, f, dtype=dtype, device=device))
        self.up = L.param(torch.empty(e, d, f, dtype=dtype, device=device))
        self.down = L.param(torch.empty(e, f, d, dtype=dtype, device=device))

    def init_(self, generator: torch.Generator) -> None:
        """The experts at the reference's scales (``d ** -0.5`` for ``gate``
        and ``up``, ``f ** -0.5`` for ``down``); the router draws itself."""
        d, f = self.gate.shape[1], self.gate.shape[2]
        for w, scale in ((self.gate, d**-0.5), (self.up, d**-0.5), (self.down, f**-0.5)):
            w.copy_(L.truncated_normal(tuple(w.shape), scale, w.dtype, generator, w.device))


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Slots per expert for ``num_tokens`` tokens: ``int(T k cf / E) + 1``,
    rounded up to a multiple of 8, at least 8."""
    cap = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts) + 1
    return max(8, -(-cap // 8) * 8)


def route(p: MoE, xt: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tokens ``xt [T, d]`` -> (router probabilities ``[T, E]`` f32, the
    renormalised top-k gates ``[T, k]`` f32, their expert ids ``[T, k]``),
    the ids by descending probability, the lower id first on a tie."""
    logits = xt.float() @ D.weight(p.router.w)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k(probs, cfg.top_k)
    return probs, gates / gates.sum(dim=-1, keepdim=True), experts


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the ``k`` largest, ties to the
    lower index."""
    values, index = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def dispatch(experts: torch.Tensor, num_experts: int, capacity: int, *, rows: int | None = None,
             offsets: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Where each (token, slot) pair goes: ``experts [T, k]`` -> (``slot [T,
    k]``, the pair's row ``expert * rows + position`` of the ``[E * rows,
    d]`` buffer (``rows``: the capacity unless given), ``keep [T, k]``, False
    for a pair past its expert's capacity).  Positions follow the stable
    sort of the flat expert ids, as the reference's ``argsort(stable=True)``
    and ``searchsorted(side="left")``, plus ``offsets [T, k]`` where given:
    the pairs of the same expert that other devices hold earlier in the
    whole batch."""
    rows = capacity if rows is None else rows
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    se = flat[order]
    starts = torch.searchsorted(se, torch.arange(num_experts, device=flat.device, dtype=se.dtype),
                                side="left")
    pos_sorted = torch.arange(flat.numel(), device=flat.device) - starts[se]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted  # a permutation: each pair written once
    if offsets is not None:
        pos = pos + offsets.reshape(-1)
    keep = pos < capacity
    slot = flat * rows + torch.where(keep, pos, 0)
    return slot.view_as(experts), keep.view_as(experts)


def scatter(xt: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor, num_experts: int,
            capacity: int) -> torch.Tensor:
    """The capacity buffer ``[E, C, d]`` in x's dtype: each kept pair's
    token row at its slot, zeros elsewhere.  Kept slots are unique, so the
    copy is exact and ordered; every dropped pair lands in a spare row that
    is thrown away."""
    d = xt.shape[1]
    dest = torch.where(keep, slot, num_experts * capacity).reshape(-1)
    buf = xt.new_zeros(num_experts * capacity + 1, d)
    buf.index_copy_(0, dest, xt.repeat_interleave(slot.shape[1], dim=0))
    return buf[: num_experts * capacity].view(num_experts, capacity, d)


def experts_ffn(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts over the capacity buffer, batched products in the
    buffer's dtype: ``[E, C, d]`` -> ``[E * C, d]``."""
    h = F.silu(torch.bmm(buf, D.weight(p.gate))) * torch.bmm(buf, D.weight(p.up))
    return torch.bmm(h, D.weight(p.down)).reshape(-1, buf.shape[2])


def combine(out_buf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor, gates: torch.Tensor,
            experts: torch.Tensor) -> torch.Tensor:
    """Each token's gated pair outputs ``[T, d]``: its kept pairs' rows of
    ``out_buf`` times their gates (cast to the activation dtype), added one
    at a time into a zero row in ascending expert id, the order of the
    reference's ``.at[token].add``."""
    d = out_buf.shape[1]
    pair = torch.where(keep[..., None], out_buf[slot], 0.0) * gates.to(out_buf.dtype)[..., None]
    pair = pair.gather(1, experts.argsort(dim=-1)[..., None].expand(-1, -1, d))
    yt = out_buf.new_zeros(slot.shape[0], d)
    for j in range(slot.shape[1]):
        yt = yt + pair[:, j]
    return yt


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, d]`` -> (``y [B, S, d]`` in x's dtype, the aux loss, an
    f32 scalar).  Under a sharded program the router reads the input with
    no exchange and the experts read it entered, and a device whose tokens
    are a share of the batch routes them as the whole batch's: the
    capacity, each pair's position in its expert and the aux loss's means
    are the whole batch's (``distributed/program.py``)."""
    x_route, x = D.moe_enter(x, p)
    B, S, d = x.shape
    T, E = B * S, cfg.num_experts
    xt = x.reshape(T, d)
    probs, gates, experts = route(p, x_route.reshape(T, d), cfg)

    # Switch eq. 4-6: mean router probability times the top-1 share, per expert
    # a one-hot by comparison, as on every device (F.one_hot takes another
    # path on meta tensors, which the dry-run's count would see)
    top1 = (experts[:, :1] == torch.arange(E, device=x.device)).float()
    me, ce = D.moe_means(probs, top1, p)
    aux = D.moe_aux_share(cfg.aux_loss_coef * E * (me * ce).sum(), p)

    C = moe_capacity(cfg, T * D.moe_token_devices(p))
    rows = D.moe_rows(C, p)
    slot, keep = dispatch(experts, E, C, rows=rows, offsets=D.moe_offsets(experts, E, B, p))
    buf = D.moe_dispatch(hints.constrain_moe_buffer(scatter(xt, slot, keep, E, rows)), p)
    out_buf = D.moe_return(experts_ffn(p, buf), p, E)
    y = combine(out_buf, slot, keep, D.moe_gates(gates, p), experts)
    return D.exit(y.reshape(B, S, d), p), aux


def moe_ffn_dense_ref(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The O(T·E·d·f) oracle of the tests, no capacity dropping: every token
    through every expert, combined with its top-k gates."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    probs, gates, experts = route(p, xt, cfg)
    h = F.silu(torch.einsum("td,edf->tef", xt, p.gate)) * torch.einsum("td,edf->tef", xt, p.up)
    all_out = torch.einsum("tef,efd->ted", h, p.down)
    full = torch.zeros(probs.shape, dtype=x.dtype, device=x.device).scatter(1, experts, gates.to(x.dtype))
    return torch.einsum("ted,te->td", all_out, full).reshape(B, S, d)
