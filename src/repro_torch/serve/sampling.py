"""Sampling for the serving engine: greedy, temperature, top-k and top-p
(nucleus), batched over the rows of ``logits [B, V]``.

Ported from the reference's ``repro/serve/sampling.py``.  The masks are the
reference's, in :func:`mask_logits`: top-k keeps every logit at or above the
k-th largest (``logits < kth`` is masked, so ties at the k-th value stay),
and top-p keeps every logit at or above the ``sum(cum < top_p)``-th largest
of the descending softmax's running sum (the smallest head whose mass
reaches ``top_p``; the largest logit always stays).  The index is clamped
to the last one, as the reference's gather clamps.  The softmax and its
running sum are taken in f64 (the reference's in f32), so the cutoff is the
same on the card and on the CPU (ROADMAP Queue C, deliberate departures).

The draw takes an explicit ``torch.Generator`` (Gumbel-max: the argmax of
the masked logits plus Gumbel noise, as ``jax.random.categorical`` draws).
It cannot reproduce ``jax.random.categorical``'s numbers: the two
generators differ (ROADMAP Queue C, deliberate departures).  Plain
PyTorch: the reference has no Pallas kernel here.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0  # 0 -> greedy
    top_k: int = 0  # 0 -> disabled
    top_p: float = 1.0  # 1 -> disabled


def mask_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """``logits [B, V]`` divided by the temperature, with ``-inf`` outside
    the top-k and top-p sets: the reference's logits as it hands them to
    ``jax.random.categorical``.  The temperature divides as a tensor on the
    logits' device: CUDA turns a division by a host scalar into a product
    with its reciprocal, which rounds one ulp apart from the CPU's (and
    XLA's) division in about one value in ten."""
    logits = logits / torch.tensor(cfg.temperature, dtype=logits.dtype, device=logits.device)
    if cfg.top_k and cfg.top_k < logits.shape[-1]:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        # the running sum in f64: in f32 its rounding follows the device's
        # summation order, which moves the cutoff by a few places on a
        # vocabulary of 150,000 flat logits (the card's parallel scan
        # against the CPU's loop)
        cum = torch.cumsum(torch.softmax(sorted_logits.double(), dim=-1), dim=-1)
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1).clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def sample(logits: torch.Tensor, generator: torch.Generator,
           cfg: SamplingConfig = SamplingConfig()) -> torch.Tensor:
    """Token ids ``[B]`` int32: the argmax for temperature 0, else a draw
    from the softmax of :func:`mask_logits` with noise from ``generator``
    (which must live on the logits' device)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    masked = mask_logits(logits, cfg)
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(masked + gumbel, dim=-1).to(torch.int32)
