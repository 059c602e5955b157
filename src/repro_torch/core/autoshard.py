"""Analytic roofline cost model and layout enumeration: the paper's
objective applied to choosing a sharding layout for an ML job.

Ported from the reference's ``repro/core/autoshard.py``, its float
arithmetic copied in its order, so that every estimate equals the
reference's bit for bit.  For an (arch x shape) job and a candidate layout
it estimates three roofline terms of the modelled TPU fleet
(``core/system_model.py``'s ``TPU_V5E_*`` and ``DCN_BW``, inputs of the
model and not speeds of this package):

  compute_s    = FLOPs / (chips * peak)
  memory_s     = HBM bytes moved / (chips * hbm_bw)
  collective_s = TP + DP collective bytes / link_bw (ICI within a pod,
                 DCN across pods)

``step_s = max(terms)`` (perfect overlap) is the duration ``d_ij`` of the
paper's Eq. (4) when ``core/continuum.py`` maps jobs onto pod slices.
Plain Python: nothing here touches a device.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import ShapeSuite
from repro_torch.core.system_model import (
    DCN_BW,
    TPU_V5E_HBM_BW,
    TPU_V5E_ICI_BW,
    TPU_V5E_PEAK_FLOPS,
)
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Layout:
    """A candidate distribution layout for one job."""

    dp: int = 16  # data-parallel degree (ICI)
    tp: int = 16  # tensor-parallel degree (ICI)
    pods: int = 1  # pod-level DP over DCN
    microbatches: int = 1
    remat: bool = True
    fsdp: bool = True  # params sharded over dp (else replicated)
    compress_dcn: bool = False  # int8 gradient compression on the pod axis
    sequence_parallel: bool = False

    @property
    def chips(self) -> int:
        return self.dp * self.tp * self.pods


@dataclasses.dataclass(frozen=True)
class RooflineEstimate:
    compute_s: float
    memory_s: float
    collective_s: float
    hbm_per_chip: float  # bytes resident (params+opt+kv shard)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bottleneck(self) -> str:
        vals = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(vals, key=vals.get)


def estimate(cfg: ModelConfig, suite: ShapeSuite, layout: Layout) -> RooflineEstimate:
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    chips = layout.chips
    d = cfg.d_model
    L = cfg.num_layers
    B, S = suite.global_batch, suite.seq_len

    bytes_param = 2  # bf16
    bytes_opt = 8  # adam m+v f32

    if suite.kind == "train":
        tokens = B * S
        flops = 6 * n_active * tokens
        if layout.remat:
            flops += 2 * n_active * tokens  # recompute forward once
        # bytes: params read fwd+bwd+update, grads written, activations
        act_bytes = 2 * tokens * d * L * (2 if not layout.remat else 0.35)
        hbm_bytes = 3 * n_active * bytes_param + n_total * bytes_opt + act_bytes
        # collectives: TP all-reduces (2 per layer fwd, 2 bwd) on activations;
        # DP gradient reduce-scatter+all-gather
        tp_coll = 4 * 2 * tokens * d * L * 2 / max(layout.tp, 1) if layout.tp > 1 else 0.0
        dp_coll = 2 * n_total * bytes_param if layout.dp > 1 else 0.0
        dcn_coll = (
            2 * n_total * (1 if layout.compress_dcn else bytes_param)
            if layout.pods > 1
            else 0.0
        )
        coll_s = (tp_coll + dp_coll) / (chips * TPU_V5E_ICI_BW) + dcn_coll / (
            layout.pods * 8 * DCN_BW
        )
    elif suite.kind == "prefill":
        tokens = B * S
        flops = 2 * n_active * tokens
        # attention flops (quadratic part) — significant at 32k
        hd = cfg.resolved_head_dim
        if cfg.num_heads:
            win = cfg.window or S
            eff = min(win, S)
            flops += 4 * B * cfg.num_heads * hd * S * eff * _global_frac(cfg)
        hbm_bytes = n_active * bytes_param + 2 * tokens * d * L * 2
        tp_coll = 2 * 2 * tokens * d * L * 2 / max(layout.tp, 1) if layout.tp > 1 else 0.0
        coll_s = tp_coll / (chips * TPU_V5E_ICI_BW)
    else:  # decode: one token per sequence
        tokens = B
        flops = 2 * n_active * tokens
        kv = kv_cache_bytes(cfg, B, S)
        hbm_bytes = n_active * bytes_param + kv
        tp_coll = 2 * 2 * tokens * d * L * 2 / max(layout.tp, 1) if layout.tp > 1 else 0.0
        coll_s = tp_coll / (chips * TPU_V5E_ICI_BW)

    resident = (
        (n_total * bytes_param) / (layout.dp * layout.tp if layout.fsdp else layout.tp)
        + (n_total * bytes_opt) / (layout.dp * layout.tp if layout.fsdp else layout.tp)
        * (1 if suite.kind == "train" else 0)
        + (kv_cache_bytes(cfg, B, S) / chips if suite.kind != "train" else 0)
    )
    return RooflineEstimate(
        compute_s=flops / (chips * TPU_V5E_PEAK_FLOPS),
        memory_s=hbm_bytes / (chips * TPU_V5E_HBM_BW),
        collective_s=coll_s,
        hbm_per_chip=resident,
    )


def _global_frac(cfg: ModelConfig) -> float:
    """Fraction of layers doing full-length attention."""
    if cfg.family in ("ssm",):
        return 0.0
    if cfg.family == "hybrid":
        return 1.0 / max(cfg.hybrid_period, 1)
    if cfg.local_global:
        return 0.5
    return 1.0


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Bytes of a bf16 KV cache (f32 SSM state) for ``batch`` sequences of
    ``seq`` positions, window slots capped at the window.  The one owner of
    this count: ``serve/kvcache.py`` re-exports it."""
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        return cfg.num_layers * batch * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
    if cfg.family == "hybrid":
        ssm = cfg.num_layers * batch * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
        n_inv = sum(1 for i in range(cfg.num_layers) if (i + 1) % cfg.hybrid_period == 0)
        return ssm + n_inv * batch * cfg.num_kv_heads * seq * hd * 2 * 2
    if cfg.num_kv_heads == 0:
        return 0.0
    total = 0.0
    for i in range(cfg.num_layers):
        w = cfg.window if (cfg.window and (not cfg.local_global or i % 2 == 0)) else None
        s_eff = min(w, seq) if w else seq
        total += batch * cfg.num_kv_heads * s_eff * hd * 2 * 2
    if cfg.family == "encdec":
        total += cfg.num_layers * batch * cfg.num_kv_heads * cfg.enc_frames * hd * 2 * 2
    return total


def enumerate_layouts(
    chips: int = 256, pods: int = 1, *, train: bool = False
) -> list[Layout]:
    """Candidate layouts on a fixed chip budget (powers of two)."""
    out = []
    tp_opts = [1, 2, 4, 8, 16, 32]
    for tp in tp_opts:
        if chips % tp:
            continue
        dp = chips // tp
        for mb in ([1, 2, 4] if train else [1]):
            for remat in ([True, False] if train else [True]):
                out.append(
                    Layout(dp=dp, tp=tp, pods=pods, microbatches=mb, remat=remat)
                )
    return out


def best_layout(
    cfg: ModelConfig,
    suite: ShapeSuite,
    *,
    chips: int = 256,
    pods: int = 1,
    hbm_per_chip: float = 16 * 1024**3,
) -> tuple[Layout, RooflineEstimate]:
    """Pick the layout minimizing the paper's objective for one job:
    α·usage + β·makespan with usage = chips (fixed here) → min step time,
    subject to the HBM capacity constraint (the paper's Eq. 2 analogue)."""
    best = None
    for lay in enumerate_layouts(chips, pods, train=(suite.kind == "train")):
        est = estimate(cfg, suite, lay)
        if est.hbm_per_chip > hbm_per_chip:
            continue
        if best is None or est.step_s < best[1].step_s:
            best = (lay, est)
    if best is None:  # nothing fits — return least-memory layout
        lay = Layout(dp=chips // 32 if chips >= 32 else 1, tp=min(32, chips))
        best = (lay, estimate(cfg, suite, lay))
    return best
