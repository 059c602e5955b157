"""Batched serving engine: slot-based continuous batching over the family's
prefill and decode steps.

Ported from the reference's ``repro/serve/engine.py``.  The engine owns
``max_slots`` sequence slots backed by one shared cache (the family's: KV
caches, or recurrent states).  A request is admitted when a slot frees: its
prompt is prefilled at batch 1 and every entry of its cache but the
position is merged into the slot's row; then every slot decodes in
lockstep, one token per tick, at one shared position ``max(slot_pos)``, as
the reference does.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi
from repro_torch.serve.kvcache import merge_slot


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 16
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    first_token_at: float | None = None  # time.perf_counter() when the first token was known


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 4
    max_len: int = 256


@dataclasses.dataclass
class EngineStats:
    """What the engine did: decode ticks, the tokens they produced (one per
    active slot) and their seconds, and the seconds of the prefills.  Each
    span ends when the chosen tokens reach the host, so it includes the
    device's work."""

    decode_ticks: int = 0
    decode_tokens: int = 0
    decode_s: float = 0.0
    prefills: int = 0
    prefill_s: float = 0.0


class ServeEngine:
    """Single-replica continuous-batching engine with greedy decoding on
    ``device`` (default the card; ``"cpu"`` runs the kernels' plain
    versions)."""

    def __init__(self, api: ModelApi, cfg: ModelConfig, params, ecfg: EngineConfig,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        where = params.embed.tok.device
        if where.type != self.device.type:
            raise ValueError(f"the parameters are on {where}, the engine on {self.device}")
        self.api = api
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.cache = api.init_cache(ecfg.max_slots, ecfg.max_len, cfg, device=self.device)
        self.slot_req: list[Request | None] = [None] * ecfg.max_slots
        self.slot_remaining = np.zeros(ecfg.max_slots, dtype=np.int64)
        self.slot_pos = np.zeros(ecfg.max_slots, dtype=np.int64)
        self.queue: list[Request] = []
        self.stats = EngineStats()

    # --- admission ------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.ecfg.max_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self._prefill_into_slot(slot, req)

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        # per-request prefill at batch 1 into a fresh cache, then copied into
        # the slot's row, so the row holds zeros past the prompt, as in the
        # reference
        t0 = time.perf_counter()
        tmp_cache = self.api.init_cache(1, self.ecfg.max_len, self.cfg, device=self.device)
        toks = torch.as_tensor(np.asarray(req.prompt, dtype=np.int32), device=self.device)[None]
        logits, tmp_cache = self.api.prefill(self.params, toks, tmp_cache, self.cfg)
        req.output.append(int(torch.argmax(logits[0])))
        req.first_token_at = time.perf_counter()
        states = [k for k in self.cache if k != "pos"]  # the family's caches: kv, or layers
        merge_slot({k: self.cache[k] for k in states}, {k: tmp_cache[k] for k in states}, slot,
                   self.ecfg.max_slots)
        self.slot_req[slot] = req
        self.slot_pos[slot] = len(req.prompt)
        self.slot_remaining[slot] = req.max_new_tokens - 1
        self.stats.prefills += 1
        self.stats.prefill_s += time.perf_counter() - t0

    # --- decode ----------------------------------------------------------------
    def step(self) -> None:
        """One engine tick: admit waiting requests, decode all active slots."""
        self._admit()
        active = [s for s in range(self.ecfg.max_slots) if self.slot_req[s] is not None]
        if not active:
            return
        t0 = time.perf_counter()
        tokens = np.zeros(self.ecfg.max_slots, dtype=np.int32)
        for s in active:
            tokens[s] = self.slot_req[s].output[-1]
        # lockstep decode: every slot at the engine's furthest position; the
        # per-slot positions are tracked on the host
        self.cache = {**self.cache, "pos": int(self.slot_pos.max())}
        logits, self.cache = self.api.decode_step(
            self.params, torch.as_tensor(tokens, device=self.device), self.cache, self.cfg
        )
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            req.output.append(int(nxt[s]))
            self.slot_pos[s] += 1
            self.slot_remaining[s] -= 1
            if self.slot_remaining[s] <= 0:
                req.done = True
                self.slot_req[s] = None
        self.stats.decode_ticks += 1
        self.stats.decode_tokens += len(active)
        self.stats.decode_s += time.perf_counter() - t0

    def run_until_done(self, max_ticks: int = 10000) -> None:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                return
            self.step()
        raise RuntimeError("engine did not drain")
