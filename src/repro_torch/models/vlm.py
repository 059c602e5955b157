"""InternVL2-style VLM backbone (the vlm family): stubbed ViT patch
embeddings prepended to the text of a dense LM.

Ported from the reference's ``repro/models/vlm.py``.  The vision tower is
stubbed there, and so here: ``patches [B, P, d]`` are inputs.  The language
model is ``models/transformer.py``; this module adds the patch-position
table (``patch_pos [P, d]``) and the prefix: ``[patches + patch_pos |
token embeddings]``, run causally from position 0, so a prompt of S tokens
leaves the cache at position P + S.  Without patches (the serving engine's
text-only path) the model is the transformer.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import program as D
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


class VLM(T.Transformer):
    """The transformer's parameters and ``patch_pos [num_patches, d]``."""

    #: the parameters consumed on the whole sequence, before a program
    #: splits the residual stream (``distributed/program.py``): the prefix
    whole_sequence = ("patch_pos",)

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__(cfg, device)
        self.patch_pos = L.param(torch.empty(cfg.num_patches, cfg.d_model,
                                             dtype=L.torch_dtype(cfg.dtype), device=device))

    def init_(self, generator: torch.Generator) -> None:
        self.patch_pos.copy_(L.truncated_normal(tuple(self.patch_pos.shape), 0.02, self.patch_pos.dtype,
                                                generator, self.patch_pos.device))


def init_params(generator: torch.Generator, cfg: ModelConfig, device: torch.device | str = "cuda") -> VLM:
    """Random parameters at the reference's scales (``patch_pos`` a
    truncated normal of 0.02), drawn from ``generator`` on its own device,
    then moved to ``device``."""
    return L.init_modules(VLM(cfg, torch.device("meta")).to_empty(device=device), generator)


def _prefix_embeds(params: VLM, cfg: ModelConfig, patches: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """[patch embeddings + positions | token embeddings] -> [B, P + S, d]."""
    tok = L.embed(params.embed, tokens, cfg)
    pre = (patches + D.weight(params.patch_pos)[None]).to(tok.dtype)
    return torch.cat([pre, tok], dim=1)


def forward(params: VLM, cfg: ModelConfig, batch: dict, *, remat: bool = False) -> tuple[torch.Tensor, dict]:
    """batch {"patches": [B, P, d], "tokens": [B, S]} -> logits over the
    whole (prefix + text) sequence, [B, P + S, V] f32, and the aux dict;
    ``remat`` as the transformer's."""
    embeds = _prefix_embeds(params, cfg, batch["patches"], batch["tokens"])
    return T.forward(params, cfg, {"embeds": embeds}, remat=remat)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device | str = "cuda") -> dict:
    return T.init_cache(cfg, batch, max_len, device)


def prefill(params: VLM, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
            patches: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """The prompt behind its patches, or, without patches, the text alone."""
    if patches is not None:
        return T.prefill(params, cfg, tokens, cache, embeds=_prefix_embeds(params, cfg, patches, tokens))
    return T.prefill(params, cfg, tokens, cache)


def decode_step(params: VLM, cfg: ModelConfig, token: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
    return T.decode_step(params, cfg, token, cache)
