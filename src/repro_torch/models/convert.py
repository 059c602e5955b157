"""The reference's parameters as the port's modules.

The reference keeps a model's parameters as a pytree, ``{"embed": {"tok",
"unembed"?}, "blocks": ..., "ln_final": {"scale"}}``, with the layers
stacked on a leading axis of each leaf: for a dense or MoE transformer
``blocks`` is one dict per window slot, each leaf with a leading
layer-group axis (an MoE block's ``moe`` holds ``router.w`` ``[d, E]``,
f32 even in a bf16 model, and ``gate``, ``up``, ``down`` ``[E, d, f]`` /
``[E, f, d]``, each behind that axis); for
the ssm and hybrid families it is one dict ``{"ln", "mamba"}`` with a
leading layer axis, and the hybrid's ``shared`` block is not stacked; a vlm
is a transformer with ``patch_pos``; an encdec model has ``enc_blocks`` and
``dec_blocks``, each stacked on a layer axis, and ``pos_enc``, ``pos_dec``
and ``ln_enc_final`` beside ``embed`` and ``ln_final``.  The port's modules
name their parameters by the same keys and give the stacked axis as a
module index: ``blocks.<slot>.<group>.<path>``
(:class:`~repro_torch.models.transformer.Transformer`,
:class:`~repro_torch.models.vlm.VLM`), ``blocks.<layer>.<path>``
(:class:`~repro_torch.models.ssm.Mamba2LM`,
:class:`~repro_torch.models.hybrid.HybridLM`) or ``enc_blocks.<layer>``,
``dec_blocks.<layer>`` (:class:`~repro_torch.models.encdec.EncDec`).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.ssm import Mamba2LM
from repro_torch.models.transformer import Transformer
from repro_torch.models.vlm import VLM


def flatten(tree: Mapping, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(dotted key path, leaf) of a nested mapping."""
    for key, node in tree.items():
        if isinstance(node, Mapping):
            yield from flatten(node, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", node


def load_arrays(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy the leaves of ``tree`` (numpy arrays, or anything ``np.asarray``
    takes, in f32 or bf16) into the parameters of ``module`` that carry
    their key paths, each cast to the dtype and device of its own parameter
    (a bf16 model keeps its f32 parameters f32).  Raises if a key is missing
    or left over, or a shape differs."""
    params = dict(module.named_parameters())

    def leaf(key: str, value) -> torch.Tensor:
        t = torch.from_numpy(np.asarray(value).astype(np.float32))
        p = params.get(key)  # a key left over is load_state_dict's to refuse
        return t if p is None else t.to(device=p.device, dtype=p.dtype)

    module.load_state_dict({k: leaf(k, v) for k, v in flatten(tree)}, strict=True)
    return module


def _unstack(stack: Mapping) -> dict:
    """A pytree whose leaves share a leading axis -> ``{"<i>": the i-th
    slice of every leaf}``."""
    leaves = dict(flatten(stack))
    n = len(next(iter(leaves.values())))
    return {str(i): {k: np.asarray(v)[i] for k, v in leaves.items()} for i in range(n)}


def params_from_arrays(tree: Mapping, cfg: ModelConfig, device: torch.device | str = "cuda"
                       ) -> Transformer | VLM | Mamba2LM | HybridLM | EncDec:
    """The port's parameters holding the values of the reference pytree
    ``tree`` of a model of any family, in ``cfg.dtype`` on ``device`` (f32
    where the model keeps a parameter in f32)."""
    flat = {"embed": tree["embed"], "ln_final": tree["ln_final"]}
    if cfg.family == "encdec":
        flat.update({k: tree[k] for k in ("pos_enc", "pos_dec", "ln_enc_final")})
        flat["enc_blocks"] = _unstack(tree["enc_blocks"])
        flat["dec_blocks"] = _unstack(tree["dec_blocks"])
        params = EncDec(cfg, torch.device("meta"))
    elif cfg.family == "ssm":
        flat["blocks"] = _unstack(tree["blocks"])
        params = Mamba2LM(cfg, torch.device("meta"))
    elif cfg.family == "hybrid":
        flat["blocks"] = _unstack(tree["blocks"])
        flat["shared"] = tree["shared"]
        params = HybridLM(cfg, torch.device("meta"))
    else:
        flat["blocks"] = {str(slot): _unstack(stack) for slot, stack in enumerate(tree["blocks"])}
        if cfg.family == "vlm":
            flat["patch_pos"] = tree["patch_pos"]
            params = VLM(cfg, torch.device("meta"))
        else:
            params = Transformer(cfg, torch.device("meta"))
    return load_arrays(params.to_empty(device=device), flat)


def named_arrays(tree: Mapping, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """A reference pytree shaped as the model's parameters (its gradients,
    its AdamW moments) as ``{port parameter name: f32 CPU tensor}``, for
    comparing leaf by leaf."""
    module = params_from_arrays(tree, dataclasses.replace(cfg, dtype="float32"), device="cpu")
    return {k: p.detach() for k, p in module.named_parameters()}
