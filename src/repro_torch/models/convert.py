"""The reference's parameters as the port's modules.

The reference keeps a dense transformer's parameters as a pytree:
``{"embed": {"tok", "unembed"?}, "blocks": (one dict per window slot, each
leaf with a leading layer-group axis), "ln_final": {"scale"}}``.  The port's
modules name their parameters by the same keys, and
:class:`~repro_torch.models.transformer.Transformer` gives the group as a
module index: ``blocks.<slot>.<group>.<path>``.
"""

from __future__ import annotations

from collections.abc import Iterator, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer


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
    their key paths, cast to each parameter's dtype and device.  Raises if a
    key is missing or left over, or a shape differs."""
    ref = next(module.parameters())
    module.load_state_dict(
        {k: torch.from_numpy(np.asarray(v).astype(np.float32)).to(device=ref.device, dtype=ref.dtype)
         for k, v in flatten(tree)},
        strict=True,
    )
    return module


def params_from_arrays(tree: Mapping, cfg: ModelConfig,
                       device: torch.device | str = "cuda") -> Transformer:
    """The port's parameters holding the values of the reference pytree
    ``tree``, in ``cfg.dtype`` on ``device``."""
    flat = {"embed": tree["embed"], "ln_final": tree["ln_final"], "blocks": {}}
    for slot, stack in enumerate(tree["blocks"]):
        n_groups = len(next(iter(dict(flatten(stack)).values())))
        flat["blocks"][str(slot)] = {
            str(grp): {k: np.asarray(v)[grp] for k, v in flatten(stack)} for grp in range(n_groups)
        }
    params = Transformer(cfg, torch.device("meta")).to_empty(device=device)
    return load_arrays(params, flat)
