"""Helpers of the training parity tests (tests/test_torch_train.py,
tests/test_torch_optim_data.py, tests/test_torch_checkpoint.py): one reduced
model in both packages with the same parameters, and the same numpy
batches for each."""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.models.registry import get_model as jax_get_model

from repro_torch.models.convert import params_from_arrays
from repro_torch.models.registry import get_model

B, S = 2, 32  # S a multiple of the reduced ssm chunk (16): the reference's chunked scan


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(port, reference, atol: float, rel: float, what: str = "") -> None:
    """max |port - reference| <= atol + rel·max |reference|."""
    p, r = to_np(port), to_np(reference)
    assert p.shape == r.shape, what
    bound = atol + rel * float(np.abs(r).max())
    err = float(np.abs(p - r).max())
    assert err <= bound, (what, err, bound)


def setup(arch: str, seed: int = 0, **overrides):
    """(reference api, port api, f32 reduced config, reference tree, port
    params): the reference's parameters from its own ``init`` with every
    norm scale and bias set to seeded random values (zero would hide them),
    carried into the port's modules by ``params_from_arrays``."""
    japi, api = jax_get_model(arch), get_model(arch)
    cfg = dataclasses.replace(japi.reduced, dtype="float32", **overrides)
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key in ("scale", "b"):
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), jnp.float32).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(leaf, japi.init(jax.random.PRNGKey(seed), cfg))
    port_cfg = dataclasses.replace(api.reduced, dtype="float32", **overrides)
    return japi, api, port_cfg, tree, params_from_arrays(tree, port_cfg, device="cpu")


def batch_of(cfg, seed: int, batch: int = B, seq: int = S, mask: bool = False) -> dict[str, np.ndarray]:
    """Random tokens, with ``frames`` (encdec) or ``patches`` (vlm) and,
    with ``mask``, a random target mask."""
    rng = np.random.default_rng(100 + seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (0.1 * rng.standard_normal((batch, cfg.enc_frames, cfg.d_model))).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = (0.1 * rng.standard_normal((batch, cfg.num_patches, cfg.d_model))).astype(np.float32)
    if mask:
        out["mask"] = (rng.random((batch, seq)) < 0.7).astype(np.int32)
    return out


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def grads_close(port: dict, reference: dict, what: str) -> None:
    assert sorted(port) == sorted(reference)
    for k in reference:
        close(port[k], reference[k], 1e-5, 1e-4, f"{what} {k}")
