"""Sharding rule tables: which slice of each tensor each device holds, by
name, for every architecture family, with divisibility-aware fallbacks.

Ported from the reference's ``repro/distributed/sharding.py``, rule for
rule.  Strategy on the mesh ``(data=16, model=16)`` (with a leading ``pod``):

* parameters: FSDP over ``data`` on the d_model-ish dimension, TP over
  ``model`` on heads, ffn width, vocabulary or experts; replicated over
  ``pod`` (pure data parallelism across pods) unless ``fsdp_over_pod``;
* activations: batch over (``pod``, ``data``); KV caches shard their kv
  heads over ``model`` when those divide, else their sequence; a batch of
  one at long context shards the sequence over every axis left;
* every rule checks divisibility and degrades to replication on that axis,
  never to a failure.

A spec is a tuple with one entry per dimension: ``None`` (replicated), an
axis name, or a tuple of axis names (the reference's ``PartitionSpec``).
Parameters are keyed by the port's names (``blocks.<slot>.<group>.attn.q.w``;
``models/convert.py``).  The reference stacks a model's layers on a leading
axis that these rules leave ``None``; the port holds each layer as a module
of its own, so a port spec is the reference's spec of the stacked leaf
without that leading entry.  :func:`local_shape` is one device's shape
under a spec (``NamedSharding(mesh, spec).shard_shape``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Iterator, Mapping

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig

Spec = tuple  # (None | str | tuple[str, ...], ...)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    dp_axes: tuple[str, ...] = ("data",)  # batch axes
    tp_axes: tuple[str, ...] = ("model",)  # tensor-parallel axes
    fsdp_over_pod: bool = False  # also FSDP parameters over "pod"
    shard_kv_seq: bool = True  # allow sequence-sharded KV caches
    # None -> FSDP parameters over dp_axes; () -> no FSDP (TP-only
    # parameters, no per-layer weight all-gather)
    param_fsdp_axes: tuple[str, ...] | None = None
    sequence_parallel: bool = False  # shard the residual stream's sequence over tp_axes

    def param_fsdp(self) -> tuple[str, ...]:
        base = self.dp_axes if self.param_fsdp_axes is None else self.param_fsdp_axes
        return (("pod",) + base) if self.fsdp_over_pod else base

    def batch_axes(self, mesh: Mesh) -> tuple[str, ...]:
        return tuple(a for a in ("pod",) + self.dp_axes if a in mesh.axis_names)


def axes_of(entry) -> tuple[str, ...]:
    """The axes of one spec entry: ``None`` -> (), ``"a"`` -> ("a",)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_size(mesh: Mesh, axes: tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes if a in mesh.axis_names)


def _fit(mesh: Mesh, axes: tuple[str, ...], dim: int):
    """The axis (or axis tuple) if ``dim`` divides over it, else the longest
    suffix that divides, else None."""
    axes = tuple(a for a in axes if a in mesh.axis_names)
    if not axes:
        return None
    if dim % axes_size(mesh, axes) == 0:
        return axes if len(axes) > 1 else axes[0]
    for i in range(1, len(axes)):  # drop from the left (pod first)
        sub = axes[i:]
        if dim % axes_size(mesh, sub) == 0:
            return sub if len(sub) > 1 else sub[0]
    return None


def local_shape(shape: tuple[int, ...], spec: Spec, mesh: Mesh) -> tuple[int, ...]:
    """One device's shape of a tensor of ``shape`` laid out by ``spec``.
    Raises on a spec that maps an axis to two dimensions, as
    ``NamedSharding`` does."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not fit shape {tuple(shape)}")
    used = [a for entry in spec for a in axes_of(entry)]
    if len(used) != len(set(used)):
        raise ValueError(f"spec {spec} maps an axis to more than one dimension")
    out = []
    for n, entry in zip(shape, spec):
        k = axes_size(mesh, axes_of(entry))
        if n % k:
            raise ValueError(f"dimension {n} does not divide over {entry} ({k})")
        out.append(n // k)
    return tuple(out)


_IN_RULES = (  # (d_in, out)-shaped products: FSDP x TP
    re.compile(r"(attn|self_attn|cross_attn)/(q|k|v)/w$"),
    re.compile(r"(mlp|moe)?/?(gate|up)/w$"),
    re.compile(r"in_proj/w$"),
)
_OUT_RULES = (  # (in, d_out)-shaped: TP x FSDP
    re.compile(r"(attn|self_attn|cross_attn)/o/w$"),
    re.compile(r"down/w$"),
    re.compile(r"out_proj/w$"),
)


def param_spec(name: str, shape: tuple[int, ...], cfg: ModelConfig, mesh: Mesh,
               policy: ShardingPolicy) -> Spec:
    """The spec of one parameter, by its name (the port's dotted name or the
    reference's ``/`` path) and its trailing dimensions; leading dimensions
    get None."""
    path = name.replace(".", "/")
    rank = len(shape)
    fsdp = policy.param_fsdp()
    tp = policy.tp_axes

    def pad(tail: list) -> Spec:
        return tuple([None] * (rank - len(tail)) + tail)

    if path.endswith("embed/tok"):
        return pad([_fit(mesh, tp, shape[-2]), _fit(mesh, fsdp, shape[-1])])
    if path.endswith("embed/unembed"):
        return pad([_fit(mesh, fsdp, shape[-2]), _fit(mesh, tp, shape[-1])])
    if re.search(r"moe/(gate|up)$", path):  # [E, d, f]
        e, d, f = shape[-3:]
        if e % axes_size(mesh, tp) == 0:
            return pad([_fit(mesh, tp, e), _fit(mesh, fsdp, d), None])
        return pad([None, _fit(mesh, fsdp, d), _fit(mesh, tp, f)])
    if path.endswith("moe/down"):  # [E, f, d]
        e, f, d = shape[-3:]
        if e % axes_size(mesh, tp) == 0:
            return pad([_fit(mesh, tp, e), None, _fit(mesh, fsdp, d)])
        return pad([None, _fit(mesh, tp, f), _fit(mesh, fsdp, d)])
    if path.endswith("router/w"):
        return pad([_fit(mesh, fsdp, shape[-2]), None])
    for rule in _IN_RULES:
        if rule.search(path):
            return pad([_fit(mesh, fsdp, shape[-2]), _fit(mesh, tp, shape[-1])])
    for rule in _OUT_RULES:
        if rule.search(path):
            return pad([_fit(mesh, tp, shape[-2]), _fit(mesh, fsdp, shape[-1])])
    if path.endswith("conv_w"):  # [k, C]
        return pad([None, _fit(mesh, tp, shape[-1])])
    if re.search(r"(A_log|dt_bias|D)$", path):
        return pad([_fit(mesh, tp, shape[-1])])
    if re.search(r"(pos_enc|pos_dec|patch_pos)$", path):
        return pad([None, _fit(mesh, fsdp, shape[-1])])
    if path.endswith("/b"):  # biases
        return pad([_fit(mesh, tp, shape[-1])])
    return (None,) * rank  # norm scales and anything small: replicated


def _named(tree) -> dict[str, torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def make_param_shardings(mesh: Mesh, cfg: ModelConfig, params,
                         policy: ShardingPolicy = ShardingPolicy()) -> dict[str, Spec]:
    """``{name: spec}`` of a model's parameters (a module, or a mapping of
    names to tensors)."""
    return {k: param_spec(k, tuple(p.shape), cfg, mesh, policy) for k, p in _named(params).items()}


def make_opt_shardings(mesh: Mesh, cfg: ModelConfig, opt_state: Mapping, param_shardings: dict,
                       policy: ShardingPolicy = ShardingPolicy()) -> dict:
    """AdamW's moments (and master copy) mirror the parameters; the step
    counter is replicated."""
    return {key: (param_shardings if key in ("m", "v", "master") else ()) for key in opt_state}


def batch_shardings(mesh: Mesh, cfg: ModelConfig, batch: Mapping,
                    policy: ShardingPolicy = ShardingPolicy()) -> dict[str, Spec]:
    """Each batch input split on its first (batch) dimension."""
    dp = policy.batch_axes(mesh)
    return {k: (_fit(mesh, dp, x.shape[0]),) + (None,) * (x.dim() - 1) for k, x in batch.items()}


def cache_spec(path: str, shape: tuple[int, ...], cfg: ModelConfig, mesh: Mesh,
               policy: ShardingPolicy) -> Spec:
    """The spec of one cache leaf by its ``/`` path (``kv/0/k``,
    ``layers/ssm``, ``self_k``, ...)."""
    dp = policy.batch_axes(mesh)
    tp = policy.tp_axes
    rank = len(shape)
    if rank == 5 and re.search(r"(k|v)$", path):  # KV cache [n_layers, B, Hkv, S, D]
        _, b, hkv, s, _ = shape
        b_ax = _fit(mesh, dp, b)
        h_ax = _fit(mesh, tp, hkv)
        used = set(axes_of(b_ax)) | set(axes_of(h_ax))
        s_ax = None
        if h_ax is None and policy.shard_kv_seq:
            s_ax = _fit(mesh, tuple(a for a in tp if a not in used), s)
        if b_ax is None and policy.shard_kv_seq:
            # a batch of one at long context: the sequence over everything left
            cands = tuple(a for a in dp + tp if a not in used | set(axes_of(s_ax)))
            s_ax = _fit(mesh, cands, s) or s_ax
        return (None, b_ax, h_ax, s_ax, None)
    if path.endswith("ssm"):  # [L, B, H, P, N]
        _, b, h, _, _ = shape
        return (None, _fit(mesh, dp, b), _fit(mesh, tp, h), None, None)
    if path.endswith("conv"):  # [L, B, k, C]
        _, b, _, c = shape
        return (None, _fit(mesh, dp, b), None, _fit(mesh, tp, c))
    if rank >= 1 and shape and shape[0] > 1:
        return (_fit(mesh, dp, shape[0]),) + (None,) * (rank - 1)
    return (None,) * rank


def cache_leaves(cache: Mapping, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(``/`` path, leaf) of a cache: nested dicts and tuples (``kv/0/k``)."""
    items = cache.items() if isinstance(cache, Mapping) else enumerate(cache)
    for key, node in items:
        path = f"{prefix}{key}"
        if isinstance(node, (Mapping, tuple, list)):
            yield from cache_leaves(node, path + "/")
        else:
            yield path, node


def make_cache_shardings(mesh: Mesh, cfg: ModelConfig, cache: Mapping,
                         policy: ShardingPolicy = ShardingPolicy()) -> dict[str, Spec]:
    """``{path: spec}`` of a cache's tensors; the position is replicated."""
    out = {}
    for path, leaf in cache_leaves(cache):
        if path.endswith("pos"):
            out[path] = ()
        else:
            out[path] = cache_spec(path, tuple(leaf.shape), cfg, mesh, policy)
    return out


def logits_sharding(mesh: Mesh, cfg: ModelConfig, batch: int,
                    policy: ShardingPolicy = ShardingPolicy()) -> Spec:
    """``[B, V]`` logits: the batch over the batch axes, the vocabulary over
    the tensor-parallel axes the batch leaves free."""
    dp = policy.batch_axes(mesh)
    b_ax = _fit(mesh, dp, batch)
    used = set(axes_of(b_ax))
    tp_free = tuple(a for a in policy.tp_axes if a not in used)
    return (b_ax, _fit(mesh, tp_free, cfg.vocab))
