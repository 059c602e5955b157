"""One device's share of a sharded step: the layout each tensor takes while
the step computes, and the exchanges between devices that the layout
implies, one function each.

The rule tables (``distributed/sharding.py``) say which slice of each
tensor a device *stores*.  A device cannot compute on every such slice:
FSDP splits a weight's input dimension, and a rule may split a dimension
inside a unit of the computation (a head, a Mamba2 block's concatenated
projection).  :class:`Program` chooses, for every module of a model, the
layout its computation uses, and the model's code calls this module's
functions at the points where the layouts meet:

* :func:`weight`: a parameter gathered from its stored slice to its compute
  layout (an all-gather over FSDP and every axis the computation does not
  split), its gradient reduce-scattered back (or, over axes on which every
  device computed the same gradient, sliced);
* :func:`enter` / :func:`exit`: a module computed tensor-parallel (attention
  by whole query heads, an MLP by ffn columns, MoE experts by expert or by
  ffn columns): the input's gradient all-reduced over the tensor-parallel
  axes, the output's partial sums all-reduced (Megatron's ``f`` and ``g``);
  under sequence parallelism an all-gather of the sequence on the way in and
  a reduce-scatter on the way out.  A module computed whole on every device
  (a Mamba2 block; attention whose heads do not divide) only changes the
  sequence's layout;
* :func:`kv_heads` / :func:`kv_select`: kv heads split inside a head are
  gathered whole before attention, and each device's query heads read the
  kv heads of their group;
* :func:`decode_query` / :func:`decode_combine` / :func:`cache_span`: a
  decode step against a KV cache whose sequence is split over devices: the
  query's heads gathered, attention over the local keys by the decode
  kernel's state variant, the partial attentions combined by their softmax
  states (flash-decoding: a max all-reduce of ``[B, H]``, then a sum
  all-reduce of ``[B, H, D + 1]`` f32); the new key written by the device
  that holds its slot;
* :func:`cache_load` / :func:`cache_store` / :func:`prompt_slice`: a cache
  kept in a finer layout than its computation (a prompt's keys cut to the
  device's share of the whole cache, ring buffer included);
* :func:`lookup`, :func:`logsumexp`, :func:`pick`: the vocabulary split
  over devices (the embedding's partial rows all-reduced; the loss's max,
  sum and target logit all-reduced over ``[B, S]``);
* :func:`moe_enter`, :func:`moe_gates`, :func:`moe_means`,
  :func:`moe_offsets`, :func:`moe_dispatch` / :func:`moe_return`: a MoE
  layer.  The router reads the block's input with no exchange (its gradient
  is whole on every device of the module's axes and is taken once), the
  experts read it entered; in ``ffn`` mode the gates' gradient is summed
  over the ffn axes.  A device whose tokens are a share of the batch routes
  them as the whole batch's: the capacity of every device's tokens, each
  pair's position after the same expert's pairs on earlier devices (an
  all-gather of per-row counts), the aux loss from the batch's means (an
  all-reduce of ``[2, E]`` sums).  Each device writes its kept pairs at
  their places in the whole batch's ``[E, C, d]`` buffer, zero elsewhere,
  and the buffer reaches the experts' layout summed over the token axes
  (reduce-scatters over the axes that split the experts or the capacity,
  an all-reduce over the rest): each slot is written once, so the sum is
  exact.  The outputs come back gathered; its capacity is split over the
  axes an installed ``hints.moe_buffer_pspec`` names (else over the
  tokens' own axes);
* :func:`data_parallel_grads`: each gradient all-reduced over the batch
  axes on which its parameter is replicated;
* :func:`batch_sum` / :func:`norm_parts`: the loss's target count and
  reported terms summed over the batch axes, and each gradient's sum of
  squares over the devices that hold distinct slices of its parameter
  (the global mean and the global norm the reference takes);
* :func:`constrain` (through ``hints.constrain``): the residual stream laid
  out by an installed spec.

With no program installed every function returns its input itself, so the
model's code runs as before, bit for bit.

A :class:`Program` runs on one of two backends.  :class:`CountingComm` is
the dry-run's plan of device 0's step, on meta: its exchanges return
tensors of the result's shape and tell a counter the bytes
(``kernels/work.py::collective``), and every device's coordinates are 0.
``distributed/comm.py::DistComm`` is a real run, a process a device: its
exchanges are ``torch.distributed`` collectives, counted alike.  Every body
takes its slices at the device's own offset along the axes it cuts
(``comm.coords``), with the same operations at every offset, so that every
device counts what device 0's plan counts.  :meth:`Program.localize` with
``source`` cuts a whole model's weights to the device's stored slices, or
draws them a module at a time from a seed (a model larger than one card).
No body asks which backend it runs on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from collections.abc import Iterator, Mapping

import torch
from torch import nn

from repro_torch.distributed import hints
from repro_torch.distributed.comm import shard_index
from repro_torch.distributed.sharding import (
    ShardingPolicy,
    Spec,
    axes_of,
    cache_leaves,
    make_param_shardings,
)
from repro_torch.kernels import work
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig

_PROGRAM: Program | None = None


@contextlib.contextmanager
def installed(program: Program | None) -> Iterator[Program | None]:
    """Run the model's code as ``program``'s share of the step."""
    global _PROGRAM
    prev = _PROGRAM
    _PROGRAM = program
    try:
        yield program
    finally:
        _PROGRAM = prev


def current() -> Program | None:
    return _PROGRAM


# -----------------------------------------------------------------------------
# Exchanges
# -----------------------------------------------------------------------------


class CountingComm:
    """The dry-run's exchanges: each returns a tensor of its result's shape
    (its values undefined; the dry-run runs on meta) and tells the counters
    its kind and result bytes.  It plans device 0: every coordinate is 0."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.coords = {a: 0 for a in mesh.axis_names}

    def size(self, axes: tuple[str, ...]) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def _out(self, kind: str, x: torch.Tensor, shape) -> torch.Tensor:
        out = x.new_empty(shape)
        work.collective(kind, out.numel() * out.element_size(), out)
        return out

    def all_gather(self, x: torch.Tensor, dim: int, axes: tuple[str, ...]) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim] *= self.size(axes)
        return self._out("all-gather", x, shape)

    def reduce_scatter(self, x: torch.Tensor, dim: int, axes: tuple[str, ...]) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim] //= self.size(axes)
        return self._out("reduce-scatter", x, shape)

    def all_reduce(self, x: torch.Tensor, axes: tuple[str, ...], op: str = "sum") -> torch.Tensor:
        return self._out("all-reduce", x, x.shape)

    def gather_to(self, x: torch.Tensor, shape, axes=None) -> torch.Tensor:
        """``x`` gathered to ``shape`` (over ``axes``, ``{dim: axes}``)."""
        return self._out("all-gather", x, shape)

    def reduce_scalars(self, values, axes: tuple[str, ...]) -> list[torch.Tensor]:
        """The plan has no exchange of a few scalars: ``values`` as they are."""
        return list(values)


class _Exchange(torch.autograd.Function):
    """``fwd(x)`` forward and ``bwd(grad)`` backward."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.bwd(grad), None, None


def _exchange(x: torch.Tensor, fwd, bwd) -> torch.Tensor:
    return _Exchange.apply(x, fwd, bwd)


class _Fork(torch.autograd.Function):
    """``fwd(x)`` forward, as two outputs whose gradients come back by
    different rules: ``bwd_a(grad_a) + bwd_b(grad_b)``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd_a, bwd_b):
        ctx.bwd_a, ctx.bwd_b = bwd_a, bwd_b
        y = fwd(x)
        return y, y.view_as(y)

    @staticmethod
    def backward(ctx, grad_a, grad_b):
        return ctx.bwd_a(grad_a) + ctx.bwd_b(grad_b), None, None, None


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x.view_as(x)


# -----------------------------------------------------------------------------
# The plan of one model's step
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModulePlan:
    """How one module computes: ``kind`` ``"tp"`` (split over ``axes``) or
    ``"whole"`` (every device the whole module), with the attention's heads
    (``heads`` query heads, ``kv_heads`` held after the projection,
    ``kv_read`` read by the kernel; ``kv_mode`` ``split``, ``gather`` or
    ``full``) and the MoE's ``moe_mode`` (``experts`` or ``ffn``) and
    ``capacity_axes`` (the axes its buffer's capacity is split over while
    the experts compute; None: the tokens' own)."""

    kind: str
    axes: tuple[str, ...] = ()
    heads: int = 0
    kv_heads: int = 0
    kv_read: int = 0
    kv_mode: str = ""
    kv_axes: tuple[str, ...] = ()
    moe_mode: str = ""
    capacity_axes: tuple[str, ...] | None = None


@dataclasses.dataclass(frozen=True)
class WeightPlan:
    """How a parameter goes from its stored slice to its compute layout:
    the axes gathered per dimension, and which of them its gradient is
    reduced over (the rest are sliced: every device there computed the same
    gradient).  ``whole_axes``: the sequence-parallel axes over which every
    device computed the parameter's whole gradient, because it is consumed
    on the whole sequence; its gradient is neither reduce-scattered nor
    all-reduced over them."""

    gathers: tuple[tuple[int, tuple[str, ...]], ...]  # (dim, axes), in order
    reduce_axes: frozenset
    whole_axes: frozenset = frozenset()


def _kept(entry, batch_axes: tuple[str, ...]) -> tuple[str, ...]:
    """The axes of a stored dimension that the computation keeps split:
    those the batch does not already split."""
    return tuple(a for a in axes_of(entry) if a not in batch_axes)


class Program:
    """One device's share of a step of ``params`` (a model built at global
    shapes, whose parameters :meth:`localize` replaces by their stored
    slices) on ``mesh`` under ``policy``.  ``batch_axes``: the axes that
    split the batch; ``seq_len``: the sequence the forward runs (for
    sequence parallelism).  :meth:`add_cache` gives a serving step's cache
    and its specs."""

    def __init__(self, mesh: Mesh, policy: ShardingPolicy, cfg: ModelConfig, params: nn.Module, *,
                 batch_axes: tuple[str, ...], seq_len: int, comm=None):
        self.mesh, self.policy, self.cfg = mesh, policy, cfg
        self.comm = CountingComm(mesh) if comm is None else comm
        if self.comm.mesh != mesh:
            raise ValueError(f"the backend's mesh {self.comm.mesh} is not the program's {mesh}")
        self.batch_axes = tuple(a for a in batch_axes if mesh.shape[a] > 1)
        self.specs: dict[str, Spec] = make_param_shardings(mesh, cfg, params, policy)
        tp = tuple(a for a in policy.tp_axes if a in mesh.axis_names and mesh.shape[a] > 1)
        self._sp_axes: tuple[str, ...] = ()  # the families whose forwards call hints.constrain
        if (policy.sequence_parallel and tp and seq_len % self.size(tp) == 0
                and cfg.family in ("dense", "moe", "vlm", "ssm", "hybrid")):
            self._sp_axes = tp
        self.seq_len = seq_len
        self.moe_spec = hints.get_moe_buffer_pspec()
        self.modules: dict[int, ModulePlan] = {}
        self.weights: dict[int, WeightPlan] = {}
        self.cache_axes: dict[int, dict[int, tuple[str, ...]]] = {}  # storage -> {dim: axes}
        self.vocab_axes: tuple[str, ...] = ()
        self._plan(params)

    @property
    def sp_axes(self) -> tuple[str, ...]:
        """The axes splitting the residual stream's sequence: the policy's
        tensor-parallel axes under sequence parallelism while the
        activation hint is installed (``hints.activation_pspec``)."""
        return self._sp_axes if hints.get_activation_pspec() is not None else ()

    # -- sizes ---------------------------------------------------------------------
    def size(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def live(self, axes) -> tuple[str, ...]:
        """The axes of more than one device."""
        return tuple(a for a in axes if self.mesh.shape[a] > 1)

    def index(self, axes) -> int:
        """This device's chunk of a dimension split over ``axes`` (in their
        order: the first varies slowest)."""
        return shard_index(self.mesh, axes, self.comm.coords)

    def _own(self, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """This device's chunk of ``x``'s ``dim`` split over ``axes`` (a view)."""
        n = x.shape[dim] // self.size(axes)
        return x.narrow(dim, self.index(axes) * n, n)

    def _placed(self, g: torch.Tensor, dim: int, axes, total: int) -> torch.Tensor:
        """``g`` (this device's chunk of ``dim`` split over ``axes``) in a
        tensor of ``total`` along ``dim``, zero elsewhere: the zeros before
        and after it, either empty, so every offset runs the same ops."""
        before = self.index(axes) * g.shape[dim]
        shape = list(g.shape)
        shape[dim] = before
        head = torch.zeros(shape, dtype=g.dtype, device=g.device)
        shape[dim] = total - before - g.shape[dim]
        return torch.cat([head, g, g.new_zeros(shape)], dim=dim)

    # -- planning ------------------------------------------------------------------
    def _spec(self, module_name: str, leaf: str) -> Spec:
        return self.specs[f"{module_name}.{leaf}" if module_name else leaf]

    def _attention_plan(self, name: str, cfg: ModelConfig) -> ModulePlan:
        H, Hkv = cfg.num_heads, cfg.num_kv_heads
        q_axes = self.live(_kept(self._spec(name, "q.w")[1], self.batch_axes))
        o_axes = self.live(_kept(self._spec(name, "o.w")[0], self.batch_axes))
        n = self.size(q_axes)
        if not q_axes or q_axes != o_axes or H % n:
            return ModulePlan("whole", heads=H, kv_heads=Hkv, kv_read=Hkv, kv_mode="full")
        k_axes = self.live(_kept(self._spec(name, "k.w")[1], self.batch_axes))
        H_loc, group = H // n, H // Hkv
        if k_axes == q_axes and Hkv % n == 0:
            return ModulePlan("tp", q_axes, H_loc, Hkv // n, Hkv // n, "split")
        read = max(1, H_loc // group)
        if H_loc % read or (H_loc > group and H_loc % group):
            raise ValueError(f"{H_loc} query heads a device do not read whole kv groups of {group}")
        return ModulePlan("tp", q_axes, H_loc, Hkv, read, "gather" if k_axes else "full", k_axes)

    def _mlp_plan(self, name: str) -> ModulePlan:
        up = self.live(_kept(self._spec(name, "up.w")[1], self.batch_axes))
        down = self.live(_kept(self._spec(name, "down.w")[0], self.batch_axes))
        return ModulePlan("tp", up) if up and up == down else ModulePlan("whole")

    def _moe_plan(self, name: str) -> ModulePlan:
        """Experts split where the rule tables store them split, or where an
        installed buffer spec ``(experts, capacity, None)`` says (a split
        that does not divide the experts degrades to none, as ``_fit``
        does); else the ffn columns where those are split."""
        spec, cap = self.moe_spec, None
        if spec is None:
            e_axes = self.live(_kept(self._spec(name, "gate")[0], self.batch_axes))
        else:
            e_axes, cap = (self.live(a for a in axes_of(e) if a in self.mesh.shape) for e in spec[:2])
            if self.cfg.num_experts % self.size(e_axes):
                e_axes = ()
            if set(e_axes) & set(cap):
                raise ValueError(f"the MoE buffer spec {spec} maps an axis twice")
        if e_axes:
            return ModulePlan("tp", e_axes, moe_mode="experts", capacity_axes=cap)
        f_axes = self.live(_kept(self._spec(name, "gate")[2], self.batch_axes))
        if f_axes and f_axes == self.live(_kept(self._spec(name, "down")[1], self.batch_axes)):
            return ModulePlan("tp", f_axes, moe_mode="ffn", capacity_axes=cap)
        return ModulePlan("whole", capacity_axes=cap)

    def _kept_dims(self, pname: str, shape, plan: ModulePlan | None) -> dict[int, tuple[str, ...]]:
        """The dimensions of a parameter the computation keeps split."""
        spec = self.specs[pname]
        leaf = pname.rsplit(".", 2)[-2:]
        kept = {}
        if plan is None or plan.kind != "tp":
            return kept
        axes = plan.axes
        tail = ".".join(leaf)
        if plan.heads:  # attention
            if tail in ("q.w", "q.b"):
                kept[len(shape) - 1] = axes
            elif tail in ("k.w", "k.b", "v.w", "v.b") and plan.kv_mode in ("split", "gather"):
                kept[len(shape) - 1] = plan.kv_axes if plan.kv_mode == "gather" else axes
            elif tail == "o.w":
                kept[0] = axes
        elif plan.moe_mode == "experts":
            if leaf[-1] in ("gate", "up", "down"):
                kept[0] = axes
        elif plan.moe_mode == "ffn":
            if leaf[-1] in ("gate", "up"):
                kept[2] = axes
            elif leaf[-1] == "down":
                kept[1] = axes
        else:  # mlp
            if tail in ("gate.w", "up.w", "up.b"):
                kept[len(shape) - 1] = axes
            elif tail == "down.w":
                kept[0] = axes
        for dim, a in kept.items():  # the stored split must be the kept one
            if self.live(axes_of(spec[dim])) and set(self.live(axes_of(spec[dim]))) >= set(a):
                continue
            raise ValueError(f"{pname}: stored {spec} cannot compute split over {a} on dim {dim}")
        return kept

    def _plan(self, params: nn.Module) -> None:
        from repro_torch.models import layers as L  # the models import this module
        from repro_torch.models.mamba import Mamba2
        from repro_torch.models.moe import MoE

        cfg = self.cfg
        self.embed_axes: tuple[str, ...] = ()
        owner: dict[str, ModulePlan] = {}
        attn = None
        for name, m in params.named_modules():
            plan = None
            if isinstance(m, L.Attention):
                plan = self._attention_plan(name, cfg)
                if attn is not None and plan != attn:
                    raise ValueError(f"{name}: attention layouts differ across layers")
                attn = plan
            elif isinstance(m, L.MLP):
                plan = self._mlp_plan(name)
            elif isinstance(m, MoE):
                plan = self._moe_plan(name)
            elif isinstance(m, Mamba2):
                plan = ModulePlan("whole")
            elif isinstance(m, L.Embed):
                v = self.live(_kept(self._spec(name, "tok")[0], self.batch_axes))
                if m.unembed is not None:
                    u = self.live(_kept(self._spec(name, "unembed")[1], self.batch_axes))
                else:
                    u = v
                self.embed_axes, self.vocab_axes = v, u
                plan = ModulePlan("tp" if v else "whole", v)
            if plan is not None:
                self.modules[id(m)] = plan
                owner[name] = plan
        self.attention = attn
        whole_seq = set(getattr(params, "whole_sequence", ()))
        for pname, p in params.named_parameters():
            mod = pname.rsplit(".", 1)[0]
            plan = owner.get(mod) or owner.get(mod.rsplit(".", 1)[0] if "." in mod else "")
            spec = self.specs[pname]
            # consumed on the whole sequence: a module computed whole (its
            # input's sequence gathered), the router of a MoE that does not
            # route a device's own share, a parameter the model names
            whole = frozenset(self._sp_axes) if (
                pname in whole_seq or (plan is not None and plan.kind == "whole")
                or (pname.endswith("router.w") and plan is not None and plan.moe_mode == "ffn")) else frozenset()
            if pname.endswith("embed.tok"):
                kept = {0: self.embed_axes} if self.embed_axes else {}
            elif pname.endswith("embed.unembed"):
                kept = {1: self.vocab_axes} if self.vocab_axes else {}
            else:
                kept = self._kept_dims(pname, p.shape, plan)
            gathers = []
            for dim, entry in enumerate(spec):
                axes = self.live(axes_of(entry))
                extra = tuple(a for a in axes if a not in kept.get(dim, ()))
                if extra:
                    gathers.append((dim, extra))
            self.weights[pname] = WeightPlan(
                tuple(gathers), frozenset(a for _, axes in gathers for a in axes
                                          if a in self.batch_axes or (a in self._sp_axes and a not in whole)), whole)

    def local_config(self) -> ModelConfig:
        """The config the model's code computes with: the attention's local
        query and kv heads (the head width given explicitly)."""
        cfg = self.cfg
        if self.attention is None:
            return cfg
        return dataclasses.replace(cfg, num_heads=self.attention.heads, num_kv_heads=self.attention.kv_heads,
                                   head_dim=cfg.resolved_head_dim)

    def localize(self, params: nn.Module,
                 source: nn.Module | Mapping[str, torch.Tensor] | torch.Generator | None = None) -> nn.Module:
        """Replace every parameter of ``params`` (built at global shapes) by
        its stored slice, and key the weight plans by the new parameters.
        Without ``source`` the slices are empty, on meta (the dry-run); with
        a model or ``{name: tensor}`` at global shapes (``params`` itself
        allowed) each is a copy of the device's own slice of the source's
        tensor, on its device: a sharded run starts from the same weights as
        a whole one.  With a seeded ``torch.Generator`` (``params`` then on
        meta) the model is drawn as ``models/layers.py::init_modules`` draws
        it, a module at a time on the generator's device, and each module's
        slices are kept before the next is drawn: the slices equal those of
        the whole model drawn from the same generator state, bit for bit,
        and the whole model is never held (a model larger than one card)."""
        from repro_torch.distributed.sharding import local_shape

        by_name = {}

        def keep(mod: nn.Module, leaf: str, pname: str, whole: torch.Tensor | None, like: nn.Parameter) -> None:
            spec = self.specs[pname]
            if whole is None:
                data = torch.empty(local_shape(tuple(like.shape), spec, self.mesh), dtype=like.dtype, device="meta")
            else:
                data = whole.detach()
                for dim, entry in enumerate(spec):
                    data = self._own(data, dim, axes_of(entry))
                data = data.clone()
            new = nn.Parameter(data, requires_grad=like.requires_grad)
            setattr(mod, leaf, new)
            by_name[pname] = new

        if isinstance(source, torch.Generator):
            prefix = {id(m): n for n, m in params.named_modules()}
            for mod in params.modules():
                if not hasattr(mod, "init_"):
                    continue
                mod.to_empty(device=source.device, recurse=False)
                with torch.no_grad():
                    mod.init_(source)
                for leaf, p in list(mod.named_parameters(recurse=False)):
                    keep(mod, leaf, f"{prefix[id(mod)]}.{leaf}" if prefix[id(mod)] else leaf, p, p)
            missing = {k for k, _ in params.named_parameters()} - set(by_name)
            if missing:
                raise ValueError(f"parameters no module draws: {sorted(missing)}")
        else:
            whole = None if source is None else (dict(source.named_parameters()) if isinstance(source, nn.Module)
                                                 else dict(source))
            for pname, p in list(params.named_parameters()):
                mod_name, leaf = pname.rsplit(".", 1) if "." in pname else ("", pname)
                keep(params.get_submodule(mod_name), leaf, pname, None if whole is None else whole[pname], p)
        self.weights = {id(by_name[k]): v for k, v in self.weights.items()}
        self.names = {id(p): k for k, p in by_name.items()}
        return params

    def add_cache(self, cache: Mapping, specs: Mapping[str, Spec]) -> None:
        """The cache leaves' stored splits (their storages as keys)."""
        for path, leaf in cache_leaves(cache):
            if isinstance(leaf, torch.Tensor):
                dims = {d: self.live(axes_of(e)) for d, e in enumerate(specs[path]) if self.live(axes_of(e))}
                self.cache_axes[leaf.untyped_storage()._cdata] = dims

    # -- the exchanges -----------------------------------------------------------
    def weight(self, w: torch.Tensor) -> torch.Tensor:
        plan = self.weights.get(id(w))
        if plan is None or not plan.gathers:
            return w
        comm = self.comm

        def fwd(x):
            for dim, axes in plan.gathers:
                x = comm.all_gather(x, dim, axes)
            return x

        def bwd(g):
            for dim, axes in reversed(plan.gathers):
                red = tuple(a for a in axes if a in plan.reduce_axes)
                rest = tuple(a for a in axes if a not in plan.reduce_axes)
                if red and rest and axes != red + rest:
                    raise ValueError(f"the gradient of a dimension gathered over {axes} reduces {red} after {rest}")
                if red:
                    g = comm.reduce_scatter(g, dim, red)
                if rest:
                    g = self._own(g, dim, rest)
                    if plan.whole_axes & set(rest):  # a copy: the whole gradient freed, as a reduce-scatter frees it
                        g = g.contiguous()
            return g

        return _exchange(w, fwd, bwd)

    def _seq_sharded(self, x: torch.Tensor) -> bool:
        """Whether ``x [B, S, ...]`` is a device's share of the sequence."""
        return bool(self.sp_axes) and x.dim() == 3 and x.shape[1] * self.size(self.sp_axes) == self.seq_len

    def _seq_whole(self, x: torch.Tensor) -> bool:
        return bool(self.sp_axes) and x.dim() == 3 and x.shape[1] == self.seq_len

    def enter(self, x: torch.Tensor, plan: ModulePlan) -> torch.Tensor:
        comm, sp = self.comm, self.sp_axes
        if self._seq_sharded(x):
            if plan.kind == "tp":
                return _exchange(x, lambda t: comm.all_gather(t, 1, sp), lambda g: comm.reduce_scatter(g, 1, sp))
            return _exchange(x, lambda t: comm.all_gather(t, 1, sp), lambda g: self._own(g, 1, sp))
        if plan.kind == "tp":
            return _exchange(x, _identity, lambda g: comm.all_reduce(g, plan.axes))
        return x

    def exit(self, y: torch.Tensor, plan: ModulePlan) -> torch.Tensor:
        comm, sp = self.comm, self.sp_axes
        if plan.moe_mode == "experts":  # whole outputs, in the tokens' own layout
            return y
        if self._seq_whole(y):
            if plan.kind == "tp":
                return _exchange(y, lambda t: comm.reduce_scatter(t, 1, sp), lambda g: comm.all_gather(g, 1, sp))
            return _exchange(y, lambda t: self._own(t, 1, sp), lambda g: comm.all_gather(g, 1, sp))
        if plan.kind == "tp":
            return _exchange(y, lambda t: comm.all_reduce(t, plan.axes), _identity)
        return y

    def kv_heads(self, t: torch.Tensor) -> torch.Tensor:
        plan, comm = self.attention, self.comm
        if plan.kv_mode != "gather":
            return t
        axes = plan.kv_axes
        return _exchange(t, lambda x: comm.all_gather(x, x.dim() - 1, axes),
                         lambda g: comm.reduce_scatter(g, g.dim() - 1, axes))

    def kv_select(self, k: torch.Tensor, v: torch.Tensor, heads: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The kv heads ``[B, Hkv, S, D]`` that ``heads`` query heads (this
        device's, in order) read: their groups' heads."""
        group = self.cfg.num_heads // self.cfg.num_kv_heads
        read = max(1, heads // group)
        if read == k.shape[1]:
            return k, v
        plan = self.attention
        first = self.index(plan.axes) * heads // group if plan.kind == "tp" else 0  # the first query head's group
        return k.narrow(1, first, read).contiguous(), v.narrow(1, first, read).contiguous()

    def cache_seq_axes(self, cache: torch.Tensor) -> tuple[str, ...]:
        """The axes splitting the sequence of a layer's KV cache ``[B, Hkv,
        S, D]`` (dimension 3 of its stacked leaf)."""
        return self.cache_axes.get(cache.untyped_storage()._cdata, {}).get(3, ())

    def cache_span(self, cache: torch.Tensor) -> tuple[int, int]:
        """(the first global position this device holds, the whole cache's
        positions) of a layer's KV cache ``[B, Hkv, S, D]``."""
        axes = self.cache_seq_axes(cache)
        S = cache.shape[2]
        return self.index(axes) * S, S * self.size(axes)

    def _head_seq_axes(self, seq_axes: tuple[str, ...]) -> tuple[str, ...]:
        """The axes that split both the query heads and the cache's sequence."""
        plan = self.attention
        return tuple(a for a in plan.axes if a in seq_axes) if plan.kind == "tp" else ()

    def decode_query(self, q: torch.Tensor, seq_axes: tuple[str, ...]) -> torch.Tensor:
        """Where one axis splits both the query heads and the cache's
        sequence, each device needs every head against its keys: gather."""
        axes = self._head_seq_axes(seq_axes)
        return self.comm.all_gather(q, 1, axes) if axes else q

    def decode_combine(self, o: torch.Tensor, lse: torch.Tensor, seq_axes: tuple[str, ...]) -> torch.Tensor:
        """Combine the attention ``o [B, H, D]`` over each device's share of
        the keys by the rows' softmax states ``lse [B, H]`` f32 (the decode
        kernel's state variant): ``M = max lse`` over the sequence's axes,
        ``w = exp(lse - M)``, the sums of ``w·o`` and ``w`` over them (one
        all-reduce of ``[B, H, D + 1]`` f32), their quotient; then each
        device's own query heads.  A share with no key has ``lse = -1e30``
        and weighs nothing beside one that has keys."""
        if not seq_axes:
            return o
        comm, D = self.comm, o.shape[-1]
        top = comm.all_reduce(lse, seq_axes, op="max")
        w = torch.exp(lse - top)[..., None]
        sums = comm.all_reduce(torch.cat([o.float() * w, w], dim=-1), seq_axes)
        o = (sums[..., :D] / sums[..., D:]).to(o.dtype)
        if self._head_seq_axes(seq_axes):
            o = self._own(o, 1, self._head_seq_axes(seq_axes)).contiguous()
        return o

    def cache_load(self, t: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
        dims = self.cache_axes.get(base.untyped_storage()._cdata, {})
        for dim, axes in dims.items():
            if dim >= 2:  # beyond [layers, batch]: split finer than the computation
                t = self.comm.all_gather(t, dim - 1, axes)
        return t

    def cache_store(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        if src.shape != dst.shape:
            dims = self.cache_axes.get(dst.untyped_storage()._cdata, {})
            for d, (a, b) in enumerate(zip(src.shape, dst.shape)):
                if a != b:  # a layer's [B, Hkv, S, D] of the leaf [L, B, Hkv, S, D]
                    src = self._own(src, d, dims.get(d + 1, ()))
        dst.copy_(src)

    def prompt_slice(self, dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor | None:
        """This device's share ``[B, Hkv, S_local, D]`` of the whole cache
        that a prompt's keys or values ``src [B, Hkv, S, D]`` fill (positions
        ``0 .. S-1``, zeros past them; the last ``S_global`` of them laid out
        as the ring buffer when they do not fit), or None when the cache's
        sequence is whole here.  Every device builds the whole cache and
        takes its slice, so every offset runs the same operations."""
        seq = self.cache_seq_axes(dst)
        if not seq:
            return None
        S, cap = src.shape[2], dst.shape[2] * self.size(seq)
        if S >= cap:
            whole = torch.roll(src[:, :, S - cap:], S % cap, dims=2)
        else:
            pad = list(src.shape)
            pad[2] = cap - S
            whole = torch.cat([src, src.new_zeros(pad)], dim=2)
        return self._own(whole, 2, seq)

    def lookup(self, tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        w = self.weight(tok)
        axes = self.embed_axes
        if not axes:
            return w[tokens]
        rows = w.shape[0]
        first = self.index(axes) * rows  # this device's first row
        local = tokens.long()
        inside = (local >= first) & (local < first + rows)
        # a token inside is ``first`` plus its row; outside, masked
        x = torch.where(inside[..., None], w[torch.remainder(local, rows)], 0.0).to(w.dtype)
        plan = ModulePlan("tp", axes)
        return self.exit(x, plan)

    def logsumexp(self, pred: torch.Tensor) -> torch.Tensor:
        axes = self.vocab_axes
        if not axes:
            return torch.logsumexp(pred, dim=-1)
        comm = self.comm
        m = comm.all_reduce(pred.detach().amax(dim=-1), axes, op="max")
        s = torch.exp(pred - m[..., None]).sum(dim=-1)
        s = _exchange(s, lambda t: comm.all_reduce(t, axes), _identity)
        return m + torch.log(s)

    def pick(self, pred: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        axes = self.vocab_axes
        if not axes:
            return pred.gather(-1, targets[..., None])[..., 0]
        cols = pred.shape[-1]
        first = self.index(axes) * cols  # this device's first column
        inside = (targets >= first) & (targets < first + cols)
        got = pred.gather(-1, torch.remainder(targets, cols)[..., None])[..., 0]
        got = torch.where(inside, got, 0.0)
        comm = self.comm
        return _exchange(got, lambda t: comm.all_reduce(t, axes), _identity)

    # -- a MoE layer ---------------------------------------------------------------
    def moe_token_axes(self, plan: ModulePlan) -> tuple[tuple[str, ...], tuple[str, ...]]:
        """(the axes splitting the batch, the axes splitting the sequence) of
        the tokens a MoE layer routes on this device: the batch axes, and in
        ``experts`` mode the sequence-parallel axes (each device routes its
        own share of the sequence there; elsewhere ``moe_enter`` gathers it)."""
        return self.batch_axes, (self.sp_axes if plan.moe_mode == "experts" else ())

    def moe_token_devices(self, plan: ModulePlan) -> int:
        """The devices whose tokens one MoE layer routes together."""
        b, s = self.moe_token_axes(plan)
        return self.size(b + s)

    def moe_enter(self, x: torch.Tensor, plan: ModulePlan) -> tuple[torch.Tensor, torch.Tensor]:
        """The block's input twice, for the router and for the experts.  The
        router, its gates and the aux loss compute whole on every device of
        the module's axes, so the router's share of the input's gradient is
        whole there too and is taken once; the experts' share is partial
        under a tensor-parallel split and is summed (Megatron's ``f``).  One
        exchange forward: the sequence's all-gather under sequence
        parallelism, none otherwise."""
        comm, sp = self.comm, self.sp_axes
        if plan.moe_mode == "experts" and sp:  # each device routes its own tokens
            return x, x
        if self._seq_sharded(x):
            experts = ((lambda g: comm.reduce_scatter(g, 1, sp)) if plan.kind == "tp"
                       else (lambda g: self._own(g, 1, sp)))
            return _Fork.apply(x, lambda t: comm.all_gather(t, 1, sp), lambda g: self._own(g, 1, sp), experts)
        if plan.kind == "tp":
            return _Fork.apply(x, _identity, _identity, lambda g: comm.all_reduce(g, plan.axes))
        return x, x

    def moe_gates(self, gates: torch.Tensor, plan: ModulePlan) -> torch.Tensor:
        """The gates ``[T, k]``, whose gradient is summed over the ffn axes
        in ``ffn`` mode: there they weigh each device's partial sums of the
        experts' outputs, so each device holds a partial gradient."""
        if plan.moe_mode != "ffn":
            return gates
        comm = self.comm
        return _exchange(gates, _identity, lambda g: comm.all_reduce(g, plan.axes))

    def moe_means(self, probs: torch.Tensor, top1: torch.Tensor, plan: ModulePlan
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """The whole batch's mean router probability and top-1 share per
        expert (``[T, E]`` each on this device): the ``[2, E]`` sums
        all-reduced over the token axes, divided by every device's tokens.
        Their gradient flows back to each device's own sums."""
        b, s = self.moe_token_axes(plan)
        if not b + s:
            return probs.mean(dim=0), top1.mean(dim=0)
        comm, n = self.comm, self.size(b + s)
        sums = _exchange(torch.stack([probs.sum(dim=0), top1.sum(dim=0)]),
                         lambda t: comm.all_reduce(t, b + s), _identity)
        means = sums / float(probs.shape[0] * n)
        return means[0], means[1]

    def moe_aux_share(self, aux: torch.Tensor, plan: ModulePlan) -> torch.Tensor:
        """This device's share of the whole batch's aux loss in the
        objective: under a batch split each device reports ``aux / n`` (the
        step's reported loss sums the devices' shares) with the whole
        term's gradient (the step sums the gradients over the batch axes)."""
        n = self.size(self.batch_axes)
        if n == 1:
            return aux
        return _exchange(aux, lambda t: t / float(n), _identity)

    def moe_rows(self, capacity: int, plan: ModulePlan) -> int:
        """The rows an expert's buffer holds: the capacity rounded up to the
        devices its capacity is split over (the rows past the capacity stay
        zero, and so do their outputs)."""
        _, _, cut_c, _, take_c = self._buffer_steps(plan)
        n = self.size(cut_c + take_c)
        return -(-capacity // n) * n

    def moe_offsets(self, experts: torch.Tensor, num_experts: int, batch: int, plan: ModulePlan
                    ) -> torch.Tensor | None:
        """Each (token, slot) pair's count of earlier pairs of its expert on
        other devices, ``[T, k]`` int64 (None when this device routes the
        whole batch): the reference sorts the whole batch's pairs, in the
        order of the global tokens ``[B, S]``, row-major.  A device holds
        rows ``[B_loc]`` of the batch axes' chunk and columns ``[S_loc]`` of
        the sequence axes' chunk, so an earlier pair sits on a device of an
        earlier batch chunk, in an earlier row of this chunk on another
        device, or in the same row on an earlier sequence chunk.  One
        all-gather of each device's per-row counts ``[B_loc, E]`` int32."""
        b_axes, s_axes = self.moe_token_axes(plan)
        if not b_axes + s_axes:
            return None
        T, k = experts.shape
        counts = torch.zeros(batch, num_experts, dtype=torch.int64, device=experts.device)
        counts.scatter_add_(1, experts.reshape(batch, -1), torch.ones_like(experts.reshape(batch, -1)))
        nb, ns = self.size(b_axes), self.size(s_axes)
        every = self.comm.all_gather(counts.to(torch.int32)[None], 0, b_axes + s_axes)
        every = every.to(torch.int64).view(nb, ns, batch, num_experts)
        db, ds = self.index(b_axes), self.index(s_axes)
        chunks = every.sum(dim=(1, 2))  # [nb, E]: each batch chunk's pairs
        before = (chunks.cumsum(0) - chunks)[db]  # earlier batch chunks
        mine = every[db]  # [ns, B_loc, E]
        rows_before = mine.cumsum(1) - mine  # earlier rows, each sequence chunk
        other_rows = rows_before.sum(0) - rows_before[ds]  # its own earlier rows: in its own positions
        same_row = (mine.cumsum(0) - mine)[ds]  # the same row on earlier sequence chunks
        per_row = before[None] + other_rows + same_row  # [B_loc, E]
        row = torch.arange(T, device=experts.device) // (T // batch)
        return per_row[row[:, None], experts]

    def _buffer_steps(self, plan: ModulePlan) -> tuple[tuple[str, ...], ...]:
        """How the ``[E, C, d]`` buffer reaches the experts' layout.  Each
        device writes its kept pairs at their places in the whole batch's
        buffer, zero elsewhere, so the whole buffer is the sum over the
        token axes: the axes over which a device takes its experts (its
        tokens are those of every device there), reduce-scatters the experts
        (token axes that split them), reduce-scatters the capacity (token
        axes that split it), all-reduces (the other token axes), and takes
        its share of the capacity."""
        b, s = self.moe_token_axes(plan)
        tokens = b + s
        experts = plan.axes if plan.moe_mode == "experts" else ()
        cap = plan.capacity_axes
        if cap is None:
            cap = tuple(a for a in tokens if a not in experts)
        return (tuple(a for a in experts if a not in tokens),
                tuple(a for a in experts if a in tokens),
                tuple(a for a in cap if a in tokens),
                tuple(a for a in tokens if a not in experts and a not in cap),
                tuple(a for a in cap if a not in tokens))

    def moe_dispatch(self, buf: torch.Tensor, plan: ModulePlan) -> torch.Tensor:
        take_e, cut_e, cut_c, summed, take_c = self._buffer_steps(plan)
        comm = self.comm
        if take_e:
            E = buf.shape[0]
            buf = _exchange(buf, lambda t: self._own(t, 0, take_e).contiguous(),
                            lambda g: self._placed(g, 0, take_e, E))
        if cut_e:
            buf = _exchange(buf, lambda t: comm.reduce_scatter(t, 0, cut_e), lambda g: comm.all_gather(g, 0, cut_e))
        if cut_c:
            buf = _exchange(buf, lambda t: comm.reduce_scatter(t, 1, cut_c), lambda g: comm.all_gather(g, 1, cut_c))
        if summed:
            buf = _exchange(buf, lambda t: comm.all_reduce(t, summed), _identity)
        if take_c:
            C = buf.shape[1]
            buf = _exchange(buf, lambda t: self._own(t, 1, take_c).contiguous(),
                            lambda g: self._placed(g, 1, take_c, C))
        return buf

    def moe_return(self, out: torch.Tensor, plan: ModulePlan, experts: int) -> torch.Tensor:
        """The experts' outputs ``[E_local * C_local, d]`` gathered to the
        whole batch's ``[E * C, d]``, :meth:`moe_dispatch` undone step by
        step.  A pair's output is read only by the device that holds its
        token, so over the token axes each gather's gradient is summed back
        (a reduce-scatter), and over the others it is the same on every
        device and taken (a slice)."""
        take_e, cut_e, cut_c, _, take_c = self._buffer_steps(plan)
        if not (take_e or cut_e or cut_c or take_c):
            return out
        comm, d = self.comm, out.shape[-1]
        if plan.moe_mode == "experts":
            experts //= self.size(plan.axes)
        out = out.reshape(experts, -1, d)
        if take_c:
            out = _exchange(out, lambda t: comm.all_gather(t, 1, take_c), lambda g: self._own(g, 1, take_c))
        if cut_c:
            out = _exchange(out, lambda t: comm.all_gather(t, 1, cut_c), lambda g: comm.reduce_scatter(g, 1, cut_c))
        if cut_e:
            out = _exchange(out, lambda t: comm.all_gather(t, 0, cut_e), lambda g: comm.reduce_scatter(g, 0, cut_e))
        if take_e:
            out = _exchange(out, lambda t: comm.all_gather(t, 0, take_e), lambda g: self._own(g, 0, take_e))
        return out.reshape(-1, d)

    def to_layout(self, t: torch.Tensor, shape: tuple[int, ...], spec: Spec) -> torch.Tensor:
        """``t`` (a device's logits ``[B, V]``: the batch split over the
        batch axes, the vocabulary over the vocabulary's) as the share of
        ``shape`` that ``spec`` asks for: gathered over the axes that split a
        dimension of ``t`` and not the spec's, cut at this device's offset
        over the spec's axes that do not split ``t``."""
        if tuple(t.shape) == tuple(shape):
            return t
        held = (self.batch_axes, self.vocab_axes)
        want = [self.live(axes_of(e)) for e in spec]
        if all(a <= b for a, b in zip(t.shape, shape)):
            return self.comm.gather_to(t, shape, {d: tuple(a for a in held[d] if a not in want[d])
                                                  for d in range(t.dim())})
        for d, (a, b) in enumerate(zip(t.shape, shape)):
            extra = tuple(x for x in want[d] if x not in held[d])
            t = t.narrow(d, self.index(extra) * min(a, b), min(a, b))
        return t

    def data_parallel_grads(self, grads: Mapping[str, torch.Tensor], params: nn.Module) -> dict:
        named = dict(params.named_parameters())
        out = {}
        for k, g in grads.items():
            plan = self.weights.get(id(named[k]))
            stored = {a for e in self.specs[k] for a in axes_of(e)}
            reduced = plan.reduce_axes | plan.whole_axes if plan else frozenset()
            axes = tuple(a for a in self.batch_axes + self.sp_axes
                         if a not in stored and a not in reduced)
            out[k] = self.comm.all_reduce(g, axes) if axes else g
        return out

    def batch_sum(self, values: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each scalar of ``values`` summed over the batch axes (uncounted:
        ``comm.reduce_scalars``)."""
        return self.comm.reduce_scalars(values, self.batch_axes) if self.batch_axes else list(values)

    def norm_parts(self, parts: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Each parameter's gradient sum of squares over the devices that
        hold distinct slices of it (the live axes of its stored spec; a
        replicated parameter's is its own), an exchange a set of axes."""
        groups: dict[tuple[str, ...], list[str]] = {}
        for k in parts:
            axes = tuple(a for e in self.specs[k] for a in self.live(axes_of(e)))
            groups.setdefault(tuple(a for a in self.mesh.axis_names if a in axes), []).append(k)
        out = dict(parts)
        for axes, names in groups.items():
            if axes:
                out.update(zip(names, self.comm.reduce_scalars([parts[k] for k in names], axes)))
        return out

    def whole(self, params: nn.Module, dst: int | None = None) -> dict[str, torch.Tensor] | None:
        """``{name: the whole parameter}`` of a localized model, gathered
        from every device's slice: on every device, or with ``dst`` on that
        device alone (None elsewhere)."""
        out = {k: self.comm.gather_whole(p.detach(), self.specs[k], dst=dst) for k, p in params.named_parameters()}
        return None if dst is not None and self.comm.rank != dst else out


# -----------------------------------------------------------------------------
# The hooks the model's code calls: each returns its input when no program
# is installed
# -----------------------------------------------------------------------------


def weight(w: torch.Tensor | None) -> torch.Tensor | None:
    prog = _PROGRAM
    return w if prog is None or w is None else prog.weight(w)


def enter(x: torch.Tensor, module: nn.Module) -> torch.Tensor:
    prog = _PROGRAM
    if prog is None:
        return x
    plan = prog.modules.get(id(module))
    return x if plan is None else prog.enter(x, plan)


def exit(y: torch.Tensor, module: nn.Module) -> torch.Tensor:  # noqa: A001 (the module's own name)
    prog = _PROGRAM
    if prog is None:
        return y
    plan = prog.modules.get(id(module))
    return y if plan is None else prog.exit(y, plan)


def kv_heads(t: torch.Tensor) -> torch.Tensor:
    prog = _PROGRAM
    return t if prog is None else prog.kv_heads(t)


def kv_select(k: torch.Tensor, v: torch.Tensor, heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    prog = _PROGRAM
    return (k, v) if prog is None else prog.kv_select(k, v, heads)


def decode_query(q: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    prog = _PROGRAM
    return q if prog is None else prog.decode_query(q, prog.cache_seq_axes(cache))


def cache_span(cache: torch.Tensor) -> tuple[int, int]:
    """(the first position this device holds, the whole cache's positions)
    of a layer's KV cache ``[B, Hkv, S, D]``: ``(0, S)`` unless a program
    splits its sequence."""
    prog = _PROGRAM
    return (0, cache.shape[2]) if prog is None else prog.cache_span(cache)


def decode_combine(o: torch.Tensor, lse: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    """The attention over this device's share of ``cache``'s keys, with its
    softmax state, combined with every other share's."""
    prog = _PROGRAM
    return o if prog is None else prog.decode_combine(o, lse, prog.cache_seq_axes(cache))


def cache_load(t: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """``t`` (a layer's slice of the cache leaf ``base``) in the
    computation's layout."""
    prog = _PROGRAM
    return t if prog is None else prog.cache_load(t, base)


def cache_store(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, ``src`` cut to ``dst``'s slice."""
    prog = _PROGRAM
    if prog is None:
        dst.copy_(src)
    else:
        prog.cache_store(dst, src)


def prompt_slice(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor | None:
    """The share of the cache ``dst`` that a prompt's keys or values ``src``
    fill, where a program splits its sequence (None elsewhere)."""
    prog = _PROGRAM
    return None if prog is None else prog.prompt_slice(dst, src)


def lookup(tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    prog = _PROGRAM
    return tok[tokens] if prog is None else prog.lookup(tok, tokens)


def logsumexp(pred: torch.Tensor) -> torch.Tensor:
    prog = _PROGRAM
    return torch.logsumexp(pred, dim=-1) if prog is None else prog.logsumexp(pred)


def pick(pred: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    prog = _PROGRAM
    return pred.gather(-1, targets[..., None])[..., 0] if prog is None else prog.pick(pred, targets)


def _moe_plan(module: nn.Module) -> tuple[Program | None, ModulePlan | None]:
    prog = _PROGRAM
    return (None, None) if prog is None else (prog, prog.modules[id(module)])


def moe_enter(x: torch.Tensor, module: nn.Module) -> tuple[torch.Tensor, torch.Tensor]:
    """A MoE block's input for its router and for its experts."""
    prog, plan = _moe_plan(module)
    return (x, x) if prog is None else prog.moe_enter(x, plan)


def moe_token_devices(module: nn.Module) -> int:
    """The devices whose tokens a MoE layer routes together (1: its own)."""
    prog, plan = _moe_plan(module)
    return 1 if prog is None else prog.moe_token_devices(plan)


def moe_means(probs: torch.Tensor, top1: torch.Tensor, module: nn.Module) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole batch's per-expert means of ``probs`` and ``top1``."""
    prog, plan = _moe_plan(module)
    if prog is None:
        return probs.mean(dim=0), top1.mean(dim=0)
    return prog.moe_means(probs, top1, plan)


def moe_aux_share(aux: torch.Tensor, module: nn.Module) -> torch.Tensor:
    prog, plan = _moe_plan(module)
    return aux if prog is None else prog.moe_aux_share(aux, plan)


def moe_gates(gates: torch.Tensor, module: nn.Module) -> torch.Tensor:
    prog, plan = _moe_plan(module)
    return gates if prog is None else prog.moe_gates(gates, plan)


def moe_rows(capacity: int, module: nn.Module) -> int:
    """The rows of an expert's buffer for ``capacity``."""
    prog, plan = _moe_plan(module)
    return capacity if prog is None else prog.moe_rows(capacity, plan)


def moe_offsets(experts: torch.Tensor, num_experts: int, batch: int, module: nn.Module) -> torch.Tensor | None:
    """Each pair's count of earlier pairs of its expert on other devices
    (None: the device routes the whole batch)."""
    prog, plan = _moe_plan(module)
    return None if prog is None else prog.moe_offsets(experts, num_experts, batch, plan)


def moe_dispatch(buf: torch.Tensor, module: nn.Module) -> torch.Tensor:
    prog = _PROGRAM
    if prog is None:
        return buf
    return prog.moe_dispatch(buf, prog.modules[id(module)])


def moe_return(out: torch.Tensor, module: nn.Module, experts: int) -> torch.Tensor:
    prog = _PROGRAM
    if prog is None:
        return out
    return prog.moe_return(out, prog.modules[id(module)], experts)


def data_parallel_grads(grads: dict, params: nn.Module) -> dict:
    prog = _PROGRAM
    return grads if prog is None else prog.data_parallel_grads(grads, params)


def batch_sum(*values: torch.Tensor) -> list[torch.Tensor]:
    """Scalars summed over the devices that split the batch (the loss's
    target count and reported terms): the values themselves when no program
    is installed."""
    prog = _PROGRAM
    return list(values) if prog is None else prog.batch_sum(list(values))


def norm_parts(parts: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``{name: a gradient's sum of squares}`` over every device that holds
    a distinct slice of the parameter: ``parts`` itself when no program is
    installed."""
    prog = _PROGRAM
    return parts if prog is None else prog.norm_parts(parts)


def constrain(x: torch.Tensor, spec) -> torch.Tensor:
    """The residual stream laid out by ``spec``: under sequence parallelism
    a device keeps its share of the sequence (a slice of the stream that
    every device of the tensor-parallel axes holds whole)."""
    prog = _PROGRAM
    if prog is None or not prog.sp_axes or x.dim() != 3 or x.shape[1] != prog.seq_len:
        return x
    return _exchange(x, lambda t: prog._own(t, 1, prog.sp_axes),
                     lambda g: prog.comm.all_gather(g, 1, prog.sp_axes))

