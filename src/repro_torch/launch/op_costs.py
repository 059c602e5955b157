"""Per-device operation costs of a PyTorch program, counted as it runs.

The counterpart of the reference's ``repro/launch/hlo_costs.py``, which
parses the compiled HLO of a jitted step.  The port has no HLO: its step is
eager PyTorch, so :class:`OpCounter`, a ``TorchDispatchMode``, sees each
ATen operation as it is dispatched, on meta tensors (the dry-run, which
allocates nothing) as on the card, and fills the reference's record
(``HloCosts.to_json``):

* ``flops``: a matrix product (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
  ``dot``) counts 2·|out|·K, the reference's dot rule; an elementwise
  arithmetic op (a dtype conversion included, as the reference's
  ``convert``) one per result element; a reduction max(input elements + 1,
  result elements) (the reference's ``reduce`` also reads its initial
  value), a sort or a scatter max(input elements, result elements);
* ``bytes``: the operands plus the results of each op, views free.  The
  port's eager ops are its fusion boundaries, as XLA's fusions are the
  reference's; a gather or an indexed write moves only its window
  (2·result, or 2·values, plus the indices), as the reference's
  ``dynamic-slice`` and ``dynamic-update-slice`` do;
* ``transcendentals``: exp, tanh, log, rsqrt, sqrt, pow, sigmoid, sin, cos
  and the activations built on them (softplus, silu, gelu), one per
  result element;
* a hand-written kernel by its formula (``kernels/work.py``), one record a
  call, whatever device runs it; the ops inside the call are not counted;
* ``collective_bytes`` / ``collective_counts``: the exchanges a sharded
  step makes (``distributed/program.py``), the result bytes on this
  device, by kind;
* ``unhandled``: every op without a rule, by name (its bytes still count).

A Python loop over layers runs each layer's ops once an iteration, so the
reference's trip-count problem does not arise.  The port's own keys beside
the reference's: ``matmul_flops`` (the products' share of ``flops``) and
``kernels`` ({name: calls, flops, bytes}).

Memory: the counter follows the life of every storage an op makes (a weak
reference to the storage; a view or an in-place op shares it) and of every
exchange's result (made by an allocation, which is not an op it counts:
a gathered weight is live until it is freed), and gives
:meth:`OpCounter.memory`: the bytes of the step's arguments, the peak of
the other live bytes (``temp``), the peak of both, the arguments written in
place (``alias``) and the step's outputs.  ``temp`` holds the card's
library workspace too (:data:`LIBRARY_WORKSPACE_BYTES`) from the first
product on: cuBLAS allocates it at a process's first product and keeps it,
so it is live at every later peak, as XLA's temporaries hold its GEMMs'
workspaces.  A storage held by a reference
cycle is freed when Python's collector runs, whose timing depends on the
process's history, so the counter collects once on entry and holds the
collector off while it counts: such a storage counts as live until the
count ends, and the peak is the same in every process.  It also imports
``torch._dynamo`` on entry, which the first op under a dispatch mode
would import, keeping the stack's tensors in the import's cycles.

:func:`by_scope` is the counterpart of ``bytes_by_scope``: bytes and FLOPs
by the ``nn.Module`` path of the parameters the op's code was reading (the
innermost ``p`` argument of the model's functions), layer indices folded.

Not ported: the HLO-text parsers themselves (``_parse_computations``, the
trip counts, ``dryrun.py::collective_bytes``); there is no HLO to parse.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import work
from repro_torch.kernels.work import (  # noqa: F401  (the kernels' formulas, one owner)
    Work,
    attention_visible,
    attention_work,
    decode_attention_work,
    flash_attention_work,
    ssd_scan_work,
)

_FREE = {  # metadata, views and allocations: no data moves
    "view", "_unsafe_view", "reshape", "_reshape_alias", "t", "transpose", "permute", "expand",
    "slice", "select", "unsqueeze", "squeeze", "as_strided", "alias", "detach", "split",
    "split_with_sizes", "unbind", "narrow", "diagonal", "view_as", "unfold", "lift_fresh",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
    "is_same_size", "sym_size", "sym_stride", "sym_numel", "resize_", "set_", "_has_compatible_shallow_copy_type",
    "result_type", "lift_fresh_copy",
}
#: cuBLAS's workspace on an H100 (compute capability 9.0), which PyTorch
#: sizes at 8 chunks of 4 MiB (``CUBLAS_WORKSPACE_CONFIG`` ``:4096:8``) and
#: allocates through its caching allocator: the dry-run plans for that card
LIBRARY_WORKSPACE_BYTES = 8 * 4 * 2**20
_MATMUL = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "vdot"}
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "tanh", "log", "log1p", "log2", "rsqrt", "sqrt", "pow", "sigmoid",
    "sin", "cos", "softplus", "silu", "gelu", "erf", "logit", "reciprocal",
}
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum", "clamp", "clamp_min",
    "clamp_max", "where", "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_not", "remainder", "fmod", "floor_divide",
    "sign", "addcmul", "addcdiv", "lerp", "masked_fill", "tanh_backward", "sigmoid_backward",
    "silu_backward", "gelu_backward", "softplus_backward", "threshold_backward", "floor", "ceil",
    "round", "trunc", "square", "xlogy",
}
_REDUCTION = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all", "argmax", "argmin", "cumsum",
    "cumprod", "logsumexp", "norm", "linalg_vector_norm", "var", "std",
}
_SORT_SCATTER = {
    "sort", "topk", "scatter", "scatter_add", "scatter_reduce", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "nll_loss_forward", "nll_loss_backward",
}
_MOVEMENT = {
    "copy", "clone", "_to_copy", "cat", "stack", "constant_pad_nd", "roll", "repeat", "flip",
    "fill", "zero", "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "scalar_tensor",
    "arange", "tril", "triu", "searchsorted", "one_hot", "contiguous", "_unsafe_index",
    "new_zeros", "new_ones", "new_full", "bernoulli", "normal", "uniform", "randperm",
    "select_backward", "slice_backward", "index_select_backward", "expand_copy", "unsqueeze_copy",
}
_GATHER = {"index", "index_select", "gather", "embedding", "take"}
_INDEXED_WRITE = {"index_put", "index_copy", "_index_put_impl", "index_add", "index_fill"}


def _name(func) -> str:
    return func.__name__.split(".")[0].rstrip("_")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a pytree, a module's parameters and buffers included."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


@dataclasses.dataclass
class OpCosts:
    """The reference's ``HloCosts`` record, counted op by op."""

    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    collective_counts: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    unhandled: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    kernels: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "transcendentals": self.transcendentals,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "collective_total_bytes": sum(self.collective_bytes.values()),
            "unhandled": dict(self.unhandled),
            "matmul_flops": self.matmul_flops,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }


def _matmul_flops(name: str, args, out: torch.Tensor) -> int:
    """2·|out|·K of a product."""
    if name in ("mm", "addmm", "mv", "addmv", "dot", "vdot"):
        a = args[1] if name in ("addmm", "addmv") else args[0]
        return 2 * out.numel() * a.shape[-1]
    a = args[1] if name == "baddbmm" else args[0]  # bmm: [b, m, k]
    return 2 * out.numel() * a.shape[-1]


class OpCounter(TorchDispatchMode):
    """Count the ops run under it (module docstring).

    ``arguments``: the step's inputs (tensors, or any pytree of them), whose
    storages are the argument bytes and are not temporaries.  ``scopes``:
    ``{id(module): name}`` of a model's modules, to count :func:`by_scope`.
    """

    def __init__(self, *, arguments=(), scopes: dict[int, str] | None = None):
        super().__init__()
        self.costs = OpCosts()
        self._kernel_depth = 0
        self._args: dict[int, int] = {}
        self._written: set[int] = set()
        self._live: dict[int, int] = {}
        self.live = 0
        self.workspace = 0  # the library's, held from the first product on
        self.peak = 0
        self.scopes = scopes
        self.scope_costs: dict[str, list[float]] = defaultdict(lambda: [0.0, 0.0])
        self.add_arguments(arguments)

    # -- the kernels' and the exchanges' hook (kernels/work.py) ---------------
    def __enter__(self):
        import torch._dynamo  # noqa: F401  (module docstring)

        self._gc_was_on = gc.isenabled()
        gc.collect()
        gc.disable()
        work.LISTENERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work.LISTENERS.remove(self)
        if self._gc_was_on:
            gc.enable()
        return super().__exit__(*exc)

    def enter_kernel(self, record: Work) -> None:
        if self._kernel_depth == 0:
            c = self.costs
            c.flops += record.flops
            c.matmul_flops += record.flops
            c.bytes += record.bytes
            c.transcendentals += record.transcendentals
            row = c.kernels.setdefault(record.kernel, {"calls": 0, "flops": 0, "bytes": 0})
            row["calls"] += 1
            row["flops"] += record.flops
            row["bytes"] += record.bytes
            self._scope_add(record.bytes, record.flops)
        self._kernel_depth += 1

    def exit_kernel(self) -> None:
        self._kernel_depth -= 1

    def collective(self, kind: str, nbytes: int, out=None) -> None:
        self.costs.collective_bytes[kind] += nbytes
        self.costs.collective_counts[kind] += 1
        if out is not None:
            self._track(out)

    # -- memory -----------------------------------------------------------------
    def add_arguments(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as the step's arguments."""
        for t in _tensors(tree):
            s = t.untyped_storage()
            self._args.setdefault(s._cdata, s.nbytes())

    def _release(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _track(self, out) -> None:
        for t in _tensors(out):
            s = t.untyped_storage()
            key = s._cdata
            if key in self._args or key in self._live:
                continue
            n = s.nbytes()
            self._live[key] = n
            self.live += n
            weakref.finalize(s, self._release, key)
        self.peak = max(self.peak, self.live + self.workspace)

    def memory(self, outputs=()) -> dict:
        """The reference's ``memory`` keys: argument, output (new storages
        among ``outputs``), temp (the peak of non-argument bytes, the
        library's workspace included once a product ran), alias
        (arguments written in place) and peak (arguments + temp)."""
        out_keys = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                    for t in _tensors(outputs)}
        argument = sum(self._args.values())
        return {
            "argument_bytes": argument,
            "output_bytes": sum(n for k, n in out_keys.items() if k not in self._args),
            "temp_bytes": self.peak,
            "alias_bytes": sum(self._args[k] for k in self._written),
            "peak_bytes": argument + self.peak,
        }

    # -- ops ----------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = _name(func)
        if name in _FREE:
            return out
        if self._kernel_depth == 0:
            self._count(func, name, args, kwargs, out)
        if func._schema.is_mutable:
            for a, arg in zip(func._schema.arguments, args):
                if a.alias_info is not None and a.alias_info.is_write and isinstance(arg, torch.Tensor):
                    key = arg.untyped_storage()._cdata
                    if key in self._args:
                        self._written.add(key)
        self._track(out)
        return out

    def _count(self, func, name: str, args, kwargs, out) -> None:
        c = self.costs
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        result = outs[0] if outs else None
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        flops = 0
        if name in _MATMUL:
            self.workspace = LIBRARY_WORKSPACE_BYTES
            flops = _matmul_flops(name, args, result)
            c.matmul_flops += flops
            if name in ("addmm", "baddbmm", "addmv"):
                flops += result.numel()  # the bias add
        elif name in _TRANSCENDENTAL:
            c.transcendentals += result.numel()
            if name in ("silu", "gelu", "softplus"):
                flops += result.numel()
        elif name in _ELEMENTWISE:
            flops = result.numel()
        elif name in _REDUCTION or name in _SORT_SCATTER:
            inputs = max((t.numel() for t in ins), default=0) + (name in _REDUCTION)
            flops = max(inputs, result.numel() if result is not None else 0)
        elif name in _GATHER:
            index = [t for t in ins if not t.is_floating_point()]
            nbytes = 2 * sum(_nbytes(t) for t in outs) + sum(_nbytes(t) for t in index)
        elif name in _INDEXED_WRITE:
            values = ins[-1] if ins else None
            index = [t for t in ins[1:-1] if not t.is_floating_point()]
            nbytes = 2 * (_nbytes(values) if values is not None else 0) + sum(_nbytes(t) for t in index)
        elif name in _MOVEMENT:
            if name in ("_to_copy", "copy") and len(ins) >= 1 and result is not None:
                src = ins[-1] if name == "copy" else ins[0]
                if src.dtype != result.dtype:
                    flops = result.numel()  # a conversion, the reference's convert
        else:
            c.unhandled[name] += 1
        c.flops += flops
        c.bytes += nbytes
        self._scope_add(nbytes, flops)

    # -- scopes -------------------------------------------------------------------
    def _scope_add(self, nbytes: float, flops: float) -> None:
        if self.scopes is None:
            return
        row = self.scope_costs[self._scope()]
        row[0] += nbytes
        row[1] += flops

    def _scope(self) -> str:
        f = sys._getframe(2)
        for _ in range(64):
            if f is None:
                break
            if "repro_torch" in f.f_code.co_filename and "p" in f.f_code.co_varnames:
                name = self.scopes.get(id(f.f_locals.get("p")))
                if name is not None:
                    return ".".join("*" if part.isdigit() else part for part in name.split("."))
            f = f.f_back
        return "(other)"


def by_scope(counter: OpCounter, top: int = 15) -> list[tuple[str, float, float]]:
    """The top ``top`` scopes of a counter made with ``scopes``, by bytes:
    ``[(scope, bytes, flops)]``, the reference's ``bytes_by_scope`` rows."""
    rows = sorted(((s, b, f) for s, (b, f) in counter.scope_costs.items()), key=lambda r: -r[1])
    return rows[:top]


def module_scopes(module: torch.nn.Module) -> dict[int, str]:
    """``{id(submodule): its path}`` for :class:`OpCounter`'s ``scopes``."""
    return {id(m): name or "(root)" for name, m in module.named_modules()}


def count(fn, *args, arguments=None, scopes=None, **kwargs):
    """``(fn(*args, **kwargs), counter)``: one call under a fresh
    :class:`OpCounter` whose arguments are ``arguments`` (default: the
    call's own)."""
    counter = OpCounter(arguments=(args, kwargs) if arguments is None else arguments, scopes=scopes)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter
