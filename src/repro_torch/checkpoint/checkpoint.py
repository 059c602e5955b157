"""Checkpoints: compressed msgpack leaf files with an atomic manifest, an
async save thread, retention and resume.

Ported from the reference's ``repro/checkpoint/checkpoint.py``, in its
layout and its leaf encoding, so that either package reads the other's
leaves: a directory ``step_%08d/`` holds ``leaf_%05d.zst`` per leaf and
``manifest.json`` (``treedef``, ``num_leaves``, ``time``, ``paths``), written
into ``<dir>.tmp`` and renamed.  A leaf is the msgpack map ``{"dtype",
"shape", "data"}`` (bf16 as its uint16 bits, dtype ``"bfloat16"``),
zlib-compressed.  The reference writes zstd where the ``zstandard`` module
is installed; neither machine the port runs on has it, so the port writes
zlib, reads zlib, and raises the reference's ``ModuleNotFoundError`` on a
zstd frame.  ``msgpack`` is not on the card's machine either: the port
encodes and decodes the subset a leaf uses itself (:func:`packb`,
:func:`unpackb`), byte for byte as ``msgpack.packb`` writes it.

Trees are nested dicts (keys in sorted order), lists and tuples whose
leaves are tensors, numpy arrays or Python numbers, flattened in the order
``jax.tree.leaves`` gives.  Leaves are stored whole; a restored leaf goes to
the device of the template's leaf.

A sharded run passes ``shardings`` (a matching tree of
``distributed/comm.py::NamedSharding``, or one for every leaf): a save
gathers each leaf whole from every device's slice and device 0 writes it;
a restore reads the file once on device 0 and scatters to each device its
slice under the layout it names, which may be another mesh's than the
save's (the reference's elastic rescale).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil
import struct
import threading
import time
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
#: leaves encoded (a save) or decoded (a sharded restore) at once
_WORKERS = 8


# -----------------------------------------------------------------------------
# the msgpack subset of a leaf: maps, str, arrays of ints, ints, bin
# -----------------------------------------------------------------------------


def _head(n: int, fix: int | None, fix_max: int, codes: tuple[int, ...]) -> bytes:
    """A length-prefixed header: the fix form up to ``fix_max``, else the
    8/16/32-bit form of ``codes`` (``None`` where there is none)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} is too long")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for dicts, lists, str, bytes and
    non-negative ints: the same bytes."""
    out = bytearray()

    def put(o) -> None:
        if isinstance(o, dict):
            out.extend(_head(len(o), 0x80, 15, (None, 0xDE, 0xDF)))
            for k, v in o.items():
                put(k)
                put(v)
        elif isinstance(o, (list, tuple)):
            out.extend(_head(len(o), 0x90, 15, (None, 0xDC, 0xDD)))
            for v in o:
                put(v)
        elif isinstance(o, str):
            b = o.encode()
            out.extend(_head(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)))
            out.extend(b)
        elif isinstance(o, (bytes, bytearray, memoryview)):
            out.extend(_head(len(o), None, 0, (0xC4, 0xC5, 0xC6)))
            out.extend(o)
        elif isinstance(o, int) and o >= 0:
            if o < 128:
                out.append(o)
            else:
                for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
                    if o < 1 << (8 * struct.calcsize(fmt)):
                        out.extend(bytes([code]) + struct.pack(fmt, o))
                        break
                else:
                    raise ValueError(f"msgpack: {o} is too large")
        else:
            raise TypeError(f"a checkpoint leaf's msgpack holds no {type(o).__name__}")

    put(obj)
    return bytes(out)


_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}


def unpackb(buf: bytes):
    """``msgpack.unpackb`` for what :func:`packb` writes; bin values come
    back as ``memoryview``s of ``buf``."""
    view = memoryview(buf)

    def get(i: int):
        c = view[i]
        i += 1
        if c < 0x80:
            return c, i
        if c in _INTS:
            fmt = _INTS[c]
            return struct.unpack_from(fmt, view, i)[0], i + struct.calcsize(fmt)
        if 0x80 <= c <= 0x8F or c in (0xDE, 0xDF):
            kind, n = "map", c & 0x0F
        elif 0x90 <= c <= 0x9F or c in (0xDC, 0xDD):
            kind, n = "array", c & 0x0F
        elif 0xA0 <= c <= 0xBF or c in (0xD9, 0xDA, 0xDB):
            kind, n = "str", c & 0x1F
        elif c in (0xC4, 0xC5, 0xC6):
            kind, n = "bin", 0
        else:
            raise ValueError(f"msgpack: type byte {c:#x} is not in a checkpoint leaf")
        if c in _LENGTHS:
            fmt = _LENGTHS[c]
            n = struct.unpack_from(fmt, view, i)[0]
            i += struct.calcsize(fmt)
        if kind == "str":
            return bytes(view[i:i + n]).decode(), i + n
        if kind == "bin":
            return view[i:i + n], i + n
        items = []
        for _ in range(2 * n if kind == "map" else n):
            v, i = get(i)
            items.append(v)
        return (dict(zip(items[::2], items[1::2])) if kind == "map" else items), i

    value, end = get(0)
    if end != len(view):
        raise ValueError(f"msgpack: {len(view) - end} bytes after the value")
    return value


# -----------------------------------------------------------------------------
# leaves
# -----------------------------------------------------------------------------


def _compress(buf: bytes) -> bytes:
    return zlib.compress(buf, 3)


def _decompress(buf: bytes) -> bytes:
    # dispatch on the frame magic, as the reference does
    if buf[:4] == _ZSTD_MAGIC:
        raise ModuleNotFoundError(
            "checkpoint leaf is zstd-compressed but the 'zstandard' module is not installed"
        )
    return zlib.decompress(buf)


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """(a numpy array of the leaf's bytes, its dtype name in the file)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, a.dtype.str


def _encode_leaf(leaf) -> bytes:
    a, dtype = _host_array(leaf)
    return _compress(packb({"dtype": dtype, "shape": list(a.shape), "data": np.ascontiguousarray(a).tobytes()}))


def _decode_leaf(buf: bytes) -> torch.Tensor:
    """A CPU tensor of the leaf's dtype and shape."""
    payload = unpackb(_decompress(buf))
    shape = payload["shape"]
    if payload["dtype"] == "bfloat16":
        a = np.frombuffer(payload["data"], dtype=np.uint16).reshape(shape)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(payload["data"], dtype=np.dtype(payload["dtype"])).reshape(shape).copy())


# -----------------------------------------------------------------------------
# trees
# -----------------------------------------------------------------------------


def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    """(key path as ``jax.tree_util.keystr`` writes it, leaf), in the order
    of ``jax.tree.leaves``: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{path}[{i}]")]
    if tree is None:
        return []
    return [(path, tree)]


def _treedef(tree) -> str:
    """The tree's structure with ``*`` for each leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "None" if tree is None else "*"


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    if template is None:
        return None
    return next(leaves)


def _sharding_leaves(shardings, n: int) -> list:
    """One sharding a leaf: ``shardings`` flattened as the tree is, or the
    one sharding given for all."""
    from repro_torch.distributed.comm import NamedSharding

    if isinstance(shardings, NamedSharding):
        return [shardings] * n
    flat = [sh for _, sh in _flatten(shardings)]
    if len(flat) != n:
        raise ValueError(f"{len(flat)} shardings for {n} leaves")
    return flat


def _gathered(tree: Any, shardings) -> tuple[Any, bool, Any]:
    """(``tree`` with every leaf gathered whole on device 0, whether this
    device writes it, the comm); every device of the mesh takes part."""
    flat = _flatten(tree)
    shs = _sharding_leaves(shardings, len(flat))
    if not shs:
        raise ValueError("a sharded save of a tree with no leaves")
    whole = [sh.comm.gather_whole(leaf, sh.spec, dst=0) for (_, leaf), sh in zip(flat, shs)]
    return _unflatten(tree, iter(whole)), all(sh.rank == 0 for sh in shs), shs[0].comm


def save_pytree(tree: Any, directory: str | Path, shardings=None) -> None:
    """Atomic: writes into ``<dir>.tmp`` then renames.  One file per leaf
    (encoded and written in parallel), a manifest with the structure.
    With ``shardings`` every device calls it: the leaves are gathered whole,
    device 0 writes them, and every device returns once they are written."""
    if shardings is not None:
        whole, writer, comm = _gathered(tree, shardings)
        if writer:
            save_pytree(whole, directory)
        comm.barrier()
        return
    directory = Path(directory)
    tmp = directory.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = _flatten(tree)

    def write(i: int, leaf) -> None:
        (tmp / f"leaf_{i:05d}.zst").write_bytes(_encode_leaf(leaf))

    with concurrent.futures.ThreadPoolExecutor(max_workers=_WORKERS) as ex:
        for f in [ex.submit(write, i, leaf) for i, (_, leaf) in enumerate(flat)]:
            f.result()
    manifest = {
        "treedef": f"PyTreeDef({_treedef(tree)})",
        "num_leaves": len(flat),
        "time": time.time(),
        "paths": [p for p, _ in flat],
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if directory.exists():
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def restore_pytree(template: Any, directory: str | Path, shardings=None) -> Any:
    """Restore into ``template``'s structure: each leaf with the dtype and
    shape it was saved with, on the device of the template's leaf (the CPU
    for a leaf that is no tensor); with ``shardings`` every device calls it,
    device 0 reads the file and each device receives its slice of each leaf
    under the layout its sharding names.  Raises ``ValueError`` when the
    leaf counts differ."""
    directory = Path(directory)
    flat = _flatten(template)
    manifest = json.loads((directory / "manifest.json").read_text())
    if manifest["num_leaves"] != len(flat):
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, template has {len(flat)}")
    if shardings is not None:
        return _unflatten(template, _scattered(directory, flat, _sharding_leaves(shardings, len(flat))))
    restored = []
    for i, (_, like) in enumerate(flat):
        t = _decode_leaf((directory / f"leaf_{i:05d}.zst").read_bytes())
        restored.append(t.to(like.device) if isinstance(like, torch.Tensor) else t)
    return _unflatten(template, iter(restored))


def _scattered(directory: Path, flat: list, shs: list):
    """Each leaf's slice for this device, in order: device 0 decodes every
    leaf (in parallel) and scatters the slices; the others receive theirs
    in the shape and dtype of their template's leaf."""
    if shs[0].rank != 0:
        for (_, like), sh in zip(flat, shs):
            yield sh.comm.scatter_whole(None, sh.spec, like)
        return
    with concurrent.futures.ThreadPoolExecutor(max_workers=_WORKERS) as ex:
        leaves = ex.map(lambda i: _decode_leaf((directory / f"leaf_{i:05d}.zst").read_bytes()), range(len(flat)))
        for ((_, like), sh), whole in zip(zip(flat, shs), leaves):
            yield sh.comm.scatter_whole(whole, sh.spec, like)


def _snapshot(tree):
    """A host copy of every leaf, so that later in-place updates of the
    tensors do not reach a save in flight."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


@dataclasses.dataclass
class CheckpointManager:
    """Step-indexed checkpoints with retention, async save and resume.  An
    async save that failed raises from the next :meth:`wait` (every save and
    restore waits first)."""

    root: Path
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        self.root = Path(self.root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None
        self._comm = None  # a sharded save's backend: every device waits for the writer

    def _dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def all_steps(self) -> list[int]:
        out = []
        for p in self.root.glob("step_*"):
            if p.is_dir() and (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._comm is not None:  # after a sharded save, until device 0 has written it
            comm, self._comm = self._comm, None
            comm.barrier()
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def save(self, step: int, tree: Any, shardings=None) -> None:
        """Save ``tree`` as step ``step`` (in the background when
        ``async_save``).  With ``shardings`` every device calls it: the
        leaves are gathered whole (in the foreground) and device 0 writes
        them; every device's next :meth:`wait` (each save and restore
        waits first) returns once they are written."""
        self.wait()
        if shardings is not None:
            whole, writer, self._comm = _gathered(tree, shardings)
            if not writer:
                return
            tree = whole
        host_tree = _snapshot(tree)

        def do_save():
            try:
                save_pytree(host_tree, self._dir(step))
                self._gc()
            except BaseException as e:  # handed to wait()
                self._error = e

        if self.async_save:
            self._pending = threading.Thread(target=do_save, daemon=True)
            self._pending.start()
        else:
            do_save()
            self.wait()

    def restore(self, template: Any, step: int | None = None, shardings=None):
        """(the tree at ``step``, or the latest, and its step), or (None,
        None) when there is no checkpoint; ``shardings`` as
        :func:`restore_pytree`'s."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        return restore_pytree(template, self._dir(step), shardings), step

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)
