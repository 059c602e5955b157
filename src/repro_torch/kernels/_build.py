"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, under ``build/kernels/`` at
the repository root, at first use.  The library's file name carries a hash
of the sources and flags, so an edited source builds anew and an unchanged
one loads at once.  Pointers and the stream cross as ``c_void_p``, integers
as ``c_int``; each C entry returns ``cudaGetLastError()``.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand-written kernel could not be built, loaded or launched, or its
    wrapper was given inputs the kernel cannot take.  Callers that degrade
    gracefully (``core.api.solve_with_fallback``) re-raise it: a failing
    kernel is a fault of the device layer, never a reason to solve elsewhere."""


class KernelBuildError(KernelError):
    """``nvcc`` is missing or refused a kernel source."""


class KernelInputError(KernelError, ValueError):
    """A wrapper was given a device, type or shape its kernel cannot take."""


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def sources() -> list[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by its contents (and any
    ``csrc/*.cuh`` header) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile every named source (default: all) that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds each
    build took (0.0 when already built); raises :class:`KernelBuildError`
    with the compiler's output if any build fails.  The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside each
    library as ``<library>.log``."""
    names = sources() if names is None else names
    t0 = time.perf_counter()
    running = {n: _start(n) for n in names if not library_path(n).is_file()}
    seconds = {n: 0.0 for n in names}
    failures = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise KernelBuildError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        try:
            lib = ctypes.CDLL(str(library_path(name)))
        except OSError as e:
            raise KernelError(f"cannot load the kernel library of csrc/{name}.cu: {e}") from e
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise KernelError(f"{what}: CUDA error {err} ({msg})")
