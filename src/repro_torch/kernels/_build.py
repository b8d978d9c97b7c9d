"""Build, load and launch the hand-written CUDA kernels under ``csrc/``.

The kernels have a plain C interface (one ``extern "C"`` launcher per
kernel, returning the ``cudaError_t`` of its launch) and are compiled with
``nvcc`` into one shared library at first use, then loaded with
``ctypes``. Every ``.cu`` file is compiled by its own ``nvcc`` process,
all started together, then linked. The library goes to
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags, so an unchanged tree reuses it and an edited one
rebuilds. A missing ``nvcc`` or a failed build raises; nothing falls back.

Each wrapper launches through :func:`launch`, which raises on a non-zero
error code and otherwise adds one to the kernel's launch counter, read by
``chip_smoke.py`` to show that the main path went through the kernels.

Both are safe from several threads (the serving frontends call the engine
from a worker, a writer and a reader thread): one lock makes exactly one
thread build and load the library, another makes each counter increment
atomic. The launch itself runs outside any lock, so launches from
different threads do not serialise on the host.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["KERNELS", "NVCC_FLAGS", "build", "compile_library", "library",
           "launch", "count_launch", "launch_counts", "reset_launch_counts",
           "check_device", "check_panel", "check_ids", "kernel_name",
           "stream_of"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32, _U32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_uint32)

#: C launcher name -> argument types (pointers and the stream as c_void_p)
KERNELS = {
    # regs, rows, keys, mask, n_edges, n_rows, p, s_hi, s_lo, stream
    "hll_accumulate": (_P, _P, _P, _P, _I64, _I64, _I32, _U32, _U32, _P),
    # regs, out, n_rows, r, stream
    "hll_estimate_stats": (_P, _P, _I64, _I32, _P),
    # regs, out, src, dst, n_edges, n_rows, r, stream
    "hll_propagate": (_P, _P, _P, _P, _I64, _I64, _I32, _P),
    # regs, pa, pb, stats, sz, n_pairs, n_rows, r, q, stream
    "intersection_stats": (_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _P),
    # regs, ids, mask, out, n_sets, n_rows, lanes, r, stream
    "union_estimate_stats": (_P, _P, _P, _P, _I64, _I64, _I32, _I32, _P),
    # a, b, stats, n_pairs, r, q, stream
    "ertl_stats": (_P, _P, _P, _I64, _I32, _I32, _P),
    # prev, cur, out, n_rows, r, stream
    "hip_delta_rows": (_P, _P, _P, _I64, _I32, _P),
}
#: the packed-layout variants take their byte kernel's arguments, with r
#: the register count (the row is r/2 bytes)
KERNELS.update({f"{name}_packed": KERNELS[name] for name in (
    "hll_accumulate", "hll_estimate_stats", "hll_propagate",
    "intersection_stats", "union_estimate_stats", "ertl_stats")})

_LAUNCHES = {name: 0 for name in KERNELS}
_LAUNCH_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH or CUDA_HOME): the CUDA kernels under "
            f"{_CSRC} cannot be built")
    return found


def _digest(files: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def compile_library(sources: list[Path], lib: Path) -> str:
    """Compile ``sources`` (one ``nvcc`` each, all started together) and
    link them into the shared library ``lib``, replaced atomically (a
    concurrent build sees all or none). Returns ``nvcc``'s report; raises
    on a failed compile or link."""
    nvcc = _nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=lib.parent))
    try:
        objs = [tmp / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(src.name, log) for src, proc, log
                  in zip(sources, procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        out = tmp / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs), "-o", str(out)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(out, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return "".join(logs)


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (once per source hash).

    Returns the library's path. ``nvcc``'s ``-Xptxas -v`` report (registers,
    shared memory, spills per kernel) is kept beside it as ``.log``.
    """
    lib = _BUILD_DIR / f"libreprotorch_{_digest(sorted(_CSRC.glob('*.cu*')))}.so"
    if not lib.exists():
        log = compile_library(sorted(_CSRC.glob("*.cu")), lib)
        lib.with_suffix(".log").write_text(log)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared.

    The first call builds and loads under a lock, so threads that launch
    their first kernel together wait for one build instead of compiling
    into the same path.
    """
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in KERNELS.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def launch(name: str, device: torch.device, *args) -> None:
    """Call C launcher ``name`` on ``device``; raise on a launch error.

    Switches the current device only when ``device`` is another one (the
    switch costs microseconds a call). Counts the launch only once the
    kernel was accepted.
    """
    lib = library()
    fn = getattr(lib, name)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError {err} "
            f"({lib.repro_error_string(err).decode()})")
    count_launch(name)


def count_launch(name: str) -> None:
    """Add one to kernel ``name``'s launch counter (atomically)."""
    with _LAUNCH_LOCK:
        _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    """Snapshot of {kernel: launches since the last reset}."""
    with _LAUNCH_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    with _LAUNCH_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current CUDA stream on ``t``'s device (the
    raw query: building a ``torch.cuda.Stream`` costs microseconds)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_device(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for others."""
    if t.is_cuda:
        return True
    if t.is_cpu:
        return False
    raise ValueError(f"{name} lies on {t.device}; only cuda and cpu are "
                     f"supported")


def check_panel(regs: torch.Tensor, layout: str) -> tuple[int, int]:
    """Validate a register panel; return (rows, r), r the register count.

    A byte row is r bytes, a packed row r/2 (two 4-bit registers a byte).
    The kernels read rows as 4- and 8-byte words: the row width must be a
    power of two >= 8, so r >= 16 (p >= 4) on the packed layout, and the
    panel 8-byte aligned (any allocation is; an offset view may not be).
    """
    if layout not in ("byte", "packed"):
        raise ValueError(f"layout must be 'byte' or 'packed', got {layout!r}")
    if regs.dtype != torch.uint8 or regs.dim() != 2:
        raise ValueError(f"regs must be uint8[V, w], got {regs.dtype}"
                         f"{list(regs.shape)}")
    v, w = regs.shape
    if w < 8 or w & (w - 1):
        if layout == "packed":
            raise ValueError(f"packed row width {w} must be a power of two "
                             f">= 8 (r = 2 * {w} registers, p >= 4)")
        raise ValueError(f"row width r={w} must be a power of two >= 8")
    if not regs.is_contiguous() or regs.data_ptr() % 8:
        raise ValueError("regs must be contiguous and 8-byte aligned")
    return v, 2 * w if layout == "packed" else w


def kernel_name(name: str, layout: str) -> str:
    """The C launcher of kernel ``name`` for ``layout``."""
    return f"{name}_packed" if layout == "packed" else name


def check_ids(t: torch.Tensor, name: str, like: torch.Tensor,
              length: int | None = None, dtype=torch.int32) -> None:
    """Validate a 1-D contiguous index/key/mask tensor beside ``like``."""
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor, "
                         f"got {t.dtype}{list(t.shape)}")
    if t.get_device() != like.get_device() or t.is_cpu != like.is_cpu:
        raise ValueError(f"{name} is on {t.device}, regs on {like.device}")
    if length is not None and t.shape[0] != length:
        raise ValueError(f"{name} has {t.shape[0]} entries, expected {length}")
