"""Build and load the hand-written CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, into ``build/alaz_tpu_torch/`` at the root of
the checkout, from the checkout's own sources; the library's file name
carries a hash of its source and flags, so an edited source rebuilds.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "alaz_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# K4's phase timeline (csrc/segment.cu ALAZ_K4_TIMELINE), for measurement only
TIMELINE_FLAGS = ("-DALAZ_K4_TIMELINE",)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/segment.cu: every pointer and the stream as
# c_void_p, so no pointer is cut to 32 bits
_SIGNATURES = {
    "alaz_scatter_sum_sorted": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "alaz_segment_expand_sorted": (_I, [_P, _P, _P, _I, _I, ctypes.c_longlong, _I, _P]),
    "alaz_gather_rows_banded": (_I, [_P, _P, _P, _I, _I, ctypes.c_longlong, _I, _P]),
    "alaz_gather_scatter_sum": (
        _I, [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    ),
    "alaz_gather_scatter_tile_edges": (_I, []),
    "alaz_cuda_error_string": (ctypes.c_char_p, [_I]),
}


@dataclass(frozen=True)
class Built:
    path: Path
    log: str  # nvcc's output: ptxas registers, shared memory, spills


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str = "segment", extra_flags: tuple = ()) -> Built:
    """Compile ``csrc/<name>.cu`` unless this exact source and flag set
    was built already."""
    src = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *extra_flags)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libalaz_{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    if out.exists() and log_path.exists():
        return Built(out, log_path.read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return Built(out, log)


_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in _SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def library() -> ctypes.CDLL:
    """The kernels' library, built and loaded once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _load(build().path)
        return _LIB


def timeline_library() -> ctypes.CDLL:
    """The kernels built with K4's phase timeline: the same entry points,
    plus ``alaz_k4_timeline(host)``, which copies the last K4 launch's
    per-tile timestamps ([4096, 5] u64: start, ids loaded, walk done, end
    in %globaltimer ns, and the SM). For measurement, never for serving."""
    lib = _load(build(extra_flags=TIMELINE_FLAGS).path)
    lib.alaz_k4_timeline.restype = _I
    lib.alaz_k4_timeline.argtypes = [_P]
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        msg = library().alaz_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
