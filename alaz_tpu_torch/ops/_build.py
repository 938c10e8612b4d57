"""Build and load the hand-written CUDA kernels.

``csrc/segment.cu`` and ``csrc/gru.cu`` are compiled by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with ``ctypes``. The build happens at first use, into
``build/alaz_tpu_torch/`` at the root of the checkout, from the
checkout's own sources; the library's file name carries a hash of its
sources and flags, so an edited source rebuilds. Nothing here runs at
import.
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
SOURCES = ("segment.cu", "gru.cu")  # one library
BUILD_DIR = _PKG.parent / "build" / "alaz_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the sources: every pointer and the stream as
# c_void_p, so no pointer is cut to 32 bits
_SIGNATURES = {
    "alaz_scatter_sum_sorted": (
        _I, [_P, _P, _P, _P, _P, _P, ctypes.c_uint, _I, _I, _I, _I, _I, _I, _P]
    ),
    "alaz_scatter_sum_split_lengths": (None, [_P]),
    "alaz_k1_split_counts": (_I, [_P]),
    "alaz_segment_expand_sorted": (_I, [_P, _P, _P, _I, _I, ctypes.c_longlong, _I, _P]),
    "alaz_gather_rows_banded": (_I, [_P, _P, _P, _I, _I, ctypes.c_longlong, _I, _P]),
    "alaz_gather_scatter_sum": (
        _I, [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    ),
    "alaz_gather_scatter_tile_edges": (_I, []),
    "alaz_sort_by_ids": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P]),
    "alaz_sort_scratch_words": (ctypes.c_longlong, [_I]),
    "alaz_sort_tile_keys": (_I, []),
    "alaz_cuda_error_string": (ctypes.c_char_p, [_I]),
    "alaz_gru_update": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "alaz_gru_activations": (_I, [_P, _P, _I, _P]),
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


def build(name: str = "segment") -> Built:
    """Compile ``SOURCES`` into the library ``libalaz_<name>`` unless these
    exact sources and flag set were built already. Either way one build
    event ``name`` reaches the open compile watchers
    (``sanitize/retrace.py``), with its seconds."""
    from alaz_tpu_torch.sanitize.retrace import build_event

    srcs = [CSRC / s for s in SOURCES]
    blob = b"".join(s.name.encode() + s.read_bytes() for s in srcs)
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libalaz_{name}-{digest}.so"
    with build_event(name, f"nvcc {' '.join(s.name for s in srcs)} -> {out.name}"):
        return _nvcc(srcs, NVCC_FLAGS, out)


def _nvcc(srcs: list, flags: tuple, out: Path) -> Built:
    log_path = out.with_suffix(".log")
    if out.exists() and log_path.exists():
        return Built(out, log_path.read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags, "-o", str(tmp), *map(str, srcs)]
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


def library(built: Built | None = None) -> ctypes.CDLL:
    """The kernels' library, loaded once per process: ``built`` (a
    ``build()`` result) where given, else built here."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str((built or build()).path))
            for fn, (restype, argtypes) in _SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIB = lib
        return _LIB


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        msg = library().alaz_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
