"""Wrappers of the hand-written Hopper kernels in ``csrc/segment.cu``.

Each wrapper launches its CUDA kernel for tensors on a CUDA device and
uses its plain PyTorch version for tensors on the CPU; nothing else
selects between them, and a CUDA tensor the kernel cannot take raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``, so a
run can show that the scoring path went through the kernels.

- ``scatter_sum_sorted`` (K1) replaces the TPU kernel
  ``alaz_tpu/ops/pallas_segment.py scatter_sum_sorted``.
- ``segment_expand_sorted`` (K2) replaces the TPU kernel
  ``alaz_tpu/ops/pallas_segment.py segment_expand_sorted``.

Both are forward only: their backward passes (each the other's) come with
training.
"""

from __future__ import annotations

import ctypes

import torch

from alaz_tpu_torch.graph.snapshot import EDGE_BLOCK_ROWS
from alaz_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/segment.cu enum


def _forward_only(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the segment kernels are forward only; their backward comes "
            "with training (ROADMAP.md)"
        )


def _cuda_input(t: torch.Tensor, name: str, device: torch.device, ndim: int, dtype=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# K1: sorted segment sum
# ---------------------------------------------------------------------------


def scatter_sum_sorted_plain(
    msgs: torch.Tensor,
    edge_dst: torch.Tensor,
    num_nodes: int,
    out_dtype: torch.dtype,
    block_starts: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1's plain version with the kernel's semantics: f32 accumulation,
    one rounding to ``out_dtype``. Under the blocked layout every slot at
    or past the frontier ``block_starts[-1]`` is masked by position, as
    the kernel never reads past it."""
    data = msgs.float()
    if block_starts is not None:
        live = torch.arange(data.shape[0], device=data.device) < block_starts[-1]
        data = torch.where(live[:, None], data, torch.zeros((), device=data.device))
    out = torch.zeros((num_nodes, data.shape[1]), dtype=torch.float32, device=data.device)
    return out.index_add_(0, edge_dst, data).to(out_dtype)


def scatter_sum_sorted(
    msgs: torch.Tensor,
    edge_dst: torch.Tensor,
    num_nodes: int,
    out_dtype: torch.dtype | None = None,
    block_starts: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[d] = Σ_{e: dst[e]=d} msgs[e] for dst-SORTED ``edge_dst``
    (int32), accumulated in f32. ``out_dtype=None`` returns the input
    dtype (one rounding of the f32 sum); ``torch.float32`` returns the
    sum itself (``segment_sum_accurate``). ``block_starts`` (the blocked
    layout's host extents) replaces the per-call search for each 128-row
    dst block's edge run, and excludes the pad edges past its frontier."""
    _forward_only(msgs)
    dtype = msgs.dtype if out_dtype is None else out_dtype
    if msgs.dtype not in _DTYPE_CODE:
        msgs = msgs.float()
    kout = dtype if dtype in (msgs.dtype, torch.float32) else torch.float32
    if msgs.device.type == "cpu":
        out = scatter_sum_sorted_plain(msgs, edge_dst, num_nodes, kout, block_starts)
    else:
        out = _scatter_sum_sorted_cuda(msgs, edge_dst, num_nodes, kout, block_starts)
    return out if kout == dtype else out.to(dtype)


def _scatter_sum_sorted_cuda(msgs, edge_dst, num_nodes, out_dtype, block_starts):
    dev = msgs.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_sum_sorted: no kernel for device {dev}")
    _cuda_input(msgs, "msgs", dev, 2)
    _cuda_input(edge_dst, "edge_dst", dev, 1, torch.int32)
    e, f = msgs.shape
    if edge_dst.shape[0] != e:
        raise ValueError(f"edge_dst has {edge_dst.shape[0]} ids for {e} message rows")
    if num_nodes <= 0 or num_nodes % EDGE_BLOCK_ROWS:
        raise ValueError(f"num_nodes={num_nodes} must be a positive multiple of {EDGE_BLOCK_ROWS}")
    if max(e, f, num_nodes) >= 2**31:
        raise ValueError("scatter_sum_sorted: dimensions must fit int32")
    n_blocks = num_nodes // EDGE_BLOCK_ROWS
    if block_starts is None:
        bounds = torch.arange(0, num_nodes + 1, EDGE_BLOCK_ROWS, dtype=torch.int32, device=dev)
        row_start = torch.searchsorted(edge_dst, bounds, out_int32=True)
    else:
        _cuda_input(block_starts, "block_starts", dev, 1, torch.int32)
        if block_starts.shape[0] != n_blocks + 1:
            raise ValueError(
                f"block_starts has {block_starts.shape[0]} entries, expected {n_blocks + 1}"
            )
        row_start = block_starts
    out = torch.empty((num_nodes, f), dtype=out_dtype, device=dev)
    vec = 4 if f % 4 == 0 and msgs.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 else 1
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.alaz_scatter_sum_sorted(
            msgs.data_ptr(), edge_dst.data_ptr(), row_start.data_ptr(), out.data_ptr(),
            num_nodes, f, e, _DTYPE_CODE[msgs.dtype], _DTYPE_CODE[out_dtype], vec,
            _stream(dev),
        )
    _build.check(rc, "scatter_sum_sorted")
    scatter_sum_sorted.launches += 1
    return out


scatter_sum_sorted.launches = 0


# ---------------------------------------------------------------------------
# K2: sorted segment expand
# ---------------------------------------------------------------------------


def segment_expand_sorted_plain(v: torch.Tensor, edge_dst: torch.Tensor) -> torch.Tensor:
    """K2's plain version: the row gather ``v[edge_dst]``."""
    return v[edge_dst]


def segment_expand_sorted(v: torch.Tensor, edge_dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """out[e] = v[dst[e]] for dst-sorted int32 ``edge_dst``; exact in any
    dtype. ``num_nodes`` is v's row count (the backward's scatter size)."""
    _forward_only(v)
    if v.device.type == "cpu":
        return segment_expand_sorted_plain(v, edge_dst)
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"segment_expand_sorted: no kernel for device {dev}")
    _cuda_input(v, "v", dev, 2)
    _cuda_input(edge_dst, "edge_dst", dev, 1, torch.int32)
    if v.shape[0] != num_nodes:
        raise ValueError(f"v has {v.shape[0]} rows, num_nodes={num_nodes}")
    e = edge_dst.shape[0]
    if max(e, num_nodes) >= 2**31:
        raise ValueError("segment_expand_sorted: dimensions must fit int32")
    out = torch.empty((e, v.shape[1]), dtype=v.dtype, device=dev)
    row_bytes = v.shape[1] * v.element_size()
    if e == 0 or row_bytes == 0:
        return out
    word = next(
        w for w in (16, 8, 4, 2, 1)
        if row_bytes % w == 0 and v.data_ptr() % w == 0 and out.data_ptr() % w == 0
    )
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.alaz_segment_expand_sorted(
            v.data_ptr(), edge_dst.data_ptr(), out.data_ptr(), num_nodes, e,
            row_bytes, word, _stream(dev),
        )
    _build.check(rc, "segment_expand_sorted")
    segment_expand_sorted.launches += 1
    return out


segment_expand_sorted.launches = 0

KERNELS = (scatter_sum_sorted, segment_expand_sorted)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
