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
- ``gather_rows_banded`` (K3) replaces the TPU kernel
  ``alaz_tpu/ops/pallas_segment.py gather_rows_banded``.
- ``pallas_gather_scatter_sum`` (K4) replaces the TPU kernel
  ``alaz_tpu/ops/pallas_segment.py pallas_gather_scatter_sum``.

All are forward only: their backward passes come with training.
"""

from __future__ import annotations

import ctypes

import torch

from alaz_tpu_torch.graph.snapshot import EDGE_BLOCK_ROWS
from alaz_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/segment.cu enum


def _forward_only(*tensors: torch.Tensor | None) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
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


def _row_starts(edge_dst, num_nodes, block_starts):
    """The edge run of each 128-row dst block: the blocked layout's host
    extents, or a search of the dst-sorted ids (the COO layout)."""
    dev = edge_dst.device
    if num_nodes <= 0 or num_nodes % EDGE_BLOCK_ROWS:
        raise ValueError(f"num_nodes={num_nodes} must be a positive multiple of {EDGE_BLOCK_ROWS}")
    n_blocks = num_nodes // EDGE_BLOCK_ROWS
    if block_starts is None:
        bounds = torch.arange(0, num_nodes + 1, EDGE_BLOCK_ROWS, dtype=torch.int32, device=dev)
        return torch.searchsorted(edge_dst, bounds, out_int32=True)
    _cuda_input(block_starts, "block_starts", dev, 1, torch.int32)
    if block_starts.shape[0] != n_blocks + 1:
        raise ValueError(
            f"block_starts has {block_starts.shape[0]} entries, expected {n_blocks + 1}"
        )
    return block_starts


def _scatter_sum_sorted_cuda(msgs, edge_dst, num_nodes, out_dtype, block_starts):
    dev = msgs.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_sum_sorted: no kernel for device {dev}")
    _cuda_input(msgs, "msgs", dev, 2)
    _cuda_input(edge_dst, "edge_dst", dev, 1, torch.int32)
    e, f = msgs.shape
    if edge_dst.shape[0] != e:
        raise ValueError(f"edge_dst has {edge_dst.shape[0]} ids for {e} message rows")
    if max(e, f, num_nodes) >= 2**31:
        raise ValueError("scatter_sum_sorted: dimensions must fit int32")
    row_start = _row_starts(edge_dst, num_nodes, block_starts)
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
    out, launched = _row_gather_cuda("segment_expand_sorted", v, edge_dst, num_nodes)
    segment_expand_sorted.launches += launched
    return out


segment_expand_sorted.launches = 0


def _row_gather_cuda(name: str, v, ids, num_nodes):
    """Launch K2 or K3 (one copy loop, two kernels): ``(out, 1)``, or
    ``(out, 0)`` when there is nothing to copy."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    _cuda_input(v, "v", dev, 2)
    _cuda_input(ids, "ids", dev, 1, torch.int32)
    if v.shape[0] != num_nodes:
        raise ValueError(f"v has {v.shape[0]} rows, num_nodes={num_nodes}")
    e = ids.shape[0]
    if max(e, num_nodes) >= 2**31:
        raise ValueError(f"{name}: dimensions must fit int32")
    out = torch.empty((e, v.shape[1]), dtype=v.dtype, device=dev)
    row_bytes = v.shape[1] * v.element_size()
    if e == 0 or row_bytes == 0:
        return out, 0
    word = next(
        w for w in (16, 8, 4, 2, 1)
        if row_bytes % w == 0 and v.data_ptr() % w == 0 and out.data_ptr() % w == 0
    )
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = getattr(lib, f"alaz_{name}")(
            v.data_ptr(), ids.data_ptr(), out.data_ptr(), num_nodes, e, row_bytes, word,
            _stream(dev),
        )
    _build.check(rc, name)
    return out, 1


# ---------------------------------------------------------------------------
# K3: row gather over unsorted ids
# ---------------------------------------------------------------------------


def gather_rows_banded_plain(v: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K3's plain version: the row gather ``v[ids]``."""
    return v[ids]


def gather_rows_banded(v: torch.Tensor, ids: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """out[e] = v[ids[e]] for UNSORTED int32 ``ids`` (the src side of a
    dst-sorted window); exact in any dtype, whatever the ids' locality.
    ``num_nodes`` is v's row count (the backward's scatter size)."""
    _forward_only(v)
    if v.device.type == "cpu":
        return gather_rows_banded_plain(v, ids)
    out, launched = _row_gather_cuda("gather_rows_banded", v, ids, num_nodes)
    gather_rows_banded.launches += launched
    return out


gather_rows_banded.launches = 0


# ---------------------------------------------------------------------------
# K4: fused gather + sorted segment sum
# ---------------------------------------------------------------------------


def pallas_gather_scatter_sum_plain(
    x: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    num_nodes: int,
    edge_weight: torch.Tensor | None = None,
    block_starts: torch.Tensor | None = None,
) -> torch.Tensor:
    """K4's plain version with the kernel's semantics: each message
    ``x[src]·w`` is formed in x's dtype, summed in f32, rounded once to
    x's dtype."""
    msgs = x[edge_src]
    if edge_weight is not None:
        msgs = msgs * edge_weight.to(msgs.dtype)[:, None]
    return scatter_sum_sorted_plain(msgs, edge_dst, num_nodes, x.dtype, block_starts)


def pallas_gather_scatter_sum(
    x: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    num_nodes: int,
    edge_weight: torch.Tensor | None = None,
    block_starts: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[d] = Σ_{e: dst[e]=d} w[e]·x[src[e]] for dst-SORTED int32
    ``edge_dst`` and any int32 ``edge_src``; the messages are never
    stored. The weight is cast to x's dtype and each product rounded to
    it before the f32 sum (the JAX package's rounding); the result is in
    x's dtype (f32 for an x of another dtype, cast back). ``block_starts``
    are K1's row starts: COO and blocked rows agree bit for bit."""
    _forward_only(x, edge_weight)
    dtype = x.dtype
    if x.dtype not in _DTYPE_CODE:
        x = x.float()
    if x.device.type == "cpu":
        out = pallas_gather_scatter_sum_plain(
            x, edge_src, edge_dst, num_nodes, edge_weight, block_starts
        )
    else:
        out = _gather_scatter_sum_cuda(x, edge_src, edge_dst, num_nodes, edge_weight, block_starts)
    return out if out.dtype == dtype else out.to(dtype)


def _lane_vec(f: int, x: torch.Tensor, out: torch.Tensor) -> int:
    """Elements a lane of K4 moves at once: 16 bytes' worth, else 4, else
    1, as far as ``f`` and both buffers' alignment allow."""
    elt = x.element_size()
    return next(
        v for v in (16 // elt, 4, 1)
        if f % v == 0 and x.data_ptr() % (v * elt) == 0 and out.data_ptr() % (v * elt) == 0
    )


_GS_TILE = None


def gather_scatter_tile_edges() -> int:
    """Live edges per tile of K4's kernel (a CTA each; the tiles past the
    live-edge frontier exit at once)."""
    global _GS_TILE
    if _GS_TILE is None:
        _GS_TILE = _build.library().alaz_gather_scatter_tile_edges()
    return _GS_TILE


def _gather_scatter_sum_cuda(x, edge_src, edge_dst, num_nodes, edge_weight, block_starts):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"pallas_gather_scatter_sum: no kernel for device {dev}")
    _cuda_input(x, "x", dev, 2)
    _cuda_input(edge_src, "edge_src", dev, 1, torch.int32)
    _cuda_input(edge_dst, "edge_dst", dev, 1, torch.int32)
    e = edge_dst.shape[0]
    if edge_src.shape[0] != e:
        raise ValueError(f"edge_src has {edge_src.shape[0]} ids for {e} edges")
    w_ptr = None
    if edge_weight is not None:
        _cuda_input(edge_weight, "edge_weight", dev, 1)
        if edge_weight.shape[0] != e:
            raise ValueError(f"edge_weight has {edge_weight.shape[0]} entries for {e} edges")
        edge_weight = edge_weight.to(x.dtype)
        w_ptr = edge_weight.data_ptr()
    n_x, f = x.shape
    if max(e, n_x, num_nodes, f * x.element_size()) >= 2**31:
        raise ValueError("pallas_gather_scatter_sum: dimensions must fit int32")
    # scratch: the per-tile f32 carries [tiles, 2, f], then under the COO
    # layout the row starts the kernel computes ([num_nodes/128 + 1] int32)
    carry_words = -(-e // gather_scatter_tile_edges()) * 2 * f
    if block_starts is None:
        if num_nodes <= 0 or num_nodes % EDGE_BLOCK_ROWS:
            raise ValueError(
                f"num_nodes={num_nodes} must be a positive multiple of {EDGE_BLOCK_ROWS}"
            )
        n_starts = num_nodes // EDGE_BLOCK_ROWS + 1
        scratch = torch.empty(carry_words + n_starts, dtype=torch.float32, device=dev)
        starts_ptr = scratch.data_ptr() + 4 * carry_words
    else:
        scratch = torch.empty(carry_words, dtype=torch.float32, device=dev)
        starts_ptr = _row_starts(edge_dst, num_nodes, block_starts).data_ptr()
    out = torch.empty((num_nodes, f), dtype=x.dtype, device=dev)
    args = (
        x.data_ptr(), edge_src.data_ptr(), edge_dst.data_ptr(), w_ptr,
        starts_ptr, int(block_starts is None), out.data_ptr(), scratch.data_ptr(),
        num_nodes, n_x, f, e, _DTYPE_CODE[x.dtype], _lane_vec(f, x, out), _stream(dev),
    )
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.alaz_gather_scatter_sum(*args)
    _build.check(rc, "pallas_gather_scatter_sum")
    pallas_gather_scatter_sum.launches += 1
    return out


pallas_gather_scatter_sum.launches = 0

KERNELS = (
    scatter_sum_sorted, segment_expand_sorted, gather_rows_banded, pallas_gather_scatter_sum,
)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
