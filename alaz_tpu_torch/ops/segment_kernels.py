"""Wrappers of the hand-written Hopper kernels in ``csrc/segment.cu``.

Each wrapper launches its CUDA kernel for tensors on a CUDA device and
uses its plain PyTorch version for tensors on the CPU; nothing else
selects between them, and a CUDA tensor the kernel cannot take raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``, so a
run can show that the scoring path went through the kernels. A count
counts the kernel that runs, whichever pass asked for it: K1's backward
is a K2 launch, and K2's a K1 launch.

- ``scatter_sum_sorted`` (K1) replaces the TPU kernel
  ``alaz_tpu/ops/pallas_segment.py scatter_sum_sorted``. Inside its one
  launch it splits a row whose edge run is longer than ``L`` edges across
  warps of ``C`` edges each (``k1_split_lengths``); ``k1_split_counts``
  reads how many rows it split, and their edges.
- ``segment_expand_sorted`` (K2) replaces the TPU kernel
  ``alaz_tpu/ops/pallas_segment.py segment_expand_sorted``.
- ``gather_rows_banded`` (K3) replaces the TPU kernel
  ``alaz_tpu/ops/pallas_segment.py gather_rows_banded``.
- ``pallas_gather_scatter_sum`` (K4) replaces the TPU kernel
  ``alaz_tpu/ops/pallas_segment.py pallas_gather_scatter_sum``.

Each wrapper is a ``torch.autograd.Function`` when a gradient is asked
for (grad mode on and an input that requires grad; otherwise it runs the
same forward without the autograd node), whose backward computes what the
JAX package's ``custom_vjp`` computes, on the kernels too:

- K1's backward is ``g[edge_dst]`` in the messages' dtype: K2.
- K2's backward is the sorted sum of ``g`` over ``edge_dst``: K1.
- K3's backward, ``dv[i] = Σ_{ids[e]=i} g[e]`` summed in f32 and rounded
  once, is K4 over the stable sort of ``ids``, unweighted: each product
  ``g·1`` is exact, and the sum has a fixed order (no atomics), so two
  runs give the same bits.
- K4's backward: ``dx`` is K4 with the roles of src and dst swapped over
  the stable sort of ``src``, in f32 (the JAX package forms those
  products in f32); ``dw[e] = Σ_f x[src[e], f]·g[dst[e], f]`` is a plain
  f32 row dot, as the JAX package leaves it to XLA.

Both sorts are ``sort_by_ids``, a kernel of the port's own that replaces
no TPU kernel (the JAX package's backward passes are XLA scatters): a
stable radix sort of the ids on the card. It counts its launches in
``sort_by_ids.launches``, apart from ``launch_counts()``'s four kernels.

The backward passes take cotangents in any layout (an expanded or
transposed one is made contiguous first) and run on the same device as
the forward: the kernels on the card, the plain versions on the CPU.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from alaz_tpu_torch.graph.snapshot import EDGE_BLOCK_ROWS
from alaz_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/segment.cu enum


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


def _rows_of_blocks(n: int) -> int:
    """``n`` rounded up to whole 128-row dst blocks (at least one): the
    row count K4 writes, for a backward scatter into ``n`` rows."""
    return max(1, -(-n // EDGE_BLOCK_ROWS)) * EDGE_BLOCK_ROWS


def _call(function, run, *args):
    """``function.apply(*args)`` when autograd needs the pass (grad mode on
    and a tensor argument that requires grad), else ``run(*args)``: the
    same forward without an autograd node, whose host work would otherwise
    pace back-to-back launches of a short kernel (K4's) on the scoring
    paths."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return function.apply(*args)
    return run(*args)


def _kernel_dtype(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a dtype the summing kernels take: as it is, or f32."""
    return t if t.dtype in _DTYPE_CODE else t.float()


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
    dtype = msgs.dtype if out_dtype is None else out_dtype
    msgs = _kernel_dtype(msgs)
    kout = dtype if dtype in (msgs.dtype, torch.float32) else torch.float32
    out = _call(_ScatterSumSorted, _run_k1, msgs, edge_dst, num_nodes, kout, block_starts)
    return out if kout == dtype else out.to(dtype)


def _run_k1(msgs, edge_dst, num_nodes, out_dtype, block_starts=None):
    """K1 where its tensors lie: the plain version on the CPU, the kernel
    on the card."""
    if msgs.device.type == "cpu":
        return scatter_sum_sorted_plain(msgs, edge_dst, num_nodes, out_dtype, block_starts)
    return _scatter_sum_sorted_cuda(msgs, edge_dst, num_nodes, out_dtype, block_starts)


class _ScatterSumSorted(torch.autograd.Function):
    """K1 forward; backward ``g[edge_dst]`` in the messages' dtype through
    K2. ``g`` ([N, F]) is cast before the gather, which is exact, so the
    cast touches N rows instead of E. The row starts get no cotangent; pad
    slots past the blocked frontier get ``g`` of their dst row, as in the
    JAX package (the models mask those messages before the sum)."""

    @staticmethod
    def forward(ctx, msgs, edge_dst, num_nodes, out_dtype, block_starts):
        ctx.save_for_backward(edge_dst)
        ctx.num_nodes = num_nodes
        ctx.msgs_dtype = msgs.dtype
        return _run_k1(msgs, edge_dst, num_nodes, out_dtype, block_starts)

    @staticmethod
    def backward(ctx, g):
        (edge_dst,) = ctx.saved_tensors
        d_msgs = _run_k2(g.to(ctx.msgs_dtype).contiguous(), edge_dst, ctx.num_nodes)
        return d_msgs, None, None, None, None


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
        stream = _stream(dev)
        partials, counters, epoch = _k1_scratch(dev, stream.value, e, f)
        rc = lib.alaz_scatter_sum_sorted(
            msgs.data_ptr(), edge_dst.data_ptr(), row_start.data_ptr(), out.data_ptr(),
            partials.data_ptr(), counters.data_ptr(), epoch,
            num_nodes, f, e, _DTYPE_CODE[msgs.dtype], _DTYPE_CODE[out_dtype], vec, stream,
        )
    _build.check(rc, "scatter_sum_sorted")
    scatter_sum_sorted.launches += 1
    return out


scatter_sum_sorted.launches = 0

# K1's arrival counters of split rows, one set a (device, stream): zeroed
# once, then tagged by each launch with an epoch above every earlier one,
# so that no launch has to clear them and launches in turn on one stream
# share them
_K1_COUNTERS: dict = {}
_K1_LOCK = threading.Lock()


def _k1_scratch(dev, stream: int, e: int, f: int) -> tuple:
    """``(partials, counters, epoch)`` for a K1 launch over ``e`` edges of
    ``f`` columns on ``stream``: the chunk warps' f32 partial sums (two
    slots for each chunk of ``C`` edges, made anew), the stream's counters
    and the launch's epoch, one more than the last launch's on them. The
    counters are made anew, zeroed, when the edge count outgrows them or
    the epochs run out of 32 bits."""
    n_chunks = -(-e // k1_split_lengths()[1])
    partials = torch.empty((n_chunks, 2, f), dtype=torch.float32, device=dev)
    key = (dev.index, stream)
    with _K1_LOCK:
        counters, epoch = _K1_COUNTERS.get(key, (None, 0))
        if counters is None or counters.shape[0] < n_chunks or epoch == 0xFFFFFFFF:
            counters, epoch = torch.zeros(max(n_chunks, 1), dtype=torch.int64, device=dev), 0
        epoch += 1
        _K1_COUNTERS[key] = (counters, epoch)
    return partials, counters, epoch


_K1_LENGTHS = None


def k1_split_lengths() -> tuple:
    """``(L, C)``: K1 splits a row whose edge run is longer than ``L`` edges
    across chunk warps of ``C`` consecutive edges each."""
    global _K1_LENGTHS
    if _K1_LENGTHS is None:
        out = (ctypes.c_int * 2)()
        _build.library().alaz_scatter_sum_split_lengths(out)
        _K1_LENGTHS = (out[0], out[1])
    return _K1_LENGTHS


def k1_split_counts(device: torch.device | str | None = None) -> tuple:
    """``(rows, edges)``: the rows K1 split across chunk warps on
    ``device`` (the current CUDA device by default) since the kernels were
    loaded, counted once a launch, and the edges of those rows. One small
    copy from the card and a sync; ``(0, 0)`` where no kernel was loaded
    (on the CPU, the plain version splits nothing)."""
    if _build._LIB is None:
        return 0, 0
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    if dev.type != "cuda":
        return 0, 0
    out = (ctypes.c_longlong * 2)()
    with torch.cuda.device(dev):
        _build.check(_build.library().alaz_k1_split_counts(out), "k1_split_counts")
    return int(out[0]), int(out[1])


# ---------------------------------------------------------------------------
# K2: sorted segment expand
# ---------------------------------------------------------------------------


def segment_expand_sorted_plain(v: torch.Tensor, edge_dst: torch.Tensor) -> torch.Tensor:
    """K2's plain version: the row gather ``v[edge_dst]``."""
    return v[edge_dst]


def segment_expand_sorted(v: torch.Tensor, edge_dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """out[e] = v[dst[e]] for dst-sorted int32 ``edge_dst``; exact in any
    dtype. ``num_nodes`` is v's row count (the backward's scatter size)."""
    return _call(_SegmentExpandSorted, _run_k2, v, edge_dst, num_nodes)


segment_expand_sorted.launches = 0


def _run_k2(v, edge_dst, num_nodes):
    if v.device.type == "cpu":
        return segment_expand_sorted_plain(v, edge_dst)
    out, launched = _row_gather_cuda("segment_expand_sorted", v, edge_dst, num_nodes)
    segment_expand_sorted.launches += launched
    return out


class _SegmentExpandSorted(torch.autograd.Function):
    """K2 forward; backward ``dv[d] = Σ_{dst[e]=d} g[e]`` through K1, f32
    accumulation, one rounding to g's dtype."""

    @staticmethod
    def forward(ctx, v, edge_dst, num_nodes):
        ctx.save_for_backward(edge_dst)
        ctx.num_nodes = num_nodes
        return _run_k2(v, edge_dst, num_nodes)

    @staticmethod
    def backward(ctx, g):
        (edge_dst,) = ctx.saved_tensors
        gk = _kernel_dtype(g).contiguous()
        dv = _run_k1(gk, edge_dst, ctx.num_nodes, gk.dtype)
        return dv.to(g.dtype), None, None


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
    return _call(_GatherRowsBanded, _run_k3, v, ids, num_nodes)


gather_rows_banded.launches = 0


def _run_k3(v, ids, num_nodes):
    if v.device.type == "cpu":
        return gather_rows_banded_plain(v, ids)
    out, launched = _row_gather_cuda("gather_rows_banded", v, ids, num_nodes)
    gather_rows_banded.launches += launched
    return out


def unsorted_segment_sum(g: torch.Tensor, ids: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """``dv[i] = Σ_{ids[e]=i} g[e]`` for unsorted int32 ``ids``: K3's
    backward. Summed in f32 and rounded once to g's dtype (f32 for a dtype
    K4 does not take, cast back), by K4 over the ids' stable sort with no
    weight: every product is exact and the order of the sum is fixed, so
    the result is deterministic. Ids outside [0, num_nodes) add nothing."""
    gk = _kernel_dtype(g).contiguous()
    sorted_ids, perm, _ = _run_sort(ids, num_nodes)
    dv = _run_k4(gk, perm, sorted_ids, _rows_of_blocks(num_nodes))
    return dv[:num_nodes].to(g.dtype)


class _GatherRowsBanded(torch.autograd.Function):
    """K3 forward; backward ``unsorted_segment_sum`` (K4)."""

    @staticmethod
    def forward(ctx, v, ids, num_nodes):
        ctx.save_for_backward(ids)
        ctx.num_nodes = num_nodes
        return _run_k3(v, ids, num_nodes)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return unsorted_segment_sum(g, ids, ctx.num_nodes), None, None


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
    dtype = x.dtype
    x = _kernel_dtype(x)
    out = _call(_GatherScatterSum, _run_k4, x, edge_src, edge_dst, num_nodes, edge_weight, block_starts)
    return out if out.dtype == dtype else out.to(dtype)


def _run_k4(x, edge_src, edge_dst, num_nodes, edge_weight=None, block_starts=None):
    if x.device.type == "cpu":
        return pallas_gather_scatter_sum_plain(
            x, edge_src, edge_dst, num_nodes, edge_weight, block_starts
        )
    return _gather_scatter_sum_cuda(x, edge_src, edge_dst, num_nodes, edge_weight, block_starts)


class _GatherScatterSum(torch.autograd.Function):
    """K4 forward. Backward, with ``g`` and ``w`` in f32 (the JAX package
    forms these products in f32; K4 in x's dtype would round them):

    - ``dx[s] = Σ_{src[e]=s} w[e]·g[dst[e]]``: K4 with src and dst swapped
      over the stable sort of src, into x's rows rounded up to whole
      128-row blocks, then cut back and cast to x's dtype;
    - ``dw[e] = Σ_f x[src[e], f]·g[dst[e], f]`` in f32: a plain row dot.

    Under the blocked layout the pad slots past the frontier took no part
    in the forward, so they get no share of ``dx`` and a zero ``dw``."""

    @staticmethod
    def forward(ctx, x, edge_src, edge_dst, num_nodes, edge_weight, block_starts):
        ctx.save_for_backward(x, edge_src, edge_dst, edge_weight, block_starts)
        ctx.num_nodes = num_nodes
        return _run_k4(x, edge_src, edge_dst, num_nodes, edge_weight, block_starts)

    @staticmethod
    def backward(ctx, g):
        x, src, dst, w, block_starts = ctx.saved_tensors
        g = g.float().contiguous()
        w32 = None if w is None else w.float()
        live = None
        if block_starts is not None:
            live = torch.arange(dst.shape[0], device=dst.device) < block_starts[-1]
            w32 = live.float() if w32 is None else torch.where(live, w32, 0.0)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gather_scatter_dx(g, src, dst, w32, x.shape[0]).to(x.dtype)
        if ctx.needs_input_grad[4]:
            dw = (x[src].float() * g[dst]).sum(dim=1)
            if live is not None:
                dw = torch.where(live, dw, 0.0)
            dw = dw.to(w.dtype)
        return dx, None, None, None, dw, None


def gather_scatter_dx(g, src, dst, w32, n_x: int) -> torch.Tensor:
    """K4's ``dx`` in f32: ``dx[s] = Σ_{src[e]=s} w[e]·g[dst[e]]``, K4 with
    src and dst swapped over ``src``'s stable sort, which carries ``dst``
    and the weights along, into
    ``n_x`` rows rounded up to whole 128-row blocks, then cut back."""
    payloads = (dst,) if w32 is None else (dst, w32.contiguous())
    sorted_src, _, carried = _run_sort(src, n_x, payloads)
    w_sorted = carried[1] if w32 is not None else None
    return _run_k4(g, carried[0], sorted_src, _rows_of_blocks(n_x), w_sorted)[:n_x]


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


# ---------------------------------------------------------------------------
# SORT: stable radix sort of int32 ids by node (K3's and K4's backward)
# ---------------------------------------------------------------------------


def sort_by_ids_plain(ids: torch.Tensor, n_rows: int, payloads=()) -> tuple:
    """The sort's plain version: ``torch.argsort`` of the keys
    ``clamp(id, -1, n_rows) + 1``, stable, then the gathers."""
    keys = ids.clamp(-1, n_rows) + 1
    perm = torch.argsort(keys, stable=True)
    return (keys[perm] - 1).to(torch.int32), perm.to(torch.int32), tuple(p[perm] for p in payloads)


def sort_by_ids(ids: torch.Tensor, n_rows: int, payloads=()) -> tuple:
    """``(sorted_ids, perm, carried)`` for int32 ``ids`` in any order: the
    stable sort by node, every negative id as -1 before row 0 and every id
    at or past ``n_rows`` as ``n_rows`` after the last row, so each id in
    range lands where ``torch.argsort(ids, stable=True)`` puts it.
    ``sorted_ids`` are the clamped ids in that order, ``perm`` (int32) the
    edge indices, ``carried`` each of ``payloads`` (at most one int32 and
    one float32 tensor of one entry an id) in that order."""
    return _run_sort(ids, n_rows, tuple(payloads))


sort_by_ids.launches = 0


def sort_tile_keys() -> int:
    """Ids per tile of the sort's kernel (a CTA each in every pass)."""
    return _build.library().alaz_sort_tile_keys()


def _run_sort(ids, n_rows, payloads=()):
    if ids.device.type == "cpu":
        return sort_by_ids_plain(ids, n_rows, payloads)
    return _sort_by_ids_cuda(ids, n_rows, payloads)


def _sort_by_ids_cuda(ids, n_rows, payloads):
    dev = ids.device
    if dev.type != "cuda":
        raise ValueError(f"sort_by_ids: no kernel for device {dev}")
    _cuda_input(ids, "ids", dev, 1, torch.int32)
    e = ids.shape[0]
    if e >= 2**31 or not 0 <= n_rows < 2**31 - 1:
        raise ValueError(f"sort_by_ids: {e} ids, n_rows={n_rows} must fit int32")
    by_dtype = {}
    for p in payloads:
        _cuda_input(p, "payload", dev, 1)
        if p.dtype not in (torch.int32, torch.float32) or p.dtype in by_dtype:
            raise TypeError("sort_by_ids takes at most one int32 and one float32 payload")
        if p.shape[0] != e:
            raise ValueError(f"a payload has {p.shape[0]} entries for {e} ids")
        by_dtype[p.dtype] = p
    sorted_ids = torch.empty(e, dtype=torch.int32, device=dev)
    perm = torch.empty(e, dtype=torch.int32, device=dev)
    outs = {dt: torch.empty_like(p) for dt, p in by_dtype.items()}
    carried = tuple(outs[p.dtype] for p in payloads)
    if e == 0:
        return sorted_ids, perm, carried
    # each payload and its output, int32 then f32; a null pair for none
    pairs = [t.data_ptr() if t is not None else None
             for dt in (torch.int32, torch.float32) for t in (by_dtype.get(dt), outs.get(dt))]
    lib = _build.library()
    scratch = torch.empty(lib.alaz_sort_scratch_words(e), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.alaz_sort_by_ids(
            ids.data_ptr(), sorted_ids.data_ptr(), perm.data_ptr(), *pairs,
            scratch.data_ptr(), e, n_rows, _stream(dev),
        )
    _build.check(rc, "sort_by_ids")
    sort_by_ids.launches += 1
    return sorted_ids, perm, carried


KERNELS = (
    scatter_sum_sorted, segment_expand_sorted, gather_rows_banded, pallas_gather_scatter_sum,
)


def reset_launch_counts() -> None:
    """Every kernel's launch count to 0, the sort's too."""
    for fn in KERNELS:
        fn.launches = 0
    sort_by_ids.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
