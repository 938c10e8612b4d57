"""Segment reductions and gathers over COO edges.

The message-passing primitives the models are built on, with the JAX
package's ``ops/segment.py`` names and semantics. The sorted ops dispatch
to the hand-written kernels (``segment_kernels``) when the config asks
for them; otherwise they run plain PyTorch with the semantics of the JAX
package's XLA path (a segment sum accumulates at the input dtype).
"""

from __future__ import annotations

import os

import torch

from alaz_tpu_torch.graph.snapshot import EDGE_BLOCK_ROWS
from alaz_tpu_torch.ops import segment_kernels


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """out[s] = Σ_{i: ids[i]=s} data[i], accumulated at data's dtype."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, data)


def blocked_segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    block_starts: torch.Tensor,
    num_segments: int,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """[E, F] → [N, F] sum under the blocked layout: ``block_starts[-1]``
    is the live-edge frontier, every slot at or past it is bucket padding
    and is zeroed by position before the plain segment sum. Bit-exact vs
    the COO sum on every real node row (masking only adds exact zeros)."""
    e = data.shape[0]
    if e % EDGE_BLOCK_ROWS:
        raise ValueError(f"edge axis {e} not tile-aligned")
    live = torch.arange(e, device=data.device) < block_starts[-1]
    live = live.reshape((e,) + (1,) * (data.dim() - 1))
    masked = torch.where(live, data, torch.zeros((), dtype=data.dtype, device=data.device))
    out = segment_sum(masked, segment_ids, num_segments)
    return out if out_dtype is None else out.to(out_dtype)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    weights: torch.Tensor | None = None,
    block_starts: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean with masked counts: ``weights`` (0/1 per edge) excludes padding
    edges from both numerator and denominator. ``block_starts`` routes
    the three reductions through ``blocked_segment_sum`` (frontier-masked
    tiles) — bit-exact, since pad edges carry weight 0 either way."""
    if block_starts is not None:
        def _sum(d):
            return blocked_segment_sum(d, segment_ids, block_starts, num_segments)
    else:
        def _sum(d):
            return segment_sum(d, segment_ids, num_segments)

    if weights is not None:
        data = data * weights[:, None]
        counts = _sum(weights)
    else:
        counts = _sum(torch.ones(segment_ids.shape[0], dtype=data.dtype, device=data.device))
    totals = _sum(data)
    return totals / torch.clamp(counts, min=1.0)[:, None]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """out[s] = max_{i: ids[i]=s} data[i]; an empty segment is the dtype's
    lowest value (−inf for floats), as ``jax.ops.segment_max`` gives it."""
    low = -torch.inf if data.is_floating_point() else torch.iinfo(data.dtype).min
    out = torch.full((num_segments,) + tuple(data.shape[1:]), low, dtype=data.dtype, device=data.device)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=True)


_KERNEL_MODES = (True, False, "interpret")


def kernels_enabled(use_pallas: bool | str) -> bool:
    """THE predicate for sorted-kernel dispatch (the JAX package's
    ``pallas_enabled``): on when the config asks for the kernels. The
    config's ``True`` and the JAX package's test mode ``"interpret"``
    both ask; where the kernel runs is then the tensor's device, decided
    in the wrapper (the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors)."""
    if use_pallas not in _KERNEL_MODES:
        raise ValueError(f"use_pallas={use_pallas!r}; expected one of {_KERNEL_MODES}")
    return bool(use_pallas)


def expand_dst(
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    use_pallas: bool | str = False,
) -> torch.Tensor:
    """[N, F] → [E, F] broadcast ``v[segment_ids]`` for dst-SORTED ids.

    The single dispatch point for the sorted-expand kernel.
    ``ALAZ_EXPAND_DST=xla|pallas`` overrides the dispatch with the JAX
    package's vocabulary: ``xla`` forces the plain row gather, ``pallas``
    the kernel. Any other value raises: a typo'd A/B run must not
    silently measure the default path under the override's label."""
    forced = os.environ.get("ALAZ_EXPAND_DST", "")
    if forced not in ("", "xla", "pallas"):
        raise ValueError(f"ALAZ_EXPAND_DST={forced!r}: must be 'xla' or 'pallas'")
    if forced == "xla":
        return v[segment_ids]
    if forced == "pallas" or kernels_enabled(use_pallas):
        return segment_kernels.segment_expand_sorted(v, segment_ids, num_segments)
    return v[segment_ids]


def segment_sum_sorted_dispatch(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    use_pallas: bool | str = False,
    out_dtype: torch.dtype | None = None,
    block_starts: torch.Tensor | None = None,
) -> torch.Tensor:
    """[E, F] → [N, F] sum over dst-SORTED segment ids: the sorted-scatter
    kernel when enabled (f32 accumulation, ``out_dtype`` emitted straight
    from the f32 sum), the plain segment sum otherwise (accumulated at the
    input dtype, then cast). ``block_starts`` hands the kernel its
    per-block edge runs and routes the plain path through
    ``blocked_segment_sum``."""
    if kernels_enabled(use_pallas):
        return segment_kernels.scatter_sum_sorted(
            data, segment_ids, num_segments, out_dtype, block_starts
        )
    if block_starts is not None:
        return blocked_segment_sum(data, segment_ids, block_starts, num_segments, out_dtype)
    out = segment_sum(data, segment_ids, num_segments)
    return out if out_dtype is None else out.to(out_dtype)


def segment_sum_accurate(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    use_pallas: bool | str = False,
    block_starts: torch.Tensor | None = None,
) -> torch.Tensor:
    """``segment_sum_sorted_dispatch`` with guaranteed f32 accumulation
    and a lossless f32 result. A bf16 running sum stagnates once
    increments fall below 2^-8 of the partial (2048 bf16 ones sum to
    256), so the plain path upcasts first; the kernel accumulates in f32
    whatever its input."""
    if not kernels_enabled(use_pallas):
        data = data.float()
    return segment_sum_sorted_dispatch(
        data, segment_ids, num_segments, use_pallas,
        out_dtype=torch.float32, block_starts=block_starts,
    )


# THE attention-logit clamp of GAT's fused softmax-aggregate: softmax of
# the clamped logits equals softmax of the logits whenever |x| <= 30, and
# exp(30) ~ 1e13 keeps the f32 segment sums far from overflow
ATTENTION_LOGIT_CLAMP = 30.0

_SRC_GATHER_MODES = ("xla", "banded", "banded-interpret")


def gather_src(
    v: torch.Tensor,
    src_ids: torch.Tensor,
    num_nodes: int,
    mode: str = "xla",
) -> torch.Tensor:
    """[N, F] → [E, F] gather ``v[src_ids]`` for UNSORTED src ids.
    ``mode``: "xla" is the plain row gather; "banded" and the JAX
    package's test mode "banded-interpret" go through the banded-gather
    wrapper (K3 on a CUDA tensor, its plain version on a CPU one). Both
    give exactly ``v[src_ids]``. An unknown mode raises: a typo must not
    measure the wrong path under the right name."""
    if mode not in _SRC_GATHER_MODES:
        raise ValueError(f"src_gather mode {mode!r}; expected one of {_SRC_GATHER_MODES}")
    if mode == "xla":
        return v[src_ids]
    return segment_kernels.gather_rows_banded(v, src_ids, num_nodes)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
    use_pallas: bool | str = False,
) -> torch.Tensor:
    """Per-segment softmax over edge logits (GAT attention normalization).

    ``logits`` may be [E] or [E, H] (all heads in one call). Masked edges
    get −1e30 logits so they contribute zero weight; a segment's max is
    zeroed where the segment is empty (−inf). With ``use_pallas`` and
    dst-sorted segment ids, the two per-edge broadcasts go through the
    sorted-expand wrapper (K2 on a CUDA tensor) and the denominator
    through the sorted-sum wrapper (K1), as the JAX package routes them
    through its sorted-expand kernel; their plain versions on a CPU
    tensor."""
    squeeze = logits.dim() == 1
    if squeeze:
        logits = logits[:, None]
    if mask is not None:
        logits = torch.where(mask[:, None], logits, -1e30)
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    exp = torch.exp(logits - expand_dst(seg_max, segment_ids, num_segments, use_pallas))
    if mask is not None:
        exp = torch.where(mask[:, None], exp, 0.0)
    denom = segment_sum_sorted_dispatch(exp, segment_ids, num_segments, use_pallas)
    denom_e = expand_dst(denom, segment_ids, num_segments, use_pallas)
    # double-where guard: an all-masked segment (the pad tail) has denom
    # 0, and a bare eps-clamped division NaNs in the backward (x/y² with
    # y² underflowing f32); make the division itself safe instead of
    # relying on masking downstream
    nonempty = denom_e > 0.0
    out = torch.where(nonempty, exp / torch.where(nonempty, denom_e, 1.0), 0.0)
    return out[:, 0] if squeeze else out


def gather_scatter_sum(
    x: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    num_nodes: int,
    edge_weight: torch.Tensor | None = None,
    use_pallas: bool | str | None = None,
    block_starts: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[d] = Σ_{e: dst[e]=d} w[e]·x[src[e]] over dst-sorted edges.

    With kernels enabled (``use_pallas=None`` means enabled; the tensors'
    device then decides where it runs) this is the fused gather-scatter
    wrapper (K4): messages formed in x's dtype, summed in f32, one
    rounding, ``block_starts`` as its row starts. Otherwise the plain
    gather and segment sum at the message dtype, through
    ``blocked_segment_sum`` when ``block_starts`` is given."""
    if use_pallas is None or kernels_enabled(use_pallas):
        return segment_kernels.pallas_gather_scatter_sum(
            x, edge_src, edge_dst, num_nodes, edge_weight, block_starts
        )
    msgs = x[edge_src]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    if block_starts is not None:
        return blocked_segment_sum(msgs, edge_dst, block_starts, num_nodes)
    return segment_sum(msgs, edge_dst, num_nodes)
