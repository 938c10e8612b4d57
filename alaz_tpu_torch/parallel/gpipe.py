"""Microbatch pipeline parallelism over a mesh axis (SURVEY §2.3 P3).

The reference's "pipeline" is staged goroutine channels (ebpf→agg→ds);
the on-device analog for deep GNN stacks is GPipe-style microbatching:
each rank along the pipeline axis owns one contiguous block of layers,
activations hop stage→stage (one send and one receive a rank a tick,
``collectives.ring_shift``: NVLink on the cards), and the classic
(M + S − 1)-tick schedule keeps every stage busy once the pipe fills.
Bubble fraction is (S−1)/(M+S−1) — choose M ≫ S.

This is deliberately model-agnostic: ``make_pipeline`` takes any
per-layer ``fn(layer_params, x) -> x`` plus, on each rank, its stage's
block of the layer params stacked on a leading layer axis (L/S layers,
applied in order), and returns the per-rank runner over microbatches.
It is the scale-out path for GNN stacks deeper than one device's memory
allows; the tests hold it to the JAX package's pipeline on gloo ranks,
including the layers-per-stage > 1 case. Every hop and the output sum
carry gradients (``collectives.py``), so the pipeline trains too.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from alaz_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_sum,
    axis_index,
    axis_size,
    ring_shift,
)
from alaz_tpu_torch.parallel.mesh import axis_group


def _layer(tree, i: int):
    """Layer ``i`` of a pytree (dicts, lists, tensors) stacked on a
    leading layer axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_layer(v, i) for v in tree)
    return tree[i]


def _n_layers(tree) -> int:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


def make_pipeline(
    fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh,
    axis: str = "sp",
) -> Callable:
    """Build the per-rank ``run(stage_layer_params, micro_shard) -> outputs``.

    - ``stage_layer_params``: pytree whose leaves have leading axis L/S,
      this rank's block of the L layers (the mesh has S ranks along
      ``axis``; rank s holds layers [s·L/S, (s+1)·L/S)).
    - ``micro_shard``: this rank's [M/S, ...] block of the M
      microbatches; every microbatch flows through all L layers stage by
      stage. The result is this rank's [M/S, ...] block of the outputs.

    Schedule: at tick t ∈ [0, M+S−1), stage s applies its layers to the
    activation of microbatch (t − s) when 0 ≤ t − s < M; activations then
    hop one stage forward. Stage 0 injects microbatch t at tick t; stage
    S−1's outputs are collected in tick order, summed over the stages
    (only the last one's are not zero) and each rank keeps its block.
    """
    group = axis_group(mesh, axis)

    def run(layer_params, micro):
        s_axis = axis_size(group)
        stage = axis_index(group)
        layers_per_stage = _n_layers(layer_params)

        def apply_stage(x):
            for i in range(layers_per_stage):
                x = fn(_layer(layer_params, i), x)
            return x

        # every microbatch goes through every stage, so the microbatch
        # axis is gathered (cheap: activations are the small thing in
        # PP; params are what's partitioned)
        micro_all = all_gather(micro, group)  # [M, ...]
        m = micro_all.shape[0]
        dev = micro_all.device
        is_first = torch.tensor(stage == 0, device=dev)
        is_last = torch.tensor(stage == s_axis - 1, device=dev)
        inflight = torch.zeros_like(micro_all[0])
        outputs = [torch.zeros_like(micro_all[0]) for _ in range(m)]
        for t in range(m + s_axis - 1):
            # one program on every stage, as shard_map runs it: the
            # stage's choices are selects, so every rank builds the same
            # autograd graph and meets the others' hops in the backward
            # too (a stage computes on the bubble's ticks and drops it)
            x = torch.where(is_first, micro_all[min(t, m - 1)], inflight)
            active = torch.tensor(0 <= t - stage < m, device=dev)
            y = torch.where(active, apply_stage(x), inflight)
            # the last stage's completed microbatch (t − (S−1)) lands in
            # the output buffer; other stages keep their zeros
            out_idx = min(max(t - (s_axis - 1), 0), m - 1)
            outputs[out_idx] = torch.where(active & is_last, y, outputs[out_idx])
            # hop activations one stage forward for the next tick
            inflight = ring_shift(y, group, shift=1)
        # every rank holds an [M, ...] buffer but only the last stage's is
        # real (the others are zeros): the sum replicates it
        out = all_reduce_sum(torch.stack(outputs), group)
        per = m // s_axis
        return out[stage * per : (stage + 1) * per]

    return run


def sequential_reference(fn, stacked_layer_params, microbatches):
    """The ground truth: every microbatch through every layer in order."""
    s = _n_layers(stacked_layer_params)

    def one(x):
        for i in range(s):
            x = fn(_layer(stacked_layer_params, i), x)
        return x

    return torch.stack([one(x) for x in microbatches])
