"""Sharding rules + the sharded train and score steps.

Strategy (the JAX package's, on ``torch.distributed``; every rank runs
the step on its part):

- **DP**: a step consumes a *stack* of G window graphs ``[G, ...]``; each
  dp rank takes its G/dp windows. The loss is the mean over all G
  windows, so a rank's gradient is its windows' share of it, and the
  gradients are summed over ``dp`` (an average of the ranks' means).
- **TP / EP** (the train step): parameters, and so the optimizer's
  moments, are STORED sharded by ``param_pspec``: every dense ``w [in,
  out]`` on its out-dim over ``tp``, the stacked expert tables
  (``expert_*`` [T, ...]) on the expert axis over ``ep``. Each rank holds its shard, and its optimizer
  steps only that shard (the moments of a shard are the shard of the
  moments: ``opt_state_pspec``'s rule). The model runs on the whole
  weights, gathered at use (``torch.func.functional_call``); the
  windows are the same on every tp and ep rank of a dp slice, so the
  gather's backward takes this rank's slice of the gradient with no
  reduction. XLA, in the JAX package, chooses its own collectives and
  may shard the activations too: the port gathers the weights (about
  10^5 values at hidden 128) and never the activations (a window's is
  about 1.7·10^7: 131,072 × 128). The score step keeps no state: it
  scores with the whole params as given.
- **SP** is layered separately (halo.py and sharded_model.py shard the
  node axis); EP's dispatch is ``experts.py``'s.

A partition spec is a tuple with one entry per dim: the mesh axis that
dim is split over, or None (``jax.sharding.PartitionSpec`` as a tuple;
``()`` replicates). Specs are keyed by parameter name: the JAX param
tree's path joined by ``.`` (``convert.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.graph.snapshot import GraphBatch
from alaz_tpu_torch.parallel.collectives import _all_gather, all_reduce_sum
from alaz_tpu_torch.parallel.mesh import AXES, axis_group, axis_sizes
from alaz_tpu_torch.train.objective import edge_bce_loss

# ---------------------------------------------------------------------------
# Partition specs
# ---------------------------------------------------------------------------


def mesh_axis_names() -> tuple[str, ...]:
    """Re-export of config.mesh_axis_names (the single source of truth
    for the mesh vocabulary) for sharding-side callers."""
    from alaz_tpu_torch.config import mesh_axis_names as _names

    return _names()


def _named(params) -> dict:
    """``{name: tensor}`` of a module's parameters or a state dict."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def param_pspec(params: Any, tp: int = 1, ep: int = 1) -> dict:
    """TP rule: 2D weights shard the output dim over 'tp' when divisible
    (heads ending in width-1 logits replicate); 1D params replicate.
    EP rule: stacked expert tables (``expert_*`` [T, ...]) shard the
    expert axis over 'ep'. ``params``: a module or a state dict; the
    result is ``{name: spec}``."""

    def rule(name: str, leaf) -> tuple:
        is_expert = any(k.startswith("expert_") for k in name.split("."))
        if is_expert and ep > 1 and leaf.shape[0] % ep == 0:
            if leaf.ndim == 3 and tp > 1 and leaf.shape[-1] % tp == 0:
                return ("ep", None, "tp")
            return ("ep",) + (None,) * (leaf.ndim - 1)
        if leaf.ndim == 2 and tp > 1 and leaf.shape[-1] % tp == 0:
            # type_emb [T, H] and dense w [in, out]: shard last dim
            return (None, "tp")
        return ()

    return {name: rule(name, leaf) for name, leaf in _named(params).items()}


# the per-parameter state torch's Adam and AdamW keep (``step`` a scalar,
# the moments shaped like the parameter), for an optimizer that has not
# stepped yet and so holds no state
_ADAM_STATE = ("step", "exp_avg", "exp_avg_sq")


def opt_state_pspec(optimizer: torch.optim.Optimizer, params: Any, tp: int = 1, ep: int = 1) -> dict:
    """Partition specs of an optimizer's state over ``params`` (the module
    it was built over), keyed ``"<param name>.<state key>"``: moment
    entries (shaped like their parameter) shard LIKE it; bookkeeping
    scalars (step counts) replicate — the train-side half of the
    contract, the rule the JAX package applies to optax's ``mu``/``nu``
    and ``count``. An Adam or AdamW that has not stepped yet is read as
    the state it will create."""
    named = _named(params)
    p_spec = param_pspec(named, tp=tp, ep=ep)
    name_of = {id(p): n for n, p in named.items()}
    out = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = name_of[id(p)]
            state = optimizer.state.get(p) or {}
            if not state:
                if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
                    raise ValueError(f"{type(optimizer).__name__} has no state yet: step it once first")
                state = {"step": torch.zeros(()), "exp_avg": p, "exp_avg_sq": p}
            for key, value in state.items():
                same = isinstance(value, torch.Tensor) and tuple(value.shape) == tuple(p.shape)
                out[f"{name}.{key}"] = p_spec[name] if same else ()
    return out


def graph_pspec(stacked: bool = True) -> dict:
    """Graph-batch spec: leading G axis sharded over 'dp'."""
    lead = ("dp",) if stacked else ()

    def spec(extra_dims: int) -> tuple:
        return (*lead, *([None] * extra_dims))

    return {
        "node_feats": spec(2),
        "node_type": spec(1),
        "node_mask": spec(1),
        "node_deg": spec(1),
        "edge_src": spec(1),
        "edge_dst": spec(1),
        "edge_type": spec(1),
        "edge_feats": spec(2),
        "edge_mask": spec(1),
        # blocked layout only: per-128-dst-row extent table. Absent from
        # COO batches — consumers key off the data dict, so the extra
        # entry here is inert under the default layout.
        "edge_block_starts": spec(1),
    }


def stack_graphs(batches: list[GraphBatch]) -> tuple[dict, np.ndarray]:
    """Stack same-bucket GraphBatches into [G, ...] arrays + labels."""
    assert len({(b.n_pad, b.e_pad) for b in batches}) == 1, "mixed shape buckets"
    graphs = [b.device_arrays() for b in batches]
    stacked = {k: np.stack([g[k] for g in graphs]) for k in graphs[0]}
    labels = np.stack([b.edge_label for b in batches])
    return stacked, labels


def adamw(lr: float, weight_decay: float = 1e-4) -> Callable:
    """``optax.adamw(lr)`` as an optimizer factory over a list of tensors
    (what ``make_sharded_train_step`` takes): betas (0.9, 0.999), eps 1e-8,
    decoupled decay 1e-4 on every parameter (``trainstep._adamw``'s)."""
    return functools.partial(
        torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


# ---------------------------------------------------------------------------
# Sharded steps
# ---------------------------------------------------------------------------


def _ep_safe_cfg(cfg: ModelConfig, mesh) -> ModelConfig:
    """Force the masked expert dispatch when the expert axis actually
    shards: the table form's [T, N, H] per-expert tables would be
    gathered across 'ep' every layer (ModelConfig.expert_dispatch docs)."""
    if axis_sizes(mesh).get("ep", 1) > 1 and cfg.expert_dispatch != "masked":
        from dataclasses import replace

        return replace(cfg, expert_dispatch="masked")
    return cfg


class _GatherOnUse(torch.autograd.Function):
    """A stored shard → the whole tensor along ``dim`` over ``group``.
    Backward: this rank's slice of the gradient, unreduced — every rank
    of the group computed the same whole-tensor gradient from the same
    windows (an all-gather's usual backward, a reduce-scatter sum, would
    scale it by the group's size)."""

    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(shard.movedim(dim, 0), group).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        n, i = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[i].contiguous(), None, None


@dataclasses.dataclass
class ShardedTrainState:
    """One rank's part of the training state: its shard of every
    parameter (by name, ``nn.Parameter`` leaves on the mesh's device) and
    the optimizer stepping them."""

    shards: dict
    optimizer: torch.optim.Optimizer


class _ShardedModel:
    """Shard, gather and apply one model family over a mesh: the part the
    train and score steps share."""

    def __init__(self, cfg: ModelConfig, mesh, params_example: nn.Module):
        self.cfg = _ep_safe_cfg(cfg, mesh)
        self.sizes = axis_sizes(mesh)
        self.groups = {ax: axis_group(mesh, ax) for ax in AXES}
        self.coords = {ax: mesh.get_local_rank(ax) for ax in AXES}
        self.device = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device(mesh.device_type)
        self.specs = param_pspec(params_example, tp=self.sizes["tp"], ep=self.sizes["ep"])
        with torch.device("meta"):
            self.skeleton = type(params_example)(self.cfg)

    def shard(self, params: nn.Module) -> dict:
        """This rank's shard of each of ``params``' tensors, by name (a
        local slice: no communication)."""
        out = {}
        for name, p in params.named_parameters():
            t = p.detach()
            for dim, ax in enumerate(self.specs[name]):
                if ax is not None:
                    t = t.chunk(self.sizes[ax], dim=dim)[self.coords[ax]]
            out[name] = t.to(self.device).contiguous()
        return out

    def gather(self, shards: dict) -> dict:
        """The whole tensors from every rank's shards (collective: every
        rank calls it), differentiable into the shards."""
        out = {}
        for name, t in shards.items():
            for dim, ax in enumerate(self.specs[name]):
                if ax is not None and self.sizes[ax] > 1:
                    t = _GatherOnUse.apply(t, self.groups[ax], dim)
            out[name] = t
        return out

    def windows(self, stacked_graph: dict, labels=None) -> list:
        """This dp rank's G/dp windows of the stack, as graphs of tensors
        on the device (with their labels when given)."""
        from alaz_tpu_torch.convert import graph_to_torch

        g = next(iter(stacked_graph.values())).shape[0]
        dp, idx = self.sizes["dp"], self.coords["dp"]
        if g % dp:
            raise ValueError(f"a stack of {g} windows does not split over dp={dp}")
        per = g // dp
        out = []
        for i in range(idx * per, (idx + 1) * per):
            graph = graph_to_torch({k: np.ascontiguousarray(v[i]) for k, v in stacked_graph.items()}, self.device)
            label = None if labels is None else torch.as_tensor(np.asarray(labels[i]), device=self.device)
            out.append((graph, label))
        return out

    def apply(self, full: dict, graph: dict) -> dict:
        return torch.func.functional_call(self.skeleton, full, (graph,))


class ShardedTrainStep(_ShardedModel):
    """``step(state, stacked_graph, labels) -> loss``: one optimizer step
    of the mean edge BCE over a dp-sharded stack of G windows with
    tp/ep-sharded parameters and optimizer state. ``init(params)`` makes
    this rank's ``ShardedTrainState``; ``gather(state.shards)`` gives the
    whole parameters back. Every rank of the mesh calls each of them."""

    def __init__(self, cfg, mesh, optimizer: Callable, params_example, pos_weight: float = 10.0):
        super().__init__(cfg, mesh, params_example)
        self.make_optimizer = optimizer
        self.pos_weight = pos_weight

    def init(self, params: nn.Module) -> ShardedTrainState:
        shards = {k: nn.Parameter(v.clone()) for k, v in self.shard(params).items()}
        return ShardedTrainState(shards, self.make_optimizer(list(shards.values())))

    def __call__(self, state: ShardedTrainState, stacked_graph: dict, labels) -> torch.Tensor:
        g_total = labels.shape[0]
        state.optimizer.zero_grad(set_to_none=True)
        full = self.gather(state.shards)
        loss = 0.0
        for graph, label in self.windows(stacked_graph, labels):
            out = self.apply(full, graph)
            loss = loss + edge_bce_loss(out["edge_logits"], label, graph["edge_mask"].float(), self.pos_weight)
        loss = loss / g_total  # this rank's share of the mean over all G
        loss.backward()
        for p in state.shards.values():
            # optax updates (and decays) every leaf: a param the loss does
            # not reach (the node head) gets a zero gradient, not none
            grad = torch.zeros_like(p) if p.grad is None else p.grad
            p.grad = all_reduce_sum(grad, self.groups["dp"])
        state.optimizer.step()
        return all_reduce_sum(loss.detach(), self.groups["dp"])


class ShardedScoreStep(_ShardedModel):
    """``score(params, stacked_graph) -> edge_logits [G/dp, E]`` of this
    rank's windows of a dp-sharded stack, scored with ``params`` (the
    whole module) as given: scoring keeps no state, so there is no shard
    to store and nothing to gather. Every rank of the mesh calls it."""

    def __call__(self, params: nn.Module, stacked_graph: dict) -> torch.Tensor:
        with torch.inference_mode():
            full = {k: p.to(self.device) for k, p in params.named_parameters()}
            return torch.stack([self.apply(full, graph)["edge_logits"] for graph, _ in self.windows(stacked_graph)])


def make_sharded_train_step(
    cfg: ModelConfig,
    mesh,
    optimizer: Callable,
    params_example: nn.Module,
    pos_weight: float = 10.0,
) -> ShardedTrainStep:
    """The train step over a dp-sharded stack of graphs with tp/ep-sharded
    params. ``optimizer`` builds the optimizer over a list of tensors
    (``adamw(lr)`` is optax's ``adamw``). Use: ``state =
    step.init(params)``, then ``loss = step(state, stacked_graph,
    labels)`` (numpy from ``stack_graphs``) on every rank."""
    return ShardedTrainStep(cfg, mesh, optimizer, params_example, pos_weight)


def make_sharded_score_step(cfg: ModelConfig, mesh, params_example: nn.Module) -> ShardedScoreStep:
    """Inference over a dp-sharded stack of graphs: ``score(params,
    stacked_graph)`` on every rank gives that rank's windows' edge
    logits."""
    return ShardedScoreStep(cfg, mesh, params_example)
