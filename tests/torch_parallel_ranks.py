"""The port's side of the parallel parity tests: what each gloo rank runs.

The test files spawn their ranks once per module
(``multislice.spawn(run_cases, world, (cases,), device="cpu")``); every
rank runs every case in order and returns ``{case key: numpy results}``.
This module imports torch and the port only: the ranks load no jax (the
test files compute the JAX side in the test process).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from alaz_tpu_torch.config import MeshConfig, ModelConfig
from alaz_tpu_torch.models.registry import get_model
from alaz_tpu_torch.parallel import collectives as C
from alaz_tpu_torch.parallel.mesh import axis_group, make_mesh


def _mesh(shape):
    return make_mesh(MeshConfig(*shape), device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _model(cfg_kw: dict, state: dict):
    cfg = ModelConfig(**cfg_kw)
    model = get_model(cfg.model)[0](0, cfg, device="cpu")
    model.load_state_dict(state)
    return cfg, model


def run_cases(cases: list) -> dict:
    """Run ``[(key, case name, kwargs), ...]`` on this rank, in order."""
    return {key: globals()[name](**kw) for key, name, kw in cases}


# -- collectives and the ring ---------------------------------------------------


def halo(shape, h, src, dst_local, mask, axis="sp"):
    """``make_halo_aggregate`` on this rank's block (``shard_graph``'s
    stacked arrays in)."""
    from alaz_tpu_torch.parallel.halo import make_halo_aggregate

    mesh = _mesh(shape)
    i = mesh.get_local_rank(axis)
    run = make_halo_aggregate(mesh, axis)
    out = run(*(torch.as_tensor(a[i : i + 1]) for a in (h, src, dst_local, mask)))
    return {"out": _np(out[0]), "index": i}


def ring_attention(shape, arrays, a_k, dtype):
    from alaz_tpu_torch.parallel.halo import ring_attention_aggregate

    mesh = _mesh(shape)
    i = mesh.get_local_rank("sp")
    dt = getattr(torch, dtype)
    qp, kv, ep, ef, s, dl, m = (torch.as_tensor(a[i]) for a in arrays)
    out = ring_attention_aggregate(
        qp.to(dt), kv.to(dt), ep.to(dt), ef.to(dt), torch.as_tensor(a_k).to(dt),
        s, dl, m, axis=axis_group(mesh, "sp"),
    )
    return {"out": _np(out), "index": i, "dtype": str(out.dtype)}


def collective_grads(shape, x, w):
    """Gradients of this rank's loss term Σ w·op(x) through each
    differentiable collective, and ``ring_shift`` by 1 and by -1."""
    mesh = _mesh(shape)
    g = axis_group(mesh, "sp")
    i = mesh.get_local_rank("sp")
    out = {"index": i}
    ops = {
        "all_reduce_sum": lambda t: C.all_reduce_sum(t, g),
        "all_gather": lambda t: C.all_gather(t, g),
        "ring_shift": lambda t: C.ring_shift(t, g, 1),
        "ring_shift_back": lambda t: C.ring_shift(t, g, -1),
    }
    for name, op in ops.items():
        xi = torch.as_tensor(x[i]).clone().requires_grad_(True)
        y = op(xi)
        wi = torch.as_tensor(w[name][i])
        (wi * y).sum().backward()
        out[name] = _np(y)
        out[f"{name}_grad"] = _np(xi.grad)
    return out


def reshard(shape, h):
    mesh = _mesh(shape)
    g = axis_group(mesh, "sp")
    i = mesh.get_local_rank("sp")
    n_loc = h.shape[0] // C.axis_size(g)
    fs = C.nodes_to_features(torch.as_tensor(h[i * n_loc : (i + 1) * n_loc]), g)
    back = C.features_to_nodes(fs, g)
    return {"features": _np(fs), "back": _np(back), "index": i}


def znorm(shape, ef, mask):
    from alaz_tpu_torch.models.common import znorm_edge_feats

    mesh = _mesh(shape)
    i = mesh.get_local_rank("sp")
    out = znorm_edge_feats(torch.as_tensor(ef[i]), torch.as_tensor(mask[i]), axis=axis_group(mesh, "sp"))
    return {"out": _np(out), "index": i}


def pipeline(shape, w, b, micro, grad=False):
    """``make_pipeline`` of ``tanh(x @ w + b)`` layers on this rank's stage
    block and microbatch block; with ``grad``, the gradient of Σ out² of
    this rank's block into its stage's params and microbatches."""
    from alaz_tpu_torch.parallel.gpipe import make_pipeline

    mesh = _mesh(shape)
    i = mesh.get_local_rank("sp")
    s = C.axis_size(axis_group(mesh, "sp"))
    per_l, per_m = w.shape[0] // s, micro.shape[0] // s
    params = {
        "w": torch.as_tensor(w[i * per_l : (i + 1) * per_l]).clone().requires_grad_(grad),
        "b": torch.as_tensor(b[i * per_l : (i + 1) * per_l]).clone().requires_grad_(grad),
    }
    mb = torch.as_tensor(micro[i * per_m : (i + 1) * per_m]).clone().requires_grad_(grad)

    def fn(layer, x):
        return torch.tanh(x @ layer["w"] + layer["b"])

    out = make_pipeline(fn, mesh, axis="sp")(params, mb)
    res = {"out": _np(out), "index": i}
    if grad:
        (out**2).sum().backward()
        res.update(w_grad=_np(params["w"].grad), b_grad=_np(params["b"].grad), micro_grad=_np(mb.grad))
    return res


# -- node-sharded forwards --------------------------------------------------------


def node_sharded(shape, cfg_kw, state, sharded, y=None, m=None):
    """The node-sharded forward of this rank's shard; with labels ``y``
    and mask ``m`` (per shard slot), also the gradient of the whole
    graph's masked squared error, summed over ``sp`` by
    ``all_reduce_grads``."""
    from alaz_tpu_torch.parallel.sharded_model import (
        all_reduce_grads,
        make_node_sharded_gat,
        make_node_sharded_graphsage,
        rank_shard,
    )

    mesh = _mesh(shape)
    i = mesh.get_local_rank("sp")
    cfg, model = _model(cfg_kw, state)
    maker = make_node_sharded_gat if cfg.model == "gat" else make_node_sharded_graphsage
    run = maker(cfg, mesh, axis="sp")
    g = rank_shard(sharded, i, "cpu")
    el, nl = run(model, g)
    out = {"edge_logits": _np(el), "node_logits": _np(nl), "index": i}
    if y is not None:
        yi, mi = torch.as_tensor(y[i]), torch.as_tensor(m[i])
        loss = ((el[0] - yi) ** 2 * mi).sum() / float(m.sum())
        loss.backward()
        all_reduce_grads(model, mesh, "sp")
        out["grads"] = {k: _np(p.grad) for k, p in model.named_parameters() if p.grad is not None}
    return out


# -- the sharded train and score steps --------------------------------------------------


def train_step(shape, cfg_kw, state, stacked, labels, lr):
    from alaz_tpu_torch.parallel.sharding import adamw, make_sharded_train_step

    mesh = _mesh(shape)
    cfg, model = _model(cfg_kw, state)
    step = make_sharded_train_step(cfg, mesh, adamw(lr), model)
    st = step.init(model)
    shard_shapes = {k: tuple(v.shape) for k, v in st.shards.items()}
    loss = step(st, stacked, labels)
    # the step leaves each shard's gradient (after the dp sum) in .grad
    grads = {k: _np(p.grad) for k, p in st.shards.items()}
    full = step.gather(st.shards)
    moments = {k: tuple(s["exp_avg"].shape) for k, s in
               zip(st.shards, (st.optimizer.state[p] for p in st.shards.values()))}
    return {
        "loss": float(loss), "params": {k: _np(v) for k, v in full.items()}, "grads": grads,
        "coords": {ax: mesh.get_local_rank(ax) for ax in ("dp", "tp", "ep", "sp")},
        "shard_shapes": shard_shapes, "moment_shapes": moments, "cfg": step.cfg.expert_dispatch,
        "rank": dist.get_rank(),
    }


def score_step(shape, cfg_kw, state, stacked):
    from alaz_tpu_torch.parallel.sharding import make_sharded_score_step

    mesh = _mesh(shape)
    cfg, model = _model(cfg_kw, state)
    out = make_sharded_score_step(cfg, mesh, model)(model, stacked)
    return {"edge_logits": _np(out), "dp": mesh.get_local_rank("dp")}
