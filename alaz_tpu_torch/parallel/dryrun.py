"""Multi-rank dry-run: every parallel leg on N ranks, each checked
against the single-device computation.

    python -m alaz_tpu_torch.parallel.dryrun N [--device cpu]

spawns N ranks (NCCL one rank per card by default, gloo on ``--device
cpu``) and runs, as the JAX package's ``dryrun_multichip`` does on N
devices:

- the flagship leg: GraphSAGE (16k-edge windows, hidden 128) on the
  hybrid (dp, tp, sp) mesh, one sharded train step, its loss
  against the single-device mean over the same windows;
- the experts' sharded train step on a (dp, tp, ep) mesh (masked
  dispatch once ep > 1), its loss checked the same way;
- the sp leg: the ring halo aggregate against the plain segment sum;
- the ring-attention leg: the node-sharded GAT forward against the
  single-device ``apply``;
- the pp leg: a GPipe pipeline over ``min(4, N)`` ranks against the
  sequential loop.

Rank 0 prints the summary line (``dryrun_multichip ok: ...``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from alaz_tpu_torch.parallel.multislice import spawn


def _close(got, ref, what: str, rtol: float, atol: float) -> None:
    if not np.allclose(got, ref, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max |Δ| {np.abs(np.asarray(got) - np.asarray(ref)).max()} "
                             f"past rtol {rtol} atol {atol}")


def _single_loss(cfg, params, stacked: dict, labels: np.ndarray, dev) -> float:
    """The single-device mean edge BCE over the stack's windows."""
    from alaz_tpu_torch.convert import graph_to_torch
    from alaz_tpu_torch.train.trainstep import make_loss_fn

    loss_fn = make_loss_fn(cfg)
    with torch.no_grad():
        losses = [
            float(loss_fn(params, graph_to_torch({k: v[i] for k, v in stacked.items()}, dev),
                          torch.as_tensor(labels[i], device=dev)))
            for i in range(labels.shape[0])
        ]
    return float(np.mean(losses))


def _train_leg(cfg, mesh, dp: int, window: dict, seed: int, label_seed: int, dev) -> float:
    """One sharded train step over ``dp`` windows; its loss held to the
    single-device mean over the same windows (relative 1e-5: the same
    per-window forwards, summed in another order)."""
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.parallel.sharding import adamw, make_sharded_train_step, stack_graphs
    from alaz_tpu_torch.replay.synth import example_batch

    params = init_params(cfg, seed, device=dev)
    stacked, labels = stack_graphs([example_batch(**window, seed=s) for s in range(dp)])
    labels = np.where(np.random.default_rng(label_seed).random(labels.shape) < 0.1, 1.0, 0.0).astype(np.float32)
    step = make_sharded_train_step(cfg, mesh, adamw(1e-3), params)
    state = step.init(params)
    loss = float(step(state, stacked, labels))
    ref = _single_loss(step.cfg, params, stacked, labels, dev)
    _close(loss, ref, f"{cfg.model} sharded loss vs single-device", 1e-5, 0.0)
    return loss


def _legs(world_size: int) -> dict:
    """Every leg on this rank (all ranks run this)."""
    import torch.distributed as dist

    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.convert import graph_to_torch
    from alaz_tpu_torch.models.registry import get_model, init_params
    from alaz_tpu_torch.ops.segment import segment_sum
    from alaz_tpu_torch.parallel.gpipe import make_pipeline, sequential_reference
    from alaz_tpu_torch.parallel.halo import make_halo_aggregate, shard_graph
    from alaz_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
    from alaz_tpu_torch.parallel.multislice import make_hybrid_mesh, slice_count
    from alaz_tpu_torch.parallel.sharded_model import (
        make_node_sharded_gat,
        rank_shard,
        shard_graph_batch,
        unshard_edge_outputs,
    )
    from alaz_tpu_torch.replay.synth import example_batch

    n = world_size
    dev_type = "cuda" if torch.cuda.is_available() and dist.get_backend() == "nccl" else "cpu"
    dev = torch.device(dev_type, torch.cuda.current_device()) if dev_type == "cuda" else torch.device("cpu")
    # Main mesh: dp stays > 1 alongside the other axes whenever the rank
    # count allows (with fewer than 4 ranks there is room for one
    # nontrivial axis and dp concedes it to tp); dp outermost, the
    # host-crossing axis of the hybrid mesh. ep rides a second mesh.
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % (tp * 2) == 0 else 1
    if n == tp * sp and sp > 1:
        sp = 1  # never let sp squeeze dp back to 1 (4-rank case)
    assert n < 4 or n // (tp * sp) > 1, "dp degenerated"
    mesh_cfg = mesh_shape_for(n, tp=tp, ep=1, sp=sp)
    mesh = make_hybrid_mesh(mesh_cfg, device=dev_type)
    n_slices = slice_count()

    # flagship leg: GraphSAGE (the model the service serves) at a
    # realistic bucket, dp over window stacks, tp over hidden dims
    gs_cfg = ModelConfig(model="graphsage", hidden_dim=128)
    gs_window = dict(n_pods=1500, n_svcs=300, n_edges=16384)
    gs_loss = _train_leg(gs_cfg, mesh, mesh_cfg.dp, gs_window, 1, 7, dev)

    # experts leg: expert tables shard over ep, dense out-dims over tp,
    # window stacks over dp — the (dp, tp, ep) train step on a second mesh
    ep = 2 if n % (tp * 2) == 0 else 1
    ep_cfg_mesh = mesh_shape_for(n, tp=tp, ep=ep, sp=1)
    ep_mesh = make_mesh(ep_cfg_mesh, device=dev_type)
    ex_cfg = ModelConfig(model="experts", hidden_dim=64)
    ex_loss = _train_leg(ex_cfg, ep_mesh, ep_cfg_mesh.dp, dict(n_pods=100, n_svcs=20, n_edges=300), 0, 0, dev)

    # sp leg: ring-halo aggregation over node shards on the main mesh's sp axis
    s_idx = mesh.get_local_rank("sp")
    rng = np.random.default_rng(1)
    n_nodes, feat = 16 * mesh_cfg.sp, 8
    e_src = rng.integers(0, n_nodes, 64).astype(np.int32)
    e_dst = rng.integers(0, n_nodes, 64).astype(np.int32)
    feats = rng.normal(size=(n_nodes, feat)).astype(np.float32)
    blocks = shard_graph(feats, e_src, e_dst, mesh_cfg.sp)
    out = make_halo_aggregate(mesh, axis="sp")(*(torch.as_tensor(b[s_idx : s_idx + 1], device=dev) for b in blocks))
    ref = segment_sum(torch.as_tensor(feats)[torch.as_tensor(e_src).long()], torch.as_tensor(e_dst).long(), n_nodes)
    n_loc = n_nodes // mesh_cfg.sp
    _close(out[0].cpu().numpy(), ref[s_idx * n_loc : (s_idx + 1) * n_loc].numpy(), "halo vs segment_sum", 1e-4, 1e-5)

    # ring-attention leg: the node-sharded GAT forward (fused
    # softmax-aggregate over ring hops) against the single-device apply
    gat_cfg = ModelConfig(model="gat", hidden_dim=16, num_heads=2, dtype="float32")
    gat_params = init_params(gat_cfg, 3, device=dev)
    gb = example_batch(n_pods=40, n_svcs=8, n_edges=160, seed=9)
    with torch.no_grad():
        gat_ref = get_model("gat")[1](gat_params, graph_to_torch(gb.device_arrays(), dev), gat_cfg)
        sharded, perm = shard_graph_batch(gb, mesh_cfg.sp)
        gat_el, _ = make_node_sharded_gat(gat_cfg, mesh, axis="sp")(gat_params, rank_shard(sharded, s_idx, dev))
    mine = np.full(perm.shape, np.nan, np.float32)
    mine[s_idx] = gat_el[0].cpu().numpy()
    got = unshard_edge_outputs(mine[s_idx : s_idx + 1], perm[s_idx : s_idx + 1], gb.e_pad)
    live = np.zeros(gb.e_pad, bool)
    live[perm[s_idx][perm[s_idx] >= 0]] = True
    _close(got[live], gat_ref["edge_logits"].cpu().numpy()[live], "ring attention vs single-device GAT", 1e-4, 1e-4)

    # pp leg: GPipe microbatch pipeline on a pipeline mesh of the first
    # pp ranks — neighbor-hop scheduling against the sequential loop
    pp = min(4, n)
    if pp >= 2:
        from torch.distributed.device_mesh import DeviceMesh

        pp_mesh = DeviceMesh(dev_type, torch.arange(pp), mesh_dim_names=("pp",))
        if dist.get_rank() < pp:
            rng = np.random.default_rng(2)
            d = 16
            w = torch.as_tensor(rng.normal(size=(pp, d, d)).astype(np.float32) * 0.3, device=dev)
            b = torch.as_tensor(rng.normal(size=(pp, d)).astype(np.float32) * 0.1, device=dev)
            micro = torch.as_tensor(rng.normal(size=(2 * pp, d)).astype(np.float32), device=dev)

            def stage_fn(layer, x):
                return torch.tanh(x @ layer["w"] + layer["b"])

            r = dist.get_rank()
            pipe_out = make_pipeline(stage_fn, pp_mesh, axis="pp")(
                {"w": w[r : r + 1], "b": b[r : r + 1]}, micro[2 * r : 2 * r + 2])
            ref = sequential_reference(stage_fn, {"w": w, "b": b}, micro)[2 * r : 2 * r + 2]
            _close(pipe_out.cpu().numpy(), ref.cpu().numpy(), "pipeline vs sequential", 1e-5, 1e-5)
    pipe_note = f" + pp={pp} pipe" if pp >= 2 else ""
    return {
        "summary": (
            f"dryrun_multichip ok: hybrid mesh dp={mesh_cfg.dp} tp={mesh_cfg.tp} "
            f"sp={mesh_cfg.sp} (slices={n_slices}) + ep mesh dp={ep_cfg_mesh.dp} "
            f"tp={ep_cfg_mesh.tp} ep={ep_cfg_mesh.ep}{pipe_note}, "
            f"graphsage[16k-edge,h128] loss={gs_loss:.4f}, "
            f"experts loss={ex_loss:.4f}, halo ok, ring-attention ok"
        ),
        "graphsage_loss": gs_loss,
        "experts_loss": ex_loss,
    }


def dryrun_multichip(world_size: int, device="cuda") -> str:
    """Every leg on ``world_size`` spawned ranks; returns (and prints)
    rank 0's summary line. Raises if a leg disagrees with its
    single-device computation."""
    results = spawn(_legs, world_size, (world_size,), device=device, timeout_s=900.0)
    line = results[0]["summary"]
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m alaz_tpu_torch.parallel.dryrun", description=__doc__.split("\n")[0])
    ap.add_argument("world_size", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.world_size, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
