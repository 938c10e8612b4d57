"""Synthetic service-map windows, drawn from a seed.

The same draws, in the same order, as the JAX package's
``__graft_entry__._example_batch``, so both packages score bit-identical
windows for one seed.
"""

from __future__ import annotations

import numpy as np

from alaz_tpu_torch.graph.builder import apply_renumber, cluster_renumber
from alaz_tpu_torch.graph.features import EDGE_FEATURE_DIM, NODE_FEATURE_DIM
from alaz_tpu_torch.graph.snapshot import GraphBatch


def example_batch(
    n_pods: int = 900,
    n_svcs: int = 100,
    n_edges: int = 4000,
    seed: int = 0,
    structure: str = "uniform",
    layout: str = "random",
) -> GraphBatch:
    """One synthetic window: pods call services.

    ``structure``: "uniform" draws src/dst independently; "community"
    mimics a real service map: pods belong to teams and call their own
    team's services ~90% of the time, and node ids are shuffled so the
    draw carries no accidental locality. ``layout``: "random" keeps ids
    as drawn; "clustered" applies ``graph/builder.py cluster_renumber``
    so sources that call the same destination take contiguous ids (the
    layout ``src_gather="banded"`` is meant for)."""
    if layout not in ("random", "clustered"):
        raise ValueError(f"layout={layout!r}: expected 'random' or 'clustered'")
    if structure not in ("uniform", "community"):
        raise ValueError(f"structure={structure!r}: expected 'uniform' or 'community'")
    rng = np.random.default_rng(seed)
    n_nodes = n_pods + n_svcs
    node_feats = rng.normal(size=(n_nodes, NODE_FEATURE_DIM)).astype(np.float32)
    node_type = np.where(np.arange(n_nodes) < n_pods, 1, 2).astype(np.int32)
    if structure == "community":
        # ~20 pods + 2 services per team; a pod calls its own team's
        # services with p=0.9, anyone else's otherwise
        n_teams = max(1, n_svcs // 2)
        pod_team = rng.integers(0, n_teams, n_pods)
        svc_team = np.arange(n_svcs) % n_teams
        edge_src = rng.integers(0, n_pods, n_edges).astype(np.int32)
        own = rng.random(n_edges) < 0.9
        # vectorized own-team pick: [n_teams, max_size] member matrix +
        # per-team size
        team_sizes = np.bincount(svc_team, minlength=n_teams)
        max_sz = int(team_sizes.max())
        members = np.zeros((n_teams, max_sz), dtype=np.int64)
        for t in range(n_teams):
            m = np.flatnonzero(svc_team == t)
            members[t, : m.shape[0]] = m
        t_of_edge = pod_team[edge_src]
        draw = rng.integers(0, 1 << 30, n_edges)
        pick_own = members[t_of_edge, draw % team_sizes[t_of_edge]]
        pick_any = rng.integers(0, n_svcs, n_edges)
        edge_dst = (n_pods + np.where(own, pick_own, pick_any)).astype(np.int32)
        shuffle = rng.permutation(n_nodes).astype(np.int32)
        edge_src, edge_dst, node_feats, node_type = apply_renumber(
            shuffle, edge_src, edge_dst, node_feats, node_type
        )
    else:
        edge_src = rng.integers(0, n_pods, n_edges).astype(np.int32)
        edge_dst = rng.integers(n_pods, n_nodes, n_edges).astype(np.int32)
    edge_type = rng.integers(1, 9, n_edges).astype(np.int32)
    edge_feats = rng.normal(size=(n_edges, EDGE_FEATURE_DIM)).astype(np.float32)
    if layout == "clustered":
        perm = cluster_renumber(edge_src, edge_dst, n_nodes)
        edge_src, edge_dst, node_feats, node_type = apply_renumber(
            perm, edge_src, edge_dst, node_feats, node_type
        )
    return GraphBatch.build(
        node_feats=node_feats,
        node_type=node_type,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_type=edge_type,
        edge_feats=edge_feats,
    )
