"""Synthetic fleet windows from a seed: a frozen copy of the port's
``replay/synth.py example_batch`` (with the port's ``cluster_renumber``
and ``apply_renumber``), kept here so that a change to
the program cannot change the traffic it is measured on.

A window is raw numpy arrays in the order they were drawn; the harness
hands them to the program, which pads and sorts them itself, and to the
reference, which works from these arrays alone.
"""

from __future__ import annotations

import numpy as np

NODE_FEATURE_DIM = 32
EDGE_FEATURE_DIM = 16


def cluster_renumber(edge_src: np.ndarray, edge_dst: np.ndarray, n_nodes: int) -> np.ndarray:
    """``perm[old_id] = new_id`` placing the sources of one destination in
    one contiguous id range: per node, ordered by (its modal destination,
    out-degree descending, old id); nodes with no out-edge last."""
    if edge_src.shape[0] == 0:
        return np.arange(n_nodes, dtype=np.int32)
    pair_key = edge_src.astype(np.int64) * np.int64(n_nodes) + edge_dst.astype(np.int64)
    uniq_pairs, inverse = np.unique(pair_key, return_inverse=True)
    pair_counts = np.bincount(inverse, minlength=uniq_pairs.shape[0])
    pair_src = (uniq_pairs // n_nodes).astype(np.int64)
    pair_dst = (uniq_pairs % n_nodes).astype(np.int64)
    order = np.lexsort((pair_counts, pair_src))
    boundaries = np.flatnonzero(np.diff(pair_src[order], append=-1))
    top_dst = np.full(n_nodes, np.int64(n_nodes), dtype=np.int64)
    out_deg = np.bincount(edge_src, minlength=n_nodes).astype(np.float64)
    top_dst[pair_src[order][boundaries]] = pair_dst[order][boundaries]
    new_order = np.lexsort((np.arange(n_nodes), -out_deg, top_dst))
    perm = np.empty(n_nodes, dtype=np.int32)
    perm[new_order] = np.arange(n_nodes, dtype=np.int32)
    return perm


def apply_renumber(perm: np.ndarray, edge_src: np.ndarray, edge_dst: np.ndarray, *node_arrays):
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return (perm[edge_src], perm[edge_dst]) + tuple(a[inv] for a in node_arrays)


def make_window(
    seed,
    n_pods: int,
    n_svcs: int,
    n_edges: int,
    structure: str = "uniform",
    layout: str = "random",
    label_rate: float = 0.0,
) -> dict:
    """One window: pods call services. ``structure`` "uniform" draws src
    and dst independently; "community" gives ~20 pods and 2 services a
    team, a pod calling its own team's services with p = 0.9, ids
    shuffled. ``layout`` "clustered" renumbers the nodes as above.
    ``label_rate``: the share of edges labelled anomalous (a Bernoulli draw
    an edge, after the window's other draws)."""
    if layout not in ("random", "clustered"):
        raise ValueError(f"layout={layout!r}: expected 'random' or 'clustered'")
    if structure not in ("uniform", "community"):
        raise ValueError(f"structure={structure!r}: expected 'uniform' or 'community'")
    rng = np.random.default_rng(seed)
    n_nodes = n_pods + n_svcs
    node_feats = rng.normal(size=(n_nodes, NODE_FEATURE_DIM)).astype(np.float32)
    node_type = np.where(np.arange(n_nodes) < n_pods, 1, 2).astype(np.int32)
    if structure == "community":
        n_teams = max(1, n_svcs // 2)
        pod_team = rng.integers(0, n_teams, n_pods)
        svc_team = np.arange(n_svcs) % n_teams
        edge_src = rng.integers(0, n_pods, n_edges).astype(np.int32)
        own = rng.random(n_edges) < 0.9
        team_sizes = np.bincount(svc_team, minlength=n_teams)
        # members[t, j]: the j-th service of team t (services are dealt
        # round robin, so service s is member s // n_teams of team s % n_teams)
        members = np.zeros((n_teams, int(team_sizes.max())), dtype=np.int64)
        svcs = np.arange(n_svcs)
        members[svc_team, svcs // n_teams] = svcs
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
    label = (rng.random(n_edges) < label_rate).astype(np.float32) if label_rate > 0 else None
    return {
        "node_feats": node_feats,
        "node_type": node_type,
        "edge_src": edge_src.astype(np.int32),
        "edge_dst": edge_dst.astype(np.int32),
        "edge_type": edge_type,
        "edge_feats": edge_feats,
        "edge_label": label,
    }


def window_seed(seed: int, index: int) -> np.random.SeedSequence:
    """The seed of the run's ``index``-th distinct window."""
    return np.random.SeedSequence([int(seed), int(index)])


def dst_order(edge_dst: np.ndarray) -> np.ndarray:
    """The edges in stable dst order: the order the program scores them in."""
    return np.argsort(edge_dst, kind="stable")


def handoff_column(seed: int, index: int, n_nodes: int) -> np.ndarray:
    """The last node-feature column of the run's ``index``-th hand-off: each
    hand-off of a window carries features of its own in that column, as
    each close of a real window writes its feature rows anew."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 104_729, int(index)]))
    return rng.standard_normal(n_nodes, dtype=np.float32)
