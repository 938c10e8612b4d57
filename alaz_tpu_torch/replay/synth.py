"""Synthetic service-map windows, drawn from a seed, and the host-ingest
trace of the JAX package's ``replay/synth.py make_ingest_trace`` (copied:
the chaos harness drives it).

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


def make_ingest_trace(
    n_rows: int,
    pods: int = 500,
    svcs: int = 50,
    outbound_ips: int = 200,
    paths: int = 64,
    windows: int = 8,
    seed: int = 0,
):
    """Synthetic L7 trace for the host-ingest microbench: V2 events with
    embedded addresses (pod sources; half service, half outbound
    destinations) and a bounded set of unique HTTP payloads.

    Returns (events, cluster_msgs): feed the msgs into a ClusterInfo and
    the events through Aggregator.process_l7. Every event attributes
    (all sources are known pods), so downstream row-conservation checks
    can equate pushed rows with emitted + ledgered rows.
    """
    import numpy as np

    from alaz_tpu_torch.events.k8s import EventType, K8sResourceMessage, Pod, ResourceType, Service
    from alaz_tpu_torch.events.net import ip_to_u32
    from alaz_tpu_torch.events.schema import HttpMethod, L7Protocol, make_l7_events

    rng = np.random.default_rng(seed)
    msgs = []
    pod_ips = np.empty(pods, dtype=np.uint32)
    for p in range(pods):
        ip = f"10.{(p >> 16) & 0xFF}.{(p >> 8) & 0xFF}.{p & 0xFF}"
        pod_ips[p] = ip_to_u32(ip)
        msgs.append(
            K8sResourceMessage(
                ResourceType.POD, EventType.ADD, Pod(uid=f"pod-{p}", name=f"p{p}", ip=ip)
            )
        )
    svc_ips = np.empty(svcs, dtype=np.uint32)
    for s in range(svcs):
        ip = f"10.96.{(s >> 8) & 0xFF}.{s & 0xFF}"
        svc_ips[s] = ip_to_u32(ip)
        msgs.append(
            K8sResourceMessage(
                ResourceType.SERVICE, EventType.ADD,
                Service(uid=f"svc-{s}", name=f"s{s}", cluster_ip=ip),
            )
        )
    # outbound destinations: third-party IPs the cluster tables don't know
    out_ips = (
        np.uint32(ip_to_u32("52.0.0.1")) + rng.permutation(1 << 16)[:outbound_ips].astype(np.uint32)
    )

    ev = make_l7_events(n_rows)
    ev["pid"] = rng.integers(1000, 1000 + pods, n_rows)
    ev["fd"] = rng.integers(3, 500, n_rows)
    # event time advances through `windows` one-second windows so window
    # closes interleave with ingest (the watermark path, not just flush)
    ev["write_time_ns"] = 1_000_000_000 + (
        np.arange(n_rows, dtype=np.uint64) * np.uint64(windows) * np.uint64(1_000_000_000)
    ) // np.uint64(max(n_rows, 1))
    ev["duration_ns"] = rng.integers(10_000, 5_000_000, n_rows)
    ev["protocol"] = L7Protocol.HTTP
    ev["method"] = HttpMethod.GET
    ev["status"] = np.where(rng.random(n_rows) < 0.05, 500, 200)
    ev["saddr"] = pod_ips[rng.integers(0, pods, n_rows)]
    ev["sport"] = rng.integers(1024, 65535, n_rows)
    # destination mix: ~half in-cluster services, ~half outbound (the
    # outbound half is what exercises the reverse-DNS intern path)
    is_out = rng.random(n_rows) < 0.5
    daddr = svc_ips[rng.integers(0, svcs, n_rows)]
    daddr[is_out] = out_ips[rng.integers(0, outbound_ips, int(is_out.sum()))]
    ev["daddr"] = daddr
    ev["dport"] = np.where(is_out, 443, 80)
    # bounded unique-payload set: the hashed-parse cache amortizes parsing,
    # so path enrichment is per-unique, as in production
    path_idx = rng.integers(0, paths, n_rows)
    for p in range(paths):
        payload = f"GET /api/v1/resource{p} HTTP/1.1\r\nHost: bench\r\n\r\n".encode()
        rows_p = np.flatnonzero(path_idx == p)
        buf = np.frombuffer(payload, dtype=np.uint8)
        ev["payload"][rows_p[:, None], np.arange(buf.shape[0])[None, :]] = buf
        ev["payload_size"][rows_p] = len(payload)
    return ev, msgs
