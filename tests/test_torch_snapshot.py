"""The PyTorch port's window batches against the JAX package's, bit for
bit: bucketing, block extents, GraphBatch fields, device arrays and the
synthetic windows must be identical for identical inputs."""

from __future__ import annotations

import numpy as np
import pytest

import __graft_entry__ as jax_entry
from alaz_tpu.graph import snapshot as jsnap
from alaz_tpu_torch.graph import snapshot as tsnap
from alaz_tpu_torch.replay.synth import example_batch


def _assert_batches_equal(a, b):
    for name in ("node_feats", "node_type", "node_mask", "edge_src", "edge_dst",
                 "edge_type", "edge_feats", "edge_mask", "edge_label"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.n_nodes, a.n_edges, a.bucket_key) == (b.n_nodes, b.n_edges, b.bucket_key)
    for layout in ("coo", "blocked"):
        da, db = a.device_arrays(layout), b.device_arrays(layout)
        assert da.keys() == db.keys()
        for k in da:
            assert da[k].dtype == db[k].dtype, k
            np.testing.assert_array_equal(da[k], db[k], err_msg=f"{layout}/{k}")
    assert a.blocked_edge_slots == b.blocked_edge_slots
    assert a.aggregated_rows() == b.aggregated_rows()


def test_pad_to_bucket_matches():
    for n in list(range(0, 3000, 7)) + [2**k + d for k in range(7, 22) for d in (-1, 0, 1)]:
        assert tsnap.pad_to_bucket(n) == jsnap.pad_to_bucket(n), n
    assert tsnap.EDGE_BLOCK_ROWS == jsnap.EDGE_BLOCK_ROWS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_block_starts_match(seed):
    rng = np.random.default_rng(seed)
    n_pad = 512
    n_edges = int(rng.integers(1, 2000))
    dst = np.sort(rng.integers(0, 400, 2048)).astype(np.int32)
    dst[n_edges:] = n_pad - 1
    a = tsnap.edge_block_starts_from(dst, n_edges, n_pad)
    b = jsnap.edge_block_starts_from(dst, n_edges, n_pad)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    assert a[-1] == n_edges
    assert tsnap.blocked_edge_slots_from(a) == jsnap.blocked_edge_slots_from(b)


@pytest.mark.parametrize("n,e", [(200, 1000), (130, 129), (5, 0)])
def test_graph_batch_build_matches(n, e):
    rng = np.random.default_rng(n + e)
    args = dict(
        node_feats=rng.normal(size=(n, 32)).astype(np.float32),
        node_type=rng.integers(0, 3, n).astype(np.int32),
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, n, e).astype(np.int32),
        edge_type=rng.integers(0, 9, e).astype(np.int32),
        edge_feats=rng.normal(size=(e, 16)).astype(np.float32),
        edge_label=(rng.random(e) < 0.1).astype(np.float32),
        node_uids=np.arange(n, dtype=np.int32) * 3,
        window_start_ms=1000,
        window_end_ms=2000,
    )
    a = tsnap.GraphBatch.build(**{k: (v.copy() if hasattr(v, "copy") else v) for k, v in args.items()})
    b = jsnap.GraphBatch.build(**args)
    _assert_batches_equal(a, b)
    np.testing.assert_array_equal(a.node_uids, b.node_uids)
    assert a.pad_edge_slots == b.pad_edge_slots
    assert a.edge_occupancy == b.edge_occupancy


def test_from_presorted_matches():
    n_pad, e_pad, n, e = 256, 1024, 200, 900

    def arrays():
        r = np.random.default_rng(7)
        return (
            r.normal(size=(n_pad, 32)).astype(np.float32),
            r.integers(0, 3, n_pad).astype(np.int32),
            r.integers(0, n, e_pad).astype(np.int32),
            np.sort(r.integers(0, n, e_pad)).astype(np.int32),
            r.integers(0, 9, e_pad).astype(np.int32),
            r.normal(size=(e_pad, 16)).astype(np.float32),
        )

    a = tsnap.GraphBatch.from_presorted(*arrays(), n, e)
    b = jsnap.GraphBatch.from_presorted(*arrays(), n, e)
    _assert_batches_equal(a, b)
    assert (a.edge_dst[e:] == n_pad - 1).all()


@pytest.mark.parametrize("layout", ["random", "clustered"])
@pytest.mark.parametrize("structure", ["uniform", "community"])
@pytest.mark.parametrize("seed", [0, 3])
def test_example_batch_matches(structure, seed, layout):
    kw = dict(n_pods=180, n_svcs=20, n_edges=1000, seed=seed, structure=structure, layout=layout)
    a = example_batch(**kw)
    b = jax_entry._example_batch(**kw)
    assert a.bucket_key == "n256xe1024"
    _assert_batches_equal(a, b)


def test_example_batch_rejects_unknown_layout_and_structure():
    with pytest.raises(ValueError, match="layout"):
        example_batch(n_pods=10, n_svcs=2, n_edges=20, layout="clustred")
    with pytest.raises(ValueError, match="structure"):
        example_batch(n_pods=10, n_svcs=2, n_edges=20, structure="communty")
