"""The port's copies of the window builder's renumbering pass and its
locality gauges against the JAX package's originals, bit for bit."""

from __future__ import annotations

import numpy as np
import pytest

from alaz_tpu.graph import builder as jb
from alaz_tpu.ops import constants as jconst
from alaz_tpu_torch.graph import builder as tb
from alaz_tpu_torch.graph import features
from alaz_tpu_torch.ops import constants as tconst


def _edges(seed: int, n: int = 600, e: int = 3000, community: bool = True):
    """Pods calling services; with ``community`` 90% of a pod's calls go
    to its own team's two services."""
    rng = np.random.default_rng(seed)
    n_svcs = n // 10
    src = rng.integers(0, n - n_svcs, e)
    if community:
        team = src % (n_svcs // 2)
        own = n - n_svcs + 2 * team + rng.integers(0, 2, e)
        dst = np.where(rng.random(e) < 0.9, own, rng.integers(n - n_svcs, n, e))
    else:
        dst = rng.integers(n - n_svcs, n, e)
    perm = rng.permutation(n)  # no accidental locality in the ids
    return perm[src].astype(np.int32), perm[dst].astype(np.int32), n


def test_constants_match():
    assert (tconst.TILE_E, tconst.BAND_WINDOWS, tconst.DMA_WINDOW) == (
        jconst.TILE_E, jconst.BAND_WINDOWS, jconst.DMA_WINDOW,
    )
    assert features.apply_renumber is tb.apply_renumber


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cluster_renumber_matches(seed, weighted):
    src, dst, n = _edges(seed, community=seed % 2 == 0)
    w = np.random.default_rng(seed).integers(1, 50, src.shape[0]).astype(np.float32) if weighted else None
    a = tb.cluster_renumber(src, dst, n, w)
    b = jb.cluster_renumber(src, dst, n, w)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.sort(a), np.arange(n))  # a permutation


def test_cluster_renumber_empty_matches():
    empty = np.zeros(0, np.int32)
    np.testing.assert_array_equal(tb.cluster_renumber(empty, empty, 7), jb.cluster_renumber(empty, empty, 7))


@pytest.mark.parametrize("renumbered", [False, True])
@pytest.mark.parametrize("e", [0, 1, 777, 4096])
def test_locality_gauges_match(e, renumbered):
    src, dst, n = _edges(e, e=max(e, 1))
    src, dst = src[:e], dst[:e]
    if renumbered and e:
        perm = tb.cluster_renumber(src, dst, n)
        src, dst = tb.apply_renumber(perm, src, dst)
    order = np.argsort(dst, kind="stable")  # windows are dst-sorted
    src = src[order]
    assert tb.src_locality_gauges(src, n) == jb.src_locality_gauges(src, n)
    assert tb.src_locality_gauges(src, n, tile=128, window=64, band=2) == jb.src_locality_gauges(
        src, n, tile=128, window=64, band=2
    )
    assert tb.src_band_windows(src) == jb.src_band_windows(src)
    assert tb.src_straggler_fraction(src, n) == jb.src_straggler_fraction(src, n)


def test_renumber_narrows_the_src_band():
    """The point of the pass: on a community map it halves the share of a
    dst-sorted chunk's src ids that fall outside the band around its
    median window (the [min, max] span narrows less: one stray per chunk
    widens it)."""
    src, dst, n = _edges(5, n=4000, e=40000)
    order = np.argsort(dst, kind="stable")
    before = tb.src_locality_gauges(src[order], n)
    s2, d2 = tb.apply_renumber(tb.cluster_renumber(src, dst, n), src, dst)
    order = np.argsort(d2, kind="stable")
    after = tb.src_locality_gauges(s2[order], n)
    assert after[0] < before[0] and after[1] < before[1] / 2


def test_apply_renumber_matches():
    src, dst, n = _edges(9)
    perm = np.random.default_rng(9).permutation(n).astype(np.int32)
    feats = np.random.default_rng(10).normal(size=(n, 3)).astype(np.float32)
    kinds = np.arange(n, dtype=np.int32) % 3
    for a, b in zip(tb.apply_renumber(perm, src, dst, feats, kinds), jb.apply_renumber(perm, src, dst, feats, kinds)):
        np.testing.assert_array_equal(a, b)
