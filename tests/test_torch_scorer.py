"""The port's scoring entry points against the JAX package's, on the CPU.

Scores are ``sigmoid(edge_logits[:n_edges])``. The JAX oracle is its
``score_batch`` under the default bf16 config with its kernels in
interpret mode; the sigmoid's slope is at most 1/4, so the logit bound
of test_torch_graphsage (four bf16 ulps of the largest logit, 2^-6 of
it) bounds the scores by a quarter of that.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from alaz_tpu.config import ModelConfig as JaxConfig
from alaz_tpu.models import graphsage as jsage
from alaz_tpu.train import trainstep as jtrain
from alaz_tpu_torch import convert
from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.models import graphsage
from alaz_tpu_torch.models.registry import init_params
from alaz_tpu_torch.runtime.scorer import WindowScorer
from alaz_tpu_torch.train.trainstep import make_score_fn, score_batch

HIDDEN = 32


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig(hidden_dim=HIDDEN, use_pallas="interpret")
    jparams = jsage.init(jax.random.PRNGKey(1), jcfg)
    cfg = ModelConfig(hidden_dim=HIDDEN)
    model = graphsage.GraphSAGE(cfg)
    model.load_state_dict(convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    batches = [jax_entry._example_batch(n_pods=180, n_svcs=20, n_edges=900 + 50 * s, seed=s) for s in range(2)]
    refs = []
    for b in batches:
        logits = jtrain.score_batch(jcfg, jparams, b)["edge_logits"][: b.n_edges]
        refs.append(1.0 / (1.0 + np.exp(-logits.astype(np.float32))))
    return cfg, model, batches, refs


def _assert_scores_close(got, ref, logit_scale):
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.isfinite(got).all() and ((got >= 0) & (got <= 1)).all()
    assert np.abs(got - ref).max() <= 0.25 * 2.0**-6 * logit_scale


def _logit_scale(ref):
    return np.abs(np.log(ref) - np.log1p(-ref)).max()


def test_score_batch_matches_jax(setup):
    cfg, model, batches, refs = setup
    for b, ref in zip(batches, refs):
        out = score_batch(cfg, model, b, device="cpu")
        assert set(out) == {"node_h", "edge_logits", "node_logits"}
        scores = 1.0 / (1.0 + np.exp(-out["edge_logits"][: b.n_edges]))
        _assert_scores_close(scores, ref, _logit_scale(ref))


def test_window_scorer_matches_jax(setup):
    cfg, model, batches, refs = setup
    scorer = WindowScorer(cfg, model, device="cpu")
    got = scorer.score_windows(batches)
    for g, ref in zip(got, refs):
        _assert_scores_close(g, ref, _logit_scale(ref))
    assert scorer.scored_batches == 2
    assert scorer.scored_edges == sum(b.n_edges for b in batches)
    # scoring is deterministic window to window
    np.testing.assert_array_equal(scorer.score(batches[0]), got[0])


def test_make_score_fn_takes_numpy_or_tensors(setup):
    cfg, model, batches, _ = setup
    fn = make_score_fn(cfg, device="cpu")
    arrays = batches[0].device_arrays()
    a = fn(model, arrays)
    b = fn(model, convert.graph_to_torch(arrays, "cpu"))
    assert torch.equal(a["edge_logits"], b["edge_logits"])
    assert not a["edge_logits"].requires_grad


def test_entry_points_without_card_raise(setup, monkeypatch):
    """With no device named, every entry point runs on cuda, and with no
    card it raises rather than running on the CPU."""
    cfg, model, batches, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: init_params(cfg),
        lambda: graphsage.init(0, cfg),
        lambda: make_score_fn(cfg),
        lambda: score_batch(cfg, model, batches[0]),
        lambda: WindowScorer(cfg, model),
        lambda: convert.graph_to_torch(batches[0].device_arrays()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
