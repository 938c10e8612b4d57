"""The port's checkpoints: a round trip of params, optimizer state, step
and TGN memory; the schema and feature-contract refusals with the JAX
package's messages; ``max_to_keep``. The format is the port's own (one
directory per step, ``torch.save`` of state dicts); the feature contract
is held equal to the JAX package's for the same config."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from alaz_tpu.config import ModelConfig as JaxConfig
from alaz_tpu.train import checkpoint as jcheckpoint
from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.models import registry, tgn
from alaz_tpu_torch.replay.synth import example_batch
from alaz_tpu_torch.train import checkpoint, trainstep

WINDOW = dict(n_pods=180, n_svcs=20, n_edges=1000, seed=1)


def _trained(cfg: ModelConfig, steps: int = 2):
    batch = example_batch(**WINDOW)
    batch.edge_label[: batch.n_edges] = (batch.edge_feats[: batch.n_edges, 0] > 1.0).astype(np.float32)
    params = registry.init_params(cfg, key=0, device="cpu")
    opt = trainstep._adamw(params, 3e-3)
    step = trainstep.make_train_step(cfg, device="cpu")
    for _ in range(steps):
        step(params, opt, batch.device_arrays(), batch.edge_label)
    return batch, params, opt, step


def test_round_trip_resumes_training_bit_for_bit(tmp_path):
    """Params, AdamW's moments and step counts, the step and the TGN memory
    come back equal, and a restored run takes the same next step as the
    run that never stopped."""
    cfg = ModelConfig(model="tgn", hidden_dim=16, dtype="float32")
    batch, params, opt, step = _trained(cfg)
    memory = torch.randn(300, 16)
    contract = checkpoint.feature_contract(cfg)
    checkpoint.save(tmp_path, 2, params, opt, memory=memory, contract=contract)
    got_step, state = checkpoint.restore(tmp_path, expect_contract=contract)
    assert got_step == 2 and checkpoint.latest_step(tmp_path) == 2
    assert set(state) == {"params", "opt_state", "memory"}
    assert torch.equal(state["memory"], memory)
    for k, v in params.state_dict().items():
        assert torch.equal(state["params"][k], v), k

    params2 = tgn.init(1, cfg, device="cpu")
    params2.load_state_dict(state["params"])
    opt2 = trainstep._adamw(params2, 3e-3)
    opt2.load_state_dict(state["opt_state"])
    assert opt2.state_dict()["state"][0]["step"] == 2
    step(params, opt, batch.device_arrays(), batch.edge_label)
    step(params2, opt2, batch.device_arrays(), batch.edge_label)
    for (k, a), b in zip(params.state_dict().items(), params2.state_dict().values()):
        assert torch.equal(a, b), k


def test_schema_refusal(tmp_path):
    cfg = ModelConfig(hidden_dim=8)
    params = registry.init_params(cfg, key=0, device="cpu")
    checkpoint.save(tmp_path, 1, params)
    path = tmp_path / "1" / checkpoint.STATE_FILE
    state = torch.load(path, weights_only=True)
    state["schema_version"] = 2
    torch.save(state, path)
    with pytest.raises(ValueError, match=r"schema v2, this build needs v3"):
        checkpoint.restore(tmp_path)


def test_contract_refusal(tmp_path):
    cfg = ModelConfig(hidden_dim=8)
    params = registry.init_params(cfg, key=0, device="cpu")
    checkpoint.save(tmp_path, 1, params, contract=checkpoint.feature_contract(cfg))
    other = ModelConfig(hidden_dim=8, edge_feat_znorm=False)
    with pytest.raises(ValueError, match="feature contract"):
        checkpoint.restore(tmp_path, expect_contract=checkpoint.feature_contract(other))
    step, _ = checkpoint.restore(tmp_path, expect_contract=checkpoint.feature_contract(cfg))
    assert step == 1


def test_max_to_keep_and_missing(tmp_path):
    params = registry.init_params(ModelConfig(hidden_dim=8), key=0, device="cpu")
    assert checkpoint.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        checkpoint.restore(tmp_path / "none")
    for s in (1, 5, 3, 7, 9):
        checkpoint.save(tmp_path, s, params, max_to_keep=3)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["5", "7", "9"]
    assert checkpoint.latest_step(tmp_path) == 9
    assert checkpoint.restore(tmp_path, step=5)[0] == 5
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(tmp_path, step=1)


@pytest.mark.parametrize("model", ["graphsage", "gat", "experts", "tgn"])
def test_feature_contract_matches_reference(model):
    for znorm in (True, False):
        kw = dict(model=model, hidden_dim=64, num_layers=3, edge_feat_znorm=znorm)
        assert checkpoint.feature_contract(ModelConfig(**kw)) == jcheckpoint.feature_contract(JaxConfig(**kw))
    assert checkpoint.SCHEMA_VERSION == jcheckpoint.SCHEMA_VERSION
