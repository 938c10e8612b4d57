"""The port's TGN against the JAX package's, on the CPU.

The JAX ``tgn.init`` params are carried across with
``convert.params_from_jax``; both packages step the same synthetic
windows (bucket 256x1024) with the same memory.

Tolerances:
- f32: rtol/atol 1e-4, the ROADMAP's oracle, on outputs, memory, the
  loss and every gradient.
- bf16 (the default config, JAX with its kernels in interpret mode):
  logits held to four bf16 ulps of the largest (2^-6·max|ref|), as the
  GraphSAGE encoder's. The memory is f32, but the GRU reads the node
  states in bf16, where the two frameworks may land an ulp apart (at
  |h| ≈ 8 an ulp is 2^-4), and that moves the gates; the memory then
  feeds the next window. It is held to the same four ulps of the largest
  node state (2^-6·max|node_h|).
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from alaz_tpu.config import ModelConfig as JaxConfig
from alaz_tpu.models import tgn as jtgn
from alaz_tpu.train.objective import edge_bce_loss as jax_edge_bce_loss
from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.convert import graph_to_torch, params_from_jax, params_to_numpy
from alaz_tpu_torch.models import registry, tgn
from alaz_tpu_torch.runtime.scorer import WindowScorer
from alaz_tpu_torch.train import trainstep
from test_torch_train import (
    assert_adamw_steps_match,
    assert_grads_match,
    jax_value_and_grad,
    labels_from_window,
    port_loss_and_grads,
)

SPEC = Path(__file__).resolve().parent.parent / "resources" / "specs" / "tgn_256x1024.json"


@pytest.fixture(scope="module")
def windows():
    return [jax_entry._example_batch(n_pods=180, n_svcs=20, n_edges=900 + 40 * s, seed=s) for s in range(3)]


def _params(jcfg: JaxConfig, seed: int = 0):
    jparams = jtgn.init(jax.random.PRNGKey(seed), jcfg)
    fields = {k: getattr(jcfg, k) for k in ModelConfig.__dataclass_fields__}
    cfg = ModelConfig(**{**fields, "use_pallas": bool(jcfg.use_pallas)})
    model = tgn.TGN(cfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)), strict=True)
    return jparams, model, cfg


def _jgraph(b):
    return {k: jnp.asarray(v) for k, v in b.device_arrays().items()}


def _close(got, ref, dtype, bound_of=None):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        bound = 2.0**-6 * np.abs(ref if bound_of is None else bound_of).max()
        assert np.abs(got - ref).max() <= bound, (np.abs(got - ref).max(), bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_over_three_windows_matches(windows, dtype):
    """Outputs and memory after each of three windows, from a memory of 128
    rows that the first window's 256-row bucket zero-extends."""
    jcfg = JaxConfig(model="tgn", hidden_dim=32, dtype=dtype, use_pallas="interpret" if dtype == "bfloat16" else False)
    jparams, model, cfg = _params(jcfg)
    jmem = jtgn.init_memory(jcfg, 128)
    mem = tgn.init_memory(cfg, 128, device="cpu")
    step = jax.jit(lambda p, g, m: jtgn.step(p, g, m, jcfg))
    for b in windows:
        jout, jmem = step(jparams, _jgraph(b), jmem)
        with torch.no_grad():
            out, mem = tgn.step(model, graph_to_torch(b.device_arrays(), "cpu"), mem, cfg)
        assert mem.shape == jmem.shape == (256, 32) and mem.dtype == torch.float32
        _close(out["edge_logits"][: b.n_edges].numpy(), np.asarray(jout["edge_logits"])[: b.n_edges], dtype)
        _close(out["node_logits"][: b.n_nodes].numpy(), np.asarray(jout["node_logits"])[: b.n_nodes], dtype)
        _close(mem.numpy(), np.asarray(jmem), dtype, bound_of=np.asarray(jout["node_h"], np.float32))


def test_memory_zero_extends_and_inactive_nodes_keep_theirs(windows):
    """A memory shorter than the bucket grows to it with zero rows; a
    longer one keeps its rows past the bucket; inactive (masked) nodes keep
    their memory bit for bit, active ones take the GRU update."""
    cfg = ModelConfig(model="tgn", hidden_dim=16, dtype="float32")
    model = tgn.init(0, cfg, device="cpu")
    b = windows[0]
    graph = graph_to_torch(b.device_arrays(), "cpu")
    with torch.no_grad():
        short = torch.randn(100, 16)
        _, grown = tgn.step(model, graph, short, cfg)
        assert grown.shape == (b.n_pad, 16)
        # the grown rows start from zero: the same as stepping the
        # explicitly zero-padded memory
        padded = torch.cat([short, torch.zeros(b.n_pad - 100, 16)])
        _, ref = tgn.step(model, graph, padded, cfg)
        assert torch.equal(grown, ref)
        long = torch.randn(1000, 16)
        _, out = tgn.step(model, graph, long, cfg)
    assert out.shape == (1000, 16)
    assert torch.equal(out[b.n_pad :], long[b.n_pad :])
    inactive = ~torch.from_numpy(b.node_mask)
    assert int(inactive.sum()) > 0
    assert torch.equal(out[: b.n_pad][inactive], long[: b.n_pad][inactive])
    assert not torch.equal(out[: b.n_nodes], long[: b.n_nodes])


def test_window_scorer_streams_like_the_reference_step_fn(windows):
    """``WindowScorer`` under ``model="tgn"`` owns the memory: presized to
    ``tgn_max_nodes`` (128 here), grown to the 256-row bucket by the first
    window, threaded window by window. Scores and the final memory against
    the reference's ``make_step_fn`` run over the same windows (bf16,
    interpret kernels); sigmoid's slope is at most 1/4, so scores are held
    at a quarter of the logit bound."""
    jcfg = JaxConfig(model="tgn", hidden_dim=32, use_pallas="interpret", tgn_max_nodes=128)
    jparams, model, cfg = _params(jcfg)
    jstep = jtgn.make_step_fn(jcfg)
    jmem = jtgn.init_memory(jcfg, jcfg.tgn_max_nodes)
    scorer = WindowScorer(cfg, model, device="cpu")
    assert scorer.memory.shape == (128, 32)
    for b in windows:
        jout, jmem = jstep(jparams, _jgraph(b), jmem)
        logits = np.asarray(jout["edge_logits"])[: b.n_edges]
        ref = 1.0 / (1.0 + np.exp(-logits))
        got = scorer.score(b)
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 0.25 * 2.0**-6 * np.abs(logits).max()
    assert scorer.memory.shape == (256, 32)
    _close(scorer.memory.numpy(), np.asarray(jmem), "bfloat16", bound_of=np.asarray(jout["node_h"], np.float32))
    assert scorer.scored_batches == 3


def test_apply_is_step_from_cold_memory(windows):
    cfg = ModelConfig(model="tgn", hidden_dim=16, dtype="float32")
    model = registry.init_params(cfg, key=0, device="cpu")
    assert isinstance(model, tgn.TGN)
    assert registry.get_model("tgn") == (tgn.init, tgn.apply)
    graph = graph_to_torch(windows[0].device_arrays(), "cpu")
    with torch.no_grad():
        a = tgn.apply(model, graph, cfg)
        s, _ = tgn.step(model, graph, torch.zeros(windows[0].n_pad, 16), cfg)
    for k in a:
        assert torch.equal(a[k], s[k]), k
    assert tgn.make_step_fn(cfg) is tgn.make_step_fn(ModelConfig(model="tgn", hidden_dim=16, dtype="float32"))


def test_init_convert_and_specfile():
    """The update gate's bias starts at -2 in the port's init and survives
    the carry from the reference's params and back; the param and output
    shapes are the reference's specfile's."""
    cfg = ModelConfig(model="tgn", hidden_dim=32)
    model = tgn.init(0, cfg, device="cpu")
    assert torch.equal(model.gru_z.b.detach(), torch.full((32,), -2.0))
    assert not model.gru_r.b.detach().any()
    tree = jax.tree_util.tree_map(np.asarray, jtgn.init(jax.random.PRNGKey(2), JaxConfig(model="tgn", hidden_dim=32)))
    back = params_to_numpy(_params(JaxConfig(model="tgn", hidden_dim=32), seed=2)[1])
    flat_a, struct_a = jax.tree_util.tree_flatten(tree)
    flat_b, struct_b = jax.tree_util.tree_flatten(back)
    assert struct_a == struct_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back["gru_z"]["b"], np.full(32, -2.0, np.float32))
    spec = json.loads(SPEC.read_text())
    cfg = ModelConfig(model="tgn")
    assert spec["config"] == {k: getattr(cfg, k) for k in spec["config"]}
    model = tgn.init(0, cfg, device="cpu")
    shapes = {k.replace(".", "/"): list(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: v["shape"] for k, v in spec["params"].items()}
    with torch.no_grad():
        out = tgn.apply(model, graph_to_torch(jax_entry._example_batch(n_pods=180, n_svcs=20, n_edges=1000, seed=1).device_arrays(), "cpu"), cfg)
    assert {k: list(v.shape) for k, v in out.items()} == {k: v["shape"] for k, v in spec["outputs"].items()}


def test_gradients_match(windows):
    """One memoryless step's loss and every gradient, f32, JAX with its
    kernels in interpret mode (the GRU's gradients are zero on both sides:
    the cold-start path drops the updated memory)."""
    b = windows[1]
    label = labels_from_window(b)
    jcfg = JaxConfig(model="tgn", hidden_dim=32, dtype="float32", use_pallas="interpret")
    np_params, ref_loss, ref_grads = jax_value_and_grad(jcfg, b, label)
    cfg = ModelConfig(model="tgn", hidden_dim=32, dtype="float32")
    _, loss, grads = port_loss_and_grads(np_params, cfg, b, label)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    assert_grads_match(grads, ref_grads)
    assert float(grads["gru_n.w"].abs().max()) == 0.0


def test_adamw_three_steps_match_optax(windows):
    assert_adamw_steps_match("tgn", windows[0])


def test_unrolled_epoch_matches(windows):
    """The loss and every gradient of one unrolled epoch over three
    windows (two sequences, to cover the average over sequences): the
    memory threads through every window, so the GRU gets gradient. The
    reference side is its unrolled objective (``train/trainstep.py
    _make_unrolled_step``), f32, on the plain paths of both packages (the
    kernels' gradients are held by test_gradients_match and
    test_torch_train)."""
    jcfg = JaxConfig(model="tgn", hidden_dim=32, dtype="float32", use_pallas=False, tgn_max_nodes=128)
    jparams, model, cfg = _params(jcfg)
    for b in windows:
        b.edge_label = labels_from_window(b)
    seqs = [windows, windows[1:]]

    def loss_fn(p):
        total = 0.0
        for seq in seqs:
            mem = jtgn.init_memory(jcfg, 256)
            seq_total = 0.0
            for b in seq:
                g = _jgraph(b)
                out, mem = jtgn.step(p, g, mem, jcfg)
                seq_total = seq_total + jax_edge_bce_loss(
                    out["edge_logits"], jnp.asarray(b.edge_label), g["edge_mask"].astype(jnp.float32), 10.0
                )
            total = total + seq_total / len(seq)
        return total / len(seqs)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    prepped = trainstep.prep_sequences(seqs, device="cpu")
    loss = trainstep.unrolled_loss(model, prepped, tgn.init_memory(cfg, 256, device="cpu"), cfg)
    trainstep.backward(model, loss)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    assert_grads_match({k: p.grad for k, p in model.named_parameters()},
                       params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads)))
    assert float(model.gru_n.w.grad.abs().max()) > 0


def test_train_tgn_unrolled_learns(windows):
    for b in windows:
        b.edge_label = labels_from_window(b)
    cfg = ModelConfig(model="tgn", hidden_dim=32, dtype="float32")
    state, losses = trainstep.train_tgn_unrolled(cfg, windows, epochs=8, device="cpu")
    assert state.step == 8 and losses[-1] < losses[0]
    assert all(np.isfinite(losses))
    state2, losses2 = trainstep.train_tgn_unrolled(cfg, [windows, windows[:2]], epochs=2, device="cpu")
    assert state2.step == 2 and np.isfinite(losses2).all()
    with pytest.raises(ValueError, match="no training windows"):
        trainstep.train_tgn_unrolled(cfg, [], device="cpu")
