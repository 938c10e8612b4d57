"""The train step's feed on the CPU: ``runtime/pipeline.py PinnedSets`` (the
page-locked double buffer under the train step and ``DevicePrefetcher``)
and ``train/trainstep.py _Feed``.

Page-locked memory needs a card, so the sets here are plain host buffers
(``pin=False``); their fill, their turns and the waits on each set's last
copies are the same code. The feed's routing is held on the ``meta``
device, which stands for a card's: host arrays are staged through the
sets, tensors already on the device pass through. The card tests
(``tests/test_torch_cuda.py``) hold the page-locked path itself.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.models.registry import init_params
from alaz_tpu_torch.obs.spans import SpanTracer
from alaz_tpu_torch.replay.synth import example_batch
from alaz_tpu_torch.runtime import pipeline
from alaz_tpu_torch.runtime.pipeline import PinnedSets, split_rows
from alaz_tpu_torch.train import trainstep


class StandInEvent:
    """A copy's event: records each ``synchronize`` and calls ``on_wait``
    there (before the set it guards is refilled)."""

    def __init__(self, on_wait=None):
        self.waits = 0
        self.on_wait = on_wait

    def synchronize(self):
        self.waits += 1
        if self.on_wait is not None:
            self.on_wait()


@pytest.fixture
def one_thread():
    """One intra-op thread: the CPU's reductions split across threads sum
    in an order that varies from run to run, and two steps compared bit
    for bit need one order."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(params=[3, 4, 7, 24])
def threads(request, monkeypatch):
    """The fill split among 3, 4, 7 and 24 threads (more than the cores),
    the interpreter switching threads every 10 µs: none divides the rows
    of the arrays below evenly."""
    monkeypatch.setattr(pipeline, "fill_threads", lambda: request.param)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield request.param
    finally:
        sys.setswitchinterval(interval)


def _array(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int64).astype(dtype)
    a = rng.standard_normal(shape).astype(dtype)
    a.flat[:4] = [np.nan, np.inf, -0.0, np.finfo(dtype).tiny / 2]  # every bit kept
    return a


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_], ids=["f32", "int32", "bool"])
@pytest.mark.parametrize("shape", [(1,), (7, 3), (100_003,), (65_537, 16), (131_071, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fill_is_bit_equal_to_copyto(threads, dtype, shape):
    a = _array(dtype, shape, seed=len(shape) * 100_003 + shape[0])
    ref = np.empty_like(a)
    np.copyto(ref, a)
    sets = PinnedSets(pin=False)
    _, bufs = sets.fill({"x": a, "t": torch.from_numpy(a)})
    for b in bufs.values():
        assert b.dtype == torch.from_numpy(a).dtype and tuple(b.shape) == a.shape
        assert b.numpy().tobytes() == ref.tobytes()


def test_fill_takes_the_window_and_its_label_bit_for_bit(threads):
    """A window's own arrays (every dtype it carries) and its f32 label,
    a strided CPU tensor and a bf16 one (numpy has no bf16), each copied
    whole."""
    b = example_batch(n_pods=900, n_svcs=100, n_edges=30_001, seed=4)
    arrays = dict(b.device_arrays(), edge_label=b.edge_label)
    assert {a.dtype for a in arrays.values()} == {np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.bool_)}
    arrays["cols"] = torch.from_numpy(b.edge_feats)[:, ::3]
    arrays["bf16"] = torch.from_numpy(b.edge_feats).bfloat16()
    _, bufs = PinnedSets(pin=False).fill(arrays)
    for k, a in arrays.items():
        ref = torch.as_tensor(a)
        assert bufs[k].dtype == ref.dtype and bufs[k].is_contiguous(), k
        assert torch.equal(bufs[k].view(torch.uint8), ref.contiguous().view(torch.uint8)), k


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8])
def test_split_rows_covers_every_row_once_in_parts_of_equal_bytes(n):
    """Each destination element is counted once per part that covers it:
    every count ends at 1. The parts' bytes differ by at most a row."""
    shapes = [(131_071, 32), (100_003,), (5,), (0, 4), (), (65_537, 16)]
    pairs = [(np.zeros(shape, np.int32), np.zeros(shape, np.int32)) for shape in shapes]
    parts = split_rows(pairs, n)
    assert len(parts) == n
    for part in parts:
        for d, _ in part:
            d += 1
    assert all((d == 1).all() for d, _ in pairs)
    sizes = [sum(s.nbytes for _, s in part) for part in parts]
    assert sum(sizes) == sum(s.nbytes for _, s in pairs)
    assert max(sizes) - min(sizes) <= 2 * 32 * 4


def test_sets_take_turns_and_refill_only_after_the_last_copies():
    sets = PinnedSets(pin=False)
    wins = [{"x": np.full((5, 2), i, np.float32), "m": np.arange(5) % (i + 2) == 0} for i in range(4)]
    slot0, bufs0 = sets.fill(wins[0])
    held = {k: v.clone() for k, v in bufs0.items()}
    seen = []
    e0 = StandInEvent(on_wait=lambda: seen.append(all(torch.equal(bufs0[k], held[k]) for k in held)))
    sets.copied(slot0, e0)
    slot1, bufs1 = sets.fill(wins[1])
    e1 = StandInEvent()
    sets.copied(slot1, e1)
    assert (slot0, slot1) == (0, 1) and e0.waits == 0 and e1.waits == 0
    slot2, bufs2 = sets.fill(wins[2])  # set 0 again: waits on its copies first
    assert slot2 == 0 and e0.waits == 1 and e1.waits == 0
    assert seen == [True]  # the set still held window 0 while it waited
    assert all(bufs2[k].data_ptr() == bufs0[k].data_ptr() for k in bufs0)  # the same buffers, refilled
    assert torch.equal(bufs2["x"], torch.full((5, 2), 2.0))
    slot3, _ = sets.fill(wins[3])  # set 1: its event, waited on once
    assert slot3 == 1 and e1.waits == 1
    slot4, _ = sets.fill(wins[0])  # set 0 had no copies since its wait
    assert slot4 == 0 and e0.waits == 1


def test_a_set_makes_a_buffer_anew_when_shape_or_dtype_change():
    sets = PinnedSets(pin=False)
    _, a = sets.fill({"x": np.zeros(4, np.float32)})
    sets.fill({"x": np.zeros(4, np.float32)})
    _, b = sets.fill({"x": np.zeros(4, np.float32)})
    assert b["x"].data_ptr() == a["x"].data_ptr()
    sets.fill({})
    _, c = sets.fill({"x": np.zeros(5, np.float32)})
    assert tuple(c["x"].shape) == (5,) and c["x"].data_ptr() != a["x"].data_ptr()
    sets.fill({})
    _, d = sets.fill({"x": np.zeros(5, np.int32)})
    assert d["x"].dtype == torch.int32
    assert list(d) == ["x"]


def test_stacked_fill_is_bit_equal_to_np_stack(threads):
    """W windows' arrays of one shape for a name, stacked into one
    ``[W, ...]`` buffer beside a plain array, split over the threads: the
    buffer is ``np.stack`` of them bit for bit."""
    shape = (65_537, 16)
    wins = [_array(np.float32, shape, seed=w) for w in range(3)]
    masks = [_array(np.bool_, shape[:1], seed=10 + w) for w in range(3)]
    one = _array(np.int32, (100_003,), seed=20)
    _, bufs = PinnedSets(pin=False).fill({"x": wins, "m": masks, "one": one})
    assert tuple(bufs["x"].shape) == (3, *shape) and tuple(bufs["m"].shape) == (3, shape[0])
    assert bufs["x"].numpy().tobytes() == np.stack(wins).tobytes()
    assert bufs["m"].numpy().tobytes() == np.stack(masks).tobytes()
    assert bufs["one"].numpy().tobytes() == one.tobytes()


def test_each_signature_keeps_its_own_pair():
    """Two signatures filled in turns (a window, and a stack of two):
    each takes turns on its own pair, and a signature's third fill goes
    into its first fill's buffers."""
    sets = PinnedSets(pin=False)
    a = {"x": np.zeros((6, 2), np.float32)}
    b = {"x": [np.ones((6, 2), np.float32)] * 2}
    fills = [sets.fill(arrays) for arrays in (a, b, a, b, a, b)]
    slots = [slot for slot, _ in fills]
    assert slots[0::2] == [0, 1, 0] and slots[1::2] == [2, 3, 2]
    ptr = [bufs["x"].data_ptr() for _, bufs in fills]
    assert ptr[4] == ptr[0] != ptr[2] and ptr[5] == ptr[1] != ptr[3]
    assert len(set(ptr)) == 4
    assert (sets.fills, sets.reuses) == (6, 2)
    assert torch.equal(fills[4][1]["x"], torch.zeros(6, 2)) and torch.equal(fills[5][1]["x"], torch.ones(2, 6, 2))


def test_a_set_is_refilled_only_after_its_own_event():
    """Each set waits on its own last copies' event, and only on that, before
    it is refilled: the set still holds its window while it waits."""
    sets = PinnedSets(pin=False)
    events = {}

    def fill_and_copy(arrays, name):
        slot, bufs = sets.fill(arrays)
        held = {k: v.clone() for k, v in bufs.items()}
        events[name] = StandInEvent(on_wait=lambda: seen.append(
            (name, all(torch.equal(bufs[k], held[k]) for k in held))))
        sets.copied(slot, events[name])

    seen = []
    fill_and_copy({"x": np.full(4, 1.0, np.float32)}, "a1")
    fill_and_copy({"x": [np.full(4, 2.0, np.float32)] * 2}, "b1")
    fill_and_copy({"x": np.full(4, 3.0, np.float32)}, "a2")
    assert seen == [] and all(e.waits == 0 for e in events.values())
    fill_and_copy({"x": np.full(4, 4.0, np.float32)}, "a3")  # a1's set
    assert seen == [("a1", True)]
    assert [events[k].waits for k in ("a1", "b1", "a2")] == [1, 0, 0]
    fill_and_copy({"x": [np.full(4, 5.0, np.float32)] * 2}, "b2")  # b's other set: nothing to wait on
    assert events["b1"].waits == 0
    fill_and_copy({"x": [np.full(4, 6.0, np.float32)] * 2}, "b3")  # b1's set
    assert seen == [("a1", True), ("b1", True)] and events["b1"].waits == 1


def test_feed_stages_host_arrays_and_passes_device_tensors():
    """On a device other than the CPU (``meta`` stands for a card): numpy
    arrays and CPU tensors go through the sets, one event after their
    copies; a tensor on the device passes through as it is."""
    events = []
    sets = PinnedSets(pin=False)
    feed = trainstep._Feed(torch.device("meta"), SpanTracer(), sets=sets,
                           event=lambda: events.append(StandInEvent()) or events[-1])
    on_dev = torch.empty(6, 2, device="meta")
    inputs = {"a": np.ones((6, 2), np.float32), "b": torch.arange(6, dtype=torch.int32), "c": on_dev,
              "m": np.ones(6, bool)}
    out = feed(inputs)
    assert set(out) == set(inputs) and out["c"] is on_dev
    for k in ("a", "b", "m"):
        assert out[k].device.type == "meta" and tuple(out[k].shape) == tuple(np.shape(inputs[k]))
        assert out[k].dtype == torch.as_tensor(inputs[k]).dtype
    assert feed.counts == {"staged": 3, "passed": 1} and len(events) == 1
    feed({"c": on_dev})  # nothing on the host: no fill, no event
    assert feed.counts == {"staged": 3, "passed": 2} and len(events) == 1
    feed(inputs)
    feed(inputs)  # the first set again: its event waited on
    assert [e.waits for e in events] == [1, 0, 0]


def _feeds(n=3, seed=5):
    out = []
    for i in range(n):
        b = example_batch(n_pods=300, n_svcs=40, n_edges=1500, seed=seed + i)
        label = np.zeros(b.e_pad, np.float32)
        label[: b.n_edges] = b.edge_feats[: b.n_edges, 0] > 1.0
        out.append((b.device_arrays(), label))
    return out


def _ranges(prof) -> dict:
    got: dict = {}
    for e in prof.events():
        if e.name.startswith("alaz."):
            got.setdefault(e.name[5:], []).append((e.time_range.start, e.time_range.end, e.thread))
    return got


def test_step_on_the_cpu_passes_its_arrays_through():
    cfg = ModelConfig(dtype="float32", hidden_dim=32)
    step = trainstep.make_train_step(cfg, 10.0, "cpu")
    params = init_params(cfg, key=3, device="cpu")
    opt = trainstep._adamw(params, 3e-3)
    for graph, label in _feeds(2):
        step(params, opt, graph, label)
    assert step.feed_counts == {"staged": 0, "passed": 2 * 10}
    assert step.tracer.hists["fill"].snapshot()["count"] == 0


def test_step_spans_fill_under_feed_and_staging_keeps_its_losses(monkeypatch, one_thread):
    """With the feed staging (plain sets, stand-in events): every step's
    ``fill`` span lies inside its ``feed``, on the same thread; losses and
    params equal, bit for bit, a step that uses the arrays in place."""
    cfg = ModelConfig(dtype="float32", hidden_dim=32)
    feeds = _feeds(3)
    plain = trainstep.make_train_step(cfg, 10.0, "cpu")
    monkeypatch.setattr(trainstep, "_Feed", functools.partial(
        trainstep._Feed, sets=PinnedSets(pin=False), event=StandInEvent))
    tracer = SpanTracer()
    staged = trainstep.make_train_step(cfg, 10.0, "cpu", tracer=tracer)
    a, b = init_params(cfg, key=3, device="cpu"), init_params(cfg, key=3, device="cpu")
    opt_a, opt_b = trainstep._adamw(a, 3e-3), trainstep._adamw(b, 3e-3)
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=every_thread) as prof:
        losses = [staged(a, opt_a, g, lbl) for g, lbl in feeds]
    ref = [plain(b, opt_b, g, lbl) for g, lbl in feeds]
    assert all(torch.equal(x, y) for x, y in zip(losses, ref))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert staged.feed_counts == {"staged": 3 * 10, "passed": 0}
    assert tracer.hists["fill"].snapshot()["count"] == 3 and tracer.hists["feed"].snapshot()["count"] == 3
    got = _ranges(prof)
    fills, feeds_r = sorted(got["fill"]), sorted(got["feed"])
    assert len(fills) == len(feeds_r) == 3
    assert all(f[0] <= s[0] and s[1] <= f[1] and s[2] == f[2] for f, s in zip(feeds_r, fills))
