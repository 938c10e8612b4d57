"""The port's span helper (``obs/spans.py SpanTracer.span``) on the
scorer's loop, the hand-off and the train step, on the CPU; one test on
the card (marked ``cuda``) holds the score step's device clock.

The Service takes synthetic windows (``replay.synth.example_batch``,
one bucket) handed to its window close callback on the test thread
before it starts, so they wait as a backlog: the serial path scores
them one by one, ``score_batch_windows=4`` stacks them.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alaz_tpu_torch.config import ModelConfig, RuntimeConfig
from alaz_tpu_torch.convert import graph_to_torch
from alaz_tpu_torch.models.registry import init_params
from alaz_tpu_torch.obs import spans
from alaz_tpu_torch.obs.histogram import Histogram
from alaz_tpu_torch.obs.spans import PORT_STAGES, SPAN_STAGES, SpanTracer
from alaz_tpu_torch.replay.synth import example_batch
from alaz_tpu_torch.runtime import service as service_mod
from alaz_tpu_torch.runtime.service import Service
from alaz_tpu_torch.train import trainstep

# each stage opened inside another span, and that span's stage
SERIAL_PARENTS = {"dispatch": "score", "wait": "score", "plane": "record", "export": "record"}
# a stacked group's dispatch runs at staging, outside its score stage
GROUP_PARENTS = {"wait": "score", "plane": "record", "export": "record"}
SCORER_STAGES = ("take", "stage", "score", "dispatch", "wait", "record", "plane", "export")


def _windows(n: int, seed: int = 0) -> list:
    out = []
    for i in range(n):
        b = example_batch(n_pods=60, n_svcs=10, n_edges=300, seed=seed + i)
        b.window_start_ms = (i + 1) * 1_000
        b.node_uids = np.arange(b.node_feats.shape[0], dtype=np.int64)  # the sink's uids: node ids
        out.append(b)
    return out


def _service(batch_windows: int = 1, device: str = "cpu") -> Service:
    cfg = RuntimeConfig(model=ModelConfig(dtype="float32", hidden_dim=32), score_batch_windows=batch_windows)
    return Service(config=cfg, model_state=init_params(cfg.model, key=0, device=device),
                   score_sink=lambda sb: None, score_threshold=0.0, device=device)


def _run(svc: Service, windows: list) -> None:
    """Hand the windows over as a backlog, then score them all."""
    for b in windows:
        svc.graph_store.on_batch(b)
    svc.start()
    try:
        svc.drain(timeout_s=60)
    finally:
        svc.stop()
    assert svc.scored_batches == len(windows)


def _window_spans(svc: Service) -> dict:
    return {e["window_start_ms"]: e for e in svc.recorder.events() if e["kind"] == "window_span"}


def _hist_count(svc: Service, stage: str) -> int:
    return svc.metrics.histogram(f"latency.{stage}_s").snapshot()["count"]


@pytest.mark.parametrize("batch_windows,parents", [(1, SERIAL_PARENTS), (4, GROUP_PARENTS)],
                         ids=["serial", "group"])
def test_every_scored_window_carries_the_scorer_stages(batch_windows, parents):
    svc = _service(batch_windows)
    windows = _windows(6)
    _run(svc, windows)
    got = _window_spans(svc)
    assert sorted(got) == [b.window_start_ms for b in windows]
    for ev in got.values():
        assert set(spans.STAGES[5:]) | {"dispatch", "wait", "record", "plane"} <= set(ev["stages"])
        assert ev["parents"] == parents
        assert all(ms >= 0 for ms in ev["stages"].values())
    for s in ("stage", "score", "dispatch", "wait", "record", "plane", "export"):
        assert _hist_count(svc, s) == len(windows)
    if batch_windows > 1:
        assert svc.score_dispatches < len(windows)  # the stacked path ran
    assert svc.tracer.live_count == 0


def test_windowless_stages_never_reopen_a_scored_window(monkeypatch):
    """The hand-off's gauges wait until the scorer has completed the
    window's span: the hand-off's stages, observed after it, reopen
    nothing."""
    svc = _service()
    svc.start()
    real = service_mod.src_locality_gauges

    def after_scoring(*args, **kwargs):
        deadline = time.monotonic() + 30
        while svc.scored_batches < handed[0] and time.monotonic() < deadline:
            time.sleep(0.005)
        return real(*args, **kwargs)

    monkeypatch.setattr(service_mod, "src_locality_gauges", after_scoring)
    handed = [0]
    try:
        for b in _windows(3):
            handed[0] += 1
            svc.graph_store.on_batch(b)
            assert svc.scored_batches == handed[0]  # scored inside its own hand-off
        svc.drain(timeout_s=60)
    finally:
        svc.stop()
    assert svc.tracer.live_count == 0
    assert svc.metrics.snapshot()["trace.live"] == 0
    assert svc.tracer.completed == 3
    for s in ("handoff", "gauges", "take"):
        assert _hist_count(svc, s) == 3
    for ev in _window_spans(svc).values():
        assert not {"handoff", "gauges", "take"} & set(ev["stages"])


def _ranges(prof) -> dict:
    """{stage: [(start_ns, end_ns, thread)]} of the trace's alaz.* ranges."""
    out: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("alaz.") and str(ev.device_type()).endswith("CPU"):
            s = ev.start_ns()
            out.setdefault(ev.name()[5:], []).append((s, s + ev.duration_ns(), ev.start_thread_id()))
    return out


def test_ranges_land_in_the_profiler_trace_on_their_threads(monkeypatch):
    observed: dict = {}
    real_observe = Histogram.observe

    def keeping(self, v):
        observed.setdefault(self.name, []).append(v)
        real_observe(self, v)

    monkeypatch.setattr(Histogram, "observe", keeping)
    svc = _service()
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=every_thread) as prof:
        _run(svc, _windows(4))
    got = _ranges(prof)
    assert set(SCORER_STAGES) | {"handoff", "gauges"} <= set(got)
    scorer = {t for s in SCORER_STAGES for _, _, t in got[s]}
    closing = {t for s in ("handoff", "gauges") for _, _, t in got[s]}
    assert len(scorer) == 1 and len(closing) == 1 and scorer != closing
    # nested as declared: each child inside one of its parent's ranges
    for child, parent in list(SERIAL_PARENTS.items()) + [("gauges", "handoff")]:
        for s, e, t in got[child]:
            assert any(ps <= s and e <= pe and pt == t for ps, pe, pt in got[parent]), child
    # each range against its histogram observation (a poll that took no
    # window has a range and no observation)
    for stage in SCORER_STAGES + ("handoff", "gauges"):
        durs = sorted((e - s) * 1e-9 for s, e, _ in got[stage])
        obs = sorted(observed[f"latency.{stage}_s"])
        if stage == "take":
            assert len(obs) == 4 and len(durs) >= 4
            for v in obs:
                assert min(abs(d - v) for d in durs) < 1e-3
        else:
            assert len(durs) == len(obs) == 4, stage
            assert max(abs(d - v) for d, v in zip(durs, obs)) < 1e-3, stage


def test_the_debug_servers_profiler_records_every_threads_spans():
    """``/profile`` and ``/profiler/start`` start their session on an HTTP
    handler thread: it records the spans of the service's threads."""
    from alaz_tpu_torch.runtime.debug_http import _torch_profiler

    tr = SpanTracer()

    def one_span():
        with tr.span("take"):
            pass

    prof = _torch_profiler()
    prof.start()
    try:
        worker = threading.Thread(target=one_span)
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    finally:
        prof.stop()
    assert "take" in _ranges(prof)


def test_no_profiler_no_range(monkeypatch):
    entered = []

    class Counting:
        # torch enters record_function itself (the optimizer's steps):
        # only the spans' ranges count
        def __init__(self, name, *args):
            if name.startswith("alaz."):
                entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    spans._profiler_modules()  # torch's modules as the helper reads them
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    for bw in (1, 4):
        _run(_service(bw), _windows(5))
    cfg = ModelConfig(dtype="float32", hidden_dim=32)
    params = init_params(cfg, key=0, device="cpu")
    step = trainstep.make_train_step(cfg, device="cpu")
    b = _windows(1)[0]
    step(params, trainstep._adamw(params, 1e-3), b.device_arrays(), b.edge_label)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with SpanTracer().span("feed"):
            pass
    assert entered == ["alaz.feed"]


def test_cpu_seconds_stay_within_wall_seconds():
    tr = SpanTracer()
    with tr.span("forward") as busy:
        x = 0
        while time.perf_counter() - busy.t0 < 0.02:
            x += 1
    with tr.span("backward") as idle:
        time.sleep(0.02)
    assert 0 < tr.cpu["forward"].value <= busy.wall_s
    assert tr.cpu["backward"].value <= 0.5 * idle.wall_s
    assert tr.hists["forward"].snapshot()["count"] == 1
    assert set(tr.cpu) == set(SPAN_STAGES) and set(PORT_STAGES) <= set(tr.hists)


def test_disabled_tracer_times_the_body_alone():
    tr = SpanTracer(enabled=False)
    with tr.span("take") as sp:
        time.sleep(0.005)
    assert sp.wall_s >= 0.005
    assert tr.hists["take"].snapshot()["count"] == 0 and tr.cpu["take"].value == 0
    assert getattr(spans._LOCAL, "stack", []) == []


def test_a_raising_body_is_not_observed_and_unwinds_the_stack():
    tr = SpanTracer()
    with pytest.raises(RuntimeError):
        with tr.span("record", 1_000):
            with tr.span("plane", 1_000):
                raise RuntimeError("boom")
    assert spans._LOCAL.stack == []
    assert tr.live_count == 0


def test_train_step_spans_and_its_loss_bit_for_bit():
    cfg = ModelConfig(dtype="float32", hidden_dim=32)
    windows = _windows(3, seed=5)
    feeds = [(b.device_arrays(), b.edge_label) for b in windows]

    def before_spans(loss_fn):
        """The step as it was written before it had spans."""

        def step(params, optimizer, graph, edge_label):
            g = {k: trainstep._autograd_tensor(v) for k, v in graph_to_torch(graph, "cpu").items()}
            label = trainstep._autograd_tensor(torch.as_tensor(edge_label, device="cpu"))
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(params, g, label)
            trainstep.backward(params, loss)
            optimizer.step()
            return loss.detach()

        return step

    tracer = SpanTracer()
    a, b = init_params(cfg, key=3, device="cpu"), init_params(cfg, key=3, device="cpu")
    opt_a, opt_b = trainstep._adamw(a, 3e-3), trainstep._adamw(b, 3e-3)
    step = trainstep.make_train_step(cfg, 10.0, "cpu", tracer=tracer)
    old = before_spans(trainstep.make_loss_fn(cfg, 10.0))
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=every_thread) as prof:
        losses = [step(a, opt_a, g, lbl) for g, lbl in feeds]
    ref = [old(b, opt_b, g, lbl) for g, lbl in feeds]
    assert all(torch.equal(x, y) for x, y in zip(losses, ref))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert step.tracer is tracer
    assert trainstep.make_train_step(cfg, device="cpu").tracer is not tracer
    for s in ("feed", "forward", "backward", "optim"):
        assert tracer.hists[s].snapshot()["count"] == 3
        assert 0 <= tracer.cpu[s].value
    # a thread CPU clock may tick coarsely (10 ms on some hosts): the
    # step's CPU seconds are read whole
    assert sum(tracer.cpu[s].value for s in ("feed", "forward", "backward", "optim")) > 0
    got = _ranges(prof)
    assert {t for s in ("feed", "forward", "backward", "optim") for _, _, t in got[s]} == {
        got["feed"][0][2]}
    feed, fwd = sorted(got["feed"]), sorted(got["forward"])
    assert all(f[1] <= w[0] for f, w in zip(feed, fwd))


@pytest.mark.cuda
@pytest.mark.parametrize("batch_windows", [1, 4], ids=["serial", "group"])
def test_score_device_time_from_events_on_card(batch_windows):
    """Each window's ``latency.score_s.<bucket>`` observation is the
    step's device time: positive and, on the serial path, within the
    window's host ``score`` span (the start event is recorded inside it,
    and the end event completes before its read returns; a stacked
    group's launches run at staging, before its ``score`` read). The
    event pool stays as large as the pairs in flight."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    svc = _service(batch_windows, device="cuda")
    seen = []
    real = svc.device.observe_score

    def observe_score(batch, dur_s):
        seen.append((batch.window_start_ms, dur_s))
        real(batch, dur_s)

    svc.device.observe_score = observe_score
    windows = _windows(12)
    _run(svc, windows)
    host = _window_spans(svc)
    assert len(seen) == len(windows)
    for w, dur_s in seen:
        assert dur_s > 0
        if batch_windows == 1:
            assert dur_s * 1e3 <= host[w]["stages"]["score"] + 1e-4, (dur_s, host[w]["stages"])
    assert 1 <= len(svc._score_clock.free) <= 2  # every pair made is back in the pool
    key = next(n for n in svc.metrics.histograms() if n.startswith("latency.score_s."))
    assert svc.metrics.histogram(key).snapshot()["count"] == len(windows)
