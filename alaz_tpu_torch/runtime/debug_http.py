"""Debug/observability HTTP server — the pprof-on-:8181 +
node-exporter-on-:8182 analog (main.go:25,160; backend.go:1038-1105).

Endpoints:
- ``/metrics``          Prometheus text (service counters/gauges + devices
                        + ``latency.*`` stage histograms, ISSUE 9; the
                        per-bucket ``latency.score_s.*`` /
                        ``device.occupancy.*`` series and ``compile.*``
                        counters, ISSUE 11)
- ``/healthz``          liveness
- ``/stats``            JSON snapshot (queue lag, aggregator stats,
                        per-stage latency percentiles, recorder counters,
                        and the per-bucket device breakdown:
                        score percentiles, occupancy, pad waste,
                        stage arena/transfer split, compile events)
- ``/scores``           score-plane snapshot (ISSUE 13): per-model
                        distribution sketch percentiles, last-window
                        summary, drift state/PSI/rebaselines; 404 when
                        the plane is disabled (absent-not-zero)
- ``/scores/top?windows=N``  top-K anomaly attribution ledger: the K
                        highest-scoring nodes of the last N windows with
                        feature z-scores + top contributing in-edges;
                        bounded by the ledger ring however large N
- ``/recorder``         flight-recorder dump (alaz_tpu/obs): the last-N
                        structured runtime events, oldest→newest
- ``/stack``            all-thread stack dump (goroutine-profile analog)
- ``/profile?seconds=N``  on-demand bounded ``torch.profiler`` deep
                        dive: single-flight (409 on overlap), clamped to
                        ``PROFILE_MAX_SECONDS``, CPU-safe; the trace dir,
                        holding a Chrome trace ``trace.json``, comes back
                        in the JSON response
- ``/profiler/start``   begin an unbounded ``torch.profiler`` trace
                        (``/profiler/stop`` ends; the manual twin of
                        ``/profile`` for attach-and-watch sessions)
"""

from __future__ import annotations

import io
import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from alaz_tpu_torch.logging import get_logger

log = get_logger("alaz_tpu.debug")


class DebugServer:
    def __init__(self, service, host: str = "127.0.0.1", port: int = 8181):
        self.service = service
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._trace_dir: Optional[str] = None
        # /profile single-flight guard: jax's profiler is process-global
        # (start_trace raises on nesting), so overlapping requests must
        # 409, not crash the handler thread mid-trace
        self._profile_mu = threading.Lock()
        self._profiling = False  # guarded-by: self._profile_mu

    def start(self) -> int:
        svc = self.service
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code: int, body: str, ctype: str = "text/plain"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, "ok")
                elif self.path == "/metrics":
                    self._send(200, svc.metrics.render_prometheus())
                elif self.path == "/stats":
                    stats = {
                        "queues": {
                            q.name: q.stats()
                            for q in (svc.l7_queue, svc.tcp_queue, svc.proc_queue, svc.k8s_queue)
                        },
                        "aggregator": svc.aggregator.stats.as_dict(),
                        "scored_batches": svc.scored_batches,
                        "scored_edges": svc.scored_edges,
                    }
                    tracer = getattr(svc, "tracer", None)
                    if tracer is not None:
                        # per-stage latency percentiles: the
                        # "where did window W spend its 0.6s" answer
                        stats["stage_latency"] = tracer.stage_snapshot()
                        stats["spans"] = {
                            "live": tracer.live_count,
                            "completed": tracer.completed,
                            "evicted": tracer.evicted,
                        }
                    device = getattr(svc, "device", None)
                    if device is not None and hasattr(device, "snapshot"):
                        # per-bucket breakdown next to
                        # stage_latency: score percentiles, occupancy,
                        # pad waste, arena/transfer split
                        stats["device"] = device.snapshot()
                    plane = getattr(svc, "compile_plane", None)
                    if plane is not None:
                        stats["compile"] = plane.snapshot()
                    score_plane = getattr(svc, "scores", None)
                    if score_plane is not None and score_plane.enabled:
                        # drift + distribution summary next to the
                        # device breakdown; the full ledger
                        # stays on /scores/top
                        stats["scores"] = score_plane.snapshot()
                    recorder = getattr(svc, "recorder", None)
                    if recorder is not None:
                        stats["recorder"] = {
                            "recorded": recorder.recorded,
                            "overwritten": recorder.overwritten,
                            "capacity": recorder.capacity,
                        }
                    if getattr(svc, "tenants", 1) > 1:
                        # per-tenant breakdown: queue lag,
                        # ledger, windows and drift state per fleet —
                        # the isolation diagnosis surface
                        stats["tenants"] = svc.tenants_snapshot()
                    self._send(200, json.dumps(stats, indent=2), "application/json")
                elif self.path == "/scores":
                    plane = getattr(svc, "scores", None)
                    if getattr(svc, "tenants", 1) > 1:
                        # multi-tenant service: per-tenant planes (ISSUE
                        # 14), keyed by tenant id; a tenant absent from
                        # the dict has not scored a window yet
                        if not getattr(svc, "_scores_enabled", False):
                            self._send(404, "score plane disabled")
                        else:
                            self._send(
                                200,
                                json.dumps(
                                    {
                                        "tenants": {
                                            str(t): p.snapshot()
                                            for t, p in sorted(
                                                svc.score_planes().items()
                                            )
                                            if p.enabled
                                        }
                                    },
                                    indent=2,
                                ),
                                "application/json",
                            )
                    elif plane is None or not plane.enabled:
                        # absent-not-zero: a disabled plane
                        # has no surface, it does not serve empty JSON
                        self._send(404, "score plane disabled")
                    else:
                        self._send(
                            200,
                            json.dumps(plane.snapshot(), indent=2),
                            "application/json",
                        )
                elif self.path == "/scores/top" or self.path.startswith(
                    "/scores/top?"
                ):
                    from urllib.parse import parse_qs, urlparse

                    # one parse for every query param this endpoint reads
                    qs = parse_qs(urlparse(self.path).query)
                    plane = getattr(svc, "scores", None)
                    if getattr(svc, "tenants", 1) > 1:
                        # ?tenant=T selects the fleet's ledger (default
                        # 0 — the primary tenant); 404 until that
                        # tenant has scored a window (absent-not-zero)
                        try:
                            tid = int(qs.get("tenant", ["0"])[0])
                        except ValueError:
                            self._send(
                                400,
                                '{"error": "tenant must be an integer"}',
                                "application/json",
                            )
                            return
                        plane = svc.tenant_scores(tid)
                    if plane is None or not plane.enabled:
                        self._send(404, "score plane disabled")
                        return
                    raw = qs.get("windows", ["1"])[0]
                    # malformed params 400 BEFORE any side effect (the
                    # /profile discipline); the ledger ring bounds the
                    # response however large the ask
                    try:
                        windows = int(raw)
                    except ValueError:
                        self._send(
                            400,
                            '{"error": "windows must be an integer"}',
                            "application/json",
                        )
                        return
                    if windows < 0:
                        self._send(
                            400,
                            '{"error": "windows must be >= 0"}',
                            "application/json",
                        )
                        return
                    self._send(
                        200,
                        json.dumps(plane.top_snapshot(windows), indent=2),
                        "application/json",
                    )
                elif self.path == "/recorder":
                    recorder = getattr(svc, "recorder", None)
                    if recorder is None:
                        self._send(404, "no flight recorder attached")
                    else:
                        self._send(
                            200,
                            json.dumps(recorder.dump(), indent=2),
                            "application/json",
                        )
                elif self.path == "/stack":
                    buf = io.StringIO()
                    frames = getattr(threading, "_current_frames", lambda: {})()
                    import sys

                    for tid, frame in sys._current_frames().items():
                        buf.write(f"--- thread {tid} ---\n")
                        traceback.print_stack(frame, file=buf)
                    self._send(200, buf.getvalue())
                elif self.path == "/profiler/start":
                    self._send(200, outer._profiler_start())
                elif self.path == "/profiler/stop":
                    self._send(200, outer._profiler_stop())
                elif self.path == "/profile" or self.path.startswith("/profile?"):
                    import math
                    from urllib.parse import parse_qs, urlparse

                    qs = parse_qs(urlparse(self.path).query)
                    try:
                        seconds = float(qs.get("seconds", ["1.0"])[0])
                    except ValueError:
                        seconds = float("nan")
                    # nan slips through float() AND the min/max clamp
                    # (NaN comparisons are all False, so min/max keep
                    # it) — reject anything non-finite up front
                    if not math.isfinite(seconds):
                        self._send(400, '{"error": "seconds must be a finite number"}',
                                   "application/json")
                        return
                    code, body = outer._profile(seconds)
                    self._send(code, body, "application/json")
                else:
                    self._send(404, "not found")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_port  # resolves port 0
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="alaz-debug-http", daemon=True)
        self._thread.start()
        log.info(f"debug http on {self.host}:{self.port}")
        return self.port

    def _profile(self, seconds: float) -> tuple:
        """On-demand bounded deep dive: one ``torch.profiler`` trace of
        the host and, where there is a card, its CUDA kernels, for
        ``seconds`` (clamped to the ``PROFILE_MAX_SECONDS`` bound — the
        endpoint must never wedge a debug thread or fill a disk
        indefinitely), written as a Chrome trace ``trace.json``;
        single-flight against itself AND the manual ``/profiler/start``
        session. Returns ``(http status, json body)``."""
        import json as json_mod
        import os
        import tempfile
        import time

        cfg = getattr(self.service, "config", None)
        max_s = float(getattr(getattr(cfg, "trace", None), "profile_max_s", 30.0))
        requested = seconds
        seconds = min(max(seconds, 0.05), max_s)
        with self._profile_mu:
            if self._profiling or self._trace_dir is not None:
                return 409, json_mod.dumps(
                    {"error": "a profiler trace is already running; "
                              "retry when it completes"}
                )
            self._profiling = True
        try:
            # retention: a polled endpoint must not grow /tmp without
            # bound — PROFILE_MAX_SECONDS bounds one request, this
            # bounds the fleet of them. Oldest dirs beyond the newest
            # few are pruned before each new trace. Pid-scoped prefix:
            # the single-flight lock is per-process, so pruning must
            # never touch a sibling process's still-being-written trace.
            self._prune_profile_dirs(keep=4)
            out_dir = tempfile.mkdtemp(prefix=self._profile_prefix())
            recorder = getattr(self.service, "recorder", None)
            if recorder is not None:
                # deep dives leave a trail: an operator reading the
                # flight recorder sees WHEN the profiler perturbed things
                recorder.record("profile", seconds=seconds, trace_dir=out_dir)
            t0 = time.perf_counter()
            prof = _torch_profiler()
            prof.start()
            try:
                time.sleep(seconds)
            finally:
                prof.stop()
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
            wall = time.perf_counter() - t0
            return 200, json_mod.dumps(
                {
                    "trace_dir": out_dir,
                    "seconds": seconds,
                    "requested_seconds": requested,
                    "wall_s": round(wall, 3),
                }
            )
        except Exception as exc:  # noqa: BLE001 - surface, don't kill the server
            return 500, json_mod.dumps({"error": repr(exc)})
        finally:
            with self._profile_mu:
                self._profiling = False

    @staticmethod
    def _profile_prefix() -> str:
        """Pid-scoped /profile trace-dir prefix: pruning is guarded by
        a per-process lock, so it may only ever see THIS process's
        dirs — a sibling service's in-flight trace is untouchable."""
        import os

        return f"alaz-profile-{os.getpid()}-"

    @classmethod
    def _prune_profile_dirs(cls, keep: int) -> None:
        """Delete all but the ``keep`` newest completed /profile trace
        dirs of THIS process (incl. empty dirs a failed trace left)."""
        import glob
        import os
        import shutil
        import tempfile

        dirs = glob.glob(
            os.path.join(tempfile.gettempdir(), cls._profile_prefix() + "*")
        )
        dirs.sort(key=lambda d: os.path.getmtime(d) if os.path.exists(d) else 0)
        for d in dirs[: max(0, len(dirs) - keep)]:
            shutil.rmtree(d, ignore_errors=True)

    def _profiler_start(self) -> str:
        import os
        import tempfile

        # reserve-then-start: the guard check and the _trace_dir claim
        # happen in ONE critical section (a check-then-act split let two
        # concurrent starts both pass and the loser's start raise
        # uncaught through the handler); the profiler call itself runs
        # outside the lock, and a failure releases the reservation
        d = tempfile.mkdtemp(prefix="alaz-torch-trace-")
        with self._profile_mu:
            if self._trace_dir is not None:
                os.rmdir(d)
                return f"already tracing to {self._trace_dir}"
            if self._profiling:
                os.rmdir(d)
                return "a /profile deep dive is running; retry when it completes"
            self._trace_dir = d
        try:
            prof = _torch_profiler()
            prof.start()
        except Exception as exc:  # noqa: BLE001 - report, don't kill the handler
            with self._profile_mu:
                self._trace_dir = None
            return f"profiler start failed: {exc!r}"
        self._session = prof
        return f"tracing to {d}"

    def _profiler_stop(self) -> str:
        import os

        # the claim is released only AFTER a successful stop: a failed
        # stop leaves the profiler RUNNING, so the guard must keep saying
        # "tracing" or no later request could ever stop it. The stop
        # under the mutex also keeps a racing /profile or
        # /profiler/start from claiming the slot mid-stop.
        with self._profile_mu:
            if self._trace_dir is None:
                return "not tracing"
            try:
                self._session.stop()
                self._session.export_chrome_trace(os.path.join(self._trace_dir, "trace.json"))
            except Exception as exc:  # noqa: BLE001 - report, keep retryable
                return f"profiler stop failed (still tracing, retry): {exc!r}"
            out, self._trace_dir = self._trace_dir, None
            self._session = None
        return f"trace written to {out}/trace.json"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


def _torch_profiler():
    """A ``torch.profiler`` session over the host and, where a card is
    visible, its CUDA activity. It records every thread's operations and
    span ranges (``alaz.<stage>``, ``obs/spans.py``), not only those of
    the HTTP handler thread that starts it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(activities=acts, experimental_config=every_thread)
