"""The port's ``python -m alaz_tpu_torch`` subcommands against the JAX
package's ``python -m alaz_tpu``, on the CPU.

Held here: ``replay``'s JSON equal but for ``events_per_s`` (a wall-clock
rate); ``train`` and ``eval`` at small sizes (a 40-pod config, a few
windows and epochs): the same exit codes, the same JSON keys and step
counts, and a ``--ckpt`` written; ``train`` with no card and no
``--device`` raises; the smoke's check of a ``train`` run against the
same run on the plain versions (``chip_smoke._train_cli``), and that it
catches a wrong backward; ``serve`` on paced traffic that neither CLI
sheds (``tests/torch_serve_cli_compare.py``): the same windows closed,
nothing lost; live ``serve --ingest-socket`` with no ``--config`` (pods
from a fake API server, an agent's frames, SIGINT): exit 0 and the same
windows closed; ``python -m alaz_tpu_torch.chaos --seed 0``: the JAX
package's exit code and legs; ``agent_example`` as the port builds it:
the JAX Makefile's stamp, and its records closing the same windows in
both packages. The scores themselves are held by
``test_torch_scenario.py`` (the windows, ``_stream_tgn_eval``) and
``test_torch_train.py`` (the steps).
"""

from __future__ import annotations

import json

import pytest
import torch

from alaz_tpu import __main__ as jcli
from alaz_tpu_torch import __main__ as cli


def test_replay_cli_matches(capsys):
    assert jcli.main(["replay"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(["replay"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref.pop("events_per_s")
    got.pop("events_per_s")
    assert got == ref and ref["passed"]


def _keys(obj):
    """The key tree of a JSON value: dicts by key, lists by position."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return None


@pytest.fixture
def small_config(tmp_path):
    path = tmp_path / "small.json"
    path.write_text(json.dumps({"podCount": 40, "serviceCount": 16, "edgeCount": 30, "edgeRate": 200,
                                "testDuration": 10}))
    return str(path)


@pytest.mark.parametrize("model", ["graphsage", "tgn"])
def test_train_cli_exit_code_and_keys_match(capsys, small_config, tmp_path, model):
    args = ["train", "--config", small_config, "--model", model, "--windows", "5", "--epochs", "6"]
    rc_ref = jcli.main(args)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc = cli.main(args + ["--device", "cpu", "--ckpt", str(tmp_path / "ckpt")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == rc_ref and _keys(got) == _keys(ref)
    assert got["steps"] == ref["steps"]
    assert (tmp_path / "ckpt" / str(got["steps"])).is_dir()


def test_train_cli_raises_without_a_card(small_config):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--config", small_config, "--windows", "3", "--epochs", "1"])


def test_eval_cli_exit_code_and_keys_match(capsys, small_config):
    args = ["eval", "--config", small_config, "--forecast-config", small_config, "--models",
            "graphsage,experts", "--windows", "5", "--forecast-windows", "6", "--epochs", "4"]
    rc_ref = jcli.main(args)
    ref = json.loads(_last_json(capsys.readouterr().out))
    rc = cli.main(args + ["--device", "cpu"])
    got = json.loads(_last_json(capsys.readouterr().out))
    assert rc == rc_ref and _keys(got) == _keys(ref)
    assert got["description"].startswith("Quality gate at FULL scale: python -m alaz_tpu_torch eval")
    for k in ("config", "n_windows", "epochs", "seed", "fault_fraction"):
        assert got[k] == ref[k]
    assert [r["steps"] for r in got["results"]] == [r["steps"] for r in ref["results"]]
    assert got["forecast"]["steps"] == ref["forecast"]["steps"]


def _last_json(out: str) -> str:
    """The indented JSON object ``eval`` prints last."""
    return out[out.rindex("\n{\n") + 1:] if "\n{\n" in out else out[out.index("{\n"):]


def _smoke_train_cli(small_config, model):
    import chip_smoke

    env = {"MODEL": model, "SRC_GATHER": "banded" if model == "gat" else "xla", "EDGE_LAYOUT": "coo",
           "USE_PALLAS": "1"}
    argv = ["train", "--config", small_config, "--model", model, "--windows", "5", "--epochs", "6"]
    return chip_smoke._train_cli(f"train_cli_{model}", argv, env, "cpu")


@pytest.mark.parametrize("model", ["graphsage", "gat", "tgn"])
def test_smoke_train_cli_holds_the_plain_run(capsys, small_config, model):
    # on the CPU both runs take the plain versions, so they agree exactly
    entry = _smoke_train_cli(small_config, model)
    assert entry["exit_code"] == entry["plain"]["exit_code"]
    assert entry["result"] == entry["plain"]["result"]
    assert entry["losses_max_err_of_max"] == 0.0 and entry["eval_logits_max_err_of_max"] == 0.0
    assert entry["first_update_grad_max_err_of_param_max"] == 0.0 and entry["eval_logits"] > 0
    assert entry["steps"] == entry["result"]["steps"]


def test_smoke_train_cli_catches_a_wrong_backward(small_config, monkeypatch):
    # K4 runs only in K3's backward on the GAT step: halve what it returns
    from alaz_tpu_torch.ops import segment_kernels as K

    run_k4 = K._run_k4
    monkeypatch.setattr(K, "_run_k4", lambda *a, **kw: run_k4(*a, **kw) * 0.5)
    with pytest.raises(RuntimeError, match="first update: gradient of"):
        _smoke_train_cli(small_config, "gat")


def test_serve_cli_paced_matches(tmp_path):
    """Both packages' ``serve`` CLIs (no checkpoint, each in its own
    process) on config4's traffic cut to 3.1 s and 10 requests a second
    an edge (24,800 events), replayed at the wall clock's pace, a load
    neither sheds: the same 4 windows closed, nothing lost. Flat out
    (config4's 496,000 events in 3.1 s) both shed at the L7 queue's
    mouth by amounts that vary from run to run, so only this result is
    held equal."""
    from tests.torch_serve_cli_compare import REPO, cut_traffic, run_once

    raw = json.loads((REPO / "testconfig/config4_temporal.json").read_text())
    traffic = tmp_path / "traffic.json"
    traffic.write_text(json.dumps(cut_traffic(raw, 3.1, edge_rate=10)))
    ref = run_once("alaz_tpu", str(traffic), paced=True)
    got = run_once("alaz_tpu_torch", str(traffic), paced=True)
    assert ref["events_lost"] == got["events_lost"] == 0
    assert ref["windows_closed"] == got["windows_closed"] == 4


def _live_traffic(tmp_path, seed: int = 2):
    """A small cluster's pods from a fake API server, and an agent's frames
    of its traffic (about 9,000 rows: well inside every queue, so neither
    CLI sheds)."""
    import chip_smoke

    from alaz_tpu_torch.config import SimulationConfig
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.replay.simulator import Simulator

    sim = Simulator(SimulationConfig(test_duration_s=2.1, pod_count=40, service_count=12, edge_count=20,
                                     edge_rate=200, seed=seed), interner=Interner())
    msgs = sim.setup()
    frames, tcp_rows, l7_rows = chip_smoke.agent_frames(sim, rows=512)
    return chip_smoke.FakeApiServer(chip_smoke.api_items(msgs)), frames, tcp_rows + l7_rows, tcp_rows


def test_serve_live_cli_matches(tmp_path):
    """Both packages' ``serve --ingest-socket`` with no ``--config`` (each
    in its own process, pods from a fake API server, no checkpoint),
    fed the same frames and stopped by SIGINT: exit 0, every row taken
    in, the same windows closed; the port's summary line agrees."""
    import os

    import chip_smoke

    api, frames, rows, tcp_rows = _live_traffic(tmp_path)
    env = {k: v for k, v in os.environ.items() if k not in ("BACKEND_HOST", "LOCAL_PIDS", "INGEST_SOCKET")}
    env.update(K8S_API_SERVER=api.url, JAX_PLATFORMS="cpu")
    try:
        runs = {
            module: chip_smoke.run_live_cli(module, argv, env, str(tmp_path / f"{module}.sock"), frames, rows,
                                            min_windows=2, scored=False, tcp_rows=tcp_rows, timeout_s=60)
            for module, argv in (("alaz_tpu", []), ("alaz_tpu_torch", ["--device", "cpu"]))
        }
    finally:
        api.close()
    ref, got = runs["alaz_tpu"], runs["alaz_tpu_torch"]
    assert ref["exit_code"] == got["exit_code"] == 0, (ref["stderr_tail"], got["stderr_tail"])
    closed = {m: r["scrape"]["metrics"]["alaz_tpu_windows_closed"] for m, r in runs.items()}
    assert closed["alaz_tpu_torch"] == closed["alaz_tpu"] == 2
    for r in runs.values():
        assert r["scrape"]["metrics"]["alaz_tpu_ingest_socket_records"] == rows
        assert "k8s informers watching" in r["stderr"]
    summary = json.loads(got["last_line"])
    assert summary["windows_closed"] == 2 and summary["windows_scored"] == 0 and summary["events"] == rows


def test_chaos_cli_matches(capsys):
    """``python -m alaz_tpu_torch.chaos --seed 0`` (a process of its own)
    against the JAX package's CLI: the same exit code, reports and legs."""
    import subprocess
    import sys

    from alaz_tpu.chaos.__main__ import main as jax_chaos

    rc_ref = jax_chaos(["--seed", "0"])
    ref = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    proc = subprocess.run([sys.executable, "-m", "alaz_tpu_torch.chaos", "--seed", "0"], capture_output=True,
                          text=True, timeout=120)
    got = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert proc.returncode == rc_ref == 0, proc.stderr[-2000:]
    assert _keys(got) == _keys(ref) and len(got) == 2
    suite = got[0]
    assert suite["findings"] == [] and all(suite[leg] for leg in ("pipeline", "frames", "backend"))
    # the frame and backend legs are deterministic: equal, not only alike
    assert (suite["frames"], suite["backend"]) == (ref[0]["frames"], ref[0]["backend"])


def test_agent_example_matches(tmp_path):
    """The port's build of ``agent_example`` carries the stamp the JAX
    package's Makefile gives it (``sha256sum agent_example.cc | cut
    -c1-16``); its 3,000 records, sent to a native-store Service of each
    package on the CPU, close the same three windows bit for bit."""
    import hashlib
    import subprocess
    import time

    from alaz_tpu.runtime.service import Service as JaxService
    from alaz_tpu.sources.ingest_server import IngestServer as JaxIngestServer
    from alaz_tpu_torch.graph import native
    from alaz_tpu_torch.runtime.service import Service
    from alaz_tpu_torch.sources.ingest_server import IngestServer
    from tests.test_torch_live import _assert_windows_equal

    exe = native.build_agent()
    from tests.test_torch_copies import REPO

    stamp = hashlib.sha256((REPO / "alaz_tpu/native/agent_example.cc").read_bytes()).hexdigest()[:16]
    assert exe.name == f"agent_example-{stamp}" and f"ALZ_SOURCE_STAMP:{stamp}".encode() in exe.read_bytes()
    windows = {}
    for name, svc_cls, srv_cls, kw in (("jax", JaxService, JaxIngestServer, {}),
                                       ("port", Service, IngestServer, {"device": "cpu"})):
        svc = svc_cls(use_native_ingest=True, **kw)
        srv = srv_cls(svc, path=tmp_path / f"{name}.sock")
        srv.start()
        try:
            run = subprocess.run([str(exe), str(tmp_path / f"{name}.sock"), "3000"], capture_output=True,
                                 text=True, timeout=30)
            assert run.returncode == 0, run.stderr
            deadline = time.monotonic() + 10
            while srv.records < 3000 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert srv.records == 3000 and srv.bad_frames == 0
            svc.flush_windows()
            windows[name] = [item[0] for item in svc.window_queue.drain()]
        finally:
            srv.stop()
            svc.graph_store.close()
    assert len(windows["jax"]) == 3
    _assert_windows_equal(windows["port"], windows["jax"])
