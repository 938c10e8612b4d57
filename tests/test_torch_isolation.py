"""The PyTorch port stands alone: no module of ``alaz_tpu_torch``, and not
``chip_smoke.py``, imports JAX, the JAX package or ``__graft_entry__``."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "alaz_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "alaz_tpu", "__graft_entry__", "optax", "orbax")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_forbidden_import_in_source():
    found = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert found == []


def test_importing_every_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    ) + ["chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(modules) > 15
    # the labelled windows, the incident suite and the sharded ingest
    assert {
        "alaz_tpu_torch.replay.scenario", "alaz_tpu_torch.replay.incidents", "alaz_tpu_torch.replay.faults",
        "alaz_tpu_torch.replay.trace", "alaz_tpu_torch.replay.__main__", "alaz_tpu_torch.aggregator.sharded",
        "alaz_tpu_torch.chaos", "alaz_tpu_torch.chaos.harness", "alaz_tpu_torch.chaos.injectors",
        "alaz_tpu_torch.__main__",
    } <= set(modules)
    # the process backend and the isolation gate
    assert {
        "alaz_tpu_torch.shm", "alaz_tpu_torch.shm.ring", "alaz_tpu_torch.shm.codec", "alaz_tpu_torch.shm.worker",
        "alaz_tpu_torch.shm.process_pool", "alaz_tpu_torch.replay.tenants",
    } <= set(modules)
    # the live sources, the export backend and health, the chaos CLI
    assert {
        "alaz_tpu_torch.sources.ingest_server", "alaz_tpu_torch.sources.k8s_client",
        "alaz_tpu_torch.sources.k8s_watch", "alaz_tpu_torch.sources.cri", "alaz_tpu_torch.sources.containers",
        "alaz_tpu_torch.sources.logstream", "alaz_tpu_torch.sources.tlsattach", "alaz_tpu_torch.sources.gotls",
        "alaz_tpu_torch.datastore.backend", "alaz_tpu_torch.runtime.health",
        "alaz_tpu_torch.aggregator.dist_tracing", "alaz_tpu_torch.chaos.__main__",
    } <= set(modules)
