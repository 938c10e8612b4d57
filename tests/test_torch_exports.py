"""Every subpackage of the JAX package exports its names from the port too.

For each subpackage of ``alaz_tpu`` (the top-level package included),
the port's twin exports what the reference exports: its ``__all__``, or,
where the reference's ``__init__`` has none (``sanitize``), the public
names it binds. The port may export more. No subpackage is exempt:
``parallel``, ported onto ``torch.distributed``, is held like the rest.
"""

from __future__ import annotations

import importlib
import subprocess
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
NOT_YET_PORTED: set = set()
SUBPACKAGES = sorted(p.parent.name for p in (REPO / "alaz_tpu").glob("*/__init__.py"))


def _exports(module) -> set:
    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {
        k for k, v in vars(module).items()
        if not k.startswith("_") and not isinstance(v, types.ModuleType) and k != "annotations"
    }


def test_every_reference_subpackage_is_listed():
    assert len(SUBPACKAGES) >= 17 and NOT_YET_PORTED <= set(SUBPACKAGES)


@pytest.mark.parametrize("sub", [""] + [s for s in SUBPACKAGES if s not in NOT_YET_PORTED])
def test_port_exports_what_the_reference_exports(sub):
    name = f".{sub}" if sub else ""
    ref = importlib.import_module(f"alaz_tpu{name}")
    port = importlib.import_module(f"alaz_tpu_torch{name}")
    want = _exports(ref)
    assert want, f"alaz_tpu{name} exports nothing"
    missing = want - _exports(port)
    assert not missing, f"alaz_tpu_torch{name} lacks {sorted(missing)}"
    for n in want & set(getattr(port, "__all__", want)):
        assert hasattr(port, n), f"alaz_tpu_torch{name}.__all__ names {n}, which it does not bind"


def test_the_new_exports_load_no_jax():
    """The three ``__init__``s that now carry the reference's imports, and
    ``sanitize``, import in a fresh interpreter without loading jax (no
    import cycle, no reach into the reference)."""
    code = (
        "import sys\n"
        "import alaz_tpu_torch.runtime, alaz_tpu_torch.sanitize, alaz_tpu_torch.datastore, alaz_tpu_torch.graph\n"
        "from alaz_tpu_torch.runtime import Service, ScoreBatch, ScoreRecord, Metrics, Counter, Gauge, "
        "HealthChecker, HealthState\n"
        "from alaz_tpu_torch.datastore import BatchingBackend, Transport\n"
        "from alaz_tpu_torch.graph import GraphBuilder, WindowedGraphStore, EDGE_BLOCK_ROWS\n"
        "from alaz_tpu_torch.obs import CompileEventPlane\n"
        "from alaz_tpu_torch.ops import segment_mean, segment_softmax\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'alaz_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_parallel_loads_no_jax():
    """Every module of ``alaz_tpu_torch.parallel`` imports in a fresh
    interpreter without loading jax or the JAX package."""
    code = (
        "import sys\n"
        "import alaz_tpu_torch.parallel\n"
        "from alaz_tpu_torch.parallel import (collectives, dryrun, gpipe, halo, mesh, multislice,\n"
        "    sharded_model, sharding)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'alaz_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
