"""The port's multi-rank dry-run and the parallel entry points' device
rule, on the CPU.

``python -m alaz_tpu_torch.parallel.dryrun 4 --device cpu`` spawns four
gloo ranks and runs every leg of the JAX package's ``dryrun_multichip``
at its sizes (GraphSAGE on 16k-edge windows at hidden 128 on the hybrid
(dp=2, tp=2) mesh, the experts on (tp=2, ep=2), the halo, ring
attention, and a 4-stage pipeline), each checked in the ranks against
its single-device computation. Without ``--device cpu`` the entry points
run on ``cuda`` and raise without a card.
"""

from __future__ import annotations

import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def test_dryrun_on_four_gloo_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "alaz_tpu_torch.parallel.dryrun", "4", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    (line,) = [ln for ln in out.stdout.splitlines() if ln.startswith("dryrun_multichip ok")]
    assert "hybrid mesh dp=2 tp=2 sp=1 (slices=1) + ep mesh dp=1 tp=2 ep=2 + pp=4 pipe" in line
    m = re.search(r"graphsage\[16k-edge,h128\] loss=(\S+), experts loss=(\S+), halo ok, ring-attention ok", line)
    assert m, line
    assert all(math.isfinite(float(v)) and float(v) > 0 for v in m.groups())


def test_entry_points_run_on_cuda_unless_asked_for_cpu(monkeypatch):
    """``make_mesh``, ``make_hybrid_mesh``, ``initialize_distributed`` and
    ``spawn`` default to ``cuda`` and, with no card, raise instead of
    running on the CPU."""
    from alaz_tpu_torch.config import MeshConfig
    from alaz_tpu_torch.parallel import multislice
    from alaz_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: make_mesh(),
        lambda: multislice.make_hybrid_mesh(MeshConfig()),
        lambda: multislice.initialize_distributed("localhost:1", 1, 0),
        lambda: multislice.spawn(print, 1),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_single_process_is_a_no_op(monkeypatch):
    """One process and no coordinator: nothing to initialize, one host."""
    from alaz_tpu_torch.parallel import multislice

    for var in ("ALAZ_TPU_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    multislice.initialize_distributed()
    assert not torch.distributed.is_initialized()
    assert multislice.slice_count() == 1


def test_a_failing_rank_fails_the_spawn():
    """A rank that raises stops the run and its traceback reaches the
    caller, instead of leaving the others waiting in a collective."""
    from alaz_tpu_torch.parallel import multislice

    with pytest.raises(RuntimeError, match="rank 1 failed"):
        multislice.spawn(_fail_on_rank_one, 2, device="cpu", timeout_s=60.0)


def _fail_on_rank_one():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one gives up")
    dist.barrier()  # rank 0 would wait here for ever
