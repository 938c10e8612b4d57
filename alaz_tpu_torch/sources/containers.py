"""Container index — the cri/CRITool analog (G20) + the container-pid sync
loop (G3, collector.go:127-209).

The reference asks the CRI for running containers, resolves each to its
pid set via cgroup walks (cri.go:160-233), filters namespaces (kube-system
excluded by default, cri.go:75-98), and every 30s diffs old/new pid sets,
pushing updates into the kernel ``container_pids`` map and synthesizing
exec/exit proc events. Here the index keeps the same contract against a
pluggable lister: live mode reads /proc + cgroup files when running on a
node; tests register containers programmatically. The diff loop emits the
same synthetic proc events into the Service.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Set

import numpy as np

from alaz_tpu_torch.events.schema import PROC_EVENT_DTYPE, ProcEventType
from alaz_tpu_torch.logging import get_logger

log = get_logger("alaz_tpu.containers")

DEFAULT_EXCLUDED_NAMESPACES = {"kube-system"}


@dataclass
class ContainerInfo:
    container_id: str
    name: str = ""
    namespace: str = "default"
    pod_uid: str = ""
    pids: Set[int] = field(default_factory=set)
    log_path: str = ""


def cgroup_pids(cgroup_procs_path: str | Path) -> Set[int]:
    """Read a cgroup.procs file → pid set (the cgroup v1/v2 walk leaf,
    cri.go:192-233)."""
    try:
        text = Path(cgroup_procs_path).read_text()
    except OSError:
        return set()
    return {int(line) for line in text.split() if line.strip().isdigit()}


class ContainerIndex:
    def __init__(
        self,
        lister: Optional[Callable[[], Iterable[ContainerInfo]]] = None,
        exclude_namespaces: Iterable[str] = DEFAULT_EXCLUDED_NAMESPACES,
        sync_interval_s: float = 30.0,
    ):
        self.lister = lister
        self.exclude = set(exclude_namespaces)
        self.sync_interval_s = sync_interval_s
        self.containers: Dict[str, ContainerInfo] = {}
        self.container_pids: Set[int] = set()
        self._service = None  # lockless-ok: attach-once publication in start() before the sync thread exists; readers null-check an atomic reference swap
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- registration (tests / adapters) -----------------------------------

    def register(self, info: ContainerInfo) -> None:
        if info.namespace in self.exclude:
            return
        with self._lock:
            self.containers[info.container_id] = info

    def remove(self, container_id: str) -> None:
        with self._lock:
            self.containers.pop(container_id, None)

    def get_pids_running_on_containers(self) -> Set[int]:
        """The CRITool.GetPidsRunningOnContainers surface (cri.go:160)."""
        with self._lock:
            out: Set[int] = set()
            for c in self.containers.values():
                out |= c.pids
            return out

    def get_log_path(self, container_id: str) -> str:
        c = self.containers.get(container_id)
        return c.log_path if c else ""

    # -- the 30s diff loop (collector.go:137-197) ---------------------------

    def sync_once(self) -> tuple[Set[int], Set[int]]:
        """Diff current vs known pids → (added, removed); pushes synthetic
        EXEC/EXIT proc events into the service."""
        if self.lister is not None:
            with self._lock:
                self.containers = {
                    c.container_id: c
                    for c in self.lister()
                    if c.namespace not in self.exclude
                }
        new = self.get_pids_running_on_containers()
        added = new - self.container_pids
        removed = self.container_pids - new
        self.container_pids = new
        if self._service is not None and (added or removed):
            ev = np.zeros(len(added) + len(removed), dtype=PROC_EVENT_DTYPE)
            for i, pid in enumerate(sorted(added)):
                ev["pid"][i] = pid
                ev["type"][i] = ProcEventType.EXEC
            for j, pid in enumerate(sorted(removed)):
                ev["pid"][len(added) + j] = pid
                ev["type"][len(added) + j] = ProcEventType.EXIT
            self._service.submit_proc(ev)
        return added, removed

    def start(self, service) -> None:
        self._service = service
        self._stop.clear()

        def run() -> None:
            # sync immediately so startup containers attribute from second
            # one (the reference's loop also syncs before ticking)
            while True:
                try:
                    self.sync_once()
                except Exception as exc:
                    log.warning(f"container sync failed: {exc}")
                if self._stop.wait(self.sync_interval_s):
                    return

        self._thread = threading.Thread(target=run, name="alaz-containers", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
