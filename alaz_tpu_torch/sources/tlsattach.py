"""TLS attachment tracking — the uprobe-attach queue analog
(collector.go:276-317 + ebpf/ssllib.go).

The reference dedups attach requests per pid (tlsPidMap), discovers the
process's TLS library from /proc/<pid>/maps (libssl flavors incl. the
"(deleted)" edge case, ssllib.go:9-80), and dispatches version-specific
uprobes. In this build the "attachment" marks a pid whose decrypted
traffic a capture adapter should label tls=1; the discovery/dedup
contract is kept so a live agent can drive real attach hooks through
``on_attach``.
"""

from __future__ import annotations

import re
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

from alaz_tpu_torch.logging import get_logger

log = get_logger("alaz_tpu.tls")

# libssl flavors, matching the reference's regex set (ssllib.go:9-40):
# libssl.so[.version], libssl3.so, and deleted-but-mapped libraries
_LIBSSL_RE = re.compile(
    r"(?P<path>/[^\s]*libssl(?P<flavor>3)?\.so(?:\.(?P<version>[0-9][0-9.]*))?)"
    r"(?P<deleted>\s+\(deleted\))?"
)


def find_ssl_lib(maps_text: str) -> Optional[dict]:
    """Parse /proc/<pid>/maps content → {path, version, deleted} or None."""
    best = None
    for line in maps_text.splitlines():
        m = _LIBSSL_RE.search(line)
        if not m:
            continue
        version = m.group("version") or ("3" if m.group("flavor") else "")
        cand = {
            "path": m.group("path"),
            "version": version,
            "deleted": bool(m.group("deleted")),
        }
        if best is None or (best["deleted"] and not cand["deleted"]):
            best = cand
    return best


def ssl_version_family(version: str) -> str:
    """semver-dispatch buckets (collector.go:577-657): 1.0.2 / 1.1.1 / 3.x."""
    if version.startswith("3"):
        return "v3"
    if version.startswith("1.1"):
        return "v1.1.1"
    if version.startswith("1.0"):
        return "v1.0.2"
    return "unknown"


class TlsAttachTracker:
    def __init__(
        self,
        on_attach: Optional[Callable[[int, dict], None]] = None,
        proc_root: str | Path = "/proc",
    ):
        self.on_attach = on_attach
        self.proc_root = Path(proc_root)
        self.attached: Dict[int, dict] = {}
        # pids whose exe was already checked and is NOT a Go TLS user: a
        # process's binary never gains buildinfo later, so the negative
        # result is permanent (unlike libssl, which can dlopen late) —
        # without this every retried signal re-reads a up-to-200MB exe
        self._not_go: set[int] = set()
        self._lock = threading.Lock()

    def signal(self, pid: int) -> bool:
        """Request attachment for a pid; dedup per pid (tlsPidMap).
        Returns True if this call performed an attachment. A failed
        discovery (no libssl mapped *yet* — dlopen, slow start) is NOT
        cached, so later signals retry."""
        with self._lock:
            if pid in self.attached:
                return False
            self.attached[pid] = {}  # reserve before the slow path
        info = self._discover(pid)
        with self._lock:
            if pid not in self.attached:
                return False  # concurrently detached: don't resurrect
            if not info:
                del self.attached[pid]  # retry on the next signal
                return False
            self.attached[pid] = info
        if self.on_attach is not None:
            self.on_attach(pid, info)
        return True

    def detach(self, pid: int) -> None:
        with self._lock:
            self.attached.pop(pid, None)
            self._not_go.discard(pid)  # a reused pid is a different exe

    def _discover(self, pid: int) -> dict:
        maps_path = self.proc_root / str(pid) / "maps"
        try:
            text = maps_path.read_text()
        except OSError:
            return {}
        lib = find_ssl_lib(text)
        if lib is not None:
            lib["family"] = ssl_version_family(lib["version"])
            return lib
        # no libssl mapped: maybe a Go binary using crypto/tls — resolve
        # the uprobe plan from the executable's ELF (collector.go:319-516)
        with self._lock:
            if pid in self._not_go:
                return {}
        from alaz_tpu_torch.sources.gotls import discover_go_tls

        exe = self.proc_root / str(pid) / "exe"
        plan = discover_go_tls(exe) if exe.exists() else None
        if plan is None:
            with self._lock:
                self._not_go.add(pid)
            return {}
        return {
            "path": str(exe),
            "version": plan.go_version,
            "deleted": False,
            "family": "go-tls",
            "plan": plan,
        }
