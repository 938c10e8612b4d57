"""Reverse-DNS cache for outbound destination naming.

The reference names third-party destinations via reverse DNS with a
5-minute cache / 10-minute purge (getHostnameFromIP + reverseDnsCache,
aggregator/data.go:113-122,1390-1405), falling back to the IP string.
Lookups are gated (off by default — zero-egress test environments, and the
reference itself treats DNS failure as routine) and never block the hot
path: misses resolve to the IP string immediately and a background thread
fills the cache for later batches.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Dict, Optional

from alaz_tpu_torch.config import env_bool
from alaz_tpu_torch.events.net import u32_to_ip

DEFAULT_TTL_S = 300.0  # defaultExpiration (data.go:113)


def enabled() -> bool:
    return env_bool("REVERSE_DNS_ENABLED", False)


class ReverseDnsCache:
    def __init__(self, ttl_s: float = DEFAULT_TTL_S, do_lookups: Optional[bool] = None):
        self.ttl_s = ttl_s
        self.do_lookups = enabled() if do_lookups is None else do_lookups
        self._cache: Dict[int, tuple[str, float]] = {}  # guarded-by: self._lock
        self._pending: set[int] = set()  # guarded-by: self._lock
        self._queue: "queue.Queue[int]" = queue.Queue()  # internally synchronized
        self._lock = threading.Lock()
        # worker handle: checked/respawned under the lock in name_for so
        # two hot-path callers can't both spawn one
        self._worker: Optional[threading.Thread] = None  # guarded-by: self._lock

    def name_for(self, ip_u32: int, now_s: Optional[float] = None) -> str:
        """Best current name: cached hostname, else the dotted IP (a single
        background worker fills the cache when lookups are on — never one
        thread per IP, never blocking this call)."""
        now_s = time.monotonic() if now_s is None else now_s
        with self._lock:
            hit = self._cache.get(ip_u32)
            if hit is not None and now_s - hit[1] < self.ttl_s:
                return hit[0]
            if self.do_lookups and ip_u32 not in self._pending:
                self._pending.add(ip_u32)
                self._queue.put(ip_u32)
                if self._worker is None or not self._worker.is_alive():
                    self._worker = threading.Thread(
                        target=self._worker_loop, name="alaz-rdns", daemon=True
                    )
                    self._worker.start()
        return u32_to_ip(ip_u32)

    def _worker_loop(self) -> None:
        while True:
            try:
                ip_u32 = self._queue.get(timeout=30)
            except queue.Empty:
                return  # worker retires when idle; respawned on demand
            ip = u32_to_ip(ip_u32)
            try:
                host = socket.gethostbyaddr(ip)[0]
            except OSError:
                host = ip  # negative-cache the failure as the IP itself
            with self._lock:
                self._cache[ip_u32] = (host, time.monotonic())
                self._pending.discard(ip_u32)

    def put(self, ip_u32: int, name: str, now_s: Optional[float] = None) -> None:
        with self._lock:
            self._cache[ip_u32] = (name, time.monotonic() if now_s is None else now_s)

    def purge(self, now_s: Optional[float] = None) -> int:
        """Drop expired entries (the 10-minute purgeTime sweep)."""
        now_s = time.monotonic() if now_s is None else now_s
        with self._lock:
            dead = [k for k, (_, t) in self._cache.items() if now_s - t >= self.ttl_s]
            for k in dead:
                del self._cache[k]
            return len(dead)
