"""Per-stage counters and gauges.

The reference logs channel lag every 2 minutes (data.go:177-186), keeps
dropped-event counters (l7.go:681-687), and exports node metrics through
an embedded Prometheus exporter (backend.go:1038-1105). This registry is
the analog: counters/gauges with a Prometheus-text rendering and a
snapshot dict for the health/metrics push path.
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
from typing import Callable, Dict

from alaz_tpu_torch.obs.histogram import Histogram


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    __slots__ = ("name", "_fn", "_value", "_on_error")

    def __init__(self, name: str, fn: Callable[[], float] | None = None):
        self.name = name
        self._fn = fn
        self._value = 0.0
        # wired by the registry: a raising callback used to render `nan`
        # into the Prometheus text SILENTLY — now every failed read bumps
        # metrics.gauge_errors and the exposition skips the NaN sample
        # (; scrapers reject NaN-bearing series anyway)
        self._on_error: Callable[[], None] | None = None

    def set(self, v: float) -> None:
        self._value = float(v)

    def _count_error(self) -> None:
        if self._on_error is not None:
            try:
                self._on_error()
            except Exception:
                pass

    @property
    def value(self) -> float:
        # NaN is an error signal however it arrives — a raising
        # callback, a callback computing 0/0, or a direct set(nan) —
        # and every read of one bumps metrics.gauge_errors, so the
        # sample's disappearance from snapshot/exposition is never silent
        if self._fn is not None:
            try:
                v = float(self._fn())
            except Exception:
                self._count_error()
                return float("nan")
        else:
            v = self._value
        if math.isnan(v):
            self._count_error()
        return v


class Metrics:
    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}  # guarded-by: self._lock
        self._gauges: Dict[str, Gauge] = {}  # guarded-by: self._lock
        self._infos: Dict[str, Dict[str, str]] = {}
        self._histograms: Dict[str, Histogram] = {}  # guarded-by: self._lock
        # sparse histograms (the per-bucket labeled series):
        # registered lazily per shape bucket, OMITTED from snapshot and
        # exposition while their count is zero — the same discipline the
        # gauge-error path applies to NaN samples: a series that has
        # nothing to say is absent, never an empty/nan render
        self._sparse: set = set()  # guarded-by: self._lock
        self._lock = threading.Lock()
        self.started_at = time.time()
        # registered through the public surface so the golden registry
        # carries the name like any other metric (ALZ044's scanner
        # recognizes self-registrations inside this class)
        self._gauge_errors = self.counter("metrics.gauge_errors")

    def info(self, name: str, **labels: str) -> None:
        """Static labeled info metric (the gpu_info/gpu_driver pattern,
        gpu/collector.go:95-100: a gauge fixed at 1 carrying labels)."""
        with self._lock:
            self._infos[name] = dict(labels)

    def infos(self) -> Dict[str, Dict[str, str]]:
        with self._lock:
            return {k: dict(v) for k, v in self._infos.items()}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = Counter(name)
                self._counters[name] = c
            return c

    def gauge(self, name: str, fn: Callable[[], float] | None = None) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = Gauge(name, fn)
                g._on_error = self._gauge_errors.inc
                self._gauges[name] = g
            elif fn is not None:
                g._fn = fn
            return g

    def histogram(self, name: str, sparse: bool = False, bounds=None) -> Histogram:
        """Lock-striped log-bucket latency histogram (obs/histogram.py):
        p50/p95/p99 land in the snapshot, the full cumulative-bucket
        exposition in the Prometheus text. ``sparse=True`` (the
        per-bucket labeled series — ``latency.score_s.<bucket>``,
        ``device.occupancy.<bucket>``) omits the series everywhere while
        it has zero observations; fixed-name histograms stay rendered so
        dashboards can key on their presence. ``bounds`` overrides the
        geometric latency ladder at FIRST registration (linear ratios
        like occupancy misread on a 2x ladder); later lookups return the
        existing instance unchanged."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = Histogram(name, bounds=bounds)
                self._histograms[name] = h
            if sparse:
                self._sparse.add(name)
            return h

    def histograms(self, include_empty_sparse: bool = True) -> Dict[str, Histogram]:
        with self._lock:
            out = dict(self._histograms)
            sparse = set(self._sparse)
        if not include_empty_sparse:
            # total_count takes the stripe locks — outside the registry lock
            for n in sparse:
                if n in out and out[n].total_count == 0:
                    del out[n]
        return out

    def snapshot(self, histograms: bool = True) -> dict:
        with self._lock:
            out = {n: c.value for n, c in self._counters.items()}
            for n, g in self._gauges.items():
                v = g.value
                if isinstance(v, float) and math.isnan(v):
                    # already counted into metrics.gauge_errors by the
                    # value read (raising OR NaN-computing callbacks,
                    # and set(nan)): skip the sample — a bare NaN token
                    # in the health-push JSON would make a strict RFC
                    # 8259 consumer reject the whole payload
                    continue
                out[n] = v
            hists = list(self._histograms.items()) if histograms else ()
            sparse = set(self._sparse)
            out["uptime_s"] = time.time() - self.started_at
        # histogram percentile walks happen outside the registry lock
        # (they take the stripe locks; the registry lock stays cheap)
        for n, h in hists:
            snap = h.snapshot()
            if snap["count"] == 0 and n in sparse:
                # empty per-bucket series: absent, not zero-rendered
                continue
            out[f"{n}.count"] = snap["count"]
            out[f"{n}.p50"] = snap["p50"]
            out[f"{n}.p95"] = snap["p95"]
            out[f"{n}.p99"] = snap["p99"]
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (the :8182/inner/metrics analog).
        Histograms render as real histogram series (cumulative buckets +
        sum + count); NaN gauge samples are SKIPPED, not emitted — a
        raising gauge callback already counted into metrics.gauge_errors
        when its value was read."""
        lines = []
        # snapshot() already skips NaN gauge samples (shared with the
        # health-push JSON path, which must stay strict-RFC-parseable)
        for name, value in sorted(self.snapshot(histograms=False).items()):
            metric = "alaz_tpu_" + name.replace(".", "_").replace("-", "_")
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {value}")
        # empty sparse (per-bucket) series stay out of the scrape — the
        # fixed-name histograms render even at zero so dashboards can
        # key on their presence
        for name, h in sorted(self.histograms(include_empty_sparse=False).items()):
            metric = "alaz_tpu_" + name.replace(".", "_").replace("-", "_")
            lines.extend(h.render_prometheus(metric))
        def esc(v) -> str:
            # exposition format: backslash, double-quote and newline must
            # be escaped inside label values or the scrape line is invalid
            return (
                str(v)
                .replace("\\", "\\\\")
                .replace('"', '\\"')
                .replace("\n", "\\n")
            )

        for name, labels in sorted(self.infos().items()):
            metric = "alaz_tpu_" + name.replace(".", "_").replace("-", "_")
            label_str = ",".join(
                f'{k}="{esc(v)}"' for k, v in sorted(labels.items())
            )
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric}{{{label_str}}} 1")
        return "\n".join(lines) + "\n"


def ledger_gauges(metrics: Metrics, ledger) -> None:
    """Surface the unified drop ledger (utils/ledger.py, ISSUE 6):
    one gauge per loss cause plus the grand total, so a degraded-mode
    incident reads as WHICH failure mode is eating rows (queue drops vs
    lateness vs quarantined frames vs deliberate shedding) instead of a
    single opaque drop counter."""
    for cause in ledger.CAUSES:
        metrics.gauge(f"ledger.{cause}", lambda c=cause: ledger.count(c))
    metrics.gauge("ledger.total", lambda: ledger.total)


def host_gauges(metrics: Metrics) -> None:
    """Node metrics — the embedded node_exporter scrape analog
    (backend.go:1038-1105): process, memory, load, cpu, network, disk and
    fd gauges from /proc, pushed to the backend via the metrics-scrape
    leg and with the health payload."""

    def rss_bytes() -> float:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return float(line.split()[1]) * 1024
        except OSError:
            pass
        return 0.0

    def meminfo(field: str) -> float:
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith(field + ":"):
                        return float(line.split()[1]) * 1024
        except OSError:
            pass
        return 0.0

    def loadavg(idx: int) -> float:
        try:
            return float(open("/proc/loadavg").read().split()[idx])
        except OSError:
            return 0.0

    def stat_field(prefix: str, idx: int, scale: float = 1.0) -> float:
        """One numeric column of a /proc/stat line (cpu jiffies → seconds
        via USER_HZ=100, the node_exporter cpu collector fields)."""
        try:
            with open("/proc/stat") as f:
                for line in f:
                    if line.startswith(prefix + " ") or line.startswith(prefix + "  "):
                        return float(line.split()[idx]) * scale
        except OSError:
            pass
        return 0.0

    def net_bytes(col: int) -> float:
        """Sum of rx (col 1) / tx (col 9) bytes over non-loopback
        interfaces (/proc/net/dev; the netdev collector)."""
        total = 0.0
        try:
            with open("/proc/net/dev") as f:
                for line in f.readlines()[2:]:
                    name, _, rest = line.partition(":")
                    if name.strip() == "lo":
                        continue
                    cols = rest.split()
                    if len(cols) > col:
                        total += float(cols[col])
        except OSError:
            return 0.0
        return total

    def disk(field: str) -> float:
        try:
            st = os.statvfs("/")
        except OSError:
            return 0.0
        if field == "total":
            return float(st.f_blocks * st.f_frsize)
        return float((st.f_blocks - st.f_bfree) * st.f_frsize)

    def open_fds() -> float:
        try:
            return float(len(os.listdir("/proc/self/fd")))
        except OSError:
            return 0.0

    def boot_uptime() -> float:
        try:
            return float(open("/proc/uptime").read().split()[0])
        except OSError:
            return 0.0

    def vmstat(field: str) -> float:
        """/proc/vmstat counters (the node_exporter vmstat collector)."""
        try:
            with open("/proc/vmstat") as f:
                for line in f:
                    if line.startswith(field + " "):
                        return float(line.split()[1])
        except OSError:
            pass
        return 0.0

    # partitions, not whole devices: sda1 / vdb2 / nvme0n1p3 / mmcblk0p1.
    # A bare trailing-digit check would also drop whole NVMe/eMMC devices
    # (nvme0n1, mmcblk0) — the common case on modern nodes.
    part_re = re.compile(
        r"^(?:(?:h|s|v|xv)d[a-z]+\d+|nvme\d+n\d+p\d+|mmcblk\d+p\d+)$"
    )

    def diskstats(col: int) -> float:
        """Sum of one /proc/diskstats column over whole devices (the
        diskstats collector). col 3=reads, 7=writes, 5/9=sectors,
        12=io_time_ms."""
        total = 0.0
        try:
            with open("/proc/diskstats") as f:
                for line in f:
                    cols = line.split()
                    if len(cols) <= col:
                        continue
                    name = cols[2]
                    if name.startswith(("loop", "ram", "dm-", "sr", "fd")):
                        continue
                    if part_re.match(name):
                        continue
                    total += float(cols[col])
        except OSError:
            return 0.0
        return total

    def sockstat(proto: str, field: str) -> float:
        """/proc/net/sockstat (the sockstat collector): TCP inuse/orphan/
        tw, UDP inuse — the reference joins on live socket state, so
        kernel socket-table pressure is first-order here."""
        try:
            with open("/proc/net/sockstat") as f:
                for line in f:
                    if line.startswith(proto + ":"):
                        parts = line.split()
                        for i, tok in enumerate(parts):
                            if tok == field and i + 1 < len(parts):
                                return float(parts[i + 1])
        except OSError:
            pass
        return 0.0

    def file_nr(idx: int) -> float:
        """/proc/sys/fs/file-nr: allocated (0) and max (2) file handles
        system-wide (the filefd collector)."""
        try:
            return float(open("/proc/sys/fs/file-nr").read().split()[idx])
        except OSError:
            return 0.0

    def psi(resource: str) -> float:
        """PSI avg10 'some' pressure percentage (the pressure
        collector); 0 where the kernel lacks CONFIG_PSI."""
        try:
            with open(f"/proc/pressure/{resource}") as f:
                for line in f:
                    if line.startswith("some"):
                        for tok in line.split():
                            if tok.startswith("avg10="):
                                return float(tok[6:])
        except OSError:
            pass
        return 0.0

    metrics.gauge("host.process_rss_bytes", rss_bytes)
    metrics.gauge("host.mem_available_bytes", lambda: meminfo("MemAvailable"))
    metrics.gauge("host.mem_total_bytes", lambda: meminfo("MemTotal"))
    metrics.gauge("host.mem_cached_bytes", lambda: meminfo("Cached"))
    metrics.gauge("host.mem_buffers_bytes", lambda: meminfo("Buffers"))
    metrics.gauge("host.swap_total_bytes", lambda: meminfo("SwapTotal"))
    metrics.gauge("host.swap_free_bytes", lambda: meminfo("SwapFree"))
    metrics.gauge("host.load1", lambda: loadavg(0))
    metrics.gauge("host.load5", lambda: loadavg(1))
    metrics.gauge("host.load15", lambda: loadavg(2))
    metrics.gauge("host.cpu_user_s", lambda: stat_field("cpu", 1, 0.01))
    metrics.gauge("host.cpu_system_s", lambda: stat_field("cpu", 3, 0.01))
    metrics.gauge("host.cpu_idle_s", lambda: stat_field("cpu", 4, 0.01))
    metrics.gauge("host.cpu_iowait_s", lambda: stat_field("cpu", 5, 0.01))
    metrics.gauge("host.cpu_steal_s", lambda: stat_field("cpu", 8, 0.01))
    metrics.gauge("host.context_switches", lambda: stat_field("ctxt", 1))
    metrics.gauge("host.forks_total", lambda: stat_field("processes", 1))
    metrics.gauge("host.procs_running", lambda: stat_field("procs_running", 1))
    metrics.gauge("host.procs_blocked", lambda: stat_field("procs_blocked", 1))
    metrics.gauge("host.net_rx_bytes", lambda: net_bytes(0))
    metrics.gauge("host.net_tx_bytes", lambda: net_bytes(8))
    metrics.gauge("host.net_rx_errors", lambda: net_bytes(2))
    metrics.gauge("host.net_rx_dropped", lambda: net_bytes(3))
    metrics.gauge("host.net_tx_errors", lambda: net_bytes(10))
    metrics.gauge("host.net_tx_dropped", lambda: net_bytes(11))
    metrics.gauge("host.disk_used_bytes", lambda: disk("used"))
    metrics.gauge("host.disk_total_bytes", lambda: disk("total"))
    metrics.gauge("host.disk_reads_completed", lambda: diskstats(3))
    metrics.gauge("host.disk_writes_completed", lambda: diskstats(7))
    metrics.gauge("host.disk_read_sectors", lambda: diskstats(5))
    metrics.gauge("host.disk_written_sectors", lambda: diskstats(9))
    metrics.gauge("host.disk_io_time_ms", lambda: diskstats(12))
    metrics.gauge("host.pgfault", lambda: vmstat("pgfault"))
    metrics.gauge("host.pgmajfault", lambda: vmstat("pgmajfault"))
    metrics.gauge("host.sockets_tcp_inuse", lambda: sockstat("TCP", "inuse"))
    metrics.gauge("host.sockets_tcp_orphan", lambda: sockstat("TCP", "orphan"))
    metrics.gauge("host.sockets_tcp_tw", lambda: sockstat("TCP", "tw"))
    metrics.gauge("host.sockets_udp_inuse", lambda: sockstat("UDP", "inuse"))
    metrics.gauge("host.filefd_allocated", lambda: file_nr(0))
    metrics.gauge("host.filefd_maximum", lambda: file_nr(2))
    metrics.gauge("host.pressure_cpu_avg10", lambda: psi("cpu"))
    metrics.gauge("host.pressure_memory_avg10", lambda: psi("memory"))
    metrics.gauge("host.pressure_io_avg10", lambda: psi("io"))
    metrics.gauge("host.open_fds", open_fds)
    metrics.gauge("host.boot_uptime_s", boot_uptime)


# per-device memory gauges under the JAX package's names, each read from
# the CUDA caching allocator's statistics (torch.cuda.memory_stats) or
# the driver (torch.cuda.mem_get_info): gauge name -> reader(device index)
def _cuda_stat(key: str):
    import torch

    return lambda i: torch.cuda.memory_stats(i).get(key, 0)


def _cuda_total(i: int) -> float:
    import torch

    return torch.cuda.get_device_properties(i).total_memory


def _cuda_free(i: int) -> float:
    import torch

    return torch.cuda.mem_get_info(i)[0]


_DEVICE_MEM_KEYS = (
    ("hbm_bytes_in_use", _cuda_stat("allocated_bytes.all.current")),
    ("hbm_peak_bytes_in_use", _cuda_stat("allocated_bytes.all.peak")),
    ("hbm_bytes_limit", _cuda_total),
    ("hbm_bytes_reservable_limit", _cuda_total),
    # the driver's free bytes: the allocator reports no largest free block
    ("hbm_largest_free_block_bytes", _cuda_free),
    ("hbm_largest_alloc_bytes", _cuda_stat("requested_bytes.all.peak")),
    ("num_allocs", _cuda_stat("allocation.all.allocated")),
    ("pool_bytes", _cuda_stat("reserved_bytes.all.current")),
)


def device_gauges(metrics: Metrics, device=None) -> None:
    """Accelerator gauges under the JAX package's names (the NVML
    collector analog): per-device memory gauges from the CUDA caching
    allocator, ``device<i>.hbm_utilization_pct`` — the allocator's
    allocated bytes over the card's capacity, an occupancy and not a
    bandwidth, under the JAX package's name — and device identity info,
    for every visible card when ``device`` is a CUDA device, and — where
    NVML answers — the environment legs of ``runtime/gpu_env.py``
    (kernel duty cycle and device memory under the TPU runtime's gauge
    names, power, SM clock, temperature, fan), where the JAX package
    registers its ``TpuEnvCollector``. On the CPU one ``device0`` with
    zero memory, as the JAX package reports a host device without memory
    statistics, and no NVML legs. The compute-side gauge is the scorer
    duty cycle the service registers."""
    import torch

    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        from alaz_tpu_torch.runtime.gpu_env import GpuEnvCollector

        GpuEnvCollector().register(metrics)
        count = torch.cuda.device_count()
        for i in range(count):
            for gauge_name, read in _DEVICE_MEM_KEYS:
                metrics.gauge(f"device{i}.{gauge_name}", lambda i=i, read=read: read(i))

            def utz_fn(i=i):
                limit = _cuda_total(i)
                used = torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0)
                return 100.0 * used / limit if limit else 0.0

            metrics.gauge(f"device{i}.hbm_utilization_pct", utz_fn)
            metrics.info(
                f"device{i}.info",
                kind=torch.cuda.get_device_name(i),
                platform="gpu",
                id=str(i),
            )
    else:
        count = 1
        for gauge_name, _ in _DEVICE_MEM_KEYS:
            metrics.gauge(f"device0.{gauge_name}", lambda: 0)
        metrics.gauge("device0.hbm_utilization_pct", lambda: 0.0)
        metrics.info("device0.info", kind="cpu", platform="cpu", id="0")
    metrics.gauge("device.count", lambda: count)
    metrics.info(
        "device.runtime",
        backend=dev.type,
        torch_version=torch.__version__,
    )
