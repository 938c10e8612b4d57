"""GPU environment metrics from NVML — Alaz's own NVML collector (power,
clocks, fan, temperature; gpu/collector.go), the counterpart of the JAX
package's ``runtime/tpu_env.py TpuEnvCollector``.

``libnvidia-ml.so.1`` is bound with ``ctypes`` (no pynvml): one sweep
reads, for every device NVML enumerates, the legs in ``metric_names``.
The three default legs export under the JAX package's gauge names, so a
dashboard reads one name on either accelerator:

- ``utilization.gpu`` → ``device<i>.tensorcore_duty_cycle_pct``: the
  share of the last sample period in which a kernel ran;
- ``memory.used`` → ``device<i>.runtime_hbm_used_bytes``;
- ``memory.total`` → ``device<i>.runtime_hbm_total_bytes``.

The extras are ``power.draw`` → ``power_draw_w``, ``clocks.sm`` →
``sm_clock_mhz``, ``temperature.gpu`` → ``temperature_c`` and
``fan.speed`` → ``fan_pct``. The leg names are ``nvidia-smi
--query-gpu``'s fields. A leg NVML answers ``NOT_SUPPORTED`` (or any
other error) for is absent from the sweep, never zero: an SXM card has
no fan. Device keys are NVML's indices, which ``nvidia-smi`` lists in
the same order.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, Optional

from alaz_tpu_torch.logging import get_logger

log = get_logger("alaz_tpu.gpu_env")

LIBRARY = "libnvidia-ml.so.1"

NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3
NVML_CLOCK_SM = 1
NVML_TEMPERATURE_GPU = 0

METRIC_DUTY_CYCLE = "utilization.gpu"
METRIC_HBM_USED = "memory.used"
METRIC_HBM_TOTAL = "memory.total"
METRIC_POWER = "power.draw"
METRIC_SM_CLOCK = "clocks.sm"
METRIC_TEMPERATURE = "temperature.gpu"
METRIC_FAN = "fan.speed"

DEFAULT_METRICS = (METRIC_DUTY_CYCLE, METRIC_HBM_USED, METRIC_HBM_TOTAL)
EXTRA_METRICS = (METRIC_POWER, METRIC_SM_CLOCK, METRIC_TEMPERATURE, METRIC_FAN)

# leg -> gauge suffix: the defaults under the JAX package's names
_GAUGE_NAMES = {
    METRIC_DUTY_CYCLE: "tensorcore_duty_cycle_pct",
    METRIC_HBM_USED: "runtime_hbm_used_bytes",
    METRIC_HBM_TOTAL: "runtime_hbm_total_bytes",
    METRIC_POWER: "power_draw_w",
    METRIC_SM_CLOCK: "sm_clock_mhz",
    METRIC_TEMPERATURE: "temperature_c",
    METRIC_FAN: "fan_pct",
}


class NvmlError(RuntimeError):
    def __init__(self, call: str, code: int):
        super().__init__(f"{call}: NVML error {code}")
        self.call, self.code = call, code


class _Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong), ("used", ctypes.c_ulonglong)]


def gauge_suffix(metric_name: str) -> str:
    """utilization.gpu → tensorcore_duty_cycle_pct; an unknown leg's dots
    become underscores."""
    return _GAUGE_NAMES.get(metric_name, metric_name.replace(".", "_"))


def _check(call: str, rc: int) -> None:
    if rc != NVML_SUCCESS:
        raise NvmlError(call, rc)


def _read(lib, handle, metric: str) -> float:
    """One leg of one device; raises NvmlError where NVML refuses it."""
    if metric == METRIC_DUTY_CYCLE:
        u = _Utilization()
        _check("nvmlDeviceGetUtilizationRates", lib.nvmlDeviceGetUtilizationRates(handle, ctypes.pointer(u)))
        return float(u.gpu)
    if metric in (METRIC_HBM_USED, METRIC_HBM_TOTAL):
        m = _Memory()
        _check("nvmlDeviceGetMemoryInfo", lib.nvmlDeviceGetMemoryInfo(handle, ctypes.pointer(m)))
        return float(m.used if metric == METRIC_HBM_USED else m.total)
    v = ctypes.c_uint(0)
    if metric == METRIC_POWER:
        _check("nvmlDeviceGetPowerUsage", lib.nvmlDeviceGetPowerUsage(handle, ctypes.pointer(v)))
        return v.value / 1000.0  # mW
    if metric == METRIC_SM_CLOCK:
        _check("nvmlDeviceGetClockInfo", lib.nvmlDeviceGetClockInfo(handle, NVML_CLOCK_SM, ctypes.pointer(v)))
        return float(v.value)
    if metric == METRIC_TEMPERATURE:
        _check("nvmlDeviceGetTemperature",
               lib.nvmlDeviceGetTemperature(handle, NVML_TEMPERATURE_GPU, ctypes.pointer(v)))
        return float(v.value)
    if metric == METRIC_FAN:
        _check("nvmlDeviceGetFanSpeed", lib.nvmlDeviceGetFanSpeed(handle, ctypes.pointer(v)))
        return float(v.value)
    raise ValueError(f"unknown NVML leg {metric!r}")


class GpuEnvCollector:
    """Samples NVML, caching one sweep per ``min_interval_s`` so a
    Prometheus scrape of N gauges costs one sweep, not N. ``lib`` is the
    NVML library (loaded from ``LIBRARY`` when None), or any object with
    its functions."""

    def __init__(
        self,
        metric_names: tuple | None = None,
        min_interval_s: float = 5.0,
        lib=None,
    ):
        self.metric_names = tuple(metric_names or DEFAULT_METRICS + EXTRA_METRICS)
        self.min_interval_s = min_interval_s
        self._lib = lib
        self._handles: Optional[list] = None
        self._cache: Dict[str, Dict[int, float]] = {}
        self._last_sweep = 0.0

    def _open(self) -> list:
        """The device handles, NVML initialized and enumerated once.
        Raises OSError where the library cannot load, NvmlError where
        NVML refuses to start."""
        if self._handles is not None:
            return self._handles
        lib = self._lib if self._lib is not None else ctypes.CDLL(LIBRARY)
        _check("nvmlInit_v2", lib.nvmlInit_v2())
        count = ctypes.c_uint(0)
        _check("nvmlDeviceGetCount_v2", lib.nvmlDeviceGetCount_v2(ctypes.pointer(count)))
        handles = []
        for i in range(count.value):
            h = ctypes.c_void_p()
            _check("nvmlDeviceGetHandleByIndex_v2", lib.nvmlDeviceGetHandleByIndex_v2(i, ctypes.pointer(h)))
            handles.append(h)
        self._lib, self._handles = lib, handles
        return handles

    def sample(self) -> Dict[str, Dict[int, float]]:
        """{leg: {device index: value}} for every configured leg NVML
        answers; a refused leg is left out for that device."""
        handles = self._open()
        out: Dict[str, Dict[int, float]] = {}
        for name in self.metric_names:
            per_dev: Dict[int, float] = {}
            for i, h in enumerate(handles):
                try:
                    per_dev[i] = _read(self._lib, h, name)
                except NvmlError as exc:
                    if exc.code != NVML_ERROR_NOT_SUPPORTED:
                        log.debug(f"nvml leg {name} device {i}: {exc}")
            if per_dev:
                out[name] = per_dev
        return out

    def _sweep_cached(self) -> Dict[str, Dict[int, float]]:
        now = time.monotonic()
        if now - self._last_sweep >= self.min_interval_s:
            self._last_sweep = now
            try:
                self._cache = self.sample()
            except (OSError, NvmlError) as exc:
                log.debug(f"nvml sweep failed: {exc}")
                self._cache = {}
        return self._cache

    def register(self, metrics) -> bool:
        """Probe once; when NVML answers, register one gauge per (leg,
        device) seen. Returns False (and registers nothing) where the
        library cannot load or answers nothing — CPU hosts, tests."""
        try:
            first = self.sample()
        except (OSError, NvmlError) as exc:
            log.debug(f"nvml unavailable: {exc}")
            return False
        if not first:
            return False
        self._cache, self._last_sweep = first, time.monotonic()
        for name, per_dev in first.items():
            for dev in per_dev:
                def fn(n=name, d=dev):
                    return self._sweep_cached().get(n, {}).get(d, float("nan"))

                metrics.gauge(f"device{dev}.{gauge_suffix(name)}", fn)
        log.info(
            f"gpu env gauges: {len(first)} legs x "
            f"{max(len(v) for v in first.values())} devices from {LIBRARY}"
        )
        return True
