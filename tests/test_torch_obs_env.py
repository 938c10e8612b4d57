"""The port's device-side environment and feed, on the CPU.

- ``runtime/gpu_env.py GpuEnvCollector`` (the NVML collector, the
  counterpart of the JAX package's ``runtime/tpu_env.py
  TpuEnvCollector``) over a stub library object standing in for
  ``libnvidia-ml.so.1``: the legs and their gauge names, a leg NVML
  refuses (absent, not zero), the sweep cache, and no library at all
  (``register`` False, no gauge).
- ``runtime/pipeline.py DevicePrefetcher`` on the CPU: the same windows,
  in order, with the same arrays as the JAX package's prefetcher yields
  for them.
"""

from __future__ import annotations

import numpy as np
import pytest

from alaz_tpu_torch.runtime import gpu_env
from alaz_tpu_torch.runtime.gpu_env import GpuEnvCollector
from alaz_tpu_torch.runtime.metrics import Metrics

NOT_SUPPORTED = gpu_env.NVML_ERROR_NOT_SUPPORTED


class StubNvml:
    """The NVML calls the collector makes, answering for ``n`` devices;
    ``refuse`` maps a call name to the NVML error it returns."""

    def __init__(self, n: int = 2, refuse: dict | None = None):
        self.n = n
        self.refuse = refuse or {}
        self.calls: list = []
        self.power_mw = 312_500

    def _answer(self, name: str) -> int:
        self.calls.append(name)
        return self.refuse.get(name, 0)

    def nvmlInit_v2(self):
        return self._answer("nvmlInit_v2")

    def nvmlDeviceGetCount_v2(self, count):
        count.contents.value = self.n
        return self._answer("nvmlDeviceGetCount_v2")

    def nvmlDeviceGetHandleByIndex_v2(self, i, handle):
        handle.contents.value = 0x1000 + i
        return self._answer("nvmlDeviceGetHandleByIndex_v2")

    @staticmethod
    def _dev(handle) -> int:
        return handle.value - 0x1000

    def nvmlDeviceGetUtilizationRates(self, handle, util):
        util.contents.gpu, util.contents.memory = 40 + self._dev(handle), 7
        return self._answer("nvmlDeviceGetUtilizationRates")

    def nvmlDeviceGetMemoryInfo(self, handle, mem):
        mem.contents.total = 85_520_809_984
        mem.contents.used = 1_000_000 * (1 + self._dev(handle))
        mem.contents.free = mem.contents.total - mem.contents.used
        return self._answer("nvmlDeviceGetMemoryInfo")

    def nvmlDeviceGetPowerUsage(self, handle, mw):
        mw.contents.value = self.power_mw
        return self._answer("nvmlDeviceGetPowerUsage")

    def nvmlDeviceGetClockInfo(self, handle, clock, mhz):
        assert clock == gpu_env.NVML_CLOCK_SM
        mhz.contents.value = 1980
        return self._answer("nvmlDeviceGetClockInfo")

    def nvmlDeviceGetTemperature(self, handle, sensor, c):
        assert sensor == gpu_env.NVML_TEMPERATURE_GPU
        c.contents.value = 41
        return self._answer("nvmlDeviceGetTemperature")

    def nvmlDeviceGetFanSpeed(self, handle, pct):
        pct.contents.value = 30
        return self._answer("nvmlDeviceGetFanSpeed")


def test_sample_reads_every_leg_of_every_device():
    lib = StubNvml(n=2)
    got = GpuEnvCollector(lib=lib).sample()
    assert got == {
        "utilization.gpu": {0: 40.0, 1: 41.0},
        "memory.used": {0: 1e6, 1: 2e6},
        "memory.total": {0: 85_520_809_984.0, 1: 85_520_809_984.0},
        "power.draw": {0: 312.5, 1: 312.5},
        "clocks.sm": {0: 1980.0, 1: 1980.0},
        "temperature.gpu": {0: 41.0, 1: 41.0},
        "fan.speed": {0: 30.0, 1: 30.0},
    }
    assert lib.calls.count("nvmlInit_v2") == 1


def test_register_uses_the_jax_packages_gauge_names_and_leaves_refused_legs_out():
    """An SXM card answers NOT_SUPPORTED for its fan: no fan gauge, not a
    zero one. The three default legs carry ``TpuEnvCollector``'s names."""
    from alaz_tpu.runtime import tpu_env

    m = Metrics()
    assert GpuEnvCollector(lib=StubNvml(n=1, refuse={"nvmlDeviceGetFanSpeed": NOT_SUPPORTED})).register(m)
    snap = m.snapshot()
    names = {k for k in snap if k.startswith("device0.")}
    jax_defaults = {f"device0.{tpu_env.gauge_suffix(n)}" for n in tpu_env.DEFAULT_METRICS}
    assert jax_defaults == {
        "device0.tensorcore_duty_cycle_pct", "device0.runtime_hbm_used_bytes", "device0.runtime_hbm_total_bytes",
    }
    assert names == jax_defaults | {"device0.power_draw_w", "device0.sm_clock_mhz", "device0.temperature_c"}
    assert snap["device0.power_draw_w"] == 312.5 and snap["device0.tensorcore_duty_cycle_pct"] == 40.0


def test_a_failing_leg_is_absent_on_that_device_only():
    class OneCardRefusesPower(StubNvml):
        def nvmlDeviceGetPowerUsage(self, handle, mw):
            mw.contents.value = 1
            return 999 if self._dev(handle) == 1 else 0

    got = GpuEnvCollector(lib=OneCardRefusesPower(n=2)).sample()
    assert got["power.draw"] == {0: 0.001}


def test_sweeps_are_cached_per_interval():
    lib = StubNvml(n=1)
    m = Metrics()
    col = GpuEnvCollector(lib=lib, min_interval_s=3600.0)
    assert col.register(m)
    sweeps = lib.calls.count("nvmlDeviceGetPowerUsage")
    lib.power_mw = 100_000
    for _ in range(5):
        assert m.snapshot()["device0.power_draw_w"] == 312.5  # cached
    assert lib.calls.count("nvmlDeviceGetPowerUsage") == sweeps
    col.min_interval_s = 0.0
    assert m.snapshot()["device0.power_draw_w"] == 100.0


def test_nvml_that_will_not_start_registers_nothing():
    m = Metrics()
    assert not GpuEnvCollector(lib=StubNvml(refuse={"nvmlInit_v2": 9})).register(m)
    assert not any(k.startswith("device") for k in m.snapshot())


def test_no_library_registers_nothing(monkeypatch):
    """Where ``libnvidia-ml.so.1`` cannot load (this host has none; the
    name is pointed at a missing file so the case holds on any host),
    ``register`` returns False and registers no gauge (absent, not zero),
    as ``TpuEnvCollector`` does where no TPU runtime answers."""
    monkeypatch.setattr(gpu_env, "LIBRARY", "libnvidia-ml-missing.so.1")
    m = Metrics()
    before = set(m.snapshot())
    assert not GpuEnvCollector().register(m)
    assert set(m.snapshot()) == before and not any(k.startswith("device") for k in before)


def test_cpu_service_registers_no_nvml_gauge():
    from alaz_tpu_torch.runtime.metrics import device_gauges

    m = Metrics()
    device_gauges(m, "cpu")
    assert not any(k.endswith(("_duty_cycle_pct", "power_draw_w")) for k in m.snapshot())


def _windows():
    from alaz_tpu_torch.replay.synth import example_batch

    return [example_batch(n_pods=60 + 20 * s, n_svcs=6, n_edges=300 + 100 * s, seed=s) for s in range(3)]


def test_prefetcher_yields_the_windows_in_order():
    import torch

    from alaz_tpu_torch.runtime.pipeline import DevicePrefetcher

    wins = _windows()
    got = list(DevicePrefetcher(iter(wins), device="cpu"))
    assert [b for b, _ in got] == wins
    for b, tensors in got:
        want = b.device_arrays()
        assert set(tensors) == set(want)
        for k, v in want.items():
            assert tensors[k].device == torch.device("cpu")
            assert np.array_equal(tensors[k].numpy(), v)
    assert list(DevicePrefetcher(iter([]), device="cpu")) == []


def test_prefetcher_arrays_equal_the_jax_prefetchers():
    """The JAX package's prefetcher over the same windows yields the same
    windows with the same arrays (its ``device_arrays()``)."""
    from alaz_tpu.graph.snapshot import GraphBatch as JaxBatch
    from alaz_tpu.runtime.pipeline import DevicePrefetcher as JaxPrefetcher
    from alaz_tpu_torch.runtime.pipeline import DevicePrefetcher

    wins = _windows()
    fields = [f for f in JaxBatch.__dataclass_fields__]
    jwins = [JaxBatch(**{f: getattr(b, f) for f in fields}) for b in wins]
    ours = list(DevicePrefetcher(wins, device="cpu"))
    theirs = list(JaxPrefetcher(jwins))
    assert len(ours) == len(theirs) == 3
    for (_, t), (_, j) in zip(ours, theirs):
        assert set(t) == set(j)
        for k in j:
            assert np.array_equal(t[k].numpy(), np.asarray(j[k]))


def test_prefetcher_without_a_card_raises():
    import torch

    from alaz_tpu_torch.runtime.pipeline import DevicePrefetcher

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher(_windows())
