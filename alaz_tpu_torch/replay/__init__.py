"""Replay/simulation harness — the main_benchmark_test.go test plane.

Every BASELINE.json config is a replay: a deterministic generator fabricates
k8s metadata, TCP establishes, and rate-shaped L7 traffic (the Simulator
analog, main_benchmark_test.go:311-633), which flows through the real
aggregator into any DataStore sink. Traces can also be saved/loaded as NPZ
for byte-identical replays.
"""

from alaz_tpu_torch.replay.simulator import Simulator, ReplayResult, run_replay
from alaz_tpu_torch.replay.trace import save_trace, load_trace

__all__ = ["Simulator", "ReplayResult", "run_replay", "save_trace", "load_trace"]
