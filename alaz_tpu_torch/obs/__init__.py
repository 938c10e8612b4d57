"""Observability planes, copied from the JAX package: window-lifecycle
spans (``spans.py``), log-bucket histograms, the flight recorder, the
device plane's per-bucket telemetry (``device.py``, without the XLA
compile event plane) and the score plane (``scores.py``)."""

from alaz_tpu_torch.obs.device import DeviceTelemetry, batch_pad_waste_pct, bucket_key
from alaz_tpu_torch.obs.histogram import DEFAULT_BOUNDS, Histogram
from alaz_tpu_torch.obs.recorder import FlightRecorder
from alaz_tpu_torch.obs.scores import SCORE_BOUNDS, DriftDetector, ScorePlane, feature_scores
from alaz_tpu_torch.obs.spans import HOST_STAGES, STAGES, SpanTracer, WindowSpan

__all__ = [
    "DEFAULT_BOUNDS",
    "Histogram",
    "FlightRecorder",
    "HOST_STAGES",
    "STAGES",
    "SpanTracer",
    "WindowSpan",
    "DeviceTelemetry",
    "batch_pad_waste_pct",
    "bucket_key",
    "SCORE_BOUNDS",
    "DriftDetector",
    "ScorePlane",
    "feature_scores",
]
