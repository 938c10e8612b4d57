"""Event sources: the seam where events enter the service. The port has
the replay source; the live sources (K8s watch, CRI, the ingest socket)
are not ported yet."""

from alaz_tpu_torch.sources.base import EventSource
from alaz_tpu_torch.sources.replay import ReplaySource

__all__ = ["EventSource", "ReplaySource"]
