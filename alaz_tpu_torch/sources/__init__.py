"""Event sources — the seam where events enter the framework.

The reference's sources are eBPF programs + k8s informers + CRI
(SURVEY §2.2 G2-G8, G19-G20). In the TPU-native build the kernel side is
replaced by pluggable sources behind one interface: replay/simulation for
tests and benchmarks (the configs in BASELINE.json), a k8s watch adapter
for live cluster metadata, a container index (the CRITool analog), a
TLS-attachment tracker, and a log streamer. A live eBPF agent feeds the
same surface by POSTing columnar event batches at a Service.
"""

from alaz_tpu_torch.sources.base import EventSource
from alaz_tpu_torch.sources.replay import ReplaySource
from alaz_tpu_torch.sources.k8s_watch import K8sWatchSource, fan_out_containers
from alaz_tpu_torch.sources.containers import ContainerIndex, ContainerInfo
from alaz_tpu_torch.sources.tlsattach import TlsAttachTracker
from alaz_tpu_torch.sources.logstream import LogStreamer, ConnectionPool

__all__ = [
    "EventSource",
    "ReplaySource",
    "K8sWatchSource",
    "fan_out_containers",
    "ContainerIndex",
    "ContainerInfo",
    "TlsAttachTracker",
    "LogStreamer",
    "ConnectionPool",
]
