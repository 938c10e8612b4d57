"""The vectorized stream-join engine.

This is the aggregator/ package analog (SURVEY §2.2 G9-G15): join L7 events
with TCP-connection state (socket lines) and Kubernetes metadata (cluster
IP maps) to produce directed pod→pod/service edges, in columnar batches.
"""

from alaz_tpu_torch.aggregator.cluster import ClusterInfo
from alaz_tpu_torch.aggregator.sockline import SocketLine, SocketLineStore
from alaz_tpu_torch.aggregator.engine import Aggregator

__all__ = ["ClusterInfo", "SocketLine", "SocketLineStore", "Aggregator"]
