"""GNN anomaly scorers over service-graph batches.

``init(key, cfg, device=None) -> module`` and ``apply(params, graph, cfg)
-> {"node_h", "edge_logits", "node_logits", ...}``, as in the JAX
package. ``graphsage`` and ``gat`` are ported so far.
"""

from alaz_tpu_torch.models import gat, graphsage
from alaz_tpu_torch.models.registry import get_model, init_params

__all__ = ["gat", "graphsage", "get_model", "init_params"]
