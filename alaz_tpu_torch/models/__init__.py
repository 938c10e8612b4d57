"""GNN anomaly scorers over service-graph batches.

``init(key, cfg, device=None) -> module`` and ``apply(params, graph, cfg)
-> {"node_h", "edge_logits", "node_logits", ...}``, as in the JAX
package, for all four families: ``graphsage``, ``gat``, ``experts`` and
``tgn`` (whose streaming entry point is ``tgn.step``).
"""

from alaz_tpu_torch.models import experts, gat, graphsage, tgn
from alaz_tpu_torch.models.registry import get_model, init_params

__all__ = ["experts", "gat", "graphsage", "tgn", "get_model", "init_params"]
