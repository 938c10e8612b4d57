"""Device-mesh parallelism on ``torch.distributed`` (SURVEY §2.3).

- ``mesh``      — the (dp, tp, ep, sp) ``DeviceMesh`` and its axis groups
- ``multislice`` — process-group initialization, the host-crossing hybrid
                  mesh, and ``spawn`` (one rank per device on this host)
- ``collectives`` — named collectives over one axis, with their gradients
- ``sharding``  — partition specs for params, optimizer state and graph
                  batches; the sharded train/score steps (DP over
                  windows; the train step's TP/EP-sharded parameters
                  and optimizer state, gathered at use)
- ``halo``      — ring halo exchange for node-sharded graphs (SP/CP)
- ``gpipe``     — GPipe microbatch pipeline via neighbor hops (PP)
- ``sharded_model`` — node-sharded GraphSAGE and GAT forwards (config-5
                  serving)
- ``python -m alaz_tpu_torch.parallel.dryrun N`` — every leg on N ranks

Everything runs per rank: each rank calls the function on its own part,
and the collectives inside it meet the other ranks'.
"""

from alaz_tpu_torch.parallel.gpipe import make_pipeline
from alaz_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from alaz_tpu_torch.parallel.sharding import (
    graph_pspec,
    make_sharded_train_step,
    param_pspec,
    stack_graphs,
)

__all__ = [
    "make_pipeline",
    "make_mesh",
    "mesh_shape_for",
    "graph_pspec",
    "param_pspec",
    "stack_graphs",
    "make_sharded_train_step",
]
