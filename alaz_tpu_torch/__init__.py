"""alaz_tpu_torch — the service-map anomaly scorer in PyTorch, for one
NVIDIA H100.

The PyTorch/CUDA counterpart of the JAX package ``alaz_tpu``, laid out
the same way so each module has an obvious twin:

- ``alaz_tpu_torch.config``   — ``ModelConfig`` (same fields and defaults)
- ``alaz_tpu_torch.graph``    — ``GraphBatch`` windows, bucketing, features,
  the ``cluster_renumber`` locality pass and its gauges
- ``alaz_tpu_torch.replay``   — synthetic service-map windows
- ``alaz_tpu_torch.ops``      — segment ops; the hand-written Hopper
  kernels live in ``csrc/`` and are bound in ``ops/segment_kernels.py``
- ``alaz_tpu_torch.models``   — GraphSAGE, GAT, edge-type experts and TGN
- ``alaz_tpu_torch.train``    — objective, train and score steps, AUROC,
  checkpoints
- ``alaz_tpu_torch.runtime``  — ``WindowScorer``, the serial scoring loop
  (it owns the TGN memory)
- ``alaz_tpu_torch.convert``  — params and graphs carried in from numpy

The package imports torch and numpy only. Entry points take ``device=``;
with none given they run on ``cuda`` and raise when there is no card.
"""
