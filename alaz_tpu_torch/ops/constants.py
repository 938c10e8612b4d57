"""Tiling constants of the JAX package's TPU kernels, copied.

The port's CUDA kernels do not tile by these. They are the parameters of
the src-locality gauges (``graph/builder.py src_locality_gauges``), which
operators read to choose ``ModelConfig.src_gather``; keeping the JAX
package's values makes both packages report the same gauges for the same
window.
"""

TILE_E = 512  # edges per TPU kernel chunk
# band width, in DMA_WINDOW-row windows, that the TPU's banded gather
# covers around each chunk's median src window
BAND_WINDOWS = 4
DMA_WINDOW = 128  # node-table rows per TPU DMA window
