"""TGN's GRU memory update: its plain PyTorch version and the wrapper of
its hand-written Hopper kernel in ``csrc/gru.cu``.

The kernel replaces no TPU kernel (the JAX package leaves the update to
XLA); it runs the whole update in one launch where the plain version
makes three GEMMs and some twenty element-wise launches, each
intermediate going through device memory. ``gru_update`` launches it for
tensors on a CUDA device and runs the plain version for tensors on the
CPU; a CUDA tensor the kernel cannot take raises. It counts its launches
in ``gru_update.launches``, apart from ``segment_kernels.launch_counts()``.
It has no backward: ``models/tgn.py update`` takes it only outside
autograd, and the plain version otherwise.

The kernel reads the three weight matrices packed for its tensor-core
products (``pack_gru_weight``), in bf16; the wrapper packs them once for
each version of the parameters and keeps the packing while they stay as
they are.
"""

from __future__ import annotations

import threading
import weakref

import torch

from alaz_tpu_torch.models.common import dense
from alaz_tpu_torch.ops import _build
from alaz_tpu_torch.ops.segment_kernels import _cuda_input, _stream

KERNEL_WIDTHS = (32, 64, 128)  # the hidden sizes csrc/gru.cu instantiates
GRU_PASSES = 4  # csrc/gru.cu kGruPasses: passes over each product's output columns


def gru_update_plain(gru_r, gru_z, gru_n, memory: torch.Tensor, node_h: torch.Tensor,
                     node_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``m_t`` on the window's active nodes from ``m_{t-1}`` (``memory``,
    f32, at least ``node_h``'s rows) and the node states ``node_h``, the
    products in ``dtype``; every other row, and the rows past the bucket,
    as they were. ``gru_r``, ``gru_z``, ``gru_n``: the GRU's dense layers
    (``w`` [2H, H], ``b`` [H])."""
    n_pad = node_h.shape[0]
    m_prev = memory[:n_pad]
    h = node_h.float()
    hz = torch.cat([m_prev.to(dtype), h.to(dtype)], dim=-1)
    r = torch.sigmoid(dense(gru_r, hz)).float()
    z = torch.sigmoid(dense(gru_z, hz)).float()
    hn = torch.cat([(r * m_prev).to(dtype), h.to(dtype)], dim=-1)
    n_t = torch.tanh(dense(gru_n, hn)).float()
    m_new = (1 - z) * n_t + z * m_prev

    m_next = torch.where(node_mask[:, None], m_new, m_prev)
    if memory.shape[0] > n_pad:
        m_next = torch.cat([m_next, memory[n_pad:]])
    return m_next


def gru_update(gru_r, gru_z, gru_n, memory: torch.Tensor, node_h: torch.Tensor,
               node_mask: torch.Tensor) -> torch.Tensor:
    """``gru_update_plain`` in bf16 as one kernel: a new ``[rows, H]`` f32
    memory, written out of place. Takes f32 ``memory`` [M, H] (M at least
    the bucket), bf16 ``node_h`` [N, H] and bool ``node_mask`` [N], all
    contiguous; H one of ``KERNEL_WIDTHS``."""
    return _run_gru(gru_r, gru_z, gru_n, memory, node_h, node_mask)


gru_update.launches = 0


def _run_gru(gru_r, gru_z, gru_n, memory, node_h, node_mask):
    """The update where its tensors lie: the plain version on the CPU, the
    kernel on the card."""
    if memory.device.type == "cpu":
        return gru_update_plain(gru_r, gru_z, gru_n, memory, node_h, node_mask, torch.bfloat16)
    return _gru_update_cuda(gru_r, gru_z, gru_n, memory, node_h, node_mask)


def pack_gru_weight(w: torch.Tensor) -> torch.Tensor:
    """A ``[K, N]`` weight (``Dense.w``, K and N multiples of 16) as the
    kernel's B operand in shared memory, bf16: for each of ``min(GRU_PASSES,
    N / 16)`` passes over the output columns and each 16-row k block, an
    ``N / passes`` x 16 slab of 8 x 8 core matrices, K-major, no swizzle:
    ``[pass, kb, n8 tile, k half, 8 rows, 8 k]``. The slab's k position
    ``8 half + e`` holds the row ``16 kb + 4 (e // 2) + 2 half + e % 2``:
    the k order of the kernel's A fragments, whose slots 2q, 2q + 1, 2q +
    8, 2q + 9 hold a thread's columns 4q .. 4q + 3. Row ``r`` of n8 tile
    ``J`` (counted over the passes) holds the column ``16 (J // 2) +
    4 (r // 2) + 2 (J % 2) + r % 2``: the order in which the tiles' sums
    line up with each thread's own four columns."""
    k, n = w.shape
    if k % 16 or n % 16:
        raise ValueError(f"weight {tuple(w.shape)}: both sides must be multiples of 16")
    passes = min(GRU_PASSES, n // 16)
    tiles = n // 8 // passes  # n8 tiles a pass
    dev = w.device

    def ax(size: int, dim: int) -> torch.Tensor:
        return torch.arange(size, device=dev).view([-1 if i == dim else 1 for i in range(6)])

    p, kb, j, half, r, e = ax(passes, 0), ax(k // 16, 1), ax(tiles, 2), ax(2, 3), ax(8, 4), ax(8, 5)
    tile = p * tiles + j
    cols = 16 * (tile // 2) + 4 * (r // 2) + 2 * (tile % 2) + r % 2
    rows = 16 * kb + 4 * (e // 2) + 2 * half + e % 2
    return w.to(torch.bfloat16)[rows, cols].contiguous()


# the packed weights and biases of the last parameter versions: key (each
# parameter's id, storage and version) -> (weak references to the six
# parameters, weights, biases)
_PACKED: dict = {}
_PACKED_LOCK = threading.Lock()
_PACKED_KEEP = 8


def _packed(gru_r, gru_z, gru_n, h: int, dev: torch.device) -> tuple:
    """``(weights [3, ...], biases [3, H])`` in bf16 for the kernel on
    ``dev``, the weights as ``pack_gru_weight`` lays them out, packed once
    for each version of the parameters, which must be ``[2h, h]`` and
    ``[h]`` on ``dev``: the key is each parameter's id, storage and version
    counter, and a hit must hold the same tensors (a parameter freed and
    another made in its place misses). A parameter made in inference mode
    keeps no version counter and is packed on every call."""
    params = (gru_r.w, gru_r.b, gru_z.w, gru_z.b, gru_n.w, gru_n.b)
    if any(p.is_inference() for p in params):
        key = None
    else:
        key = (h, dev) + tuple((id(p), p.data_ptr(), p._version) for p in params)
        with _PACKED_LOCK:
            hit = _PACKED.get(key)
        if hit is not None and all(ref() is p for ref, p in zip(hit[0], params)):
            return hit[1], hit[2]
    for w, b in zip(params[0::2], params[1::2]):
        if tuple(w.shape) != (2 * h, h) or tuple(b.shape) != (h,) or w.device != dev or b.device != dev:
            raise ValueError(f"gru_update: a GRU layer is {tuple(w.shape)}, {tuple(b.shape)} on "
                             f"{w.device}; expected ({2 * h}, {h}), ({h},) on {dev}")
    with torch.no_grad():
        weights = torch.stack([pack_gru_weight(w) for w in params[0::2]])
        biases = torch.stack([b.to(torch.bfloat16) for b in params[1::2]]).contiguous()
    if key is not None:
        with _PACKED_LOCK:
            if len(_PACKED) >= _PACKED_KEEP:
                _PACKED.clear()
            _PACKED[key] = (tuple(map(weakref.ref, params)), weights, biases)
    return weights, biases


def gru_activations(x: torch.Tensor) -> torch.Tensor:
    """The kernel's own sigmoid and tanh of the bf16 values ``x`` (1-D, on
    the card), each rounded to bf16: ``[2, n]`` (sigmoid, tanh), to hold
    them to ``torch.sigmoid`` and ``torch.tanh``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"gru_activations: no kernel for device {dev}")
    _cuda_input(x, "x", dev, 1, torch.bfloat16)
    out = torch.empty((2, x.shape[0]), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().alaz_gru_activations(x.data_ptr(), out.data_ptr(), x.shape[0],
                                                   _stream(dev))
    _build.check(rc, "gru_activations")
    return out


def _gru_update_cuda(gru_r, gru_z, gru_n, memory, node_h, node_mask):
    dev = memory.device
    if dev.type != "cuda":
        raise ValueError(f"gru_update: no kernel for device {dev}")
    _cuda_input(memory, "memory", dev, 2, torch.float32)
    _cuda_input(node_h, "node_h", dev, 2, torch.bfloat16)
    _cuda_input(node_mask, "node_mask", dev, 1, torch.bool)
    n_pad, h = node_h.shape
    n_mem = memory.shape[0]
    if h not in KERNEL_WIDTHS:
        raise ValueError(f"gru_update: hidden size {h}; the kernel takes {KERNEL_WIDTHS}")
    if memory.shape[1] != h or n_mem < n_pad or node_mask.shape[0] != n_pad:
        raise ValueError(
            f"gru_update: memory {tuple(memory.shape)}, node_h {tuple(node_h.shape)}, "
            f"node_mask {tuple(node_mask.shape)} do not fit"
        )
    if n_mem >= 2**31 // h:
        raise ValueError("gru_update: the memory's elements must fit int32 rows")
    weights, biases = _packed(gru_r, gru_z, gru_n, h, dev)
    out = torch.empty_like(memory)
    if memory.data_ptr() % 16 or node_h.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("gru_update: memory, node_h and the output must be 16-byte aligned")
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.alaz_gru_update(
            memory.data_ptr(), node_h.data_ptr(), node_mask.data_ptr(), weights.data_ptr(),
            biases.data_ptr(), out.data_ptr(), n_pad, n_mem, h, _stream(dev),
        )
    _build.check(rc, "gru_update")
    gru_update.launches += 1
    return out
