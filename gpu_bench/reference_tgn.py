"""The plain reference of TGN as the system runs it: Temporal Graph
Networks (Rossi et al. 2020, arXiv:2006.10637) with a GRU memory updater,
in float32 with TF32 off (``reference.tf32_off``). For each window ``t``
over stable node slots:

    h_t = GraphSAGE_θ(x_t, e_t ; h⁰ += W_m·m_{t-1})   (mean aggregation)
    r = σ(W_r·[m_{t-1}, h_t]),  z = σ(W_z·[m_{t-1}, h_t])
    n = tanh(W_n·[r ⊙ m_{t-1}, h_t])
    m_t = (1 − z) ⊙ n + z ⊙ m_{t-1}

and the window's edge logits are read from ``h_t`` by GraphSAGE's edge
head.

Departures from the paper, as the system makes them:

- the memory is updated from the window's node embedding ``h_t``; the
  paper updates it from per-event messages, through a message function
  and a message aggregator;
- there is no time encoding: windows are a fixed 1 s apart;
- the embedding is the system's edge-conditioned GraphSAGE (its memory
  entering as a bias on the embedded node state); the paper embeds with
  temporal graph attention;
- every live slot's memory is updated each window, with or without an
  event in it: every slot of a window is live, so every row is updated;
  the paper updates the memory of the nodes with events in the batch
  alone.

It imports torch, numpy and ``reference.py``'s helpers only: no kernel,
no module and no output of the program. Parameters are a dict of tensors
named as the program's TGN state dict: the GraphSAGE encoder's under
``encoder.`` (``reference.make_params``), then ``mem_in``, ``gru_r``,
``gru_z``, ``gru_n``. ``q`` rounds every matrix product's two operands,
for the control (``reference.fp8_quant``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gpu_bench import reference
from gpu_bench.reference import _gelu, _layernorm, _lin, _seg_sum, _znorm, no_quant

ENCODER = "encoder."


def _encoder_cfg(cfg: dict) -> dict:
    return dict(cfg, model="graphsage")


def param_spec(cfg: dict) -> dict:
    """{name: shape} of every parameter, named as the program's TGN names
    them."""
    h = cfg["hidden_dim"]
    spec = {ENCODER + k: v for k, v in reference.param_spec(_encoder_cfg(cfg)).items()}
    spec.update({"mem_in.w": (h, h), "mem_in.b": (h,)})
    for gate in ("gru_r", "gru_z", "gru_n"):
        spec.update({f"{gate}.w": (2 * h, h), f"{gate}.b": (h,)})
    return spec


def make_params(cfg: dict, seed: int, device) -> dict:
    """Random parameters from ``seed``: the encoder's as
    ``reference.make_params`` draws GraphSAGE's, then the memory's
    (He-normal weights, biases N(0, 0.1²)) from a stream of their own."""
    out = {ENCODER + k: v for k, v in reference.make_params(_encoder_cfg(cfg), seed, device).items()}
    own = {k: v for k, v in param_spec(cfg).items() if not k.startswith(ENCODER)}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), 200_610_637]).generate_state(1, np.uint64)[0] >> 1))
    total = sum(int(torch.Size(s).numel()) for s in own.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    at = 0
    for name, shape in own.items():
        n = int(torch.Size(shape).numel())
        t = flat[at: at + n].reshape(shape)
        at += n
        out[name] = (t * (2.0 / shape[0]) ** 0.5 if name.endswith(".w") else 0.1 * t).contiguous()
    return out


def init_memory(p: dict, n_nodes: int, device) -> torch.Tensor:
    """The cold memory: zeros, one row a node slot."""
    return torch.zeros((n_nodes, p["mem_in.w"].shape[0]), dtype=torch.float32, device=device)


def _layers(p: dict) -> int:
    n = 0
    while f"{ENCODER}layers.{n}.msg.w" in p:
        n += 1
    return n


def encode(p: dict, g: dict, memory: torch.Tensor, q: Callable = no_quant) -> tuple:
    """``(h_t [N, H], edge logits [E])`` of window ``g`` (edge order as
    given) under ``memory`` (m_{t-1}, [N, H]). The edge features are
    z-scored when the encoder's edge projection is wider than them."""
    x = g["node_feats"].float()
    n = x.shape[0]
    src, dst = g["edge_src"].long(), g["edge_dst"].long()
    ef = g["edge_feats"].float()
    if p[f"{ENCODER}layers.0.edge_proj.w"].shape[0] > ef.shape[1]:
        ef = _znorm(ef)
    h = _lin(p, ENCODER + "embed", x, q) + _lin(p, "mem_in", memory, q)
    deg = torch.clamp(torch.bincount(dst, minlength=n).float(), min=1.0)[:, None]
    for layer in range(_layers(p)):
        pre = f"{ENCODER}layers.{layer}"
        msgs = _lin(p, f"{pre}.msg", h, q)[src] + _lin(p, f"{pre}.edge_proj", ef, q)
        agg = _seg_sum(msgs, dst, n) / deg
        h_new = _lin(p, f"{pre}.self", h, q) + _lin(p, f"{pre}.neigh", agg, q)
        h = h + _gelu(_layernorm(p, f"{pre}.ln", h_new))
    z = torch.cat([h[src], h[dst], ef], dim=1)
    hidden = _gelu(_lin(p, ENCODER + "edge_head.0", z, q))
    return h, _lin(p, ENCODER + "edge_head.1", hidden, q)[:, 0]


def update(p: dict, memory: torch.Tensor, h: torch.Tensor, q: Callable = no_quant) -> torch.Tensor:
    """m_t from m_{t-1} and h_t: the GRU cell, on every row."""
    hz = torch.cat([memory, h], dim=1)
    r = torch.sigmoid(_lin(p, "gru_r", hz, q))
    z = torch.sigmoid(_lin(p, "gru_z", hz, q))
    n = torch.tanh(_lin(p, "gru_n", torch.cat([r * memory, h], dim=1), q))
    return (1.0 - z) * n + z * memory


def step(p: dict, window: dict, memory: torch.Tensor, q: Callable = no_quant) -> tuple:
    """One window: ``(edge logits [E], m_t)``."""
    h, logits = encode(p, window, memory, q)
    return logits, update(p, memory, h, q)


def set_alert_share(p: dict, window: dict, share: float, device) -> None:
    """Shift the edge head's output bias so that ``share`` of ``window``'s
    edges score at or above 0.5 from cold memory by this reference
    (``reference.set_alert_share``'s rule)."""
    g = reference.to_tensors(window, device)
    with torch.no_grad():
        _, logits = encode(p, g, init_memory(p, g["node_feats"].shape[0], device))
        k = logits.shape[0] - int(round(share * logits.shape[0]))
        p[ENCODER + "edge_head.1.b"] -= torch.kthvalue(logits, max(k, 1)).values
