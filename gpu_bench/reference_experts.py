"""The plain reference of the edge-type experts as the system runs them: a
relational message-passing network (R-GCN, Schlichtkrull et al. 2017,
arXiv:1703.06103) whose relations are the L7 protocols, in float32 with
TF32 off (``reference.tf32_off``). Each of ``T`` protocol slots (slot 0
unknown or pad, then the agent's protocol codes) has its own message
weight. For each layer:

    m_e   = h[src_e] · W_{type_e} + b_{type_e}     (0 where type_e ∉ [0, T))
            + W_ep · ef_e + b_ep
    agg_d = Σ_{dst_e = d} m_e / max(deg_d, 1)
    h     = h + gelu(LN(W_self·h + W_neigh·agg))

and the window's edge logits are read from ``h`` by GraphSAGE's edge head
(``reference.forward``'s). Each edge's message is computed the routed
way: for each type, the edges of that type, their ``h[src]`` rows times
that type's weight. No per-node table of every expert is formed, so the
program's table form is checked, not repeated.

Departures from R-GCN, as the system makes them:

- one mean over all of a node's in-edges, where R-GCN normalises each
  relation's messages by that relation's in-degree;
- an edge-feature projection in each message;
- layer norm, GELU and a residual around each layer, where R-GCN sums
  the relations' messages and a self-connection under one activation;
- no basis or block-diagonal decomposition of the relation weights;
- the program keeps the degree and the residual stream in bf16 (unlike
  GraphSAGE's f32 carry); here, as everywhere in the reference, they are
  float32.

It imports torch, numpy and ``reference.py``'s helpers only: no kernel,
no module and no output of the program. Parameters are a dict of tensors
named as the program's ``Experts`` state dict: ``layers.<l>.expert_w
[T, H, H]`` and ``layers.<l>.expert_b [T, H]``, and the rest as
``reference.param_spec`` lays out GraphSAGE's without its ``msg``. ``q``
rounds every matrix product's two operands, for the control
(``reference.fp8_quant``).
"""

from __future__ import annotations

from typing import Callable

import torch

from gpu_bench import reference
from gpu_bench.reference import _gelu, _layernorm, _lin, _seg_sum, _znorm, no_quant


def param_spec(cfg: dict) -> dict:
    """{name: shape} of every parameter, named as the program's
    ``Experts`` names them."""
    h, t = cfg["hidden_dim"], cfg["num_edge_types"]
    spec = {k: v for k, v in reference.param_spec(dict(cfg, model="graphsage")).items() if ".msg." not in k}
    for layer in range(cfg["num_layers"]):
        spec[f"layers.{layer}.expert_w"] = (t, h, h)
        spec[f"layers.{layer}.expert_b"] = (t, h)
    return spec


def make_params(cfg: dict, seed: int, device) -> dict:
    """Random parameters from ``seed``, drawn on ``device`` in one call:
    He-normal weights (each expert's over its fan-in ``H``), biases and
    layer-norm offsets N(0, 0.1²), gains 1 + N(0, 0.1²)."""
    spec = param_spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    total = sum(int(torch.Size(s).numel()) for s in spec.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in spec.items():
        n = int(torch.Size(shape).numel())
        t = flat[at: at + n].reshape(shape)
        at += n
        if name.endswith((".w", ".expert_w")):
            t = t * (2.0 / shape[-2]) ** 0.5
        elif name.endswith(".g"):
            t = 1.0 + 0.1 * t
        else:  # biases, the experts' biases, layer-norm offsets
            t = 0.1 * t
        out[name] = t.contiguous()
    return out


def expert_messages(p: dict, pre: str, h: torch.Tensor, src: torch.Tensor, etype: torch.Tensor,
                    q: Callable = no_quant) -> torch.Tensor:
    """``[E, H]``: each edge's expert message, routed by type; zero where
    the type is outside ``[0, T)``."""
    w, b = p[f"{pre}.expert_w"], p[f"{pre}.expert_b"]
    msgs = h.new_zeros((src.shape[0], h.shape[1]))
    for t in range(w.shape[0]):
        sel = torch.nonzero(etype == t).reshape(-1)
        if sel.numel():
            msgs[sel] = q(h[src[sel]]) @ q(w[t]) + b[t]
    return msgs


def forward(p: dict, g: dict, cfg: dict, q: Callable = no_quant) -> torch.Tensor:
    """Per-edge anomaly logits [E] of the window ``g`` (edge order as
    given)."""
    x = g["node_feats"].float()
    n = x.shape[0]
    src, dst, etype = g["edge_src"].long(), g["edge_dst"].long(), g["edge_type"].long()
    ef = g["edge_feats"].float()
    if cfg["edge_feat_znorm"]:
        ef = _znorm(ef)
    h = _lin(p, "embed", x, q)
    deg = torch.clamp(torch.bincount(dst, minlength=n).float(), min=1.0)[:, None]
    for layer in range(cfg["num_layers"]):
        pre = f"layers.{layer}"
        msgs = expert_messages(p, pre, h, src, etype, q) + _lin(p, f"{pre}.edge_proj", ef, q)
        agg = _seg_sum(msgs, dst, n) / deg
        h_new = _lin(p, f"{pre}.self", h, q) + _lin(p, f"{pre}.neigh", agg, q)
        h = h + _gelu(_layernorm(p, f"{pre}.ln", h_new))
    z = torch.cat([h[src], h[dst], ef], dim=1)
    hidden = _gelu(_lin(p, "edge_head.0", z, q))
    return _lin(p, "edge_head.1", hidden, q)[:, 0]


def set_alert_share(params: dict, window: dict, cfg: dict, share: float, device) -> None:
    """Shift the edge head's output bias so that ``share`` of ``window``'s
    edges score at or above 0.5 by this reference
    (``reference.set_alert_share``'s rule)."""
    with torch.no_grad():
        logits = forward(params, reference.to_tensors(window, device), cfg)
        k = logits.shape[0] - int(round(share * logits.shape[0]))
        params["edge_head.1.b"] -= torch.kthvalue(logits, max(k, 1)).values
        del logits
