"""The plain reference: GraphSAGE (arXiv:1706.02216, mean aggregator with
edge-conditioned messages) and GAT (arXiv:1710.10903, additive attention
over incoming edges with edge features) as the configuration states them,
in float32 with TF32 off, and the edge loss and AdamW update of training.

It imports torch and numpy only: no kernel, no module and no output of the
program. For the replayed fleet it works out each closed window's edges,
counts and feature rows from the traffic generator's topology alone. Parameters are a dict of tensors named as the program's state
dict (``param_spec``), made by the harness from the seed; graphs are the
raw window arrays of ``gen_windows.make_window``, in drawn edge order (the
segment sums here need no sort).

``quant`` rounds every matrix product's two operands, for the control
(``plant.py``): the reference put in the program's place and computed one
precision below the configuration's bf16 (fp8 with per-tensor scales: e4m3
operands, e5m2 gradients, f32 accumulation).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

EDGE_STAT_COLS = 7
LOGIT_CLAMP = 30.0  # the models' attention-logit clamp: softmax of the clamped logits


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def no_quant(x: torch.Tensor) -> torch.Tensor:
    return x


def _fp8_round(x: torch.Tensor, dtype) -> torch.Tensor:
    scale = torch.finfo(dtype).max / x.abs().max().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    """fp8 training's rounding of a matrix product's operand: e4m3 in the
    forward, and the gradient that flows back through it in e5m2, each
    under a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2)


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded as an fp8 matrix product takes it (``_Fp8``)."""
    return _Fp8.apply(x)


def param_spec(cfg: dict) -> dict:
    """{name: shape} of every parameter, named as the program's modules
    name them."""
    h, fn, nl = cfg["hidden_dim"], cfg["node_feature_dim"], cfg["num_layers"]
    ef = cfg["edge_feature_dim"] + (EDGE_STAT_COLS if cfg["edge_feat_znorm"] else 0)
    spec = {"embed.w": (fn, h), "embed.b": (h,)}
    dense = {"graphsage": {"msg": h, "edge_proj": ef, "self": h, "neigh": h},
             "gat": {"q": h, "kv": h, "edge_proj": ef, "out": h}}[cfg["model"]]
    for layer in range(nl):
        for name, fan_in in dense.items():
            spec[f"layers.{layer}.{name}.w"] = (fan_in, h)
            spec[f"layers.{layer}.{name}.b"] = (h,)
        if cfg["model"] == "gat":
            nh = cfg["num_heads"]
            spec[f"layers.{layer}.attn"] = (nh, 3 * (h // nh))
        spec[f"layers.{layer}.ln.g"] = (h,)
        spec[f"layers.{layer}.ln.b"] = (h,)
    spec.update({
        "edge_head.0.w": (2 * h + ef, h), "edge_head.0.b": (h,),
        "edge_head.1.w": (h, 1), "edge_head.1.b": (1,),
        "node_head.0.w": (h, h), "node_head.0.b": (h,),
        "node_head.1.w": (h, 1), "node_head.1.b": (1,),
    })
    return spec


def make_params(cfg: dict, seed: int, device) -> dict:
    """Random parameters from ``seed``, drawn on ``device`` in one call:
    He-normal weights, biases and layer-norm offsets N(0, 0.1²), gains
    1 + N(0, 0.1²), attention vectors N(0, 0.1²)."""
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
        if name.endswith(".w"):
            t = t * (2.0 / shape[0]) ** 0.5
        elif name.endswith(".g"):
            t = 1.0 + 0.1 * t
        else:  # biases, layer-norm offsets, attention vectors
            t = 0.1 * t
        out[name] = t.contiguous()
    return out


def set_alert_share(params: dict, window: dict, cfg: dict, share: float, device) -> None:
    """Shift the edge head's output bias so that ``share`` of ``window``'s
    edges score at or above 0.5 by this reference: every seed then sends
    its sink the same share of each window, where random weights alone
    would send anything from a few to most of the edges."""
    with torch.no_grad():
        logits = forward(params, to_tensors(window, device), cfg)
        k = logits.shape[0] - int(round(share * logits.shape[0]))
        params["edge_head.1.b"] -= torch.kthvalue(logits, max(k, 1)).values
        del logits


def to_tensors(window: dict, device) -> dict:
    """The raw window arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in window.items() if v is not None}


def _lin(p: dict, name: str, x: torch.Tensor, q: Callable) -> torch.Tensor:
    return q(x) @ q(p[f"{name}.w"]) + p[f"{name}.b"]


def _layernorm(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * p[f"{name}.g"] + p[f"{name}.b"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _seg_sum(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device).index_add(0, ids, vals)


def _znorm(ef: torch.Tensor, clip: float = 8.0, eps: float = 1e-8) -> torch.Tensor:
    """Each edge's stat columns as z-scores against the window's edges."""
    stats = ef[:, :EDGE_STAT_COLS]
    mean = stats.mean(0, keepdim=True)
    var = ((stats - mean) ** 2).mean(0, keepdim=True)
    z = torch.clamp((stats - mean) / torch.sqrt(var + eps), -clip, clip)
    return torch.cat([ef, z], dim=1)


def forward(p: dict, g: dict, cfg: dict, q: Callable = no_quant) -> torch.Tensor:
    """Per-edge anomaly logits [E] of the window ``g`` (edge order as given)."""
    x = g["node_feats"].float()
    n = x.shape[0]
    src, dst = g["edge_src"].long(), g["edge_dst"].long()
    ef = g["edge_feats"].float()
    if cfg["edge_feat_znorm"]:
        ef = _znorm(ef)
    h = _lin(p, "embed", x, q)
    deg = torch.bincount(dst, minlength=n).float()
    hd = cfg["hidden_dim"] // cfg.get("num_heads", 1)
    for layer in range(cfg["num_layers"]):
        pre = f"layers.{layer}"
        if cfg["model"] == "graphsage":
            msgs = _lin(p, f"{pre}.msg", h, q)[src] + _lin(p, f"{pre}.edge_proj", ef, q)
            agg = _seg_sum(msgs, dst, n) / torch.clamp(deg, min=1.0)[:, None]
            h_new = _lin(p, f"{pre}.self", h, q) + _lin(p, f"{pre}.neigh", agg, q)
        elif cfg["model"] == "gat":
            nh = cfg["num_heads"]
            a = q(p[f"{pre}.attn"])
            qn = _lin(p, f"{pre}.q", h, q).reshape(n, nh, hd)
            kv = _lin(p, f"{pre}.kv", h, q).reshape(n, nh, hd)
            e_feat = _lin(p, f"{pre}.edge_proj", ef, q).reshape(-1, nh, hd)
            kv_src = kv[src]
            logit = (
                (q(qn) * a[:, :hd]).sum(-1)[dst]
                + (q(kv_src) * a[:, hd: 2 * hd]).sum(-1)
                + (q(e_feat) * a[:, 2 * hd:]).sum(-1)
            )
            logit = torch.clamp(F.leaky_relu(logit, 0.2), -LOGIT_CLAMP, LOGIT_CLAMP)
            w = torch.exp(logit)  # [E, nh]
            num = _seg_sum((kv_src + e_feat) * w[:, :, None], dst, n)
            den = _seg_sum(w, dst, n)
            safe = torch.where(den > 0, den, torch.ones_like(den))
            agg = torch.where(den[:, :, None] > 0, num / safe[:, :, None], torch.zeros_like(num))
            h_new = _lin(p, f"{pre}.out", agg.reshape(n, nh * hd), q)
        else:
            raise ValueError(f"no reference for model {cfg['model']!r}")
        h = h + _gelu(_layernorm(p, f"{pre}.ln", h_new))
    z = torch.cat([h[src], h[dst], ef], dim=1)
    hidden = _gelu(_lin(p, "edge_head.0", z, q))
    return _lin(p, "edge_head.1", hidden, q)[:, 0]


def edge_loss(logits: torch.Tensor, label: torch.Tensor, pos_weight: float = 10.0) -> torch.Tensor:
    """Positive-weighted binary cross-entropy over the window's edges."""
    per_edge = -label * F.logsigmoid(logits) - (1.0 - label) * F.logsigmoid(-logits)
    weight = torch.where(label > 0.5, pos_weight, 1.0)
    return (per_edge * weight).sum() / torch.clamp(weight.sum(), min=1.0)


class AdamW:
    """Decoupled weight decay Adam (Loshchilov & Hutter), every parameter
    decayed: ``p ← p(1 − lr·wd) − lr·m̂/(√v̂ + eps)``."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-4):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = self.betas
        for k, p in params.items():
            g = grads[k]
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m_hat = self.m[k] / (1.0 - b1 ** self.t)
            v_hat = self.v[k] / (1.0 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))


def train_steps(p0: dict, windows: list, cfg: dict, lr: float) -> dict:
    """The first ``len(windows)`` train steps from ``p0``: each step's loss
    and gradient of the loss at each edge's logit, the first step's
    gradients, and the params after the last step."""
    params = {k: v.detach().clone() for k, v in p0.items()}
    opt = AdamW(params, lr)
    losses, logit_grads, first_grads = [], [], None
    for g in windows:
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits = forward(leaves, g, cfg)
        loss = edge_loss(logits, g["edge_label"].float())
        grads = torch.autograd.grad(loss, [logits] + list(leaves.values()), allow_unused=True)
        logit_grads.append(grads[0].detach())
        grads = {k: (gr if gr is not None else torch.zeros_like(params[k])) for k, gr in zip(leaves, grads[1:])}
        if first_grads is None:
            first_grads = grads
        opt.step(params, grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "logit_grads": logit_grads, "first_grads": first_grads, "params": params}


# -- the replayed fleet: what the aggregator's join and the window close owe --

NODE_FEATURE_DIM, EDGE_FEATURE_DIM = 32, 16
EP_POD, EP_SERVICE = 1, 2


def replay_window(pod_idx, svc_idx, proto, conn_ts, edge_rate: float, per_edge: int, window: int,
                  latency_ns: int = 50, window_ms: int = 1_000) -> dict:
    """Window ``window`` (start ms // window_ms) of the replayed fleet, from
    the generator's topology alone: each edge's requests whose write time
    falls in the window, joined to (calling pod, called service, protocol)
    and reduced to one row an edge, with the window's node and edge
    features (log-counts, mean and max latency, error, TLS and rate
    columns, the protocol one-hot; per node its type one-hot, in and out
    counts, errors, latencies and degrees)."""
    dt = int(1e9 / edge_rate)
    lo_ns = window * window_ms * 1_000_000
    hi_ns = (window + 1) * window_ms * 1_000_000
    first = conn_ts.astype(np.int64) + 10
    # request k of an edge lies in the window when lo <= first + k·dt < hi
    k_lo = np.clip(-((first - lo_ns) // dt), 0, per_edge)
    k_hi = np.clip(-((first - hi_ns) // dt), 0, per_edge)
    count = (k_hi - k_lo).astype(np.int64)
    live = count > 0
    key = np.stack([pod_idx[live], svc_idx[live], proto[live].astype(np.int64)], 1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    cnt = np.bincount(inv.reshape(-1), weights=count[live]).astype(np.float64)
    pods, p_of = np.unique(uniq[:, 0], return_inverse=True)
    svcs, s_of = np.unique(uniq[:, 1], return_inverse=True)
    n_p = pods.shape[0]
    src, dst = p_of.reshape(-1), n_p + s_of.reshape(-1)
    n = n_p + svcs.shape[0]
    lat_sum, lat_max = cnt * latency_ns, np.full_like(cnt, float(latency_ns))
    node_type = np.concatenate([np.full(n_p, EP_POD), np.full(svcs.shape[0], EP_SERVICE)])
    nf = np.zeros((n, NODE_FEATURE_DIM), dtype=np.float32)
    for t in range(4):
        nf[:, t] = node_type == t
    out_cnt = np.bincount(src, weights=cnt, minlength=n)
    in_cnt = np.bincount(dst, weights=cnt, minlength=n)
    out_lat = np.bincount(src, weights=lat_sum, minlength=n)
    in_lat = np.bincount(dst, weights=lat_sum, minlength=n)
    nf[:, 4] = np.log1p(out_cnt)
    nf[:, 5] = np.log1p(in_cnt)
    nf[:, 6] = 0.0  # no request fails in this traffic
    nf[:, 7] = 0.0
    nf[:, 8] = np.log1p(out_lat / np.maximum(out_cnt, 1.0)) / 20.0
    nf[:, 9] = np.log1p(in_lat / np.maximum(in_cnt, 1.0)) / 20.0
    nf[:, 10] = np.log1p(np.bincount(src, minlength=n).astype(np.float64))
    nf[:, 11] = np.log1p(np.bincount(dst, minlength=n).astype(np.float64))
    ef = np.zeros((cnt.shape[0], EDGE_FEATURE_DIM), dtype=np.float32)
    ef[:, 0] = np.log1p(cnt)
    ef[:, 1] = np.log1p(lat_sum / np.maximum(cnt, 1.0)) / 20.0
    ef[:, 2] = np.log1p(lat_max) / 20.0
    ef[:, 6] = np.log1p(cnt / (window_ms / 1_000.0))
    ef[np.arange(cnt.shape[0]), 7 + np.clip(uniq[:, 2], 0, 8)] = 1.0
    return {
        "pod": uniq[:, 0], "svc": uniq[:, 1], "proto": uniq[:, 2], "count": cnt,
        "graph": {"node_feats": nf, "edge_src": src.astype(np.int32), "edge_dst": dst.astype(np.int32),
                  "edge_feats": ef},
    }
