"""Plain reference of DeepSeek-V2's decoder as one expert-parallel rank
holds it, in float32 with TF32 off: the logits the served tokens are judged
against.

Plain ``torch`` operations on the weight tensors the benchmark drew; no
kernel, cache or batching, and nothing of the program is imported.  The
configuration file gives the equations in Hugging Face's key names
(DeepSeek-V2's ``config.json``) and the rank's share in ``share``.  Weights
are laid out ``[d_in, d_out]`` (``x @ w``), head tensors ``[r, heads, d]``,
expert stacks ``[E_held, d_in, d_out]``.

Each layer is ``x + attn(norm1(x))`` then ``x + mlp(norm2(x))``, RMSNorm
``x / sqrt(mean(x^2) + rms_norm_eps) * scale``; a final norm and an untied
head.  Latent attention (MLA) in its materialised form, for T tokens at
positions 0..T-1, h heads, latent rank r, query rank r_q:

    q         = norm_q(x W_dq) W_uq                  [T, h, dn + dr]
    [c, k_r]  = x W_dkv;  c = norm_kv(c)             [T, r], [T, dr]
    k_n = c W_uk,  v = c W_uv                        [T, h, dn], [T, h, dv]
    q_r, k_r rotated (YaRN, below); k_r shared by every head
    s[t, u]   = (q_n[t] . k_n[u] + q_r[t] . k_r[u]) * (dn + dr)^-0.5 * m^2
    out       = softmax_u<=t(s) v, then [T, h dv] W_o

YaRN (``rope_scaling``, factor s over L0 original positions): rotation of
interleaved pairs (2i, 2i + 1) of the rope dims (rot of them) by angle
``pos * f_i`` with ``f_i = theta^(-2i/rot) (1 - ramp_i) + theta^(-2i/rot) /
s ramp_i``, ``ramp_i = clamp((i - lo) / (hi - lo), 0, 1)``, ``lo =
max(floor(c(beta_fast)), 0)``, ``hi = min(ceil(c(beta_slow)), rot - 1)``,
``c(b) = rot ln(L0 / (2 pi b)) / (2 ln theta)``; cos and sin times
``mscale(s, mscale) / mscale(s, mscale_all_dim)`` and ``m =
mscale(s, mscale_all_dim)``, ``mscale(s, a) = 0.1 a ln s + 1`` (Hugging
Face's ``DeepseekV2YarnRotaryEmbedding`` and ``DeepseekV2Attention``).

The MLP: SwiGLU ``(silu(x W_g) * (x W_u)) W_d`` in the first
``first_k_dense_replace`` layers; after them the MoE layer:

    p         = softmax(x W_router)                  [T, n_routed_experts]
    groups    = the n_group blocks of consecutive experts, each scored by
                its largest p; the topk_group best kept, the other
                experts' p set to 0 (``topk_method`` group_limited_greedy)
    (w, e)    = the num_experts_per_tok largest p and their experts
    w         = w * routed_scaling_factor   (norm_topk_prob false)
    y         = sum over the token's choices e that this rank holds of
                w * SwiGLU_e(x),  plus the shared experts' SwiGLU(x) once

**The share** (``share``): the rank holds the ``experts_held`` experts from
``expert_first`` on; the router keeps all its outputs and its top k, and
what the absent experts would add is left out here as in the program.  The
sum of all ranks' shares, with the shared experts once, is the whole layer
(the CPU tests check it).

Departures from the published model: the depth and the share (the file's
``reduced``); rotary on interleaved pairs where Hugging Face de-interleaves
the head first (the same rotation of permuted dims, the weights being
random); the weights drawn from the seed.

The control (``control=True``) computes the same forward with every matrix
product with a weight, the router's too, taking both inputs rounded to fp8
(e4m3, a scale per output column for weights and per token for
activations): the step below the bfloat16 the configuration serves in.
Layers are upcast one at a time and queries run in blocks, so the
reference fits beside the program's own weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["served_logits", "moe_layer", "yarn"]

FP8_MAX = 448.0        # largest finite float8_e4m3fn
_QUERY_BLOCK = 256     # attention rows at a time (bounds the score matrix)


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim``'s complement (the amax over ``dim``), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Linear:
    """Products with weights in float32, or with both inputs in fp8."""

    def __init__(self, control: bool):
        self.control = control

    def weight(self, w: torch.Tensor, fan_in: int = 0) -> torch.Tensor:
        """``w`` in float32; in fp8 with a scale per output column (the
        amax over the fan-in axis ``fan_in``)."""
        w = w.to(torch.float32)
        return _fp8(w, fan_in) if self.control else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, -1) if self.control else x

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ w


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _swiglu(x, w_gate, w_up, w_down, lin: _Linear):
    return lin(F.silu(lin(x, w_gate)) * lin(x, w_up), w_down)


def _mscale(s: float, a: float) -> float:
    return 1.0 if s <= 1 else 0.1 * a * math.log(s) + 1.0


def yarn(cfg: dict, device) -> Tuple[torch.Tensor, float, float]:
    """-> (f [rot / 2] float32, the cos/sin factor, m): the module
    docstring's YaRN, or plain RoPE (``theta^(-2i/rot)``, 1, 1) where the
    file states no ``rope_scaling``."""
    rot, theta = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    i = torch.arange(rot // 2, dtype=torch.float64, device=device)
    base = theta ** (-2.0 * i / rot)
    rs = cfg.get("rope_scaling")
    if not rs:
        return base.to(torch.float32), 1.0, 1.0
    if rs["type"] != "yarn":
        raise ValueError(f"rope_scaling {rs['type']!r}")
    s, l0 = float(rs["factor"]), rs["original_max_position_embeddings"]

    def c(b):
        return rot * math.log(l0 / (2 * math.pi * b)) / (2 * math.log(theta))
    lo = max(math.floor(c(rs["beta_fast"])), 0)
    hi = min(math.ceil(c(rs["beta_slow"])), rot - 1)
    hi = hi + 0.001 if hi == lo else hi
    ramp = ((i - lo) / (hi - lo)).clamp(0, 1)
    f = base * (1 - ramp) + base / s * ramp
    return (f.to(torch.float32),
            _mscale(s, rs["mscale"]) / _mscale(s, rs["mscale_all_dim"]),
            _mscale(s, rs["mscale_all_dim"]))


def _rope(x: torch.Tensor, f: torch.Tensor, factor: float) -> torch.Tensor:
    """x [T, heads, rot] at positions 0..T-1, rotated in interleaved pairs
    (2i, 2i + 1) by ``pos * f_i``."""
    ang = torch.arange(x.shape[0], dtype=torch.float32,
                       device=x.device)[:, None] * f
    cos = (torch.cos(ang) * factor)[:, None, :]
    sin = (torch.sin(ang) * factor)[:, None, :]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, b * cos + a * sin],
                       dim=-1).reshape(x.shape)


def _mla(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: dict,
         lin: _Linear, rope) -> torch.Tensor:
    """Causal latent attention of x [T, d] (the module docstring)."""
    t = x.shape[0]
    h, dn, dr = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], \
        cfg["qk_rope_head_dim"]
    dv, r, eps = cfg["v_head_dim"], cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    f, factor, m = rope
    cq = _norm(lin(x, p["w_dq"]), p["norm_q"]["scale"], eps)
    q = torch.einsum("tr,rhe->the", lin.act(cq), p["w_uq"])
    q_n, q_r = q[..., :dn], _rope(q[..., dn:], f, factor)
    dkv = lin(x, p["w_dkv"])
    c = _norm(dkv[:, :r], p["norm_kv"]["scale"], eps)
    k_r = _rope(dkv[:, None, r:], f, factor)[:, 0]              # [T, dr]
    k_n = torch.einsum("tr,rhd->thd", lin.act(c), p["w_uk"])
    v = torch.einsum("tr,rhd->thd", lin.act(c), p["w_uv"])
    scale = (dn + dr) ** -0.5 * m * m
    out = torch.empty((t, h, dv), dtype=torch.float32, device=x.device)
    keys = torch.arange(t, device=x.device)
    for r0 in range(0, t, _QUERY_BLOCK):
        r1 = min(t, r0 + _QUERY_BLOCK)
        s = (torch.einsum("qhd,khd->hqk", q_n[r0:r1], k_n[:r1]) +
             torch.einsum("qhd,kd->hqk", q_r[r0:r1], k_r[:r1])) * scale
        mask = keys[None, :r1] <= torch.arange(r0, r1,
                                               device=x.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
        out[r0:r1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  v[:r1])
    return lin(out.reshape(t, h * dv), p["wo"])


def _route(x: torch.Tensor, router: torch.Tensor, cfg: dict,
           lin: _Linear) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (w [T, k] float32, e [T, k] global expert ids): the module
    docstring's router."""
    e_all, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    if cfg.get("scoring_func", "softmax") != "softmax":
        raise ValueError(f"scoring_func {cfg['scoring_func']!r}")
    p = torch.softmax(lin(x, router), dim=-1)
    method = cfg.get("topk_method", "greedy")
    if method == "group_limited_greedy":
        n_g, keep = cfg["n_group"], cfg["topk_group"]
        grouped = p.reshape(-1, n_g, e_all // n_g)
        best = grouped.amax(-1).topk(keep, dim=-1).indices        # [T, keep]
        mask = torch.zeros(grouped.shape[:2], dtype=torch.bool,
                           device=x.device)
        mask.scatter_(1, best, True)
        p = grouped.masked_fill(~mask[..., None], 0.0).reshape(p.shape)
    elif method != "greedy":
        raise ValueError(f"topk_method {method!r}")
    w, e = p.topk(k, dim=-1)
    if cfg.get("norm_topk_prob", True) and k > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    else:
        w = w * cfg.get("routed_scaling_factor", 1.0)
    return w, e


def moe_layer(x: torch.Tensor, p: dict, cfg: dict, held: Sequence[int],
              lin: Optional[_Linear] = None, shared: bool = True
              ) -> torch.Tensor:
    """The MoE half of a layer on normed x [T, d]: the routed experts
    ``held`` (global ids; ``p``'s stacks hold them in that order) for the
    tokens routed to them, plus the shared experts where ``shared``.  ``p``
    in float32 (or rounded by ``lin``)."""
    lin = lin or _Linear(False)
    w, e = _route(x, p["router"], cfg, lin)
    y = torch.zeros_like(x)
    for j, ex in enumerate(held):
        hit = e == ex                                           # [T, k]
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        out = _swiglu(x[rows], p["w_gate"][j], p["w_up"][j], p["w_down"][j],
                      lin)
        y.index_add_(0, rows, out * (w * hit)[rows].sum(-1, keepdim=True))
    if shared and "shared" in p:
        s = p["shared"]
        y = y + _swiglu(x, s["w_gate"], s["w_up"], s["w_down"], lin)
    return y


def _held(cfg: dict) -> List[int]:
    share = cfg.get("share", {})
    first = share.get("expert_first", 0)
    return list(range(first, first + share.get("experts_held",
                                               cfg["n_routed_experts"])))


def _expect(tree: dict, keys: set, where: str):
    if set(tree) != keys:
        raise KeyError(f"{where}: weight leaves {sorted(tree)}, the "
                       f"configuration's equations need {sorted(keys)}")


def _layer_weights(p: dict, i: int, cfg: dict, lin: _Linear) -> dict:
    """Layer i's leaves in float32, rounded by ``lin`` (norms and the
    vectors stay float32)."""
    dense = i < cfg["first_k_dense_replace"]
    _expect(p, {"norm1", "attn", "norm2", "mlp" if dense else "moe"},
            f"layer {i}")
    _expect(p["attn"], {"w_dkv", "norm_kv", "w_uk", "w_uv", "wo", "w_dq",
                        "norm_q", "w_uq"}, f"layer {i} attn")
    out = {"norm1": p["norm1"]["scale"].float(),
           "norm2": p["norm2"]["scale"].float()}
    a = p["attn"]
    out["attn"] = {k: ({"scale": v["scale"].float()} if k.startswith("norm")
                       else lin.weight(v)) for k, v in a.items()}
    if dense:
        out["mlp"] = {k: lin.weight(v) for k, v in p["mlp"].items()}
        return out
    m = p["moe"]
    _expect(m, {"router", "w_up", "w_gate", "w_down", "shared"},
            f"layer {i} moe")
    if m["w_up"].shape[0] != len(_held(cfg)):
        raise ValueError(f"layer {i}: {m['w_up'].shape[0]} experts held, "
                         f"the file's share says {len(_held(cfg))}")
    out["moe"] = {"router": lin.weight(m["router"]),
                  **{k: lin.weight(m[k], 1) for k in ("w_up", "w_gate",
                                                      "w_down")},
                  "shared": {k: lin.weight(v) for k, v in
                             m["shared"].items()}}
    return out


def _block(x, w: dict, cfg: dict, lin: _Linear, rope) -> torch.Tensor:
    eps = cfg["rms_norm_eps"]
    x = x + _mla(_norm(x, w["norm1"], eps), w["attn"], cfg, lin, rope)
    h = _norm(x, w["norm2"], eps)
    if "mlp" in w:
        m = w["mlp"]
        return x + _swiglu(h, m["w_gate"], m["w_up"], m["w_down"], lin)
    return x + moe_layer(h, w["moe"], cfg, _held(cfg), lin)


@torch.no_grad()
def served_logits(weights: dict, cfg: dict, seqs: List[torch.Tensor],
                  starts: List[int], control: bool = False
                  ) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """Teacher-forced logits of each sequence ``seqs[i]`` (int64 token ids
    on the weights' device: a prompt and the served tokens but the last) at
    positions ``starts[i]..len - 1``: the logits that chose the served
    tokens.  -> per sequence ``(reference [n, vocab], control [n, vocab]
    or None)``, float32."""
    if len(weights["layers"]) != cfg["num_hidden_layers"]:
        raise ValueError("layer count differs from the configuration")
    _expect(weights, {"embed", "layers", "final_norm"}, "model")
    _expect(weights["embed"], {"tok", "head"}, "embed")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        tok = weights["embed"]["tok"]
        rope = yarn(cfg, tok.device)
        lins = [_Linear(False)] + ([_Linear(True)] if control else [])
        hs = [[tok[s].to(torch.float32) for s in seqs] for _ in lins]
        for i, p in enumerate(weights["layers"]):
            for lin, h in zip(lins, hs):
                w = _layer_weights(p, i, cfg, lin)
                for j in range(len(h)):
                    h[j] = _block(h[j], w, cfg, lin, rope)
                del w
        scale = weights["final_norm"]["scale"].float()
        out = []
        for lin, h in zip(lins, hs):
            head = lin.weight(weights["embed"]["head"])
            out.append([lin(_norm(x[s0:], scale, cfg["rms_norm_eps"]), head)
                        for x, s0 in zip(h, starts)])
            del head
        ctl = out[1] if control else [None] * len(seqs)
        return list(zip(out[0], ctl))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
