"""Plain reference of a dense decoder-only transformer, in float32 with
TF32 off: the logits the served tokens are judged against.

Plain ``torch`` operations on the weight tensors the benchmark drew; no
kernel, cache or batching, and nothing of the program is imported.  The
equations are the ones a configuration file states (``norm``, ``act``,
``mlp_glu``, ``rope_fraction``, ``rope_theta``, the widths): pre-norm
blocks ``x + attn(norm1(x))`` then ``x + mlp(norm2(x))``, causal
multi-query or grouped-query attention with rotary positions on the
leading ``rope_fraction`` of each head in interleaved pairs, a final norm
and an untied head.  Weights are laid out ``[d_in, d_out]`` (``x @ w``);
query head ``n * groups + g`` reads key/value head ``n``.

The control (``control=True``) computes the same forward with every
matrix product's two inputs rounded to fp8 (e4m3, a scale per output
column for weights and per token for activations): the step below the
bfloat16 the configurations serve in.  Layers are upcast one at a time,
so a 20-billion-parameter model fits beside the program's own weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["served_logits"]

FP8_MAX = 448.0        # largest finite float8_e4m3fn
_QUERY_BLOCK = 512     # attention rows at a time (bounds the score matrix)


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim``'s complement (the amax over ``dim``), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Linear:
    """``x @ w`` in float32, or with both inputs rounded to fp8."""

    def __init__(self, control: bool):
        self.control = control

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.to(torch.float32)
        return _fp8(w, 0) if self.control else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.control:
            x = _fp8(x, -1)
        return x @ w


def _norm(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: dict):
    if cfg["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + cfg["norm_eps"]) * p["scale"] + \
            p["bias"]
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) +
                           cfg["norm_eps"]) * p["scale"]


def _act(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg["act"] == "silu":
        return F.silu(x)
    if cfg["act"] == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown act {cfg['act']!r}")


def _rope(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """x [T, heads, hd] at positions 0..T-1: the leading ``rope_fraction``
    of hd rotated in interleaved pairs (2i, 2i + 1) by ``pos * theta **
    (-2i / rot)``."""
    t, _, hd = x.shape
    rot = int(hd * cfg["rope_fraction"]) // 2 * 2
    if rot == 0:
        return x
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(
        0, rot, 2, dtype=torch.float32, device=x.device) / rot))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., 0:rot:2], x[..., 1:rot:2]
    out = x.clone()
    out[..., 0:rot:2] = a * cos - b * sin
    out[..., 1:rot:2] = b * cos + a * sin
    return out


def _attention(q, k, v, cfg: dict) -> torch.Tensor:
    """Causal attention, q [T, H, hd], k/v [T, KV, hd] -> [T, H * hd]."""
    t, h, hd = q.shape
    kv = k.shape[1]
    qg = q.reshape(t, kv, h // kv, hd)
    out = torch.empty_like(qg)
    keys = torch.arange(t, device=q.device)
    for r0 in range(0, t, _QUERY_BLOCK):
        r1 = min(t, r0 + _QUERY_BLOCK)
        s = torch.einsum("tngd,snd->ngts", qg[r0:r1], k[:r1]) / math.sqrt(hd)
        mask = keys[None, :r1] <= torch.arange(r0, r1, device=q.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
        out[r0:r1] = torch.einsum("ngts,snd->tngd", torch.softmax(s, -1),
                                  v[:r1])
    return out.reshape(t, h * hd)


def _expect(tree: dict, keys: set, where: str):
    if set(tree) != keys:
        raise KeyError(f"{where}: weight leaves {sorted(tree)}, the "
                       f"configuration's equations need {sorted(keys)}")


def _block(x, p, cfg: dict, lin: _Linear) -> torch.Tensor:
    t = x.shape[0]
    h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    a = _norm(x, p["norm1"], cfg)
    at = p["attn"]
    q, k, v = lin(a, at["wq"]), lin(a, at["wk"]), lin(a, at["wv"])
    if cfg["attention_bias"]:
        q, k, v = q + at["bq"], k + at["bk"], v + at["bv"]
    q = _rope(q.reshape(t, h, hd), cfg)
    k = _rope(k.reshape(t, kv, hd), cfg)
    x = x + lin(_attention(q, k, v.reshape(t, kv, hd), cfg), at["wo"])
    m = _norm(x, p["norm2"], cfg)
    mp = p["mlp"]
    up = lin(m, mp["w_up"])
    hid = _act(cfg, lin(m, mp["w_gate"])) * up if cfg["mlp_glu"] \
        else _act(cfg, up)
    return x + lin(hid, mp["w_down"])


def _layer_weights(p: dict, cfg: dict, lins: Sequence[_Linear]):
    """One layer's leaves in float32 for each linear rule (norms stay
    float32 for both)."""
    norm_keys = {"scale", "bias"} if cfg["norm"] == "layernorm" else {"scale"}
    attn_keys = {"wq", "wk", "wv", "wo"} | (
        {"bq", "bk", "bv"} if cfg["attention_bias"] else set())
    mlp_keys = {"w_up", "w_down"} | ({"w_gate"} if cfg["mlp_glu"] else set())
    _expect(p, {"norm1", "attn", "norm2", "mlp"}, "layer")
    _expect(p["norm1"], norm_keys, "norm1")
    _expect(p["norm2"], norm_keys, "norm2")
    _expect(p["attn"], attn_keys, "attn")
    _expect(p["mlp"], mlp_keys, "mlp")
    out = []
    for lin in lins:
        w = {n: {k: v.to(torch.float32) for k, v in p[n].items()}
             for n in ("norm1", "norm2")}
        w["attn"] = {k: (lin.weight(v) if k.startswith("w")
                         else v.to(torch.float32))
                     for k, v in p["attn"].items()}
        w["mlp"] = {k: lin.weight(v) for k, v in p["mlp"].items()}
        out.append(w)
    return out


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
        lins = [_Linear(False)] + ([_Linear(True)] if control else [])
        tok = weights["embed"]["tok"]
        hs = [[tok[s].to(torch.float32) for s in seqs] for _ in lins]
        for p in weights["layers"]:
            for lin, w, h in zip(lins, _layer_weights(p, cfg, lins), hs):
                for i in range(len(h)):
                    h[i] = _block(h[i], w, cfg, lin)
        fn = {k: v.to(torch.float32)
              for k, v in weights["final_norm"].items()}
        out = []
        for lin, h in zip(lins, hs):
            head = lin.weight(weights["embed"]["head"])
            out.append([lin(_norm(x[s0:], fn, cfg), head)
                        for x, s0 in zip(h, starts)])
            del head
        ctl = out[1] if control else [None] * len(seqs)
        return list(zip(out[0], ctl))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
