"""Full-softmax attention references (plain torch), in the JAX package's
layouts and signatures (``src/repro/kernels/ref.py``).  They materialize the
whole score tensor in f32 — the thing the flash kernels exist to avoid — and
serve as the oracles the kernels and their plain versions are held to."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attn_ref(q, k, v, *, causal: bool = True, kv_groups: int = 1):
    """q [BH, Sq, dk], k/v [BH//kv_groups, Sk, d*] -> [BH, Sq, dv]."""
    bh, sq, dk = q.shape
    if kv_groups > 1:
        k = k.repeat_interleave(kv_groups, dim=0)
        v = v.repeat_interleave(kv_groups, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * (dk ** -0.5)
    if causal:
        sk = k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)


def attn_decode_ref(q, k, v, pos, *, kv_groups: int = 1):
    """q [BH, dk] (one query position), cached k/v [BKV, Sk, d*], ``pos``
    the last valid cache index -> [BH, dv]."""
    dk = q.shape[-1]
    if kv_groups > 1:
        k = k.repeat_interleave(kv_groups, dim=0)
        v = v.repeat_interleave(kv_groups, dim=0)
    s = torch.einsum("hd,hkd->hk", q.float(), k.float()) * (dk ** -0.5)
    sk = k.shape[1]
    valid = torch.arange(sk, device=q.device) <= int(pos)
    s = torch.where(valid[None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hk,hkd->hd", p, v.float()).to(q.dtype)
