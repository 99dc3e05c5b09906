"""mfu.mla_moe (model step: ``core/modelserve.py`` -> ``models/transformer.py``):
model FLOPs of the prefills and decode steps of the window's ticks outside
the profiled stretch, over those ticks' host seconds times the H100's 989
TFLOP/s of dense bf16, in %, for a decoder of latent attention (MLA) and
routed experts, as one expert-parallel rank holds it.

Two FLOPs a multiply-add, from the configuration file's widths:

* every layer, per token: the MLA projections (``W_dq``, ``W_uq``,
  ``W_dkv``, ``W_o``); a prefill of L tokens adds ``W_uk`` and ``W_uv`` on
  its latent and causal materialised attention over L (L + 1) / 2 (query,
  key) pairs; a decode step at cache position p adds the absorbed form's
  two head products (q through ``W_uk``, the latent through ``W_uv``) and
  attention over the latent and rope key of p + 1 positions;
* the dense layers' SwiGLU; each MoE layer's router and shared experts per
  token, and its routed experts per (token, held expert) pair that the
  program's counters (``moe.prefill``, ``moe.decode``: ``core/trace.py``)
  report: the dropless dispatch's padding rows are not counted.  A decode
  tick's pairs count every slot's row, so they are scaled by the tick's
  active rows over its slots;
* the head on one token a prefill and a decode step.

None where the program records no MoE counter."""
from portbench import yardstick

PROGRAM_TRACE = True


def _widths(c: dict):
    return (c["hidden_size"], c["num_attention_heads"], c["q_lora_rank"],
            c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
            c["v_head_dim"])


def _token_flops(c: dict) -> int:
    """Two FLOPs a multiply-add of everything one token meets that does
    not depend on its position or its routes, over all layers."""
    d, h, rq, r, dn, dr, dv = _widths(c)
    n = c["num_hidden_layers"]
    dense = min(c["first_k_dense_replace"], n)
    proj = d * rq + rq * h * (dn + dr) + d * (r + dr) + h * dv * d
    shared = 3 * d * c["moe_intermediate_size"] * c["n_shared_experts"]
    mlp = dense * 3 * d * c["intermediate_size"] + \
        (n - dense) * (d * c["n_routed_experts"] + shared)
    return 2 * (n * proj + mlp + d * c["vocab_size"])


def prefill_flops(c: dict, L: int) -> float:
    d, h, rq, r, dn, dr, dv = _widths(c)
    n = c["num_hidden_layers"]
    per = _token_flops(c) - 2 * d * c["vocab_size"] + \
        2 * n * r * h * (dn + dv)                       # k_nope and v
    pairs = L * (L + 1) // 2
    return float(L * per + 2 * d * c["vocab_size"] +
                 2 * n * pairs * h * (dn + dr + dv))


def decode_flops(c: dict, p: int) -> float:
    d, h, rq, r, dn, dr, dv = _widths(c)
    n = c["num_hidden_layers"]
    absorbed = h * dn * r + h * r * dv
    return float(_token_flops(c) + 2 * n * absorbed +
                 2 * n * (p + 1) * h * (2 * r + dr))


def read(r):
    if not r.steady or not r.trace:
        return None
    c = r.config
    expert = 2 * 3 * c["hidden_size"] * c["moe_intermediate_size"]
    slots = int(r.wl["slots"])
    flops, counted = 0.0, False
    for t in r.steady:
        flops += sum(prefill_flops(c, L) for L in r.prefill_lengths[t])
        flops += sum(decode_flops(c, p) for p in r.decode_positions[t])
        counts = r.trace[t][2] if r.trace[t] and len(r.trace[t]) > 2 else []
        for name, values in counts:
            if name == "moe.prefill":
                flops += expert * values[1]
            elif name == "moe.decode":
                flops += expert * values[1] * \
                    len(r.decode_positions[t]) / slots
            else:
                continue
            counted = True
    if not counted:
        return None
    secs = sum(r.tick_s[t] for t in r.steady)
    return flops / (secs * yardstick.BF16_FLOPS) * 100.0
