"""k5_roofline (kernels: ``kernels/flash_attn.py`` K5): the summed bound
of the profiled stretch's K5 calls over K5's summed device time in the
profiler, in %.  Each prefill of L tokens calls K5 once a layer with q
[H, L, hd] and k/v [KV, L, hd], causal (``yardstick.attention_count``,
the bound its larger term at the card's peaks)."""
from portbench import yardstick

#: device operations that are K5: the bf16 routes of the prefill kernel
PATTERNS = ("flash_prefill_sm90_kernel", "flash_prefill_ws_kernel")


def read(r):
    st = r.stretch
    if st is None:
        return None
    c = r.config
    h, kv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    bound = 0.0
    for t in st.ticks:
        for L in r.prefill_lengths[t]:
            fl, nb = yardstick.attention_count(h, L, L, hd, hd, h // kv, True,
                                               c["dtype"])
            bound += c["num_hidden_layers"] * yardstick.bound_s(
                fl, nb, c["dtype"])
    busy = sum(e - s for name, s, e in st.ops
               if any(p in name for p in PATTERNS)) / 1e9
    if bound == 0.0 or busy == 0.0:
        return None
    return bound / busy * 100.0
