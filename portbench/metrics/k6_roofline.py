"""k6_roofline (kernels: ``kernels/flash_attn.py`` K6): the summed bound
of the profiled stretch's K6 calls over K6's summed device time (both
passes) in the profiler, in %.  Each decode tick calls K6 once a layer
over all S slots; its bytes are the cache rows the active slots'
positions need (pos + 1 each), not ``max_seq`` (``yardstick.
decode_count``)."""
from portbench import yardstick

#: device operations that are K6: split-KV partials and combine, and the
#: grouped-head kernels
PATTERNS = ("flash_decode_partial_kernel", "flash_decode_combine_kernel",
            "gqa_decode_")


def read(r):
    st = r.stretch
    if st is None:
        return None
    c = r.config
    h, kv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    slots = int(r.wl["slots"])
    bound = 0.0
    for t in st.ticks:
        pos = r.decode_positions[t]
        if pos:
            fl, nb = yardstick.decode_count(slots, h, kv, hd, hd,
                                            sum(p + 1 for p in pos),
                                            c["dtype"])
            bound += c["num_hidden_layers"] * yardstick.bound_s(
                fl, nb, c["dtype"])
    busy = sum(e - s for name, s, e in st.ops
               if any(p in name for p in PATTERNS)) / 1e9
    if bound == 0.0 or busy == 0.0:
        return None
    return bound / busy * 100.0
