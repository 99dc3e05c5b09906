"""moe_prefill_ms (read as ``moe_prefill_ms.mla_moe``; model step:
``models/transformer.py`` ``block_prefill``): host ms of the program's
``moe`` spans a prefill, in the window's ticks outside the profiled stretch:
each MoE layer's norm, router, dropless dispatch, held and shared experts
and combine, as the host launches them (``core/trace.py``).  None where
the program records no such span."""
PROGRAM_TRACE = True


def read(r):
    if not r.trace:
        return None
    n = sum(r.prefills[t] for t in r.steady)
    ns = sum(s[2] - s[1] for t in r.steady if r.trace[t]
             for s in r.trace[t][0] if s[0] == "moe")
    return ns / 1e6 / n if n and ns else None
