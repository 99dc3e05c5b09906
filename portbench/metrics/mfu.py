"""mfu (model step: ``core/modelserve.py`` -> ``models/transformer.py``):
model FLOPs of the prefills and decode steps of the window's ticks
outside the profiled stretch, over those ticks' host seconds times the
H100's 989 TFLOP/s of dense bf16, in %.  A prompt of L tokens counts
every layer's projections on L tokens, causal attention and the head once;
a decode step at cache position p counts one token's projections,
attention over p + 1 keys and the head (``yardstick.prefill_flops``,
``decode_flops``)."""
from portbench import yardstick


def read(r):
    if not r.steady:
        return None
    flops = sum(yardstick.prefill_flops(r.config, L)
                for t in r.steady for L in r.prefill_lengths[t]) + \
        sum(yardstick.decode_flops(r.config, p)
            for t in r.steady for p in r.decode_positions[t])
    secs = sum(r.tick_s[t] for t in r.steady)
    return flops / (secs * yardstick.BF16_FLOPS) * 100.0
