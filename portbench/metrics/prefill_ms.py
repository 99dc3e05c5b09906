"""prefill_ms (batcher: ``core/batching.py`` ``StreamingQueryBatcher``):
host ms a prefill, the batcher's ``prefill_seconds`` over its
``prefills`` in the window's ticks outside the profiled stretch (each
prefill's clock ends in the first token's host read)."""


def read(r):
    n = sum(r.prefills[t] for t in r.steady)
    if n == 0:
        return None
    return sum(r.prefill_s[t] for t in r.steady) / n * 1e3
