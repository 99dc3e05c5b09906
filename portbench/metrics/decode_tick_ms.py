"""decode_tick_ms (batcher): mean host ms of the batcher's decode ticks
(``decode_times``: admission, the graphed ``compiled_serve_tick`` and the
lanes' host read) in the window's ticks outside the profiled stretch."""


def read(r):
    xs = [x for t in r.steady for x in r.decode_times[t]]
    return sum(xs) / len(xs) * 1e3 if xs else None
