"""sched_self_ms (scheduler: ``runtime/scheduler.py`` ``Runtime.tick``):
the scheduler's own host time a tick, ms: the ticks' host seconds less
the batcher's prefill and decode host seconds, over the window's ticks
outside the profiled stretch.  It holds the client segments, dispatch,
routing and the drain."""


def read(r):
    if not r.steady:
        return None
    wall = sum(r.tick_s[t] for t in r.steady)
    inner = sum(r.prefill_s[t] + r.decode_s[t] for t in r.steady)
    return (wall - inner) / len(r.steady) * 1e3
