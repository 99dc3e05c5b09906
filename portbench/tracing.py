"""The traced stretch: ``torch.profiler`` over whole scheduler ticks in the
middle of a ``--trace 1`` window, reduced to device operations, the
device's busy time and the idle gaps named by the host span around them.

The profiler records the card's activity alone (CUPTI: kernels, graph
replays' kernels included, copies and sets): recording every host
operation as well doubled the host time of an eager prefill, and so the
idle time it was to measure.  Host spans are the benchmark's own, around
the calls into each layer (:data:`SPANS`), on the wall clock in ns that
the profiler's timestamps use, so a gap reads as what the host was doing
while the card had nothing to run.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["SPANS", "Stretch", "Span", "start", "stop", "busy_intervals",
           "busy_seconds", "breakdown"]

#: host span names: the scheduler's tick, the batcher's prefill and its
#: decode tick (admission, the graphed tick and the lanes' read)
SPANS = {"tick": "scheduler: Runtime.tick",
         "prefill": "batcher: host_prefill (lm_prefill)",
         "decode": "batcher: decode tick (admit + compiled_serve_tick)"}


@dataclass
class Stretch:
    """One profiled stretch: the ticks it covers, its host-clock length,
    and the trace's device operations and host spans (ns, one clock)."""
    ticks: List[int] = field(default_factory=list)
    seconds: float = 0.0
    ops: List[Tuple[str, int, int]] = field(default_factory=list)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    t0_ns: int = 0
    t1_ns: int = 0


class Span:
    """A host span of ``kind`` (:data:`SPANS`) added to ``stretch.spans``
    on the profiler's clock."""

    def __init__(self, stretch: Stretch, kind: str):
        self.stretch, self.name = stretch, SPANS[kind]

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        self.stretch.spans.append((self.name, self.t0, time.time_ns()))


def start(cuda: bool = True):
    """Begin profiling the card (the host, where there is none: a CPU run
    has no device operations to keep)."""
    from torch.profiler import ProfilerActivity, profile
    act = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    prof = profile(activities=[act], record_shapes=False, with_stack=False)
    prof.__enter__()
    return prof


def stop(prof, stretch: Stretch) -> Stretch:
    """End ``prof`` and keep its device operations."""
    prof.__exit__(None, None, None)
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and \
                not e.is_user_annotation():
            s = int(e.start_ns())
            stretch.ops.append((e.name(), s, s + int(e.duration_ns())))
    return stretch


def busy_intervals(ops: List[Tuple[str, int, int]]) -> List[Tuple[int, int]]:
    """The union of the device operations' intervals, in order."""
    out: List[List[int]] = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(stretch: Stretch) -> float:
    lo, hi = stretch.t0_ns, stretch.t1_ns
    return sum(max(0, min(e, hi) - max(s, lo))
               for s, e in busy_intervals(stretch.ops)) / 1e9


def _host_at(spans, t: int) -> str:
    """The innermost benchmark span that holds time ``t``."""
    best: Optional[Tuple[str, int, int]] = None
    for name, s, e in spans:
        if not (s <= t < e):
            continue
        if best is None or e - s < best[2] - best[1]:
            best = (name, s, e)
    return best[0] if best else "host: between the benchmark's spans"


def breakdown(stretch: Stretch, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time ``[[name, seconds]]``
    and the longest idle gaps ``[[what the host was doing, seconds]]``."""
    by_op: Dict[str, int] = {}
    for name, s, e in stretch.ops:
        by_op[name] = by_op.get(name, 0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    edge = stretch.t0_ns
    for s, e in busy_intervals(stretch.ops) + [(stretch.t1_ns,
                                                stretch.t1_ns)]:
        if s > edge:
            gaps.append((s - edge, _host_at(stretch.spans, (edge + s) // 2)))
        edge = max(edge, e)
    gaps.sort(key=lambda g: -g[0])
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, ns / 1e9] for ns, n in gaps[:top]]}
