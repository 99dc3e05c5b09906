"""Timestamp synchronization across pipelines (paper §4.2.3, Fig. 4).

A copy of ``src/repro/core/sync.py`` (numpy only).

Mechanism (following nnstreamer's synchronization-in-mqtt-elements doc [21]):

* every pipeline has a local monotonic clock and a *base time* (the clock
  value when the pipeline started); buffer pts are relative to base time
  ("running time");
* publishers send ``base_time_utc`` — their base time converted to universal
  time using an NTP-estimated offset between local clock and UTC;
* subscribers convert incoming pts into their own running time:
  ``pts_local = pts_remote + base_time_utc(remote) - base_time_utc(local)``.

Clock skew between devices is what NTP estimates away: the classic
4-timestamp exchange gives offset = ((t1-t0)+(t2-t3))/2.

Everything here is control-plane (python/numpy); the per-buffer rebase is a
scalar add that rides along in the jitted pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .buffers import StreamBuffer

__all__ = ["SimClock", "ntp_offset", "PipelineClock"]

NS = 1_000_000_000


class SimClock:
    """A device-local clock with skew + jitter against simulated UTC.

    ``true_utc`` is the hidden reference; devices only see ``now()`` =
    true_utc + skew (+ jitter per read).  Tests drive true time explicitly so
    the NTP estimate is verifiable against ground truth.
    """

    def __init__(self, skew_ns: int = 0, jitter_ns: int = 0, seed: int = 0):
        self.skew_ns = int(skew_ns)
        self.jitter_ns = int(jitter_ns)
        self._true = 0
        self._rng = np.random.default_rng(seed)

    def advance(self, ns: int):
        self._true += int(ns)

    @property
    def true_utc(self) -> int:
        return self._true

    def now(self) -> int:
        j = int(self._rng.integers(-self.jitter_ns, self.jitter_ns + 1)) \
            if self.jitter_ns else 0
        return self._true + self.skew_ns + j


def ntp_offset(client: SimClock, server: SimClock,
               network_delay_ns: int = 500_000, rounds: int = 8) -> int:
    """Estimate (server - client) clock offset with NTP's 4-timestamp
    exchange, taking the minimum-delay round (standard NTP filtering)."""
    best: Optional[Tuple[int, int]] = None  # (delay, offset)
    for _ in range(rounds):
        t0 = client.now()
        client.advance(network_delay_ns)
        server.advance(network_delay_ns)
        t1 = server.now()
        t2 = server.now()
        client.advance(network_delay_ns)
        server.advance(network_delay_ns)
        t3 = client.now()
        delay = (t3 - t0) - (t2 - t1)
        offset = ((t1 - t0) + (t2 - t3)) // 2
        if best is None or delay < best[0]:
            best = (delay, offset)
    return best[1]


@dataclass
class PipelineClock:
    """Per-pipeline clock: local SimClock + NTP offset to UTC + base time."""

    clock: SimClock
    utc_offset_ns: int = 0     # estimated (utc - local); NTP-calibrated
    base_time_local: int = 0   # local clock at pipeline start

    def start(self):
        self.base_time_local = self.clock.now()
        return self

    def calibrate(self, reference: SimClock, **kw):
        """NTP against a reference (broker-adjacent NTP server)."""
        self.utc_offset_ns = ntp_offset(self.clock, reference, **kw)
        return self

    def base_time_utc(self) -> int:
        return self.base_time_local + self.utc_offset_ns

    def running_time(self) -> int:
        return self.clock.now() - self.base_time_local

    def rebase(self, buf: StreamBuffer) -> StreamBuffer:
        """Convert a remote buffer's pts into this pipeline's running time."""
        remote_base_utc = buf.meta["base_time_utc"]
        delta = remote_base_utc - self.base_time_utc()
        return buf.with_(pts=buf.pts + delta,
                         meta={k: v for k, v in buf.meta.items()
                               if k != "base_time_utc"})


def max_pairwise_skew(timestamps_ns: List[int]) -> int:
    return int(max(timestamps_ns) - min(timestamps_ns)) if timestamps_ns else 0
