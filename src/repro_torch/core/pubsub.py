"""The ``Channel`` of ``src/repro/core/pubsub.py``: a bounded FIFO standing
in for a network socket between two pipelines (the query protocol's request
and response channels).  ``mqttsink``/``mqttsrc`` wait for the pub/sub
slice (ROADMAP M3)."""
from __future__ import annotations

from collections import deque
from typing import Deque, Optional

from .buffers import StreamBuffer

__all__ = ["Channel"]


class Channel:
    """Bounded point-to-point FIFO with byte accounting; a push onto a full
    channel drops the oldest frame (leaky) and counts it.  The broadcast to
    attached subscriber queues comes with the pub/sub elements."""

    def __init__(self, capacity: int = 16):
        self.q: Deque = deque()
        self.capacity = capacity
        self.bytes_sent = 0
        self.msgs_sent = 0
        self.drops = 0

    def push(self, buf: StreamBuffer, nbytes: Optional[int] = None) -> bool:
        """Returns False iff the push displaced a queued frame."""
        self.bytes_sent += buf.nbytes() if nbytes is None else nbytes
        self.msgs_sent += 1
        dropped = len(self.q) >= self.capacity
        if dropped:
            self.drops += 1
            self.q.popleft()
        self.q.append(buf)
        return not dropped

    def pop(self) -> Optional[StreamBuffer]:
        return self.q.popleft() if self.q else None

    def __len__(self):
        return len(self.q)
