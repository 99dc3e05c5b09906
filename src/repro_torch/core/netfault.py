"""Adversarial network fabric: lossy-transport faults + delivery semantics.

Port of ``src/repro/core/netfault.py`` (DESIGN.md §10).  Every among-device
hop rides an in-process :class:`~.pubsub.Channel`, which never loses,
duplicates, reorders, corrupts or delays a frame.  This module supplies
both halves of the lossy network:

* **Fault model** — a :class:`FaultPolicy` installed on a channel by a
  :class:`FaultFabric` wraps ``Channel.push`` and deterministically (seeded
  LCG, fault clock driven by scheduler ticks) injects drop, duplication,
  payload corruption (bit flips), reordering, delay (frames held N ticks)
  and scripted directional partition windows, each counted on the link's
  ledger.

* **Delivery protocol** — senders stamp each frame with a ``(sender_id,
  seq)`` delivery id (``meta["dseq"]``) and a CRC32 payload checksum
  (``meta["crc"]``); a receiver-side :class:`DeliveryGuard` rejects corrupt
  frames (counted), dedups by delivery id through a bounded LRU window,
  and replays the cached answer for a retransmit whose original answer was
  lost.  Senders retransmit on timeout with exponential backoff
  (:class:`DeliveryPolicy`).  At-least-once + dedup = effectively-once.

The message-layer conservation law, asserted per link::

    sent == accepted + dropped_by_fault + rejected_corrupt + deduped
            + in_flight + overflow_drops + purged

**The CRC domain** (:func:`checksum`): host-resident bytes only.  A numpy
array and a torch tensor on the CPU are covered; a CUDA tensor is exempt,
so stamping and verifying a frame on the card never copies it to the host
(the clean-link overhead rule).  The codec payloads (``Quant8Payload``,
``SparsePayload``) are covered leaf by leaf under the same rule.  The bit
flip of the fault model (:meth:`FaultLink._flip`) always makes a HOST copy
of every tensor of the frame it damages, so a corrupted frame whose sender
stamped it on the card verifies against bytes the stamp never covered and
is rejected: corruption cannot hide behind the exemption.

Numpy, torch and stdlib only.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .buffers import Quant8Payload, SparsePayload, tree_flatten, \
    tree_unflatten

__all__ = [
    "DeliveryPolicy", "DeliveryGuard", "FaultPolicy", "FaultLink",
    "FaultFabric", "checksum", "memoize_crc", "stamp", "link_for", "note",
    "note_purged", "lcg_stream",
]


def lcg_stream(seed: int = 0):
    """Deterministic uniform(0,1) stream (32-bit LCG), the generator of the
    chaos harness."""
    state = (int(seed) & 0xFFFFFFFF) or 1
    while True:
        state = (1664525 * state + 1013904223) & 0xFFFFFFFF
        yield state / 2.0 ** 32


# -- integrity ----------------------------------------------------------------

def _is_payload(t) -> bool:
    return isinstance(t, (Quant8Payload, SparsePayload))


def _host_resident(t) -> bool:
    """Whether a leaf's bytes lie in the CRC domain: a numpy array or a
    torch tensor on the CPU."""
    if isinstance(t, np.ndarray):
        return True
    return isinstance(t, torch.Tensor) and t.device.type == "cpu"


def _crc_leaf(t, c: int) -> int:
    """Fold one leaf's dtype/shape framing and raw bytes into ``c`` when
    it is host-resident; a CUDA tensor (or any other leaf) adds nothing."""
    if not _host_resident(t):
        return c
    if isinstance(t, np.ndarray):
        c = zlib.crc32(t.dtype.str.encode(), c)
        c = zlib.crc32(repr(t.shape).encode(), c)
        return zlib.crc32(t.tobytes(), c)
    c = zlib.crc32(str(t.dtype).encode(), c)
    c = zlib.crc32(repr(tuple(t.shape)).encode(), c)
    # a byte view: bf16 has no numpy dtype
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return zlib.crc32(raw.numpy().tobytes(), c)


def checksum(buf) -> int:
    """CRC32 over the payload's HOST-RESIDENT bytes (module docstring):
    every numpy array's and CPU tensor's dtype/shape framing and raw bytes,
    codec payloads leaf by leaf, plus the presentation timestamp when it
    is a host integer (a CPU tensor's value included; a CUDA pts is
    exempt — reading it would sync).  Stamp and verify apply the same rule
    to the same objects.

    The value is memoized on the buffer object (``_crc_memo``): every
    mutation path (``with_``, codec encode, ``_flip``) builds a FRESH
    buffer without the memo, so a suspect frame is always recomputed; the
    memo only short-circuits re-verifying the object the sender stamped."""
    c = getattr(buf, "_crc_memo", None)
    if c is not None:
        return c
    pts = getattr(buf, "pts", None)
    if isinstance(pts, torch.Tensor) and pts.device.type == "cpu" and \
            pts.numel() == 1 and not pts.is_floating_point():
        pts = int(pts)
    c = zlib.crc32(b"%d" % pts) if isinstance(pts, (int, np.integer)) \
        else zlib.crc32(b"-")
    for t in buf.tensors:
        if _is_payload(t):
            for leaf in tree_flatten(t)[0]:
                c = _crc_leaf(leaf, c)
        else:
            c = _crc_leaf(t, c)
    c &= 0xFFFFFFFF
    memoize_crc(buf, c)
    return c


def memoize_crc(buf, c: int) -> None:
    """Attach a computed payload checksum to ``buf`` (``meta`` is not part
    of the CRC domain, so a copy that only changed meta may carry it).
    Never attach a value the payload was not computed from."""
    try:
        buf._crc_memo = c
    except AttributeError:
        pass


def stamp(buf, dseq: Tuple[int, int]):
    """Return ``buf`` with delivery id + checksum in its routing meta."""
    c = checksum(buf)
    out = buf.with_(meta={**buf.meta, "dseq": dseq, "crc": c})
    memoize_crc(out, c)
    return out


# -- delivery protocol --------------------------------------------------------

@dataclass(frozen=True)
class DeliveryPolicy:
    """Knobs for the at-least-once + dedup delivery layer.

    ``timeout_ticks`` is the wait before the FIRST retransmit; each further
    retransmit waits ``backoff``x longer, capped at ``max_backoff_ticks``.
    ``window`` bounds the receiver's dedup LRU and answer replay cache —
    size it above the worst-case in-flight population or an evicted id can
    be re-served.  ``hop_retries`` bounds the synchronous stage-hop
    retransmit loop (a hop cannot wait a tick: the chain holds the slot)."""
    timeout_ticks: int = 2
    backoff: float = 2.0
    max_backoff_ticks: int = 16
    window: int = 1024
    hop_retries: int = 4

    def __post_init__(self):
        # the schedule reaches its cap within a few retries: precompute the
        # prefix so the per-dispatch lookup is a tuple index
        object.__setattr__(self, "_retry_table", tuple(
            self._retry_at(k) for k in range(16)))

    def _retry_at(self, retries: int) -> int:
        t = self.timeout_ticks * (self.backoff ** int(retries))
        return max(1, min(int(t), self.max_backoff_ticks))

    def retry_in(self, retries: int) -> int:
        """Ticks to wait after the ``retries``-th send (0 = the original)."""
        if 0 <= retries < 16:
            return self._retry_table[retries]
        return self._retry_at(retries)


class DeliveryGuard:
    """Receiver-side delivery guard: CRC verification, bounded-LRU dedup by
    delivery id, and a bounded replay cache of committed answers.

    ``check(raw, channel)`` returns ``"ok"`` / ``"dup"`` / ``"corrupt"`` and
    books the verdict on the channel's fault link (if any) via :func:`note`.
    Frames without a ``dseq`` (edge clients) pass through as ``"ok"``."""

    def __init__(self, policy: Optional[DeliveryPolicy] = None):
        self.policy = policy or DeliveryPolicy()
        self._seen: "OrderedDict[Tuple[int, int], bool]" = OrderedDict()
        self._answers: "OrderedDict[Tuple[int, int], object]" = OrderedDict()
        self.accepted = 0
        self.deduped = 0
        self.rejected_corrupt = 0
        self.replayed = 0

    def check(self, raw, channel=None) -> str:
        meta = raw.meta or {}
        crc = meta.get("crc")
        if crc is not None and checksum(raw) != int(crc):
            self.rejected_corrupt += 1
            note(channel, "rejected_corrupt")
            return "corrupt"
        dseq = meta.get("dseq")
        if dseq is not None and dseq in self._seen:
            self._seen.move_to_end(dseq)
            self.deduped += 1
            note(channel, "deduped")
            return "dup"
        if dseq is not None:
            self._seen[dseq] = True
            while len(self._seen) > self.policy.window:
                self._seen.popitem(last=False)
        self.accepted += 1
        note(channel, "accepted")
        return "ok"

    def seen(self, dseq) -> bool:
        return dseq in self._seen

    def forget(self, dseq) -> None:
        """Evict a delivery id whose request was shed UNSERVED (endpoint
        death mid-queue): the failover re-dispatch reuses the id, and a
        window that still held it would dedup the retry into a void."""
        if dseq is None:
            return
        self._seen.pop(dseq, None)
        self._answers.pop(dseq, None)

    # -- answer replay cache --------------------------------------------------
    def record_answer(self, dseq, replay_fn) -> None:
        """Remember how to re-send the committed answer for ``dseq``: the
        closure re-pushes the exact payload object already shipped, so a
        replay is bitwise the original as long as nothing writes into that
        payload after it shipped (every serve path returns fresh
        tensors)."""
        if dseq is None:
            return
        self._answers[dseq] = replay_fn
        while len(self._answers) > self.policy.window:
            self._answers.popitem(last=False)

    def replay_answer(self, dseq) -> bool:
        fn = self._answers.get(dseq)
        if fn is None:
            return False
        fn()
        self.replayed += 1
        return True

    def stats(self) -> Dict[str, int]:
        return {"accepted": self.accepted, "deduped": self.deduped,
                "rejected_corrupt": self.rejected_corrupt,
                "replayed": self.replayed}


# -- fault model --------------------------------------------------------------

@dataclass(frozen=True)
class FaultPolicy:
    """Per-link fault rates + scripted partition windows.  Rates are carved
    out of ONE uniform draw per frame (disjoint bands), so enabling one
    fault does not perturb which frames another hits.  ``partitions`` is a
    tuple of ``(t0, t1)`` fault-clock windows during which the link eats
    every frame (directional: a link wraps ONE channel)."""
    seed: int = 0
    drop: float = 0.0
    dup: float = 0.0
    corrupt: float = 0.0
    reorder: float = 0.0
    delay: float = 0.0
    delay_ticks: Tuple[int, int] = (1, 3)
    partitions: Tuple[Tuple[int, int], ...] = ()


def _host_copy(t):
    """A host-resident copy of one tensor of a frame: a torch tensor comes
    to the CPU (copied even when already there), a codec payload leaf by
    leaf, anything else as a numpy array (the JAX package's
    ``np.asarray(t).copy()``)."""
    if isinstance(t, torch.Tensor):
        return torch.empty(t.shape, dtype=t.dtype).copy_(t.detach())
    if _is_payload(t):
        leaves, td = tree_flatten(t)
        return tree_unflatten(td, [_host_copy(l) for l in leaves])
    return np.array(t, order="C")


def _byte_views(t) -> List:
    """Flat uint8 views of a host copy's leaves, in leaf order."""
    leaves = tree_flatten(t)[0] if _is_payload(t) else [t]
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf.reshape(-1).view(torch.uint8))
        else:
            out.append(leaf.reshape(-1).view(np.uint8))
    return out


def _nbytes(views) -> int:
    return sum(int(v.shape[0]) for v in views)


class FaultLink:
    """One faulty unidirectional link: wraps a channel's ``push``."""

    def __init__(self, channel, policy: FaultPolicy, fabric: "FaultFabric",
                 name: str):
        self.channel = channel
        self.policy = policy
        self.fabric = fabric
        self.name = name
        self._rng = lcg_stream(policy.seed)
        self._orig_push = channel.push
        self._held: List[Tuple[int, object, Optional[int]]] = []
        self._swap: Optional[Tuple[object, Optional[int]]] = None
        # sender side
        self.sent = 0
        self.injected_dups = 0
        self.dropped_fault = 0
        self.corrupted = 0
        self.delayed = 0
        self.reordered = 0
        self.delivered = 0
        self.overflow_drops = 0
        # receiver side, booked back by note()
        self.accepted = 0
        self.deduped = 0
        self.rejected_corrupt = 0
        self.purged = 0
        channel.push = self.push

    # -- the faulty push ------------------------------------------------------
    def partitioned(self, t: int) -> bool:
        return any(t0 <= t < t1 for t0, t1 in self.policy.partitions)

    def push(self, buf, nbytes=None) -> bool:
        p = self.policy
        self.sent += 1
        if self.partitioned(self.fabric.now):
            self.dropped_fault += 1
            return True     # the network ate it; the sender can't know
        r = next(self._rng)
        edge = p.drop
        if r < edge:
            self.dropped_fault += 1
            return True
        edge += p.dup
        if r < edge:
            self.sent += 1  # the injected copy counts as a send
            self.injected_dups += 1
            ok = self._deliver(buf, nbytes)
            self._deliver(buf, nbytes)
            return ok
        edge += p.corrupt
        if r < edge:
            self.corrupted += 1
            return self._deliver(self._flip(buf), nbytes)
        edge += p.delay
        if r < edge:
            lo, hi = p.delay_ticks
            hold = int(lo) + int(next(self._rng) * (int(hi) - int(lo) + 1))
            self.delayed += 1
            self._held.append((self.fabric.now + max(1, hold), buf, nbytes))
            return True
        edge += p.reorder
        if r < edge:
            if self._swap is None:
                self._swap = (buf, nbytes)
                self.reordered += 1
                return True
            held, self._swap = self._swap, None
            ok = self._deliver(buf, nbytes)
            self._deliver(*held)
            return ok
        return self._deliver(buf, nbytes)

    def _deliver(self, buf, nbytes) -> bool:
        ok = self._orig_push(buf, nbytes)
        self.delivered += 1
        if not ok:
            self.overflow_drops += 1
        return ok

    def _flip(self, buf):
        """Flip one payload bit (rng-chosen tensor, byte, bit) in a fresh
        HOST copy of the frame's tensors.  Structure — dtype, shape, meta —
        survives, so only the checksum can tell, and the copy lies in the
        CRC domain even when the sender's tensors were on the card.  The
        draws are the JAX package's (tensor index, byte position, bit) over
        the same byte counts; a codec payload counts its leaves' bytes in
        leaf order (the JAX package cannot flip one: ROADMAP Queue 3)."""
        tensors = [_host_copy(t) for t in buf.tensors]
        views = [_byte_views(t) for t in tensors]
        flippable = [i for i, v in enumerate(views) if _nbytes(v) > 0]
        if not flippable:
            # nothing to flip in the payload: corrupt the checksum itself
            meta = dict(buf.meta or {})
            if "crc" in meta:
                meta["crc"] = int(meta["crc"]) ^ 1
                return buf.with_(meta=meta)
            return buf
        i = flippable[int(next(self._rng) * len(flippable)) % len(flippable)]
        size = _nbytes(views[i])
        pos = int(next(self._rng) * size) % size
        bit = 1 << (int(next(self._rng) * 8) % 8)
        for flat in views[i]:
            n = int(flat.shape[0])
            if pos < n:
                flat[pos] ^= bit
                break
            pos -= n
        return buf.with_(tensors=tuple(tensors))

    # -- fault clock ----------------------------------------------------------
    def step(self, now: int) -> None:
        """Release due delayed frames (and any straggling reorder stash);
        called once per scheduler tick by the owning fabric."""
        if self._swap is not None:
            held, self._swap = self._swap, None
            self._deliver(*held)
        if not self._held:
            return
        due = [h for h in self._held if h[0] <= now]
        if not due:
            return
        self._held = [h for h in self._held if h[0] > now]
        for _, buf, nbytes in due:
            self._deliver(buf, nbytes)

    def uninstall(self) -> None:
        if self.channel.push == self.push:
            self.channel.push = self._orig_push
        _REGISTRY.pop(id(self.channel), None)

    # -- ledger ---------------------------------------------------------------
    def queued(self) -> int:
        ch = self.channel
        return len(ch.q) + sum(len(rx.q) for rx in ch.consumers)

    def in_flight(self) -> int:
        return len(self._held) + (1 if self._swap is not None else 0) \
            + self.queued()

    def conservation(self) -> Tuple[int, Dict[str, int]]:
        terms = {"accepted": self.accepted,
                 "dropped_by_fault": self.dropped_fault,
                 "rejected_corrupt": self.rejected_corrupt,
                 "deduped": self.deduped,
                 "in_flight": self.in_flight(),
                 "overflow_drops": self.overflow_drops,
                 "purged": self.purged}
        return self.sent, terms

    def stats(self) -> Dict[str, int]:
        sent, terms = self.conservation()
        return {"sent": sent, "delivered": self.delivered,
                "injected_dups": self.injected_dups,
                "corrupted": self.corrupted, "delayed": self.delayed,
                "reordered": self.reordered, **terms}


class FaultFabric:
    """The set of faulty links in one scenario + the shared fault clock.

    Set ``rt.fabric = fabric`` and the runtime steps it at the top of every
    tick (releasing delayed frames before that tick's dispatch), or call
    ``step()`` by hand.  Link seeds fix the fault schedule, the tick clock
    fixes *when*."""

    def __init__(self):
        self.links: Dict[int, FaultLink] = {}
        self.now = 0

    def install(self, channel, policy: FaultPolicy, name: Optional[str] = None
                ) -> FaultLink:
        link = FaultLink(channel, policy, self,
                         name or f"link{len(self.links)}")
        self.links[id(channel)] = link
        _REGISTRY[id(channel)] = link
        return link

    def uninstall(self, channel) -> None:
        link = self.links.pop(id(channel), None)
        if link is not None:
            link.uninstall()

    def step(self, now: Optional[int] = None) -> None:
        self.now = self.now + 1 if now is None else int(now)
        for link in list(self.links.values()):
            link.step(self.now)

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {link.name: link.stats() for link in self.links.values()}

    def assert_conservation(self) -> None:
        """The message-layer conservation law, per link: every frame ever
        pushed is accepted, eaten by a fault, rejected as corrupt, deduped,
        in flight, overflowed, or purged by an endpoint teardown."""
        for link in self.links.values():
            sent, terms = link.conservation()
            total = sum(terms.values())
            assert sent == total, (
                f"message conservation violated on {link.name}: "
                f"sent={sent} != {total} = sum({terms})")


# -- link registry ------------------------------------------------------------
# Receiver-side verdicts happen far from the FaultLink that carried the
# frame (a guard pops from a channel it never installed anything on), so
# the registry maps channel identity -> link and note() books the verdict
# back.  A no-op for channels with no link.

_REGISTRY: Dict[int, FaultLink] = {}


def link_for(channel) -> Optional[FaultLink]:
    return _REGISTRY.get(id(channel)) if channel is not None else None


def note(channel, field: str, n: int = 1) -> None:
    if not _REGISTRY:        # no chaos scenario installed: stay off the path
        return
    link = _REGISTRY.get(id(channel)) if channel is not None else None
    if link is not None:
        setattr(link, field, getattr(link, field) + n)


def note_purged(channel, n: int) -> None:
    """An endpoint teardown cleared ``n`` queued frames (they move to the
    reconfig orphan ledger) — keep the message ledger exact."""
    if n:
        note(channel, "purged", n)
