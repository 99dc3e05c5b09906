"""Elastic server fleets: autoscaling as a reconfiguration (DESIGN.md §9).

Port of ``src/repro/runtime/autoscale.py``.  The autoscaler only composes
what exists:

* the **signal** is :meth:`Broker.scaling_signal`: live replica count and
  per-replica load, which the runtime's heartbeat refreshes every tick from
  each endpoint's queue depth, admission backlog and (under QoS) active
  streams;
* **scale-up** is a §6 reconfiguration: a fresh Device on the runtime's
  torch device gets an empty placeholder run (retired, so the scheduler
  skips it), and one ``add``/``link`` edit grows the replica pipeline into
  it through prepare → warm → commit.  The replica registers inside the
  commit, so it becomes discoverable and runnable at once.  Its params are
  drawn from a fresh ``make_generator(seed, device)`` for every scale-up,
  so every replica holds the same weights and answers bitwise alike,
  whichever one join-shortest-queue picks.  A replica whose device dies
  mid-warm rolls back on the ordinary ``target-dead`` path;
* **scale-down** is a remove-all reconfiguration of an idle replica (no
  queued request, no admission backlog, no stream, no occupied slot), so
  draining loses nothing; the commit releases the replica's graph bindings
  and folds its tenant ledgers into the runtime's archive.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..core.pipeline import Pipeline
from ..device import make_generator
from .scheduler import Device, Runtime

__all__ = ["Autoscaler"]


class Autoscaler:
    """Load-driven replica controller for one serve topic.

    ``factory(index)`` builds a FRESH replica pipeline (same model preset,
    same topic), e.g. ``lambda i: serve_pipeline(model, operation=op)``.
    ``seed`` seeds every replica's params: the same seed as the first
    replica's generator gives bitwise-equal weights.

    Thresholds are in heartbeat-load units (requests + backlog + active
    streams): scale up when the topic's MEAN load per replica reaches
    ``high_load``; scale down when it drops to ``low_load`` and one of OUR
    replicas is drained idle.  ``cooldown_ticks`` separates actions, and a
    transition in flight is never raced by the next decision.
    """

    def __init__(self, runtime: Runtime, topic: str,
                 factory: Callable[[int], Pipeline],
                 high_load: float = 8.0, low_load: float = 0.5,
                 max_replicas: int = 4, min_replicas: int = 1,
                 cooldown_ticks: int = 8, warm_ticks: int = 1,
                 seed: int = 0):
        self.rt = runtime
        self.topic = topic
        self.factory = factory
        self.high_load = float(high_load)
        self.low_load = float(low_load)
        self.max_replicas = int(max_replicas)
        self.min_replicas = int(min_replicas)
        self.cooldown_ticks = int(cooldown_ticks)
        self.warm_ticks = int(warm_ticks)
        self.seed = int(seed)
        #: replicas THIS controller grew: list of {"device", "run"}
        self.replicas: List[Dict] = []
        self._pending: Optional[Dict] = None     # the transition in flight
        self._next_index = 0
        self._last_action_tick = -(10 ** 9)
        self.scale_ups = 0
        self.scale_downs = 0
        self.rollbacks = 0
        runtime.autoscalers.append(self)

    # -- the per-tick decision -------------------------------------------------
    def step(self):
        """Called by ``Runtime.tick`` right after pending reconfigurations
        settle: reap the transition in flight, then decide at most one."""
        self._reap_pending()
        if self._pending is not None:
            return
        if self.rt.ticks - self._last_action_tick < self.cooldown_ticks:
            return
        sig = self.rt.broker.scaling_signal(self.topic).get(self.topic)
        if sig is None or sig["replicas"] <= 0:
            return
        if sig["replicas"] < self.max_replicas and \
                sig["mean_load"] >= self.high_load:
            self._scale_up()
        elif sig["replicas"] > max(self.min_replicas, 1) and \
                sig["mean_load"] <= self.low_load:
            victim = self._idle_replica()
            if victim is not None:
                self._scale_down(victim)

    def _reap_pending(self):
        p = self._pending
        if p is None:
            return
        status = p["handle"].status
        if status not in ("committed", "rolled_back"):
            return
        self._pending = None
        self._last_action_tick = self.rt.ticks
        if status == "committed":
            if p["kind"] == "up":
                self.replicas.append({"device": p["device"],
                                      "run": p["run"]})
                self.scale_ups += 1
            else:
                self.replicas = [r for r in self.replicas
                                 if r["run"] is not p["run"]]
                self.scale_downs += 1
        else:
            # the placeholder run stays retired: no half-replica serves
            self.rollbacks += 1

    # -- transitions (both are §6 reconfigurations) ----------------------------
    def _scale_up(self):
        idx = self._next_index
        self._next_index += 1
        template = self.factory(idx)
        dev = Device(f"{self.topic.replace('/', '-')}-replica{idx}",
                     device=self.rt.device)
        # the replica takes the cached executables (CUDA graphs on the
        # card), as a pipeline added with Device.add_pipeline's default
        run = dev.add_pipeline(Pipeline(name=f"replica{idx}"))
        run.retired = True          # nothing to run until the commit
        self.rt.add_device(dev)

        def edit(plan):
            for elem in template.elements.values():
                plan.add(elem)
            for link in template.links:
                plan.link(link.src.name, link.dst.name,
                          link.src_pad, link.dst_pad)
        handle = self.rt.reconfigure(
            run, edit, warm_ticks=self.warm_ticks,
            rng=make_generator(self.seed, self.rt.device))
        self._pending = {"kind": "up", "handle": handle, "device": dev,
                         "run": run}

    def _idle_replica(self) -> Optional[Dict]:
        """A replica of OURS that is fully drained: removing it can lose
        nothing."""
        for rep in self.replicas:
            run = rep["run"]
            if run.retired or not rep["device"].alive:
                continue
            if self._replica_idle(run):
                return rep
        return None

    def _replica_idle(self, run) -> bool:
        """Empty request channel and admission queue, no stream, and no
        occupied slot in the plan state (a device read: the one place the
        active mask is read, outside any graph)."""
        for e in run.pipe.elements.values():
            ep = getattr(e, "endpoint", None)
            if ep is None or not hasattr(ep, "requests"):
                continue
            if len(ep.requests):
                return False
            batcher = self.rt._batchers.get(ep.endpoint_id)
            if batcher is not None:
                if len(batcher.admission):
                    return False
                if getattr(batcher, "active_streams", None) is not None \
                        and batcher.active_streams():
                    return False
        for e in run.pipe.elements.values():
            if getattr(e, "is_stream_serve", False) and \
                    e.active_slots(run.state):
                return False
        return True

    def _scale_down(self, rep: Dict):
        run = rep["run"]

        def edit(plan):
            for name in list(run.pipe.elements):
                plan.remove(name)
        handle = self.rt.reconfigure(run, edit, warm_ticks=self.warm_ticks)
        self._pending = {"kind": "down", "handle": handle,
                         "device": rep["device"], "run": run}

    # -- introspection ---------------------------------------------------------
    def stats(self) -> Dict:
        return {"topic": self.topic,
                "managed_replicas": len(self.replicas),
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "rollbacks": self.rollbacks,
                "pending": (self._pending or {}).get("kind")}
