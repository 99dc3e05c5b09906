"""Multi-tenant serving under overload on the PyTorch/CUDA port (twin of
``examples/multitenant_fleet.py``): three tiers, one elastic fleet.

Nine clients share one inference hub under a three-tier QoS contract
(DESIGN.md §9): ``realtime`` (priority 0, strict deadline), ``standard``
(priority 1, rate-budgeted), ``best-effort`` (priority 2 — the tier that
sheds FIRST, explicitly).  The hub's serve capacity is capped at 3
requests/tick and the fleet at 2 replicas, so nine 1-req/tick clients are
a sustained overload even after scale-up.

Three §9 behaviors compose: isolation (realtime keeps sub-tick latency
through the overload), explicit shedding (requests over budget come back
as error frames with a reason, and the ledger balances: admitted == served
+ shed + queued + in-flight), elasticity (the broker's queue-depth signal
trips the autoscaler, which grows a replica as an ordinary §6
reconfiguration and removes it once the burst drains).

    PYTHONPATH=src python examples_torch/multitenant_fleet.py [--device cpu]
"""
import argparse
import os
import sys

import torch

from repro_torch.core import TensorSpec, parse_launch
from repro_torch.core.admission import QoSConfig, TenantSpec
from repro_torch.core.elements import register_model
from repro_torch.device import resolve_device
from repro_torch.runtime import Device, Runtime
from repro_torch.runtime.autoscale import Autoscaler

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
from chaoslib import Chaos  # noqa: E402

TIERS = {"realtime": 3, "standard": 3, "best-effort": 3}   # clients each
TICKS_LOAD, TICKS_DRAIN = 18, 20


def init(generator, device):
    return {"w": torch.full((12, 8), 0.25, device=device)}


def apply(p, x):
    return x.to(torch.float32).reshape(1, -1) @ p["w"]


def serve_ps():
    ps = parse_launch(
        "tensor_query_serversrc operation=infer name=ssrc ! "
        "tensor_filter model=mt_svc ! tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    return ps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    register_model("mt_svc", init, apply,
                   out_specs=(TensorSpec((1, 8), "float32"),))
    qos = QoSConfig(
        tenants=(
            TenantSpec("realtime", priority=0, deadline_ticks=4),
            TenantSpec("standard", priority=1, rate=1, burst=2),
            TenantSpec("best-effort", priority=2, deadline_ticks=6,
                       max_queue=4),
        ),
        default=TenantSpec(priority=2),
        serve_per_tick=3)                      # the overloaded capacity
    rt = Runtime(qos=qos, device=dev)

    hub = Device("hub", device=dev)
    hub.add_pipeline(serve_ps(), jit=False)
    rt.add_device(hub)

    clients = []
    for tier, n in TIERS.items():
        for i in range(n):
            cdev = Device(f"{tier}-{i}", device=dev)
            cdev.add_pipeline(parse_launch(
                f"testsrc width=2 height=2 ! tensor_converter ! "
                f"tensor_query_client operation=infer tenant={tier} "
                f"name=qc ! appsink name=res"), jit=False)
            rt.add_device(cdev)
            clients.append((tier, cdev))

    asc = Autoscaler(rt, "query/infer", lambda i: serve_ps(),
                     high_load=3.0, low_load=0.5, max_replicas=2,
                     cooldown_ticks=3, warm_ticks=1)

    # scripted burst end: every client stops after the load phase, so the
    # fleet drains and the autoscaler removes the idle replicas
    chaos = Chaos(rt)
    for _, cdev in clients:
        chaos.at(TICKS_LOAD + 1,
                 lambda d=cdev: setattr(d, "alive", False), label=None)
    chaos.at(TICKS_LOAD + 1, lambda: None, label="burst ends (clients stop)")

    print(f"== {sum(TIERS.values())} clients / 3 tiers vs 3-req/tick hub "
          f"({TICKS_LOAD} ticks overload, then drain) ==")
    chaos.run(TICKS_LOAD + TICKS_DRAIN)

    stats = rt.stats()                         # asserts conservation
    print("\nper-tenant SLO ledger:")
    hdr = (f"{'tenant':>12} {'prio':>4} {'admitted':>8} {'served':>7} "
           f"{'shed':>5} {'p50':>5} {'p99':>5}  shed reasons")
    print(hdr)
    for tid in ("realtime", "standard", "best-effort"):
        t = stats["tenants"][tid]
        reasons = ", ".join(f"{r}={n}" for r, n in
                            sorted(t["shed_reasons"].items())) or "-"
        print(f"{tid:>12} {t['priority']:>4} {t['admitted']:>8} "
              f"{t['served']:>7} {t['shed']:>5} {t['p50_ticks']:>5.0f} "
              f"{t['p99_ticks']:>5.0f}  {reasons}")
        assert t["admitted"] == t["served"] + t["shed"] + t["queued"] + \
            t["in_flight"]

    rtm = stats["tenants"]["realtime"]
    print(f"\nisolation: realtime p99 {rtm['p99_ticks']:.0f} ticks through "
          f"a 2x overload (shed {rtm['shed']})")
    for scaler in stats.get("autoscale", []):
        print(f"elasticity: {scaler['scale_ups']} scale-up(s), "
              f"{scaler['scale_downs']} scale-down(s), "
              f"{scaler['rollbacks']} rollback(s) on topic {scaler['topic']}"
              f" -> {scaler['managed_replicas']} extra replica(s) left")
    errs = 0
    for _, cdev in clients:
        errs += len(cdev.runs[0].sink_log.get("qc.error", []))
    total_shed = sum(t["shed"] for t in stats["tenants"].values())
    print(f"explicit degradation: {errs} client-visible error frames for "
          f"{total_shed} sheds — zero silent drops")
    print(f"fleet events: {[(t, l) for t, l in chaos.log]}")
    return {"tenants": {tid: {k: t[k] for k in
                              ("priority", "admitted", "served", "shed",
                               "queued", "in_flight", "p50_ticks",
                               "p99_ticks", "shed_reasons")}
                        for tid, t in stats["tenants"].items()},
            "autoscale": [{k: s[k] for k in
                           ("scale_ups", "scale_downs", "rollbacks",
                            "topic", "managed_replicas")}
                          for s in stats.get("autoscale", [])],
            "error_frames": errs, "sheds": total_shed,
            "events": list(chaos.log)}


if __name__ == "__main__":
    main()
