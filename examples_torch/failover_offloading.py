"""Fault-tolerant among-device offloading on the PyTorch/CUDA port (twin of
``examples/failover_offloading.py``): a fleet that degrades gracefully.

Six TVs offload object detection to two hubs.  The capability-aware broker
routes every TV to the primary hub (it declares the higher throughput).
Mid-run the primary dies *mid-batch* — three requests already sit on its
queue.  Nothing is lost: the scheduler re-dispatches the orphaned requests
to the backup within the same tick, the TVs never miss a frame, and when
the primary revives (same registration, so it outranks the backup again)
the bindings win back automatically.

    PYTHONPATH=src python examples_torch/failover_offloading.py [--device cpu]
"""
import argparse
import os
import sys

import torch

from repro_torch.core import TensorSpec, parse_launch
from repro_torch.core.elements import register_model
from repro_torch.device import resolve_device
from repro_torch.runtime import Device, Runtime

# the deterministic chaos harness the failover tests and benchmark use —
# one copy of the fault semantics, everywhere (it imports no framework)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
from chaoslib import Chaos  # noqa: E402

N_TVS = 6
TICKS_A, TICKS_B, TICKS_C = 4, 4, 4   # healthy / degraded / recovered


def init(generator, device):
    return {"w": torch.randn((48 * 48 * 3, 8), generator=generator,
                             device=device) * 0.01}


def apply(p, x):
    logits = x.to(torch.float32).reshape(1, -1) @ p["w"]
    return torch.sigmoid(logits[:, :4]).reshape(1, 4)


def hub(rt, name, throughput, dev):
    hub_dev = Device(name, device=dev)
    srv = parse_launch(
        f"tensor_query_serversrc operation=objdetect name=ssrc "
        f"throughput={throughput} ! "
        f"tensor_filter model=ssd_tiny_fo ! tensor_query_serversink name=ssink")
    srv.elements["ssink"].pair_with(srv.elements["ssrc"])
    run = hub_dev.add_pipeline(srv, jit=False)
    rt.add_device(hub_dev)
    return hub_dev, run, srv.elements["ssrc"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    register_model("ssd_tiny_fo", init, apply,
                   out_specs=(TensorSpec((1, 4), "float32"),))

    rt = Runtime(query_batch=8, lease_ticks=3, device=dev)
    primary_dev, primary_run, primary_ssrc = hub(rt, "living-room-pc", 8,
                                                 dev)
    backup_dev, backup_run, backup_ssrc = hub(rt, "old-phone", 2, dev)

    tvs = []
    for i in range(N_TVS):
        tv = Device(f"tv{i}", device=dev)
        cli = parse_launch(
            "testsrc width=48 height=48 ! tensor_converter ! "
            "tensor_query_client operation=objdetect name=qc ! "
            "appsink name=boxes")
        tvs.append(tv.add_pipeline(cli, jit=False))
        rt.add_device(tv)

    rt.run(TICKS_A)
    healthy = (primary_run.frames, backup_run.frames)
    print(f"healthy:   primary served {primary_run.frames:3d} frames, "
          f"backup {backup_run.frames:3d} — throughput ranking routes all "
          f"{N_TVS} TVs to the PC")

    # the PC dies the instant the 3rd request of the next tick lands on it —
    # a genuine mid-batch crash with orphans on the dead queue
    harness = Chaos(rt)
    harness.kill_server_mid_batch(TICKS_A + 1, primary_dev, primary_ssrc,
                                  after_n=3)
    harness.run(TICKS_B)
    assert any("mid-batch" in label for _, label in harness.log)
    fo = rt.stats()["failover"]
    on_cadence = all(tv.frames == TICKS_A + TICKS_B for tv in tvs)
    degraded = (fo["orphaned_requests"], fo["redispatches"],
                backup_run.frames)
    print(f"degraded:  PC crashed mid-batch — {fo['orphaned_requests']} "
          f"orphaned requests re-dispatched ({fo['redispatches']} "
          f"redispatches), backup now at {backup_run.frames:3d} frames; "
          f"every TV still on cadence: {on_cadence}")

    # the PC comes back: same registration revives, outranks the phone again
    before = primary_run.frames
    harness.revive_server(TICKS_A + TICKS_B + 1, primary_dev, primary_ssrc)
    harness.run(TICKS_C)
    recovered = primary_run.frames - before
    print(f"recovered: PC revived and won its bindings back — served "
          f"{recovered:3d} of the last {TICKS_C * N_TVS} "
          f"requests; backup is idle again")

    assert all(tv.frames == TICKS_A + TICKS_B + TICKS_C for tv in tvs)
    assert rt.stats()["failover"]["parked_now"] == 0
    print(f"OK — {N_TVS} TVs x {TICKS_A + TICKS_B + TICKS_C} ticks, zero "
          f"lost requests across one crash and one revival "
          f"(lease expiries: {rt.broker.expiries})")
    return {"healthy": healthy, "degraded": degraded,
            "on_cadence": on_cadence, "recovered": recovered,
            "tv_frames": [tv.frames for tv in tvs],
            "parked_now": rt.stats()["failover"]["parked_now"],
            "lease_expiries": rt.broker.expiries,
            "chaos_log": list(harness.log)}


if __name__ == "__main__":
    main()
