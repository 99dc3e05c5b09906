"""Mesh-sharded among-device offloading on the PyTorch/CUDA port (twin of
``examples/sharded_offloading.py``): one hub, many screens, placement
decided by cost — and survived by failover.

Eight TVs offload a classifier to a hub that owns a mesh of 8 slots on
its device (``make_host_mesh(devices=[dev] * 8)``: the port's counterpart
of the JAX example's 8 forged host devices).  Each tick the hub gathers
the eight requests into ONE batch; the batcher holds both the
single-device executable and the mesh-sharded one (a frame slice per
data slot) and, in the default ``auto`` mode, probes both once and serves
through the faster — placement never changes an answer, only its latency.
Phase B kills the hub mid-batch (chaos harness): orphaned requests
re-dispatch to the backup exactly as in the single-device fabric.

    PYTHONPATH=src python examples_torch/sharded_offloading.py [--device cpu]
"""
import argparse
import os
import sys

import torch

from repro_torch.core import TensorSpec, parse_launch
from repro_torch.core.elements import register_model
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import data_axis_size, make_host_mesh
from repro_torch.runtime import Device, Runtime

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
from chaoslib import Chaos  # noqa: E402

N_TVS = 8
TICKS_A, TICKS_B = 5, 5      # healthy (sharded-capable) / degraded


def init(generator, device):
    return {"w": torch.randn((48 * 48 * 3, 8), generator=generator,
                             device=device) * 0.01}


def apply(p, x):
    logits = x.to(torch.float32).reshape(1, -1) @ p["w"]
    return torch.sigmoid(logits[:, :4]).reshape(1, 4)


def hub(rt, name, throughput, dev):
    hub_dev = Device(name, device=dev)
    srv = parse_launch(
        f"tensor_query_serversrc operation=classify name=ssrc "
        f"throughput={throughput} ! "
        f"tensor_filter model=cls_tiny_sh ! tensor_query_serversink name=ssink")
    srv.elements["ssink"].pair_with(srv.elements["ssrc"])
    run = hub_dev.add_pipeline(srv, jit=False)
    rt.add_device(hub_dev)
    return hub_dev, run, srv.elements["ssrc"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    register_model("cls_tiny_sh", init, apply,
                   out_specs=(TensorSpec((1, 4), "float32"),))

    mesh = make_host_mesh(devices=[dev] * 8)
    print(f"host mesh: {mesh} ({data_axis_size(mesh)}-way data axis, "
          f"{mesh.size} slots)")

    rt = Runtime(query_batch=N_TVS, mesh=mesh, device=dev)  # shard_mode auto
    primary_dev, primary_run, primary_ssrc = hub(rt, "edge-server", 8, dev)
    backup_dev, backup_run, backup_ssrc = hub(rt, "old-phone", 2, dev)

    tv_runs = []
    for i in range(N_TVS):
        tv = Device(f"tv{i}", device=dev)
        pc = parse_launch(
            "testsrc width=48 height=48 ! tensor_converter ! "
            "tensor_query_client operation=classify name=qc ! "
            "appsink name=out")
        tv_runs.append(tv.add_pipeline(pc, jit=False))
        rt.add_device(tv)

    # -- phase A: healthy fleet — one batch per tick, placement calibrated ---
    rt.run(TICKS_A)
    batcher = rt._batchers[primary_ssrc.endpoint.endpoint_id]
    qb = rt.stats()["query_batching"]
    placement = batcher.placements.get(N_TVS, "single")
    phase_a = (primary_run.frames, primary_run.bursts)
    print(f"\nphase A ({TICKS_A} ticks, {N_TVS} TVs):")
    print(f"  primary served {primary_run.frames} frames in "
          f"{primary_run.bursts} batched dispatches")
    print(f"  calibrated placement for batch {N_TVS}: {placement} "
          f'(auto-probed; force with Runtime(shard_mode="always"/"never"))')
    print(f"  sharded frames so far: {qb['sharded_frames']}")

    # -- phase B: the serving hub dies mid-batch; orphans re-dispatch --------
    harness = Chaos(rt)
    harness.kill_server_mid_batch(rt.ticks + 1, primary_dev, primary_ssrc,
                                  after_n=N_TVS // 2)
    harness.run(TICKS_B)
    fo = rt.stats()["failover"]
    print(f"\nphase B (hub killed mid-batch at tick {TICKS_A + 1}):")
    for t, label in harness.log:
        print(f"  tick {t}: {label}")
    print(f"  redispatches={fo['redispatches']} parked_now={fo['parked_now']} "
          f"orphaned={fo['orphaned_requests']}")
    print(f"  backup served {backup_run.frames} frames")

    total = TICKS_A + TICKS_B
    assert all(r.frames == total for r in tv_runs), "a TV lost a frame!"
    print(f"\nevery TV got {total}/{total} answers — zero loss under the "
          f"mesh.")
    return {"phase_a": phase_a, "placement": placement,
            "sharded_frames": rt.stats()["query_batching"]["sharded_frames"],
            "chaos_log": list(harness.log),
            "redispatches": fo["redispatches"],
            "parked_now": fo["parked_now"],
            "orphaned": fo["orphaned_requests"],
            "backup_frames": backup_run.frames,
            "tv_frames": [r.frames for r in tv_runs]}


if __name__ == "__main__":
    main()
