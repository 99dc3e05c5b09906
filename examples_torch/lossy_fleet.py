"""Among-device offloading over an ADVERSARIAL network on the PyTorch/CUDA
port (twin of ``examples/lossy_fleet.py``, DESIGN.md §10).

Four TVs offload inference to a hub, but the links between them are the
opposite of reliable: both directions drop frames, duplicate frames,
flip bits in payloads — and mid-run the request link suffers a scripted
partition window during which *nothing* gets through.  The delivery
layer (delivery ids + CRC + timeout/backoff retransmit + idempotent
dedup) turns that at-least-once chaos into effectively-once serving:
every TV still collects its full answer budget, every answer is BITWISE
the one a fault-free twin computes, and the per-link message ledgers
balance exactly — zero silent loss, zero double-serves.

    PYTHONPATH=src python examples_torch/lossy_fleet.py [--device cpu]

The fault schedule is host-deterministic: the answer links' seeds come
from the clients' ids, which count from 1 in a fresh process, as in the
JAX example.  On the card the CRC covers host bytes only, so corrupted
frames are host copies (``core/netfault.py``).
"""
import argparse
import os
import sys

import numpy as np
import torch

from repro_torch.core import TensorSpec, parse_launch
from repro_torch.core.elements import register_model
from repro_torch.core.netfault import DeliveryPolicy, FaultFabric, FaultPolicy
from repro_torch.device import resolve_device
from repro_torch.runtime import Device, Runtime

# the deterministic chaos harness the netfault tests and benchmark use —
# one copy of the lossy-link semantics, everywhere
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
from chaoslib import lossy_endpoint  # noqa: E402

N_TVS = 4
BUDGET = 12          # answers each TV must collect
MAX_TICKS = 60       # liveness bound: chaos may stretch, not stall, the run

# the request link: drops, duplicates, corruption, AND a scripted
# partition — fault-clock ticks [10, 14) eat every frame silently
REQ_FAULTS = FaultPolicy(seed=11, drop=0.06, dup=0.03, corrupt=0.02,
                         partitions=((10, 14),))
# answer links (per-client seeds derived by the harness): drops + dups
ANS_FAULTS = FaultPolicy(seed=23, drop=0.05, dup=0.02, corrupt=0.01)


def init(generator, device):
    return {"w": torch.randn((48, 16), generator=generator,
                             device=device) * 0.05}


def apply(p, x):
    return torch.tanh(x.to(torch.float32).reshape(1, -1) @ p["w"])


def fleet(dev):
    """One hub + N_TVS query clients, delivery layer ON."""
    rt = Runtime(query_batch=8, delivery=DeliveryPolicy(), device=dev)
    hub = Device("hub", device=dev)
    srv = parse_launch(
        "tensor_query_serversrc operation=svc name=ssrc ! "
        "tensor_filter model=lossy_svc ! tensor_query_serversink name=ssink")
    srv.elements["ssink"].pair_with(srv.elements["ssrc"])
    hub.add_pipeline(srv, jit=False)
    rt.add_device(hub)
    tvs = []
    for i in range(N_TVS):
        tv = Device(f"tv{i}", device=dev)
        cli = parse_launch(
            "testsrc width=4 height=4 ! tensor_converter ! "
            "tensor_query_client operation=svc name=qc ! appsink name=res")
        tvs.append(tv.add_pipeline(cli, jit=False))
        rt.add_device(tv)
    return rt, srv.elements["ssrc"], tvs


def answers(tvs):
    return [[b.tensor.cpu().numpy() for b in tv.sink_log.get("res", ())]
            for tv in tvs]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    register_model("lossy_svc", init, apply,
                   out_specs=(TensorSpec((1, 16), "float32"),))

    # -- fault-free twin: the bitwise reference -------------------------------
    rt0, _, tvs0 = fleet(dev)
    rt0.run(BUDGET)
    reference = answers(tvs0)

    # -- the same fleet on hostile links --------------------------------------
    rt, ssrc, tvs = fleet(dev)
    fabric = FaultFabric()
    rt.fabric = fabric                # the scheduler drives the fault clock
    lossy_endpoint(fabric, ssrc.endpoint, REQ_FAULTS, ANS_FAULTS, name="svc")

    ticks = 0
    while ticks < MAX_TICKS and any(
            len(tv.sink_log.get("res", ())) < BUDGET for tv in tvs):
        rt.tick()
        ticks += 1

    got = answers(tvs)
    complete = all(len(g) >= BUDGET for g in got)
    bitwise = all(np.array_equal(x, y)
                  for ref, g in zip(reference, got)
                  for x, y in zip(ref, g))
    fabric.assert_conservation()      # every frame accounted, per link

    # -- report ---------------------------------------------------------------
    stats = rt.stats()
    d = stats["delivery"]
    print(f"{N_TVS} TVs x {BUDGET} answers over lossy links "
          f"(done in {ticks} ticks; fault-free twin took {BUDGET}):\n")
    print(f"{'link':10s} {'sent':>5s} {'dropped':>8s} {'dup':>4s} "
          f"{'corrupt':>8s} {'deduped':>8s} {'accepted':>9s}")
    for name, s in sorted(stats["netfault"].items()):
        print(f"{name:10s} {s['sent']:5d} {s['dropped_by_fault']:8d} "
              f"{s['injected_dups']:4d} {s['corrupted']:8d} "
              f"{s['deduped']:8d} {s['accepted']:9d}")
    print(f"\ndelivery layer: {d['retransmits']} retransmits, "
          f"{d['deduped']} server dedups, {d['replayed']} answer replays, "
          f"{d['rejected_corrupt']} corrupt frames rejected, "
          f"{d['client_answer_dups']} client-side dups discarded, "
          f"{d['client_answer_corrupt']} corrupt answers rejected")

    assert complete, [len(g) for g in got]
    assert bitwise
    lied = sum(s["dropped_by_fault"] + s["corrupted"]
               for s in stats["netfault"].values())
    print(f"\nOK — every TV got its {BUDGET} answers, each BITWISE the "
          f"fault-free twin's, and the message ledgers balance: the network "
          f"lied {lied} times and no client ever saw it")
    return {"ticks": ticks, "netfault": stats["netfault"],
            "delivery": {k: d[k] for k in
                         ("retransmits", "deduped", "replayed",
                          "rejected_corrupt", "client_answer_dups",
                          "client_answer_corrupt")},
            "lied": lied, "answers": [len(g) for g in got]}


if __name__ == "__main__":
    main()
