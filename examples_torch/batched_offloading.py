"""Micro-batched inference offloading on the PyTorch/CUDA port (twin of
``examples/batched_offloading.py``): one capable hub serving many weak
clients (paper §4.2.2 scaled up — DESIGN.md §2).

Eight TVs offload the same object-detection service to a single phone.
With query batching (default, ``query_batch=8``) the phone gathers the
eight concurrent requests that arrive each tick and serves them in ONE
dispatch; each answer routes back by client id.  Setting
``query_batch=0`` restores the paper's one-round-trip-per-frame serving.

    PYTHONPATH=src python examples_torch/batched_offloading.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core import TensorSpec, parse_launch
from repro_torch.core.elements import register_model
from repro_torch.device import resolve_device
from repro_torch.runtime import Device, Runtime

N_CLIENTS = 8
TICKS = 12


def init(generator, device):
    return {"w": torch.randn((48 * 48 * 3, 8), generator=generator,
                             device=device) * 0.01}


def apply(p, x):
    logits = x.to(torch.float32).reshape(1, -1) @ p["w"]
    boxes = torch.sigmoid(logits[:, :4])
    scores = torch.softmax(logits[:, 4:], dim=-1)[0]
    return boxes.reshape(1, 4), scores


SERVER = """
tensor_query_serversrc operation=objdetect name=ssrc !
  tensor_filter framework=torch model=ssd_tiny !
  tensor_query_serversink name=ssink
"""

CLIENT = """
testsrc width=48 height=48 ! tensor_converter !
  tensor_query_client operation=objdetect name=qc ! appsink name=boxes
"""


def build(query_batch: int, dev):
    rt = Runtime(query_batch=query_batch, device=dev)
    phone = Device("phone", device=dev)
    srv = parse_launch(SERVER)
    srv.elements["ssink"].pair_with(srv.elements["ssrc"])
    srv_run = phone.add_pipeline(srv, jit=False)
    rt.add_device(phone)
    tvs = []
    for i in range(N_CLIENTS):
        tv = Device(f"tv{i}", device=dev)
        tvs.append(tv.add_pipeline(parse_launch(CLIENT), jit=False))
        rt.add_device(tv)
    return rt, srv_run, tvs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    register_model("ssd_tiny", init, apply,
                   out_specs=(TensorSpec((1, 4), "float32"),
                              TensorSpec((4,), "float32")))
    counters = {}
    for label, batch in (("batched (batch=8)", 8),
                         ("sequential (batch=0)", 0)):
        rt, srv_run, tvs = build(batch, dev)
        rt.run(2)  # warm the executable cache outside the timed window
        t0 = time.perf_counter()
        rt.run(TICKS)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        qb = rt.stats()["query_batching"]
        assert all(run.frames == TICKS + 2 for run in tvs)
        print(f"{label}: {N_CLIENTS} clients x {TICKS} ticks in "
              f"{dt * 1e3:.0f}ms — server dispatches: "
              f"{qb['batches'] or qb['sequential_frames']}"
              f" ({qb['batched_frames']} frames batched,"
              f" {qb['sequential_frames']} sequential)")
        boxes = tvs[0].last_outputs["boxes"].tensors[0]
        print(f"  tv0 last boxes: {['%.2f' % float(v) for v in boxes[0]]}")
        counters[batch] = {
            "dispatches": qb["batches"] or qb["sequential_frames"],
            "batched_frames": qb["batched_frames"],
            "sequential_frames": qb["sequential_frames"],
            "client_frames": [run.frames for run in tvs]}

    print("OK — every client answered every tick; batching only changed "
          "how many dispatches the phone paid")
    return counters


if __name__ == "__main__":
    main()
