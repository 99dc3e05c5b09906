"""Fig. 2 / Listing 1 on the PyTorch/CUDA port (twin of
``examples/offloading_query.py``): inference offloading with query
elements.

Device A (a TV: camera + display, no NPU) runs the full UI pipeline but its
``tensor_filter`` is replaced by ``tensor_query_client`` — nothing else
changes (R1).  Device B (a phone) serves the model; a second phone joins and
the client fails over when the first dies (R3/R4).

    PYTHONPATH=src python examples_torch/offloading_query.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import TensorSpec, parse_launch
from repro_torch.core.elements import register_model
from repro_torch.device import resolve_device
from repro_torch.runtime import Device, Runtime


def init(generator, device):
    return {"w": torch.randn((300 * 300 * 3, 8), generator=generator,
                             device=device) * 0.01}


def apply(p, x):
    logits = x.to(torch.float32).reshape(1, -1) @ p["w"]
    boxes = torch.sigmoid(logits[:, :4])
    scores = torch.softmax(logits[:, 4:], dim=-1)[0]
    return boxes.reshape(1, 4), scores


SERVER = """
tensor_query_serversrc operation=objectdetection/ssdv2 name=ssrc !
  tensor_filter framework=torch model=ssd_v2 !
  tensor_query_serversink name=ssink
"""

CLIENT = """
testsrc name=v4l2src width=320 height=240 ! tee name=ts
ts. videoconvert ! videoscale ! video/x-raw,width=300,height=300,format=RGB !
  queue leaky=2 ! tensor_converter !
  tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 !
  tensor_query_client operation=objectdetection/ssdv2 name=qc !
  appsink name=boxes
ts. queue leaky=2 ! videoconvert ! appsink name=screen
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    register_model("ssd_v2", init, apply,
                   out_specs=(TensorSpec((1, 4), "float32"),
                              TensorSpec((8,), "float32")))

    rt = Runtime(device=dev)
    for name in ("phoneB", "phoneC"):
        phone = Device(name, device=dev)
        srv = parse_launch(SERVER)
        srv.elements["ssink"].pair_with(srv.elements["ssrc"])
        phone.add_pipeline(srv, jit=False)
        rt.add_device(phone)
        # keep handles for the failover demo
        if name == "phoneB":
            primary = srv.elements["ssrc"]

    tv = Device("tv", device=dev)
    cli = parse_launch(CLIENT)
    tv.add_pipeline(cli, jit=False)
    rt.add_device(tv)

    rt.run(5)
    out = tv.runs[0].last_outputs
    boxes = tuple(out["boxes"].tensors[0].shape)
    screen = tuple(out["screen"].tensor.shape)
    frames_before = tv.runs[0].frames
    print(f"5 frames offloaded: boxes={boxes} screen={screen}")

    # phoneB dies mid-stream -> client rebinds to phoneC (R4)
    primary.endpoint.alive = False
    rt.broker.mark_down(primary.registration)
    rt.run(5)
    qc = cli.elements["qc"]
    print(f"after failover: frames={tv.runs[0].frames} "
          f"(failovers={qc.binding.failovers}) — service uninterrupted")
    assert tv.runs[0].frames == 10
    print("OK")
    return {"frames_before": frames_before, "frames": tv.runs[0].frames,
            "failovers": qc.binding.failovers, "boxes": boxes,
            "screen": screen}


if __name__ == "__main__":
    main()
