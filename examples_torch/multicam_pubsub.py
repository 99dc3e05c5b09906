"""Fig. 3 / Listing 2 on the PyTorch/CUDA port (twin of
``examples/multicam_pubsub.py``): distributed IoT AI with stream pub/sub.

Two Raspberry-Pi-class camera devices (C1, C2) publish frames under topics;
a processing device (P, "Coral accelerator") subscribes to one stream, runs
object detection, and republishes the inference; a display device (D) muxes
both camera streams + the inference overlay with timestamp synchronization
(§4.2.3) despite skewed device clocks.

    PYTHONPATH=src python examples_torch/multicam_pubsub.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import SimClock, TensorSpec, parse_launch
from repro_torch.core.elements import register_model
from repro_torch.device import resolve_device
from repro_torch.runtime import Device, Runtime


def init(generator, device):
    return {"w": torch.randn((2304, 4 + 8), generator=generator,
                             device=device) * 0.02}


def apply(p, x):
    z = x.to(torch.float32).reshape(1, -1) @ p["w"]
    return torch.sigmoid(z[:, :4]), torch.softmax(z[0, 4:], dim=-1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    register_model("detector", init, apply,
                   out_specs=(TensorSpec((1, 4), "float32"),
                              TensorSpec((8,), "float32")))

    rt = Runtime(device=dev)

    # camera devices with skewed clocks (real consumer devices disagree on
    # time)
    for side, skew_ms in (("left", 0), ("right", 40)):
        cam = Device(f"cam_{side}",
                     clock=SimClock(skew_ns=skew_ms * 1_000_000), device=dev)
        p = parse_launch(f"""
            testsrc name=v4l2src width=32 height=24 ! tensor_converter !
              queue leaky=2 ! mqttsink pub-topic=edge/cam/{side}
        """)
        cam.add_pipeline(p, jit=False)
        rt.add_device(cam)

    # processing device: subscribe left camera, detect, republish
    proc = Device("coral", device=dev)
    pp = parse_launch("""
        mqttsrc sub-topic=edge/cam/left is-live=false !
          tensor_transform mode=arithmetic option=typecast:float32,div:255.0 !
          tensor_filter framework=torch model=detector !
          mqttsink pub-topic=edge/inference
    """)
    proc.add_pipeline(pp, jit=False)
    rt.add_device(proc)

    # display device: mux cameras + inference (wildcard discovery, R3)
    disp = Device("lcd", device=dev)
    pd = parse_launch("""
        mqttsrc sub-topic=edge/cam/left is-live=false ! queue ! mux.sink_0
        mqttsrc sub-topic=edge/cam/right is-live=false ! queue ! mux.sink_1
        tensor_mux name=mux ! appsink name=video
        mqttsrc sub-topic=edge/inference is-live=false ! queue ! appsink name=boxes
    """)
    disp.add_pipeline(pd, jit=False)
    rt.add_device(disp)

    rt.run(8)
    run = disp.runs[0]
    video = run.last_outputs["video"]
    shapes = [tuple(t.shape) for t in video.tensors]
    boxes = tuple(run.last_outputs["boxes"].tensors[0].shape)
    print(f"display muxed {run.frames} frames: "
          f"{shapes} pts={int(video.pts)}ns")
    print(f"inference overlay: boxes={boxes}")
    stats = rt.stats()
    print(f"stats: {stats}")
    assert run.frames >= 6
    print("OK — 4 devices, 3 topics, NTP-aligned mux, <40 lines of "
          "pipeline code")
    return {"frames": run.frames, "video": shapes, "pts": int(video.pts),
            "boxes": boxes, "stats": stats}


if __name__ == "__main__":
    main()
