"""Quickstart on the PyTorch/CUDA port (twin of ``examples/quickstart.py``):
describe an AI pipeline as a gst-launch-style string, compile it, and run
frames through it — the pipe-and-filter core of the paper in ~30 lines.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

It runs on the card unless ``--device cpu``.  ``compiled_step()`` is the
cached executable (a CUDA graph per binding on the card).
"""
import argparse

import torch

from repro_torch.core import TensorSpec, parse_launch
from repro_torch.core.elements import register_model
from repro_torch.device import make_generator, resolve_device


# 1. register a model (any torch init/apply pair; real apps use
#    repro_torch.models)
def init(generator, device):
    return {"w": torch.randn((768, 10), generator=generator,
                             device=device) * 0.05}


def apply(p, x):
    return torch.mean(x.reshape(-1, 3), 0) @ p["w"][:3]


PIPELINE = """
    testsrc name=cam width=32 height=24 ! tee name=ts
    ts. queue leaky=2 ! videoconvert ! appsink name=preview
    ts. videoconvert ! videoscale ! video/x-raw,width=16,height=16,format=RGB !
        tensor_converter !
        tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 !
        tensor_filter model=tiny ! tensor_decoder mode=classification !
        appsink name=label
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    register_model("tiny", init, apply,
                   out_specs=(TensorSpec((10,), "float32"),))

    # 2. describe the pipeline (Listing-1 style)
    pipe = parse_launch(PIPELINE).realize()
    print(pipe.describe())

    # 3. compile & run
    params = pipe.init(make_generator(0, dev), dev)
    state = pipe.init_state(dev)
    step = pipe.compiled_step()
    frames = []
    for i in range(5):
        outs, state = step(params, state)
        frames.append({"preview": tuple(outs["preview"].tensor.shape),
                       "class": int(outs["label"].tensor),
                       "pts": int(outs["label"].pts)})
        print(f"frame {i}: preview={frames[-1]['preview']} "
              f"class={frames[-1]['class']} pts={frames[-1]['pts']}us")
    print("OK")
    return {"links": len(pipe.links), "frames": frames}


if __name__ == "__main__":
    main()
