"""Fig. 5 on the PyTorch/CUDA port (twin of
``examples/augmented_worker.py``): augmented worker — multi-device AND
multi-modal.

A wearable streams IMU+audio frames; the mobile's DETECT pipeline gates on
action onset (tensor_if) and publishes an activation signal back; the
wearable only streams full-rate sensors while activated (power saving), and
the mobile's classifier decides correct/incorrect assembly.

    PYTHONPATH=src python examples_torch/augmented_worker.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import TensorSpec, parse_launch
from repro_torch.core.elements import register_model
from repro_torch.device import resolve_device
from repro_torch.runtime import Device, Runtime


def det_init(generator, device):
    return {"w": torch.randn((96, 1), generator=generator,
                             device=device) * 0.3}


def det_apply(p, x):
    return torch.sigmoid(x.to(torch.float32).reshape(1, -1) @ p["w"])


def cls_init(generator, device):
    return {"w": torch.randn((96, 2), generator=generator,
                             device=device) * 0.3}


def cls_apply(p, x):
    return torch.softmax(x.to(torch.float32).reshape(1, -1) @ p["w"], dim=-1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    register_model("detect", det_init, det_apply,
                   out_specs=(TensorSpec((1, 1), "float32"),))
    register_model("assembly_cls", cls_init, cls_apply,
                   out_specs=(TensorSpec((1, 2), "float32"),))

    rt = Runtime(device=dev)

    watch = Device("wearable", device=dev)
    pw = parse_launch("""
        testsrc name=imu width=8 height=4 ! tensor_converter !
          queue leaky=2 ! mqttsink pub-topic=worker/sensors
    """)
    watch.add_pipeline(pw, jit=False)
    rt.add_device(watch)

    phone = Device("mobile", device=dev)
    # left pipeline: DETECT action onset, gate, publish activation
    p_detect = parse_launch("""
        mqttsrc sub-topic=worker/sensors is-live=false !
          tensor_transform mode=arithmetic option=typecast:float32,div:255.0 !
          tensor_filter framework=torch model=detect !
          tensor_if name=gate threshold=0.5 operator=GE !
          mqttsink pub-topic=worker/activation
    """)
    phone.add_pipeline(p_detect, jit=False)
    # right pipeline: classify assembly correctness while activated
    p_cls = parse_launch("""
        mqttsrc sub-topic=worker/sensors is-live=false !
          tensor_transform mode=arithmetic option=typecast:float32,div:255.0 !
          tensor_filter framework=torch model=assembly_cls !
          appsink name=verdict
    """)
    phone.add_pipeline(p_cls, jit=False)
    rt.add_device(phone)

    # the wearable listens for activation (to duty-cycle its sensors)
    p_act = parse_launch("mqttsrc sub-topic=worker/activation is-live=false"
                         " ! appsink name=act")
    watch.add_pipeline(p_act, jit=False)
    rt._wire(watch, watch.runs[-1])

    rt.run(8)
    verdict = phone.runs[1].last_outputs["verdict"]
    act = watch.runs[1].last_outputs.get("act")
    print(f"assembly verdict p(correct)={float(verdict.tensor[0, 0]):.3f}")
    if act is not None:
        print(f"wearable activation signal received, "
              f"gate={int(act.tensors[-1])}")
    print(f"frames: detect={phone.runs[0].frames} "
          f"classify={phone.runs[1].frames}")
    assert phone.runs[1].frames >= 6
    print("OK — gated multi-modal among-device pipeline (Fig. 5)")
    return {"detect": phone.runs[0].frames,
            "classify": phone.runs[1].frames,
            "activation": act is not None,
            "verdict_shape": tuple(verdict.tensor.shape)}


if __name__ == "__main__":
    main()
