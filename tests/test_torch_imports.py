"""The port stands alone and runs on the card unless asked for the CPU.

* no file under ``src/repro_torch`` imports ``jax`` or the JAX package
  ``repro`` (AST scan), and neither does ``chip_smoke.py``;
* importing the port's serve entry point leaves ``jax`` out of
  ``sys.modules`` (a fresh interpreter);
* without CUDA, every entry point raises unless ``device="cpu"`` is passed
  — the port never drops to the CPU on its own.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import stablelm_1_6b
from repro_torch.device import resolve_device
from repro_torch.launch import model_serve as ms
from repro_torch.models import transformer as tt
from repro_torch.runtime import Device, Runtime

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch.launch.model_serve, "
            "repro_torch.runtime; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == "[]"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA rule cannot be seen")


def test_entry_points_raise_without_cuda(no_cuda):
    cfg = stablelm_1_6b.config().smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runtime()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Device("hub").add_pipeline(ms.serve_pipeline(slots=2, max_seq=8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.cache_init(cfg, 2, 8)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ms.sequential_decode(params, cfg, [1, 2], 3, 8)


def test_entry_points_run_on_the_cpu_when_asked():
    cfg = stablelm_1_6b.config().smoke()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params["embed"]["tok"].device.type == "cpu"
    toks = ms.sequential_decode(params, cfg, [1, 2], 3, 8, slots=2,
                                device="cpu")
    assert len(toks) == 3
    rt = Runtime(device="cpu")
    run = Device("hub", device="cpu").add_pipeline(
        ms.serve_pipeline(slots=2, max_seq=8))
    assert run.device == rt.device


def test_runtime_refuses_a_pipeline_on_another_device():
    rt = Runtime(device="cpu")
    dev = Device("hub", device="cpu")
    dev.add_pipeline(ms.serve_pipeline(slots=2, max_seq=8))
    dev.runs[0].device = torch.device("meta")
    with pytest.raises(ValueError, match="runtime on cpu"):
        rt.add_device(dev)


@pytest.mark.parametrize("kw,item", [({"qos": object()}, "M9"),
                                     ({"mesh": object()}, "M11"),
                                     ({"delivery": object()}, "M10"),
                                     ({"query_batch": 0}, "M3")])
def test_later_slices_raise_naming_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        Runtime(device="cpu", **kw)


def test_live_reconfiguration_waits_for_m7():
    rt = Runtime(device="cpu")
    pipe = ms.serve_pipeline(slots=2, max_seq=8)
    run = Device("hub", device="cpu").add_pipeline(pipe)
    with pytest.raises(NotImplementedError, match="M7"):
        pipe.reconfig()
    with pytest.raises(NotImplementedError, match="M7"):
        rt.reconfigure(run, lambda plan: None)


def test_windowed_layers_wait_for_m5():
    import dataclasses
    cfg = dataclasses.replace(stablelm_1_6b.config().smoke(),
                              layer_pattern="GL", window=8)
    with pytest.raises(NotImplementedError, match="M5"):
        tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_wire_codecs_wait_for_slice_2():
    from repro_torch.core import compression as comp
    from repro_torch.core.buffers import StreamBuffer
    buf = StreamBuffer(tensors=(torch.zeros(4),))
    assert comp.encode(buf, "none") == (buf, 16)
    for codec in ("quant8", "sparse:0.25"):
        with pytest.raises(NotImplementedError, match="M2"):
            comp.encode(buf, codec)
