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


SCANNED = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

#: the wire-codec slice's modules, which the scan must reach
CODEC_MODULES = ("kernels/ops.py", "kernels/quant8.py",
                 "kernels/sparse_enc.py", "kernels/sparse_dec.py",
                 "kernels/ref.py", "core/compression.py",
                 "core/batching.py", "core/elements.py")
#: the rGLRU state family's modules
RGLRU_MODULES = ("kernels/rglru_scan.py", "models/rglru.py",
                 "configs/recurrentgemma_9b.py", "models/layers.py",
                 "models/transformer.py", "core/formats.py")


def test_the_scan_covers_the_codec_modules():
    for rel in CODEC_MODULES:
        assert PORT / rel in SCANNED, rel


def test_the_scan_covers_the_rglru_modules():
    for rel in RGLRU_MODULES:
        assert PORT / rel in SCANNED, rel


#: the attention and MoE decoder zoo's modules
ZOO_MODULES = ("models/moe.py", "models/mla.py", "models/vlm.py",
               "models/model.py", "models/__init__.py", "configs/__init__.py",
               "configs/deepseek_v2_236b.py", "configs/gemma3_4b.py",
               "configs/granite_20b.py", "configs/internvl2_76b.py",
               "configs/mixtral_8x22b.py", "configs/qwen1_5_110b.py",
               "configs/mamba2_130m.py", "configs/whisper_large_v3.py")


def test_the_scan_covers_the_zoo_modules():
    for rel in ZOO_MODULES:
        assert PORT / rel in SCANNED, rel


#: tenant QoS and elastic serving's modules
QOS_MODULES = ("runtime/autoscale.py", "runtime/scheduler.py",
               "core/admission.py", "launch/model_serve.py")


def test_the_scan_covers_the_qos_modules():
    for rel in QOS_MODULES:
        assert PORT / rel in SCANNED, rel


#: the lossy network's modules: the delivery layer and the edge clients
NET_MODULES = ("core/netfault.py", "edge/__init__.py", "edge/edge.py")


def test_the_scan_covers_the_delivery_modules():
    for rel in NET_MODULES:
        assert PORT / rel in SCANNED, rel


@pytest.mark.parametrize("path", SCANNED,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch.launch.model_serve, "
            "repro_torch.runtime, repro_torch.core.compression, "
            "repro_torch.kernels.ops, repro_torch.core.elements, "
            "repro_torch.models.rglru, repro_torch.kernels.rglru_scan, "
            "repro_torch.configs.recurrentgemma_9b, "
            "repro_torch.core.netfault, repro_torch.edge, "
            "repro_torch.models.model, repro_torch.models.moe, "
            "repro_torch.models.mla, repro_torch.models.vlm, "
            "repro_torch.configs; "
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
    if item == "M3":
        # query_batch=0 is ported: synchronous round trips in the client
        assert not Runtime(device="cpu", **kw).batching.enabled
        return
    if item == "M9":
        # tenant QoS is ported: the runtime keeps the policy it is given
        qos = ms.three_tier_qos()
        assert Runtime(device="cpu", qos=qos).qos is qos
        return
    if item == "M10":
        # the delivery layer is ported: the runtime keeps the policy
        from repro_torch.core.netfault import DeliveryPolicy
        pol = DeliveryPolicy()
        rt = Runtime(device="cpu", delivery=pol)
        assert rt.delivery is pol and rt.fabric is None
        return
    with pytest.raises(NotImplementedError, match=item):
        Runtime(device="cpu", **kw)


def test_live_reconfiguration_waits_for_m7():
    """M6 and M7 are ported: ``Pipeline.reconfig`` returns an edit script,
    ``Runtime.reconfigure`` prepares and commits it, and ``Runtime`` takes
    ``lease_ticks`` and ``park_deadline_ticks``."""
    from repro_torch.core.reconfig import ReconfigPlan
    rt = Runtime(device="cpu", lease_ticks=3, park_deadline_ticks=2)
    assert rt.broker.default_lease_ticks == 3
    assert rt.park_deadline_ticks == 2
    pipe = ms.serve_pipeline(slots=2, max_seq=8)
    dev = Device("hub", device="cpu")
    run = dev.add_pipeline(pipe)
    rt.add_device(dev)
    assert isinstance(pipe.reconfig(), ReconfigPlan)
    rc = rt.reconfigure(run, lambda plan: None, warm_ticks=0)
    assert rc.status == "warming"
    rt.run(1)
    assert rc.status == "committed"
    assert rt.stats()["reconfig"]["planned"] == 1


def test_windowed_layers_wait_for_m5():
    """M5 is ported: windowed ('L') and recurrent ('R') layers run, and
    since M12a MoE, MLA and the int8 KV cache; the Mamba-2 kind 'S' still
    raises, naming its own item (M12b)."""
    import dataclasses
    g = torch.Generator().manual_seed(0)
    for pattern in ("GL", "RRL"):
        cfg = dataclasses.replace(stablelm_1_6b.config().smoke(),
                                  layer_pattern=pattern, window=8,
                                  lru_width=64)
        params = tt.init_params(cfg, g, "cpu")
        assert len(ms.sequential_decode(params, cfg, [1, 2], 3, 16, slots=2,
                                        device="cpu")) == 3
    for extra in (dict(n_experts=4, top_k=2, d_ff_expert=64),
                  dict(mla=True, kv_lora_rank=32, qk_nope_dim=16,
                       qk_rope_dim=8, v_head_dim=16),
                  dict(kv_cache_quant=True)):
        cfg = dataclasses.replace(stablelm_1_6b.config().smoke(), **extra)
        params = tt.init_params(cfg, g, "cpu")
        assert len(ms.sequential_decode(params, cfg, [1, 2], 3, 16, slots=2,
                                        device="cpu")) == 3
    cfg = dataclasses.replace(stablelm_1_6b.config().smoke(),
                              layer_pattern="S")
    with pytest.raises(NotImplementedError, match="M12b"):
        tt.init_params(cfg, g, "cpu")
