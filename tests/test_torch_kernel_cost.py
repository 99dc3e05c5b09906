"""One count per kernel (``repro_torch.kernels.cost``), the wrappers' shape-
only ``meta`` route, and the dry run on ``meta`` (``launch/dryrun.py``).

* Every kernel wrapper on ``meta`` returns the outputs its CPU route gives,
  shape for shape and dtype for dtype (forward and, for S1 and S2, the
  backward through autograd), books its ``cost.py`` count on the active
  counter and leaves ``LAUNCHES`` alone; the CPU route books the same count
  and hides its plain version's ops, so a meta trace and a CPU run of one
  step count alike.
* ``cost.bound_ms`` at PERF.md section 6's timed shapes gives the table's
  bound column to its printed digits.
* A mini dry run, the counterpart of the JAX package's
  ``tests/test_distributed.py::test_mini_dryrun_lowers_on_small_mesh``,
  traces gemma3-4b, mixtral-8x22b and mamba2-130m (smoke, vocab 512) train
  and decode steps on a (2, 4) mesh of ``meta`` slots.
* ``lower_combo`` traces full-width combos on the one-card meta mesh; the
  ``use_flash_attn`` stablelm prefill books K5 with the count of
  [1024, 32768, 64]; internvl2-76b x prefill_32k is skipped with the port's
  reason, its prefill raising there.
* The 1- and 2-unit extrapolation equals the full trace for every arch.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import cost
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import norm as kn
from repro_torch.kernels import quant8 as kq
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels import rotary as kr
from repro_torch.kernels import sparse_dec as kd
from repro_torch.kernels import sparse_enc as ke
from repro_torch.kernels import ssd_decode as sd
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh, set_mesh
from repro_torch.models.model import build_model

torch.set_num_threads(2)
MODULES = (kq, ke, kd, fa, rs, ss, sd, kn, kr)


def _launches():
    return {k: v for m in MODULES for k, v in m.LAUNCHES.items()}


def _sig(tree):
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if tree is None:
        return None
    return tuple(_sig(t) for t in tree)


def _on(device, args):
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


def _rand(*shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.randn(shape, generator=g).to(dtype)


def _s3_args(dtype):
    b, h, n, hd = 3, 4, 8, 16
    row = _rand(b, h * hd + 2 * n, dtype=dtype)
    return (_rand(b, h, n, hd), torch.rand(b, h), -torch.rand(h),
            row[:, h * hd:h * hd + n], row[:, h * hd + n:], row[:, :h * hd],
            _rand(h), torch.tensor([True, False, True]))


#: name -> (wrapper, CPU arguments, keyword arguments, its cost.py count)
WRAPPERS = {
    "quantize8": (kq.quantize8, (_rand(64, 256),), {},
                  cost.quantize8(64, 256)),
    "dequantize8": (kq.dequantize8, (torch.ones(64, 256, dtype=torch.int8),
                                     torch.ones(2, 2)), {},
                    cost.dequantize8(64, 256)),
    "sparse_enc": (ke.sparse_enc, (_rand(4 * 512, dtype=torch.bfloat16),),
                   dict(kb=40, frame_blocks=2, totals=True),
                   cost.sparse_enc(4 * 512, 40, torch.bfloat16, True)),
    "sparse_dec": (kd.sparse_dec, (_rand(4, 40),
                                   torch.zeros(4, 40, dtype=torch.int32)),
                   {}, cost.sparse_dec(4, 40, torch.float32)),
    "flash_attention": (fa.flash_attention,
                        tuple(_rand(*s, dtype=torch.bfloat16) for s in
                              ((8, 70, 128), (2, 70, 128), (2, 70, 128))),
                        dict(kv_groups=4),
                        cost.flash_attention(8, 70, 70, 128, 128, 4, True,
                                             torch.bfloat16)),
    "flash_decode": (fa.flash_decode,
                     (_rand(3 * 8, 64), _rand(3, 40, 2, 64),
                      _rand(3, 40, 2, 64),
                      torch.tensor([0, 5, 39], dtype=torch.int32)),
                     dict(kv_groups=4),
                     cost.flash_decode(3, 8, 2, 64, 64, 40, torch.float32)),
    "rglru_scan": (rs.rglru_scan, (torch.rand(2, 9, 33), _rand(2, 9, 33)),
                   {}, cost.rglru_scan(2, 9, 33)),
    "ssd_state_scan": (ss.ssd_state_scan, (torch.rand(2, 3, 4),
                                           _rand(2, 3, 4, 8, 16),
                                           _rand(2, 4, 8, 16)), {},
                       cost.ssd_state_scan(2, 3, 4, 8, 16, True)),
    "ssd_decode": (sd.ssd_decode_step, _s3_args(torch.bfloat16), {},
                   cost.ssd_decode(3, 4, 8, 16, torch.bfloat16, True)),
    "norm": (kn.norm, (_rand(3, 5, 64, dtype=torch.bfloat16), _rand(64),
                       _rand(64)), {},
             cost.norm(15, 64, torch.bfloat16, layernorm=True)),
    "rotary": (kr.rotary, (_rand(2, 7, 4, 32, dtype=torch.bfloat16),
                           _rand(2, 7, 2, 32, dtype=torch.bfloat16),
                           torch.arange(7, dtype=torch.int32)[None]
                           .expand(2, 7).contiguous(), 0.5, 10000.0), {},
               cost.rotary(2, 7, 6, 32, 16, torch.bfloat16, 2)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_meta_route_gives_the_kernel_outputs_and_books_its_count(name):
    fn, args, kw, count = WRAPPERS[name]
    before = _launches()
    want = fn(*args, **kw)                      # the CPU route
    meta_args = _on("meta", args)
    counter = HA.CostCounter()
    with counter:
        got = fn(*meta_args, **kw)
    assert _sig(got) == _sig(want)
    assert all(t.device.type == "meta" for t in
               (got if isinstance(got, tuple) else (got,)) if t is not None)
    assert counter.kernels == {name: {"calls": 1, "flops": count.flops,
                                      "bytes": count.bytes}}
    assert counter.flops == count.flops and counter.bytes == count.bytes
    cpu = HA.CostCounter()
    with cpu:
        fn(*args, **kw)
    assert cpu.kernels == counter.kernels
    assert (cpu.flops, cpu.bytes) == (counter.flops, counter.bytes)
    assert _launches() == before


@pytest.mark.parametrize("name,shape", [("rglru_scan", (2, 9, 33)),
                                        ("ssd_state_scan", (2, 3, 4, 8, 16))])
def test_meta_backward_gives_the_gradients_shapes_and_books(name, shape):
    before = _launches()
    if name == "rglru_scan":
        args = [torch.empty(shape, device="meta", requires_grad=True)
                for _ in range(2)]
        fn = rs.rglru_scan
    else:
        args = [torch.empty(shape[:3], device="meta", requires_grad=True),
                torch.empty(shape, device="meta", requires_grad=True)]
        fn = ss.ssd_state_scan
    counter = HA.CostCounter()
    with counter:
        out = fn(*args)
        out = out if isinstance(out, tuple) else (out,)
        sum(o.sum() for o in out).backward()
    assert [a.grad.shape for a in args] == [a.shape for a in args]
    assert counter.kernel_calls() == {name: 1, f"{name}_bwd": 1}
    bwd = cost.rglru_scan_bwd(*shape) if name == "rglru_scan" else \
        cost.ssd_state_scan_bwd(*shape)
    assert counter.kernels[f"{name}_bwd"]["bytes"] == bwd.bytes
    assert _launches() == before


def test_meta_route_runs_the_card_checks():
    """A meta call fails where the card's would: K5 at a head dim no kernel
    is built for, a misaligned bf16 view, S3 with a strided row."""
    m = torch.empty((4, 16, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="dk == dv"):
        fa.flash_attention(m, m, m)
    v = torch.empty((4, 16, 65), dtype=torch.bfloat16, device="meta")[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(v, v, v)
    a = _on("meta", _s3_args(torch.float32))
    wide = torch.empty((3, 16), device="meta")
    with pytest.raises(ValueError, match="contiguous rows"):
        sd.ssd_decode_step(*a[:3], wide[:, ::2], *a[4:])


#: PERF.md section 6's bound column at each kernel's timed shape
PERF_BOUNDS = {
    "K1": (cost.quantize8(8 * 512, 2048), 0.01252),
    "K2": (cost.dequantize8(8 * 512, 2048), 0.01252),
    "K3": (cost.sparse_enc(8 * 1048576, 80, torch.float32, True), 0.01319),
    "K4": (cost.sparse_dec(8 * 2048, 80, torch.float32), 0.01315),
    "K5": (cost.flash_attention(32, 512, 512, 64, 64, 1, True,
                                torch.bfloat16), 0.00250),
    "S1": (cost.rglru_scan(1, 3000, 4096), 0.04402),
    "S2": (cost.ssd_state_scan(1, 16, 24, 128, 64), 0.00775),
    "S3": (cost.ssd_decode(8, 24, 128, 64, torch.bfloat16), 0.00378),
    "S4": (cost.norm(1774, 6144, torch.bfloat16), 0.01302),
    "S5": (cost.rotary(1, 1774, 49, 128, 128, torch.bfloat16, 2), 0.01329),
    "S1 bwd": (cost.rglru_scan_bwd(2, 2048, 4096), 0.10016),
    "S2 bwd": (cost.ssd_state_scan_bwd(8, 16, 24, 128, 64, True, True,
                                       False), 0.09203),
}


def _k6_timed_count():
    """K6 at chip_smoke 3b's shape and its draw of positions (the first
    draw of ``np.random.default_rng(0)``, the first and last slot pinned)."""
    pos = np.random.default_rng(0).integers(128, 1024, 8).astype(np.int64)
    pos[0], pos[-1] = 0, 1023
    return cost.flash_decode(8, 32, 32, 64, 64, 1024, torch.bfloat16,
                             rows=int((pos + 1).sum()))


@pytest.mark.parametrize("kernel", sorted(PERF_BOUNDS) + ["K6"])
def test_bound_ms_reproduces_the_perf_table(kernel):
    count, want = (_k6_timed_count(), 0.00844) if kernel == "K6" else \
        PERF_BOUNDS[kernel]
    assert round(cost.bound_ms(count), 5) == want
    assert cost.bound(count)["bound_by"] == "bytes"


def test_k5_fp32_bound_is_operations_at_the_f32_peak():
    count = cost.flash_attention(32, 512, 512, 64, 64, 1, True,
                                 torch.float32)
    b = cost.bound(count)
    assert b["bound_by"] == "operations" and round(b["bound_ms"], 5) == \
        0.01606


def _smoke(arch):
    return dataclasses.replace(get_config(arch).smoke(), vocab=512)


@pytest.mark.parametrize("arch", ["gemma3-4b", "mixtral-8x22b",
                                  "mamba2-130m"])
def test_mini_dryrun_traces_on_a_small_mesh_of_meta_slots(arch):
    cfg = _smoke(arch)
    model = build_model(cfg)
    mesh = make_host_mesh(4, devices=["meta"] * 8)
    pshape = ST.eval_params_shape(model, True)
    counter = HA.CostCounter()
    with set_mesh(mesh), counter:
        step = ST.make_train_step(model, mesh, stacked=True)
        tok = torch.empty((8, 32), dtype=torch.int32, device="meta")
        params, opt, metrics = step(pshape, ST.eval_opt_shape(pshape),
                                    {"tokens": tok})
        dstep = ST.make_decode_step(model, mesh, stacked=True)
        nxt, cache = dstep(pshape, torch.empty((8,), dtype=torch.int32,
                                               device="meta"),
                           ST.eval_cache_shape(model, 8, 64, True))
    assert metrics["loss"].device.type == "meta" and nxt.shape == (8,)
    assert counter.flops > 0
    colls = HA.collective_bytes(counter)
    if arch == "mixtral-8x22b":
        assert colls["all-reduce"] > 0      # the expert-parallel psum
    if arch == "mamba2-130m":
        assert colls["collective-permute"] > 0   # sequence-parallel SSD


FULL = [("stablelm-1.6b", "train_4k", None),
        ("deepseek-v2-236b", "decode_32k", None),
        ("mamba2-130m", "long_500k", None),
        ("whisper-large-v3", "decode_32k", None),
        ("stablelm-1.6b", "prefill_32k", {"use_flash_attn": True})]


@pytest.mark.parametrize("arch,shape,over", FULL,
                         ids=[f"{a}-{s}" + ("-flash" if o else "")
                              for a, s, o in FULL])
def test_full_width_combos_trace_on_the_one_card_mesh(arch, shape, over):
    rec = D.lower_combo(arch, shape, False, analysis=False, overrides=over,
                        mesh=D.one_card_mesh())
    assert rec["status"] == "compiled", rec
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert rec["roofline"]["split"] == "even"
    assert rec["card"] == "NVIDIA H100 80GB HBM3"
    kern = rec["scanned_cost_raw"]["kernels"]
    cfg = get_config(arch)
    if over:
        k5 = cost.flash_attention(1024, 32768, 32768, 64, 64, 1, True,
                                  torch.bfloat16)
        assert kern == {"flash_attention": cfg.n_layers,
                        "norm": 2 * cfg.n_layers + 1,
                        "rotary": cfg.n_layers}
        assert rec["roofline"]["compute_peak"] == "bf16"
        assert rec["scanned_cost_raw"]["flops"] > cfg.n_layers * k5.flops
    if arch == "mamba2-130m":
        assert kern == {"ssd_decode": cfg.n_layers, "norm": cfg.n_layers + 1}


def test_flash_prefill_books_the_k5_count_of_its_shape():
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=1,
                              use_flash_attn=True)
    model = build_model(cfg)
    counter = HA.CostCounter()
    params = ST.eval_params_shape(model, True)
    with counter:
        ST.make_prefill_step(model, None, 32768)(
            params, ST.input_specs(model, "prefill_32k"))
    k5 = cost.flash_attention(1024, 32768, 32768, 64, 64, 1, True,
                              torch.bfloat16)
    assert counter.kernels["flash_attention"] == {
        "calls": 1, "flops": k5.flops, "bytes": k5.bytes}


def test_internvl2_prefill_32k_is_skipped_where_the_port_raises():
    """The JAX package keeps a ring there
    (``tests/test_torch_dryrun_parity.py`` pins that side)."""
    rec = D.lower_combo("internvl2-76b", "prefill_32k", False,
                        mesh=D.one_card_mesh())
    assert rec["status"] == "skipped"
    assert "33024 tokens (256 patches + 32768)" in rec["reason"]
    # the port's prefill raises there (smoke width: patches + text past
    # max_seq)
    model = build_model(_smoke("internvl2-76b"))
    specs = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in model.input_specs("prefill", 2, 32).items()}
    with pytest.raises(ValueError, match="exceeds max_seq=32"):
        model.prefill(ST.eval_params_shape(model, False), specs, 32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_unit_extrapolation_equals_the_full_trace(arch):
    """At smoke width (train, the step with the most ops): C(1) + (units -
    1) (C(2) - C(1)) of the 1- and 2-unit list-layout traces equals the
    full stacked trace's FLOPs; on an eager trace no layer is counted
    once for many."""
    cfg = _smoke(arch)
    name = "smoke_train"
    ST.SHAPES[name] = {"mode": "train", "seq": 32, "global_batch": 2}
    try:
        rec = D.lower_combo(cfg, name, False, mesh=D.one_card_mesh())
    finally:
        del ST.SHAPES[name]
    assert rec["status"] == "compiled"
    full = rec["scanned_cost_raw"]["flops"]
    assert rec["extrapolated"]["flops_per_device"] == pytest.approx(
        full, rel=1e-12)
    c1, c2 = (rec["unit_costs"][k]["flops"] for k in ("1", "2"))
    assert c2 > c1 > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_card_route_books_the_meta_count_once_a_launch(name, cuda):
    fn, args, kw, count = WRAPPERS[name]
    if name == "flash_decode":          # K6 takes 16-byte-aligned caches
        args = args[:1] + tuple(t.contiguous() for t in args[1:])
    before = _launches()
    counter = HA.CostCounter()
    with counter:
        got = fn(*_on(cuda, args), **kw)
    meta = HA.CostCounter()
    with meta:
        want = fn(*_on("meta", args), **kw)
    torch.cuda.synchronize()
    assert _sig(got) == _sig(want)
    assert counter.kernels == meta.kernels == {
        name: {"calls": 1, "flops": count.flops, "bytes": count.bytes}}
    after = _launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {name: 1}


@pytest.mark.cuda
def test_a_card_step_counts_as_its_meta_trace(cuda):
    """A smoke mamba2 train step (S2 and its backward, on autograd's
    device thread) counts on the card exactly as on meta."""
    cfg = _smoke("mamba2-130m")
    model = build_model(cfg)
    counts = []
    for dev in ("meta", cuda):
        params = ST.eval_params_shape(model, True) if dev == "meta" else \
            model.init_stacked(torch.Generator(device=dev).manual_seed(0),
                               dev)
        opt = ST.eval_opt_shape(params)
        tok = torch.zeros((2, 64), dtype=torch.int32, device=dev)
        counter = HA.CostCounter()
        with counter:
            ST.make_train_step(model, None)(params, opt, {"tokens": tok})
        counts.append((counter.flops, counter.bytes,
                       counter.kernel_calls()))
    assert counts[0] == counts[1]
