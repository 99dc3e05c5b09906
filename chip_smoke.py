#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, one result line each (any failure exits non-zero):

1. environment — torch/CUDA versions and the card's name and power limit;
2. build — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and prints the seconds;
3. kernels vs plain — K5 (flash prefill) and K6 (flash decode) against
   their plain PyTorch versions: fp32 at smoke shapes within atol = rtol =
   2e-5, and bf16 at the full-width shapes within one bf16 ulp (plus 1e-5
   absolute) of the plain version computed in f32 from the same bf16
   inputs; times each kernel,
   its plain version and ``scaled_dot_product_attention`` (a yardstick the
   port never calls) with CUDA events, warm L2;
4. serve — stablelm-1.6b at full width (24 layers, bf16, flash attention)
   behind ``serve_pipeline(slots=8, max_seq=1024)`` with 8 staggered
   clients; checks every answer, token conservation, the kernels' launch
   counts on this run, continuous == sequential decode bitwise for every
   stream (replayed in the slot it was served in), and a small fp32 server
   on the card against the port's CPU path.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
FP32_TOL = 2e-5
BF16_ATOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bf16_excess(out, ref):
    """Largest amount by which |out - ref| exceeds one bf16 ulp of ref (8
    significant bits); the bf16 tolerance is an excess of at most
    BF16_ATOL, the f32 summation-order noise of results near zero."""
    import torch
    mag = ref.abs().clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((out.float() - ref).abs() - ulp).max().item()


def phase_env():
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"phase 1 env: python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    log = build.build_all()
    secs = time.perf_counter() - t0
    regs = {n: [l.split(":", 1)[1].strip() for l in e["ptxas"].splitlines()
                if "registers" in l] for n, e in log.items()}
    print(f"phase 2 build: {secs:.1f} s for {sorted(log)}; "
          f"ptxas {json.dumps(regs)}")
    return secs


def phase_kernels(seed):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as fa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # -- fp32 at smoke shapes: atol = rtol = 2e-5 ----------------------------
    worst = 0.0
    for bh, L, d, grp, causal in [(4, 64, 64, 1, True), (8, 100, 64, 4, True),
                                  (8, 77, 64, 4, False), (4, 96, 64, 2, True),
                                  (2, 130, 64, 1, False)]:
        q, k, v = rn(bh, L, d), rn(bh // grp, L, d), rn(bh // grp, L, d)
        o = fa.flash_attention(q, k, v, causal=causal, kv_groups=grp)
        r = fa.flash_attention_plain(q, k, v, causal=causal, kv_groups=grp)
        torch.cuda.synchronize()
        err = ((o - r).abs() - FP32_TOL * r.abs()).max().item()
        check(err <= FP32_TOL, f"K5 fp32 {bh}x{L}x{d} g{grp} causal={causal}"
                               f": error {err}")
        worst = max(worst, err)
    for S, H, KV, smax, d in [(3, 8, 2, 300, 64), (3, 4, 4, 64, 64),
                              (3, 4, 1, 129, 64)]:
        q, kc, vc = rn(S * H, d), rn(S, smax, KV, d), rn(S, smax, KV, d)
        pos = torch.tensor([0, smax // 2, smax - 1], dtype=torch.int32,
                           device=dev)
        o = fa.flash_decode(q, kc, vc, pos, kv_groups=H // KV)
        r = fa.flash_decode_plain(q, kc, vc, pos, kv_groups=H // KV)
        torch.cuda.synchronize()
        err = ((o - r).abs() - FP32_TOL * r.abs()).max().item()
        check(err <= FP32_TOL, f"K6 fp32 S{S} H{H} KV{KV} Smax{smax} d{d}: "
                               f"error {err}")
        worst = max(worst, err)
    print(f"phase 3a kernels fp32 smoke shapes: pass (atol=rtol={FP32_TOL}, "
          f"worst excess {worst:.2e})")

    # -- bf16 at the full-width shapes ----------------------------------------
    table = {}
    for L in (128, 512):
        q, k, v = (rn(32, L, 64, dtype=torch.bfloat16) for _ in range(3))
        o = fa.flash_attention(q, k, v, causal=True)
        r = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal=True)
        excess = bf16_excess(o, r)
        check(excess <= BF16_ATOL, f"K5 bf16 [32,{L},64]: {excess} beyond "
                                   f"one ulp")
        kern = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True))
        plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                         causal=True))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True))
        nbytes = 4 * q.numel() * 2
        flops = 4 * 32 * 64 * L * (L + 1) / 2
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        table[f"K5 L={L}"] = dict(
            max_abs_err=(o.float() - r).abs().max().item(), excess=excess,
            ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >=
            flops / BF16_FLOPS else "operations")
    S, H, smax = 8, 32, 1024
    q = rn(S * H, 64, dtype=torch.bfloat16)
    kc, vc = (rn(S, smax, H, 64, dtype=torch.bfloat16) for _ in range(2))
    pos_np = rng.integers(128, smax, S).astype(np.int32)
    pos_np[0], pos_np[-1] = 0, smax - 1
    pos = torch.as_tensor(pos_np, device=dev)
    o = fa.flash_decode(q, kc, vc, pos)
    r = fa.flash_decode_plain(q.float(), kc.float(), vc.float(), pos)
    excess = bf16_excess(o, r)
    check(excess <= BF16_ATOL, f"K6 bf16 [8*32,64] x [8,1024,32,64]: "
                               f"{excess} beyond one ulp")
    kern = cuda_ms(lambda: fa.flash_decode(q, kc, vc, pos))
    plain = cuda_ms(lambda: fa.flash_decode_plain(q, kc, vc, pos))
    q4 = q.reshape(S, H, 1, 64)
    k4, v4 = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    mask = (torch.arange(smax, device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                         attn_mask=mask))
    rows = int((pos_np.astype(np.int64) + 1).sum())
    nbytes = 2 * q.numel() * 2 + S * 4 + rows * H * 64 * 2 * 2
    flops = 4 * rows * H * 64
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    table["K6 S=8 max_seq=1024"] = dict(
        max_abs_err=(o.float() - r).abs().max().item(), excess=excess, ms=kern,
        plain_ms=plain, library_ms=lib, bound_ms=bound,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS
        else "operations", pos=pos_np.tolist())
    for name, row in table.items():
        print(f"phase 3b {name} bf16: max abs err {row['max_abs_err']:.3e} "
              f"(excess over 1 ulp {row['excess']:.1e}), kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']})")
    return table


def _serve(rt_device, model, slots, max_seq, clients, seed, max_ticks):
    """Drive one serve pipeline plus staggered clients until every client
    has its answers.  ``clients`` is a list of (join_tick, prompts, gens)."""
    import torch
    from repro_torch.device import make_generator
    from repro_torch.launch import model_serve as ms
    from repro_torch.runtime import Device, Runtime
    rt = Runtime(device=rt_device)
    hub = Device("hub", device=rt_device)
    srv = hub.add_pipeline(ms.serve_pipeline(model=model, slots=slots,
                                             max_seq=max_seq),
                           generator=make_generator(seed, rt.device))
    rt.add_device(hub)
    runs = [None] * len(clients)
    t0 = time.perf_counter()
    while rt.ticks < max_ticks:
        for i, (join, prompts, gens) in enumerate(clients):
            if runs[i] is None and rt.ticks >= join:
                dev = Device(f"tv{i}", device=rt_device)
                p = ";".join(",".join(str(t) for t in pr) for pr in prompts)
                g = ";".join(str(x) for x in gens)
                runs[i] = dev.add_pipeline(ms.client_pipeline(prompts=p,
                                                              gens=g))
                rt.add_device(dev)
        rt.tick()
        done = 0
        for i, run in enumerate(runs):
            if run is not None and \
                    len(run.sink_log.get("res", [])) >= len(clients[i][1]):
                run.retired = True      # this client asks for nothing more
                done += 1
        if done == len(clients):
            break
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rt, srv, runs, wall


def _check_answers(runs, clients, vocab, slots):
    """-> [(prompt, gen, tokens, slot the stream was served in)]"""
    answers = []
    for i, (run, (_, prompts, gens)) in enumerate(zip(runs, clients)):
        check(run is not None, f"client {i} never joined")
        bufs = run.sink_log.get("res", [])
        check(len(bufs) == len(prompts), f"client {i}: {len(bufs)} answers, "
                                         f"expected {len(prompts)}")
        for j, b in enumerate(bufs):
            a, slot = np.asarray(b.tensor), b.meta.get("slot")
            check(slot in range(slots), f"client {i} answer {j}: served in "
                                        f"slot {slot}")
            check(a.shape == (gens[j],) and a.dtype == np.int32,
                  f"client {i} answer {j}: shape {a.shape} {a.dtype}")
            check(((a >= 0) & (a < vocab)).all(),
                  f"client {i} answer {j}: token outside the vocabulary")
            answers.append((prompts[j], gens[j], a.tolist(), slot))
    return answers


def phase_serve(seed):
    import torch
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import model_serve as ms
    from repro_torch.models import transformer

    cfg = dataclasses.replace(stablelm_1_6b.config(), use_flash_attn=True)
    ms.register_serve_model("stablelm-1.6b-flash", lambda: cfg)
    rng = np.random.default_rng(seed)
    clients = []
    for i in range(8):
        n_req = 2 if i < 4 else 1           # 12 streams over 8 slots
        prompts = [rng.integers(0, cfg.vocab, int(rng.integers(128, 513)))
                   .tolist() for _ in range(n_req)]
        gens = [int(rng.integers(16, 65)) for _ in range(n_req)]
        clients.append((2 * i, prompts, gens))

    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rt, srv, runs, wall = _serve(None, "stablelm-1.6b-flash", 8, 1024,
                                 clients, seed, max_ticks=400)
    launches = dict(fa.LAUNCHES)
    answers = _check_answers(runs, clients, cfg.vocab, 8)
    qb = rt.stats()["query_batching"]
    check(qb["tokens_generated"] == qb["tokens_delivered"] +
          qb["tokens_dropped"] + qb["tokens_in_flight"],
          f"token conservation broken: {qb}")
    check(launches["flash_attention"] == cfg.n_layers * qb["prefills"],
          f"K5 launches {launches} != {cfg.n_layers} x {qb['prefills']}")
    check(launches["flash_decode"] == cfg.n_layers * qb["decode_ticks"],
          f"K6 launches {launches} != {cfg.n_layers} x "
          f"{qb['decode_ticks']}")
    check(qb["batched_frames"] > qb["decode_ticks"],
          "the decode batch was never wider than one stream")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    serve = dict(ticks=rt.ticks, wall_s=wall, prefills=qb["prefills"],
                 decode_ticks=qb["decode_ticks"],
                 tokens=qb["tokens_generated"],
                 prefill_ms_per_request=1e3 * qb["prefill_seconds"] /
                 qb["prefills"],
                 decode_ms_per_tick=1e3 * qb["decode_seconds"] /
                 qb["decode_ticks"],
                 mean_active_slots=qb["batched_frames"] / qb["decode_ticks"],
                 tokens_per_s=qb["tokens_generated"] / wall,
                 peak_gib=peak_gib, launches=launches)
    print(f"phase 4a serve stablelm-1.6b bf16 24 layers slots 8 max_seq "
          f"1024: {len(answers)} answers in {rt.ticks} ticks, "
          f"{wall:.2f} s; prefill {serve['prefill_ms_per_request']:.2f} "
          f"ms/request, decode {serve['decode_ms_per_tick']:.2f} ms/tick "
          f"(mean {serve['mean_active_slots']:.2f} active slots), "
          f"{serve['tokens_per_s']:.1f} tokens/s, peak {peak_gib:.2f} GiB, "
          f"launches {launches}")

    params, ecfg = srv.params["lm"], srv.pipe.elements["lm"].cfg
    for prompt, gen, got, slot in answers:
        ref = ms.sequential_decode(params, ecfg, prompt, gen, 1024, slots=8,
                                   slot=slot)
        check(got == ref, f"continuous != sequential for a {len(prompt)}"
                          f"-token prompt in slot {slot}: {got} vs {ref}")
    used = sorted({a[3] for a in answers})
    print(f"phase 4b continuous == sequential decode: {len(answers)} streams "
          f"bitwise, each replayed in its serve slot (slots {used})")

    # a small fp32 server on the card against the port's CPU path
    small = [(i, [[i + 1, i + 2, i + 3]], [6 + i]) for i in range(4)]
    rt2, srv2, runs2, _ = _serve(None, "stablelm-smoke-flash", 4, 32, small,
                                 seed, max_ticks=40)
    got = _check_answers(runs2, small, 512, 4)
    scfg = srv2.pipe.elements["lm"].cfg
    cpu_params = transformer.params_from_numpy(
        _to_numpy(srv2.params["lm"]), scfg, "cpu")
    for prompt, gen, toks, slot in got:
        ref = ms.sequential_decode(cpu_params, scfg, prompt, gen, 32,
                                   slots=4, slot=slot, device="cpu")
        check(toks == ref, f"fp32 card answer {toks} != CPU {ref}")
    print("phase 4c fp32 smoke server on the card == the port's CPU path: "
          f"{len(got)} streams")
    return serve, srv


def _profile(fn):
    """Run ``fn`` once under torch.profiler -> (host wall ms, device busy
    ms, [(op, self device ms, calls)] by device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()                                        # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, host_rows = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            # kernel rows; host-side ops that launched them only if the
            # trace attributes no kernel rows of its own
            (rows if str(e.device_type).endswith("CUDA") else
             host_rows).append((e.key, dev_us / 1e3, e.count))
    rows = rows or host_rows
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows


def phase_profile(srv, seed):
    """Where the time of one full-width prefill (512 tokens) and of one
    decode tick with all 8 slots active goes, by device kernel."""
    import torch
    from repro_torch.core.buffers import tree_flatten
    from repro_torch.models import transformer
    elem = srv.pipe.elements["lm"]
    params, cfg = srv.params["lm"], elem.cfg
    prompt = np.random.default_rng(seed + 1).integers(0, cfg.vocab, 512)
    res = {}
    res["prefill L=512"] = _profile(lambda: elem.host_prefill(params, prompt))
    _, c1 = elem.host_prefill(params, prompt)
    cache = transformer.cache_init(cfg, 8, elem.max_seq)
    for d, s in zip(tree_flatten(cache["layers"])[0],
                    tree_flatten(c1["layers"])[0]):
        d.copy_(s.expand_as(d))
    cache["pos"].fill_(512)
    token = torch.zeros(8, dtype=torch.int32, device="cuda")
    active = torch.ones(8, dtype=torch.bool, device="cuda")

    def tick():
        cache["pos"].fill_(512)
        transformer.serve_decode_step(params, cfg, cache, token, active)
    res["decode tick S=8"] = _profile(tick)
    out = {}
    for name, (wall, busy, rows) in res.items():
        top = ", ".join(f"{k[:40]} {ms_:.2f} ms x{n}" for k, ms_, n in
                        rows[:6])
        print(f"phase 5 profile {name}: host wall {wall:.2f} ms, device "
              f"busy {busy:.2f} ms ({100 * busy / wall:.0f}%); top: {top}")
        out[name] = {"wall_ms": wall, "device_ms": busy,
                     "top": [list(r) for r in rows[:15]]}
    return out


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-width prefill and decode tick")
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    import repro_torch  # noqa: F401  (fails at once outside a checkout)
    import torch
    smi = phase_env()
    build_s = phase_build()
    table = phase_kernels(args.seed)
    serve, srv = phase_serve(args.seed)
    profile = phase_profile(srv, args.seed) if args.profile else None

    k5, k6 = table["K5 L=512"], table["K6 S=8 max_seq=1024"]
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
         "replaces": "src/repro/kernels/flash_attn.py:70",
         "launches": serve["launches"]["flash_attention"],
         **{k: k5[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_attn.py:110",
         "launches": serve["launches"]["flash_decode"],
         **{k: k6[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}},
    ]
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"nvidia_smi": smi, "build_s": build_s,
                                   "kernels": table, "serve": serve,
                                   "profile": profile},
                                  indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
