"""K5 and K6 at chip_smoke 14a's head-dim 128/256 shapes, bf16 and fp32,
against an earlier commit's kernels on the same card.

    python3 tools/flash_vs_parent.py [--parent DIR] [--out FILE] [--check]
                                     [--dtypes bfloat16,float32]

Builds this checkout's K5/K6 sources (``kernels/build.py``) and, with
``--parent``, the K5 (``flash_prefill_sm90.cu`` for bf16,
``flash_prefill.cu`` for fp32) and K6 (``flash_decode_gqa.cu`` for bf16,
``flash_decode.cu`` for fp32) sources of another checkout (a ``git archive`` of the commit to compare with,
unpacked into DIR) into ``DIR/build``.  At every shape of
``chip_smoke._zoo_kernel_shapes`` in the chosen dtypes it holds this
checkout's kernel to its plain version (bf16: one bf16 ulp + 1e-5; fp32:
atol = rtol = 2e-5), then times the parent's kernel and this one in turns
(parent, new, new, parent; CUDA events over 20 calls, as chip_smoke's
``cuda_ms``) beside SDPA in the same dtype and the bounds, profiles 20
calls by kernel, and prints one line a shape.  ``--check`` stops after the
checks.  The parent's entry points ``repro_flash_prefill_sm90``,
``repro_flash_prefill`` (fp32, dispatching head dims 64, 128 and 256),
``repro_flash_decode_gqa`` (bf16, with this checkout's ``decode_geometry``)
and ``repro_flash_decode`` (fp32, 128-key splits) take the arguments given
here.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

_c = ctypes
#: the parent's ``repro_flash_prefill`` (fp32: dtype code, q, k, v, o, BH,
#: Sq, Sk, D, groups, causal, 8 strides, scale, stream)
_PARENT_PREFILL_F32_ARGS = ([_c.c_int] + [_c.c_void_p] * 4 + [_c.c_int] * 6
                            + [_c.c_longlong] * 8 + [_c.c_float, _c.c_void_p])


def _build_parent(parent: Path):
    """nvcc the parent's K5 (bf16 and fp32) and K6 sources -> {name:
    CDLL}."""
    from repro_torch.kernels import build
    out = parent / "build"
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    procs = {}
    for name in ("flash_prefill_sm90", "flash_prefill", "flash_decode_gqa",
                 "flash_decode"):
        lib = out / f"lib{name}_parent.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(lib), str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"parent {name}: nvcc failed\n{log}")
        print(f"parent ptxas {name}: " + "; ".join(
            f"{r['kernel']} {r.get('registers')} registers, spill "
            f"{r.get('spill_stores')}/{r.get('spill_loads')} B"
            for r in cs.ptxas_report(log)))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _parent_k5(libs, dtype):
    """The parent's K5 on ``dtype``'s route: bf16 ``flash_prefill_sm90``,
    fp32 ``flash_prefill``."""
    import torch
    from repro_torch.kernels import flash_attn as fa
    if dtype == torch.bfloat16:
        fn = libs["flash_prefill_sm90"].repro_flash_prefill_sm90
        fn.argtypes, fn.restype = fa._PREFILL_SM90_ARGS, ctypes.c_int
    else:
        fn = libs["flash_prefill"].repro_flash_prefill
        fn.argtypes, fn.restype = _PARENT_PREFILL_F32_ARGS, ctypes.c_int

    def call(q, k, v, grp):
        bh, sq, dk = q.shape
        o = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh,
                sq, k.shape[1], dk, grp, 1, q.stride(0), q.stride(1),
                k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                o.stride(0), o.stride(1), dk ** -0.5,
                torch.cuda.current_stream().cuda_stream)
        rc = fn(*args) if dtype == torch.bfloat16 else fn(0, *args)
        cs.check(rc == 0, f"parent K5 launch failed: {rc}")
        return o
    return call


def _parent_k6(libs, dtype):
    """The parent's K6 for ``dtype`` at head dims 128 and 256: bf16 on
    flash_decode_gqa.cu, fp32 on flash_decode.cu."""
    import torch
    from repro_torch.kernels import flash_attn as fa
    bf16 = dtype == torch.bfloat16
    if bf16:
        fn = libs["flash_decode_gqa"].repro_flash_decode_gqa
        fn.argtypes, fn.restype = fa._DECODE_GQA_ARGS, ctypes.c_int
    else:
        fn = libs["flash_decode"].repro_flash_decode
        fn.argtypes, fn.restype = fa._DECODE_ARGS, ctypes.c_int

    def call(q, kc, vc, pos, grp):
        s_, smax, kvh, dk = kc.shape
        h = kvh * grp
        geo = fa.decode_geometry(smax, kvh, grp, dk, dtype) if bf16 else \
            (None, fa.DECODE_SPLIT, fa.decode_splits(smax))
        o = torch.empty_like(q)
        part = torch.empty((s_ * h, geo[2], dk + 2), dtype=torch.float32,
                           device=q.device)
        ks, vs = kc.stride(), vc.stride()
        args = (q.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos.data_ptr(),
                part.data_ptr(), o.data_ptr(), s_, h, dk, grp, smax)
        rest = (q.stride(0), ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                o.stride(0), dk ** -0.5,
                torch.cuda.current_stream().cuda_stream)
        rc = fn(*args, geo[1], geo[2], *rest) if bf16 else \
            fn(0, *args, geo[2], *rest)
        cs.check(rc == 0, f"parent K6 launch failed: {rc}")
        return o
    return call


def _k6_at_split(q, kc, vc, pos, grp, split):
    """flash_decode_gqa.cu's two passes at a split width of the caller's
    choosing (the wrapper takes ``decode_geometry``'s), on q's dtype."""
    import torch
    from repro_torch.kernels import flash_attn as fa
    s_, smax, kvh, d = kc.shape
    h = kvh * grp
    nsplit = -(-smax // split)
    o = torch.empty_like(q)
    part = torch.empty((s_ * h, nsplit, d + 2), dtype=torch.float32,
                       device=q.device)
    fn = fa._lib("flash_decode_gqa", "repro_flash_decode_gqa"
                 if q.dtype == torch.bfloat16 else
                 "repro_flash_decode_gqa_f32", fa._DECODE_GQA_ARGS)
    ks, vs = kc.stride(), vc.stride()
    rc = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos.data_ptr(),
            part.data_ptr(), o.data_ptr(), s_, h, d, grp, smax, split, nsplit,
            q.stride(0), ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
            o.stride(0), d ** -0.5, torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"K6 at split {split}: launch failed: {rc}")
    return o


def _turns(new, old):
    """parent, new, new, parent -> (new ms pair, parent ms pair)."""
    if old is None:
        return [cs.cuda_ms(new), cs.cuda_ms(new)], None
    p0 = cs.cuda_ms(old)
    n0, n1 = cs.cuda_ms(new), cs.cuda_ms(new)
    return [n0, n1], [p0, cs.cuda_ms(old)]


def _excess(out, ref):
    """-> chip_smoke's excess of ``out`` over its plain version ``ref``
    (fp32: beyond rtol = 2e-5; bf16: beyond one bf16 ulp); it passes at
    2e-5 (fp32 atol) or 1e-5 (bf16)."""
    return cs._excess(out, ref)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtypes", default="bfloat16,float32")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attn as fa

    smi = cs.phase_env()
    dtypes = args.dtypes.split(",")
    log = build.build_all(["flash_prefill_sm90", "flash_prefill",
                           "flash_decode_gqa", "flash_decode"])
    ptxas = {n: cs.ptxas_report(e["ptxas"]) for n, e in log.items()}
    for n, e in log.items():
        for line in e["ptxas"].splitlines():
            if "arning" in line or "erformance" in line or \
                    "serializ" in line:
                print(f"nvcc {n}: {line.strip()[:300]}")
    for n, rows in ptxas.items():
        print(f"ptxas {n}: " + "; ".join(
            f"{r['kernel']} {r.get('registers')} registers, spill "
            f"{r.get('spill_stores')}/{r.get('spill_loads')} B"
            for r in rows))
        for r in rows:
            cs.check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
                     f"{n}: {r['kernel']} spills: {r}")
    # the warp-specialised kernel's consumers take 240 registers from the
    # block's pool (setmaxnreg): the pool must be 384 x 168
    for r in ptxas["flash_prefill_sm90"]:
        if r["kernel"].startswith("flash_prefill_ws_kernel"):
            cs.check(r.get("registers") == 168,
                     f"{r['kernel']}: {r.get('registers')} registers a "
                     f"thread, not the 168 that setmaxnreg's 24/240/240 "
                     f"split needs")
    parent = _build_parent(args.parent) if args.parent else None

    g = torch.Generator(device="cuda").manual_seed(args.seed + 14)
    rng = np.random.default_rng(args.seed + 14)

    def rn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    k5, k6 = cs._zoo_kernel_shapes()
    rows = {}
    for name, (bh, grp, d, L, dtype, model) in k5.items():
        if dtype not in dtypes:
            continue
        dt = getattr(torch, dtype)
        k5_old = _parent_k5(parent, dt) if parent else None
        q, k, v = (rn(bh, L, d, dtype=dt), rn(bh // grp, L, d, dtype=dt),
                   rn(bh // grp, L, d, dtype=dt))
        o = fa.flash_attention(q, k, v, causal=True, kv_groups=grp)
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                       causal=True, kv_groups=grp)
        torch.cuda.synchronize()
        row = dict(model=model, shape=[bh, L, d], kv_groups=grp,
                   kernel=fa.prefill_kernel(dt, d), excess=_excess(o, ref))
        if dt == torch.float32:
            row["geometry"] = list(fa.wide_prefill_geometry(
                bh, L, L, d, grp, True, fa._sm_count(q.device)))
        if k5_old is not None:
            row["parent_excess"] = _excess(k5_old(q, k, v, grp), ref)
        cs.check(row["excess"] <= cs._excess(o, ref)[1], f"{name}: {row}")
        if not args.check:
            row["ms"], row["parent_ms"] = _turns(
                lambda: fa.flash_attention(q, k, v, causal=True,
                                           kv_groups=grp),
                (lambda: k5_old(q, k, v, grp)) if k5_old else None)
            row["sdpa_ms"] = cs.cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True,
                    enable_gqa=grp > 1))
            _, busy, prof = cs._profile(
                lambda: [fa.flash_attention(q, k, v, causal=True,
                                            kv_groups=grp)
                         for _ in range(20)])
            row["profile_20_calls"] = [[n[:60], ms_, c] for n, ms_, c in
                                       prof[:3]]
            row.update(cs._bound(4 * q.numel() * q.element_size(),
                                 4 * bh * d * L * (L + 1) / 2,
                                 cs.BF16_FLOPS if dt == torch.bfloat16
                                 else cs.FP32_FLOPS))
        rows[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    for name, (S, H, kv, d, smax, dtype, model) in k6.items():
        if dtype not in dtypes:
            continue
        dt = getattr(torch, dtype)
        k6_old = _parent_k6(parent, dt) if parent else None
        grp = H // kv
        q = rn(S * H, d, dtype=dt)
        kc, vc = rn(S, smax, kv, d, dtype=dt), rn(S, smax, kv, d, dtype=dt)
        pos_np = rng.integers(128, smax, S).astype(np.int32)
        pos_np[0], pos_np[-1] = 0, smax - 1
        pos = torch.as_tensor(pos_np, device="cuda")
        o = fa.flash_decode(q, kc, vc, pos, kv_groups=grp)
        ref = fa.flash_decode_plain(q.float(), kc.float(), vc.float(), pos,
                                    kv_groups=grp)
        torch.cuda.synchronize()
        geo = fa.decode_geometry(smax, kv, grp, d, dt)
        row = dict(model=model, cache=[S, smax, kv, d], heads=H,
                   geometry=list(geo), excess=_excess(o, ref))
        if k6_old is not None:
            row["parent_excess"] = _excess(k6_old(q, kc, vc, pos, grp), ref)
        cs.check(row["excess"] <= cs._excess(o, ref)[1], f"{name}: {row}")
        if not args.check:
            row["ms"], row["parent_ms"] = _turns(
                lambda: fa.flash_decode(q, kc, vc, pos, kv_groups=grp),
                (lambda: k6_old(q, kc, vc, pos, grp)) if k6_old else None)
            q4 = q.reshape(S, H, 1, d)
            k4, v4 = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
            mask = (torch.arange(smax, device="cuda")[None, :]
                    <= pos[:, None].long())[:, None, None, :]
            row["sdpa_ms"] = cs.cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, enable_gqa=H > kv))
            # the split width against decode_geometry's, and each pass's
            # device time
            if geo.kernel != "split":
                row["split_ms"] = {}
                unit = fa.GQA_SPLIT_UNIT[geo.kernel]
                for split in sorted({geo.split // 2, geo.split,
                                     2 * geo.split, 4 * geo.split} - {0}):
                    if split % unit:
                        continue
                    same = torch.equal(
                        _k6_at_split(q, kc, vc, pos, grp, split), o)
                    row["split_ms"][split] = [cs.cuda_ms(
                        lambda: _k6_at_split(q, kc, vc, pos, grp, split)),
                        "same bits" if same else "other bits"]
            _, busy, prof = cs._profile(
                lambda: [fa.flash_decode(q, kc, vc, pos, kv_groups=grp)
                         for _ in range(20)])
            row["profile_20_calls"] = [[n[:60], ms_, c] for n, ms_, c in
                                       prof[:4]]
            n_rows = int((pos_np.astype(np.int64) + 1).sum())
            row.update(cs._bound(
                2 * q.numel() * q.element_size() + S * 4 +
                n_rows * kv * d * 2 * q.element_size(), 4 * n_rows * H * d,
                cs.BF16_FLOPS if dt == torch.bfloat16 else cs.FP32_FLOPS))
        rows[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"nvidia_smi": smi, "ptxas": ptxas,
                                        "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
