"""K5 and K6 (bf16) at chip_smoke 14a's head-dim 128/256 shapes, against an
earlier commit's kernels on the same card.

    python3 tools/flash_vs_parent.py [--parent DIR] [--out FILE] [--check]

Builds this checkout's K5/K6 sources (``kernels/build.py``) and, with
``--parent``, the same two sources of another checkout (a ``git archive``
of the commit to compare with, unpacked into DIR) into ``DIR/build``.  At
every bf16 shape of ``chip_smoke._zoo_kernel_shapes`` it holds this
checkout's kernel to its plain version (one bf16 ulp + 1e-5), then times
the parent's kernel and this one in turns (parent, new, new, parent; CUDA
events over 20 calls, as chip_smoke's ``cuda_ms``) beside SDPA and the
bounds, and prints one line a shape.  ``--check`` stops after the checks.
The parent's entry points ``repro_flash_prefill_sm90`` and
``repro_flash_decode`` take the arguments they take here.
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


def _build_parent(parent: Path):
    """nvcc the parent's K5 (bf16) and K6 sources -> {name: CDLL}."""
    from repro_torch.kernels import build
    out = parent / "build"
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    procs = {}
    for name in ("flash_prefill_sm90", "flash_decode"):
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


def _parent_k5(lib):
    from repro_torch.kernels import flash_attn as fa
    fn = lib.repro_flash_prefill_sm90
    fn.argtypes, fn.restype = fa._PREFILL_SM90_ARGS, ctypes.c_int

    def call(q, k, v, grp):
        import torch
        bh, sq, dk = q.shape
        o = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh,
                sq, k.shape[1], dk, grp, 1, q.stride(0), q.stride(1),
                k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                o.stride(0), o.stride(1), dk ** -0.5,
                torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"parent K5 launch failed: {rc}")
        return o
    return call


def _parent_k6(lib):
    from repro_torch.kernels import flash_attn as fa
    fn = lib.repro_flash_decode
    fn.argtypes, fn.restype = fa._DECODE_ARGS, ctypes.c_int

    def call(q, kc, vc, pos, grp):
        import torch
        s_, smax, kvh, dk = kc.shape
        h = kvh * grp
        nsplit = fa.decode_splits(smax)
        o = torch.empty_like(q)
        part = torch.empty((s_ * h, nsplit, dk + 2), dtype=torch.float32,
                           device=q.device)
        ks, vs = kc.stride(), vc.stride()
        rc = fn(1, q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                pos.data_ptr(), part.data_ptr(), o.data_ptr(), s_, h, dk,
                grp, smax, nsplit, q.stride(0), ks[0], ks[1], ks[2], vs[0],
                vs[1], vs[2], o.stride(0), dk ** -0.5,
                torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"parent K6 launch failed: {rc}")
        return o
    return call


def _k6_at_split(q, kc, vc, pos, grp, split):
    """flash_decode_gqa.cu's two passes at a split width of the caller's
    choosing (the wrapper takes ``decode_geometry``'s)."""
    import torch
    from repro_torch.kernels import flash_attn as fa
    s_, smax, kvh, d = kc.shape
    h = kvh * grp
    nsplit = -(-smax // split)
    o = torch.empty_like(q)
    part = torch.empty((s_ * h, nsplit, d + 2), dtype=torch.float32,
                       device=q.device)
    fn = fa._lib("flash_decode_gqa", "repro_flash_decode_gqa",
                 fa._DECODE_GQA_ARGS)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attn as fa

    smi = cs.phase_env()
    log = build.build_all(["flash_prefill_sm90", "flash_decode_gqa",
                           "flash_decode"])
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
    # the warp-specialised kernel's consumers take 240 registers from the
    # block's pool (setmaxnreg): the pool must be 384 x 168
    for r in ptxas["flash_prefill_sm90"]:
        if r["kernel"].startswith("flash_prefill_ws_kernel"):
            cs.check(r.get("registers") == 168,
                     f"{r['kernel']}: {r.get('registers')} registers a "
                     f"thread, not the 168 that setmaxnreg's 24/240/240 "
                     f"split needs")
    parent = _build_parent(args.parent) if args.parent else None
    k5_old = _parent_k5(parent["flash_prefill_sm90"]) if parent else None
    k6_old = _parent_k6(parent["flash_decode"]) if parent else None

    g = torch.Generator(device="cuda").manual_seed(args.seed + 14)
    rng = np.random.default_rng(args.seed + 14)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    k5, k6 = cs._zoo_kernel_shapes()
    rows = {}
    for name, (bh, grp, d, L, dtype, model) in k5.items():
        if dtype != "bfloat16":
            continue
        q, k, v = rn(bh, L, d), rn(bh // grp, L, d), rn(bh // grp, L, d)
        o = fa.flash_attention(q, k, v, causal=True, kv_groups=grp)
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                       causal=True, kv_groups=grp)
        torch.cuda.synchronize()
        row = dict(model=model, shape=[bh, L, d], kv_groups=grp,
                   excess=cs.bf16_excess(o, ref))
        if k5_old is not None:
            row["parent_excess"] = cs.bf16_excess(k5_old(q, k, v, grp), ref)
        cs.check(row["excess"] <= cs.BF16_ATOL, f"{name}: {row}")
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
            row.update(cs._bound(4 * q.numel() * 2,
                                 4 * bh * d * L * (L + 1) / 2, cs.BF16_FLOPS))
        rows[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    for name, (S, H, kv, d, smax, dtype, model) in k6.items():
        if dtype != "bfloat16":
            continue
        grp = H // kv
        q = rn(S * H, d)
        kc, vc = rn(S, smax, kv, d), rn(S, smax, kv, d)
        pos_np = rng.integers(128, smax, S).astype(np.int32)
        pos_np[0], pos_np[-1] = 0, smax - 1
        pos = torch.as_tensor(pos_np, device="cuda")
        o = fa.flash_decode(q, kc, vc, pos, kv_groups=grp)
        ref = fa.flash_decode_plain(q.float(), kc.float(), vc.float(), pos,
                                    kv_groups=grp)
        torch.cuda.synchronize()
        row = dict(model=model, cache=[S, smax, kv, d], heads=H,
                   geometry=list(fa.decode_geometry(smax, kv, grp, d)),
                   excess=cs.bf16_excess(o, ref))
        if k6_old is not None:
            row["parent_excess"] = cs.bf16_excess(
                k6_old(q, kc, vc, pos, grp), ref)
        cs.check(row["excess"] <= cs.BF16_ATOL, f"{name}: {row}")
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
            geo = fa.decode_geometry(smax, kv, grp, d)
            row["split_ms"] = {}
            for split in sorted({geo.split // 2, geo.split, 2 * geo.split,
                                 4 * geo.split} - {0}):
                if split % fa.GQA_TILE[geo.kernel]:
                    continue
                same = torch.equal(_k6_at_split(q, kc, vc, pos, grp, split), o)
                row["split_ms"][split] = [cs.cuda_ms(
                    lambda: _k6_at_split(q, kc, vc, pos, grp, split)),
                    "same bits" if same else "other bits"]
            _, busy, prof = cs._profile(
                lambda: [fa.flash_decode(q, kc, vc, pos, kv_groups=grp)
                         for _ in range(20)])
            row["profile_20_calls"] = [[n[:60], ms_, c] for n, ms_, c in
                                       prof[:4]]
            n_rows = int((pos_np.astype(np.int64) + 1).sum())
            row.update(cs._bound(2 * q.numel() * 2 + S * 4 +
                                 n_rows * kv * d * 4, 4 * n_rows * H * d,
                                 cs.BF16_FLOPS))
        rows[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"nvidia_smi": smi, "ptxas": ptxas,
                                        "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
