"""Dry run of the port (``src/repro/launch/dryrun.py``): prove every (arch x
shape x mesh) traces with coherent layouts, and count its work, with no
card: every tensor lives on ``meta``, which allocates nothing.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card

The JAX package lowers and compiles each step for 256 or 512 forged host
devices and reads XLA's analyses.  The port's counterparts:

* **The mesh.**  The production mesh is (16, 16) or (2, 16, 16) slots, each
  on ``meta`` (``make_production_mesh(devices="meta")``): the counterpart
  of the forged host devices.  ``lower_combo`` and ``extrapolated_roofline``
  take another mesh too; a (1, 1) mesh of one ``meta`` slot stands for one
  card (``--mesh card``, the records' ``"mesh": "card"``).
* **"Lowered"** means the step traced on ``meta`` at full width under the
  mesh's rules (``launch/steps.py``'s step makers install them, so the
  expert-parallel MoE and the sequence-parallel SSD take their mesh
  paths), every layout of ``launch/shardings.py`` checked to divide its
  dimension.  The trace runs under ``hlo_analysis.CostCounter``, and
  **"compiled"** means its record was taken.
* **memory.**  ``argument_bytes`` and ``output_bytes`` a device are each
  leaf's bytes over the product of its spec's axis sizes.  ``peak_bytes``
  (the counter's high-water mark of live storages, the arguments
  included) and ``temp_bytes`` (the peak less the arguments) are given on
  a one-slot mesh only, ``None`` on a mesh of more slots: the port runs
  the dense layers whole, with no tensor parallelism (ROADMAP Queue 1),
  so a per-device peak would be invented.
* **scanned_cost_raw** is the full trace's count.  An eager trace counts
  every layer, so there is no scan body counted once to correct for.
* **roofline** comes from the full trace, its FLOPs and bytes split evenly
  over the mesh's slots (``"split": "even"``).  The JAX package's numbers
  are XLA's per-device counts of the GSPMD-partitioned program, which the
  port does not execute: on one card it cannot.  The collective term is the
  bytes ``launch/spmd.py`` books a device.  Times are on the constants of
  ``NVIDIA H100 80GB HBM3`` (``launch/mesh.py``).
* **unit_costs** and **units_extrapolated** come from unrolled 1-unit and
  2-unit traces, extrapolated layer-linearly as the JAX package does
  (``C(1) + (units - 1) (C(2) - C(1))``); on an eager trace that equals
  the full trace (``tests/test_torch_kernel_cost.py``).
* **model_flops_total** and **model_vs_hlo_flops** keep the JAX package's
  formula (6 N_active D for training, 2 N_active D for serving).

The records go to ``build/dryrun.json`` (``--out``), not the JAX package's
``results/dryrun.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import replace
from typing import Dict, Optional

import torch

from ..configs import ARCH_IDS, get_config
from ..models.model import build_model
from ..models.transformer import layer_plan
from . import hlo_analysis as HA
from . import shardings as SH
from . import steps as ST
from .mesh import (H100_NAME, make_host_mesh, make_production_mesh,
                   mesh_axis_sizes, set_mesh)

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun.json")

META = torch.device("meta")


def one_card_mesh():
    """A (1, 1) (data, model) mesh of one ``meta`` slot: one card."""
    return make_host_mesh(devices=[META])


def _walk(tree, specs, fn):
    """``fn(tensor, NamedSharding)`` over the tensors of ``tree`` and the
    matching nodes of the spec tree ``specs``."""
    if isinstance(tree, torch.Tensor):
        fn(tree, specs)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _walk(v, specs[k], fn)
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            _walk(v, s, fn)


def _per_device_bytes(tree, specs, mesh, check: bool = False) -> int:
    """Bytes a device holds of ``tree`` laid out by ``specs``; with
    ``check``, raise where a spec does not divide its dimension."""
    sizes = mesh_axis_sizes(mesh)
    total = [0]

    def one(t, ns):
        div = 1
        for dim, entry in enumerate(ns.spec):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n = 1
            for a in axes:
                n *= sizes[a]
            if check and t.shape[dim] % n:
                raise ValueError(f"spec {ns.spec} does not divide "
                                 f"{tuple(t.shape)}")
            div *= n
        total[0] += t.numel() * t.element_size() // div
    _walk(tree, specs, one)
    return total[0]


class Compiled:
    """The counter's record of a traced step (the counterpart of a
    compiled executable's analyses)."""

    def __init__(self, record: Dict, memory: Dict):
        self.record = record
        self.memory = memory

    def cost_analysis(self) -> Dict:
        return {"flops": self.record["flops"],
                "bytes accessed": self.record["bytes"],
                "transcendentals": self.record["transcendentals"]}

    def memory_analysis(self) -> Dict:
        return dict(self.memory)

    def collectives(self) -> Dict[str, int]:
        return dict(self.record["collectives"])

    def kernel_calls(self) -> Dict[str, int]:
        return {k: int(v["calls"])
                for k, v in self.record["kernels"].items()}


class Lowered:
    """A step traced on ``meta`` under the mesh's rules, its counter
    kept."""

    def __init__(self, counter: HA.CostCounter, memory: Dict):
        self.counter = counter
        self.memory = memory

    def compile(self) -> Compiled:
        return Compiled(self.counter.record(), self.memory)


def _build_lowered(cfg, model, shape_name: str, mesh, stacked: bool):
    """Trace the step for one combo on ``meta``; -> (lowered, meta)."""
    info = ST.SHAPES[shape_name]
    mode = info["mode"]
    seq = model.clamp_seq(info["seq"])
    batch = info["global_batch"]
    stacked = stacked and model.supports_stacked

    params = ST.eval_params_shape(model, stacked)
    pspec = SH.stacked_param_shardings(cfg, mesh, params) if stacked \
        else SH.param_shardings(cfg, mesh, params)
    specs = ST.input_specs(model, shape_name)
    bspec = SH.batch_shardings(cfg, mesh, specs)
    counter = HA.CostCounter()

    if mode == "train":
        step = ST.make_train_step(model, mesh, stacked=stacked)
        opt = ST.eval_opt_shape(params)
        ospec = ST.opt_shardings(mesh, pspec, opt)
        args, arg_specs = (params, opt, specs), (pspec, ospec, bspec)
        arg_bytes = sum(_per_device_bytes(t, s, mesh, check=True)
                        for t, s in zip(args, arg_specs))
        counter.track(args)
        with counter:
            params_o, opt_o, metrics = step(params, opt, specs)
        out_bytes = _per_device_bytes(params_o, pspec, mesh) + \
            _per_device_bytes(opt_o, ospec, mesh) + \
            _per_device_bytes(metrics, SH.batch_shardings(cfg, mesh, metrics),
                              mesh)
    elif mode == "prefill":
        step = ST.make_prefill_step(model, mesh, max_seq=seq, stacked=stacked)
        arg_bytes = _per_device_bytes(params, pspec, mesh, check=True) + \
            _per_device_bytes(specs, bspec, mesh, check=True)
        counter.track((params, specs))
        with counter:
            logits, cache = step(params, specs)
        # outputs without a layout of their own take the batch rule
        out_bytes = _per_device_bytes(
            logits, SH.batch_shardings(cfg, mesh, logits), mesh) + \
            _per_device_bytes(cache, SH.cache_shardings(cfg, mesh, cache),
                              mesh)
    else:  # decode
        shard_kv = (shape_name == "long_500k")
        step = ST.make_decode_step(model, mesh, shard_kv_seq=shard_kv,
                                   stacked=stacked)
        cache = ST.eval_cache_shape(model, batch, seq, stacked)
        cspec = SH.cache_shardings(cfg, mesh, cache, shard_kv_seq=shard_kv)
        token = specs["token"]
        tspec = SH.batch_shardings(cfg, mesh, {"token": token})["token"]
        arg_bytes = _per_device_bytes(params, pspec, mesh, check=True) + \
            _per_device_bytes(token, tspec, mesh, check=True) + \
            _per_device_bytes(cache, cspec, mesh, check=True)
        counter.track((params, token, cache))
        with counter:
            tok, cache_o = step(params, token, cache)
        out_bytes = _per_device_bytes(tok, tspec, mesh) + \
            _per_device_bytes(cache_o, cspec, mesh)
    one_slot = mesh.size == 1
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": counter.peak - arg_bytes if one_slot else None,
              "peak_bytes": counter.peak if one_slot else None}
    return Lowered(counter, memory), {"mode": mode, "seq": seq,
                                      "global_batch": batch}


def _cost_and_colls(compiled: Compiled) -> Dict:
    cost = compiled.cost_analysis()
    return {"flops": float(cost["flops"]),
            "bytes": float(cost["bytes accessed"]),
            "colls": compiled.collectives(),
            "kernels": compiled.kernel_calls()}


def _reduced_cfg(cfg, k: int):
    """cfg with k pattern-units of layers (prefix/tail preserved)."""
    prefix, period, repeats, tail = layer_plan(cfg)
    n_layers = len(prefix) + k * period + (cfg.n_layers - len(prefix)
                                           - repeats * period)
    kw = {"n_layers": n_layers}
    if cfg.enc_dec:
        kw["n_enc_layers"] = k
        kw["n_layers"] = k
    return replace(cfg, **kw), (cfg.n_enc_layers if cfg.enc_dec else repeats)


def _config(arch, overrides):
    cfg = get_config(arch) if isinstance(arch, str) else arch
    return replace(cfg, **overrides) if overrides else cfg


def extrapolated_roofline(arch, shape_name: str, multi_pod: bool,
                          n_chips: int, mesh=None,
                          overrides: Optional[Dict] = None) -> Dict:
    """Layer-linear extrapolation of the three roofline terms from
    unrolled 1-unit and 2-unit traces (``arch``: a name or a config)."""
    cfg = _config(arch, overrides)
    mesh = mesh if mesh is not None else \
        make_production_mesh(multi_pod=multi_pod, devices=META)
    measures = {}
    for k in (1, 2):
        cfg_k, _ = _reduced_cfg(cfg, k)
        with set_mesh(mesh):
            lowered, _ = _build_lowered(cfg_k, build_model(cfg_k),
                                        shape_name, mesh, stacked=False)
        measures[k] = _cost_and_colls(lowered.compile())
    c1, c2 = measures[1], measures[2]
    _, units = _reduced_cfg(cfg, 1)

    def lin(a, b):
        return a + (units - 1) * (b - a)

    flops = lin(c1["flops"], c2["flops"])
    bytes_ = lin(c1["bytes"], c2["bytes"])
    colls = {k: int(lin(c1["colls"][k], c2["colls"][k])) for k in c1["colls"]}
    terms = HA.roofline_terms({"flops": flops / n_chips,
                               "bytes accessed": bytes_ / n_chips},
                              colls, n_chips, dtype=cfg.dtype)
    terms["dominant"] = HA.dominant_term(terms)
    terms["units_extrapolated"] = units
    return {"roofline": terms, "collectives": colls,
            "unit_costs": {str(k): m for k, m in measures.items()}}


def port_applicable(cfg, shape_name: str):
    """Where the port refuses a combo that the JAX package traces: a
    vision prompt (patches + text) longer than the prefill's ``max_seq``.
    The JAX package's ``block_prefill`` keeps the last ``max_seq``
    positions as a ring there, dropping the first patches that decode
    reads at a global layer; the port raises (ROADMAP, "Different from the
    reference by design")."""
    info = ST.SHAPES[shape_name]
    if info["mode"] == "prefill" and cfg.frontend == "vision" and \
            cfg.n_patches:
        # the prefill step's max_seq is the (clamped) text length
        seq = min(info["seq"], cfg.max_seq) if cfg.max_seq else info["seq"]
        return False, (f"prompt of {cfg.n_patches + seq} tokens "
                       f"({cfg.n_patches} patches + {seq}) exceeds "
                       f"max_seq={seq}: the port keeps no ring over a "
                       f"global layer's cache (ROADMAP, by design)")
    return True, ""


def lower_combo(arch, shape_name: str, multi_pod: bool,
                compile_: bool = True, analysis: bool = True,
                overrides: Optional[Dict] = None, variant: str = "",
                mesh=None) -> Dict:
    """Full trace (layout proof, memory and count) plus the extrapolated
    unit costs.  ``overrides`` patches ModelConfig fields (variants,
    recorded under ``variant``); ``mesh`` replaces the production mesh of
    ``meta`` slots (a one-slot mesh is recorded as ``"card"``)."""
    t0 = time.time()
    cfg = _config(arch, overrides)
    name = arch if isinstance(arch, str) else cfg.name
    model = build_model(cfg)
    tag = {"arch": name, "shape": shape_name,
           "mesh": "card" if mesh is not None and mesh.size == 1 else
           "multi" if multi_pod else "single"}
    for ok, why in (ST.shape_applicable(cfg, shape_name),
                    port_applicable(cfg, shape_name)):
        if not ok:
            return {**tag, "status": "skipped", "reason": why}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, devices=META)
    n_chips = mesh.size
    stacked = model.supports_stacked

    with set_mesh(mesh):
        lowered, meta = _build_lowered(cfg, model, shape_name, mesh, stacked)
    t_lower = time.time() - t0
    rec = {**tag, "mesh_shape": mesh_axis_sizes(mesh), "n_chips": n_chips,
           **meta, "lower_s": round(t_lower, 1), "status": "lowered"}
    if variant:
        rec["variant"] = variant
        rec["overrides"] = overrides
    if not compile_:
        return rec
    compiled = lowered.compile()
    rec["compile_s"] = round(time.time() - t0 - t_lower, 1)
    rec["memory"] = compiled.memory_analysis()
    raw = _cost_and_colls(compiled)
    rec["scanned_cost_raw"] = raw
    rec["status"] = "compiled"
    terms = HA.roofline_terms({"flops": raw["flops"] / n_chips,
                               "bytes accessed": raw["bytes"] / n_chips},
                              raw["colls"], n_chips, dtype=cfg.dtype)
    terms["dominant"] = HA.dominant_term(terms)
    terms["split"] = "even"
    rec["roofline"] = terms
    rec["collectives"] = raw["colls"]
    rec["card"] = H100_NAME

    if analysis:
        ana = extrapolated_roofline(cfg, shape_name, multi_pod, n_chips,
                                    mesh)
        rec["unit_costs"] = ana["unit_costs"]
        rec["units_extrapolated"] = ana["roofline"]["units_extrapolated"]
        rec["roofline"]["units_extrapolated"] = rec["units_extrapolated"]
        rec["extrapolated"] = ana["roofline"]
        # MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (serve)
        toks = meta["global_batch"] * (meta["seq"] if meta["mode"] != "decode"
                                       else 1)
        n_active = model.active_param_count()
        mf = (6.0 if meta["mode"] == "train" else 2.0) * n_active * toks
        rec["model_flops_total"] = mf
        hlo_total = rec["roofline"]["flops_per_device"] * n_chips
        rec["model_vs_hlo_flops"] = mf / hlo_total if hlo_total else None
    rec["analysis_s"] = round(time.time() - t0, 1)
    return rec


def append_result(rec: Dict, path: str = RESULTS):
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = []
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data = [r for r in data
            if not (r["arch"] == rec["arch"] and r["shape"] == rec["shape"]
                    and r["mesh"] == rec["mesh"]
                    and r.get("variant", "") == rec.get("variant", ""))]
    data.append(rec)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(ST.SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both", "card"),
                    default="single",
                    help="the production mesh (16x16), the multi-pod one "
                         "(2x16x16), both, or one card's (1x1)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--no-analysis", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override field=value (perf variants)")
    ap.add_argument("--variant", default="",
                    help="label for this perf variant in results json")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k] = {"0": False, "1": True, "true": True,
                        "false": False}.get(v.lower(), v)

    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(ST.SHAPES) if (args.all or not args.shape) \
        else (args.shape,)
    meshes = {"single": (False,), "multi": (True,), "both": (False, True),
              "card": ("card",)}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                card = multi == "card"
                where = "card" if card else "multi" if multi else "single"
                tag = f"{arch} × {shape} × {where}"
                try:
                    rec = lower_combo(arch, shape, multi is True,
                                      compile_=not args.no_compile,
                                      analysis=not args.no_analysis
                                      and multi is not True,
                                      overrides=overrides or None,
                                      variant=args.variant,
                                      mesh=one_card_mesh() if card else None)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": where,
                           "status": "FAILED",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                append_result(rec, args.out)
                status = rec["status"]
                extra = ""
                if "roofline" in rec:
                    r = rec["roofline"]
                    extra = (f" dominant={r['dominant']}"
                             f" compute={r['compute_s']:.2e}s"
                             f" mem={r['memory_s']:.2e}s"
                             f" coll={r['collective_s']:.2e}s")
                    if rec.get("model_vs_hlo_flops") is not None:
                        extra += f" model/hlo={rec['model_vs_hlo_flops']:.2f}"
                elif status == "skipped":
                    extra = f" ({rec['reason']})"
                print(f"[dryrun] {tag}: {status}{extra}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
