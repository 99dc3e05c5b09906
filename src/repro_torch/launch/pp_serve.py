"""Among-device serving across the pod axis: pipeline-parallel decode
(``src/repro/launch/pp_serve.py``).

The paper's Fig. 2 at pod scale: the first pod owns the first ``R / P``
layers of the stacked model, the next pod the next ``R / P``, and so on;
a request's residual stream is the query payload, shipped between
pipeline stages by :func:`~.spmd.ppermute` over the ``pod`` axis.  The
batch is cut into ``P`` microbatches that pipeline GPipe-style, so in the
steady state every stage works (the bubble of one decode step is
``(P - 1) / (2P - 1)``).

The JAX package runs the schedule as one ``shard_map`` body, manual over
``pod``, on every pod at once.  The port runs it on one controller, as
``launch/spmd.py`` runs every ``shard_map`` body: time step by time step,
each stage's work on the device of its pod's first slot, then the
``ppermute``.  A stage's layers are views of ``params["stack"][0]`` and
its caches views of ``cache["groups"][0]`` (rows ``s R/P .. (s+1) R/P``
of the stacked dimension, and a microbatch's rows of the batch
dimension), so on slots that share a device nothing is copied and the
decode writes its cache rows in place.  A stage on another device than
the tree works on a copy that is written back after the step.

Each active stage runs its microbatch through ``transformer.block_decode``
layer by layer, the arithmetic of ``decode_step_stacked`` on that
microbatch alone (K6 on the card under ``use_flash_attn``), and the last
stage unembeds each microbatch as it leaves the pipeline, so its tokens
are bitwise that decode's too.  (The JAX package gathers the last stage's
outputs with a ``psum`` and unembeds the whole batch; on the card a GEMM's
row can depend on the batch it is computed in.)  Where the
JAX package computes an idle stage (a microbatch index out of range) and
masks its result, the port skips it: the results are the same.  The
``data`` and ``model`` axes place nothing (the GSPMD layouts are specs
only in the port, ROADMAP Queue 1); the step installs the reference's
activation rules with ``batch`` on ``data`` all the same.

Restrictions (checked by :func:`pp_applicable`): decoder-only, one layer
kind repeated (period 1), no prefix or tail layers, repeats divisible by
the pod count: the uniform archs (qwen, granite, stablelm, internvl2's
LM, mamba2, mixtral).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import numpy as np
import torch

from ..models import layers as L
from ..models.model import Model
from ..models.sharding import sharding_rules
from ..models.transformer import (_map, _rows, block_decode, greedy,
                                  layer_plan)
from . import shardings as SH
from . import spmd
from .mesh import Mesh

__all__ = ["pp_applicable", "make_pp_serve_step"]


def pp_applicable(model: Model, mesh) -> bool:
    cfg = model.cfg
    if "pod" not in mesh.axis_names or cfg.enc_dec:
        return False
    prefix, period, repeats, tail = layer_plan(cfg)
    return (not prefix and not tail and period == 1
            and repeats % mesh.shape["pod"] == 0)


def _stage_devices(mesh: Mesh) -> List[torch.device]:
    """The device of each stage: its pod's slot at position 0 of every
    other axis."""
    pod = mesh.axis_names.index("pod")
    out = []
    for s in range(mesh.shape["pod"]):
        idx = [0] * len(mesh.axis_names)
        idx[pod] = s
        out.append(mesh.devices[tuple(idx)])
    return out


def make_pp_serve_step(model: Model, mesh: Mesh, shard_kv_seq: bool = False
                       ) -> Callable:
    """-> ``serve_step(params, token, cache) -> (next_token int32 [B],
    cache)`` over a stacked tree and stacked cache; the cache's rows are
    written in place, ``pos`` advances by 1, ``prefix`` and ``tail`` pass
    through.  The batch must split into ``P`` equal microbatches."""
    cfg = model.cfg
    if not pp_applicable(model, mesh):
        raise ValueError(f"{cfg.name}: pipeline-parallel decode needs a "
                         f"'pod' axis, a decoder-only model with one "
                         f"repeated layer kind and no prefix or tail, and "
                         f"repeats divisible by the pods; mesh {mesh.shape}")
    n_pods = mesh.shape["pod"]
    kind = cfg.kind(0)
    # batch splits over `data` only: `pod` is the stage axis here
    rules = SH.activation_rules(cfg, mesh, shard_kv_seq=shard_kv_seq)
    rules["batch"] = "data"
    rules["__mesh__"] = mesh
    devs = _stage_devices(mesh)
    pod_axis = mesh.axis_names.index("pod")
    perm = [(i, i + 1) for i in range(n_pods - 1)]
    #: what an idle stage holds when y ships (on its own device, so the
    #: ppermute's zeros for stage 0 are made there)
    idle = [torch.empty(0, device=d) for d in devs]

    #: each stage's slots (its pod's row of the mesh)
    slots_of = [[idx for idx in np.ndindex(mesh.devices.shape)
                 if idx[pod_axis] == s] for s in range(n_pods)]

    def stage_rows(leaf: torch.Tensor, s: int) -> torch.Tensor:
        """Stage ``s``'s rows of a stacked leaf (a view)."""
        n = leaf.shape[0] // n_pods
        return leaf.narrow(0, s * n, n)

    def stage_part(leaf: torch.Tensor, s: int) -> torch.Tensor:
        return stage_rows(leaf, s).to(devs[s])

    def write_back(leaf: torch.Tensor, part: torch.Tensor, s: int):
        if leaf.device != devs[s]:      # the stage worked on a copy
            stage_rows(leaf, s).copy_(part)

    def serve_step(params, token, cache):
        with sharding_rules(**rules):
            b = token.shape[0]
            if b % n_pods:
                raise ValueError(f"batch {b} does not split into "
                                 f"{n_pods} microbatches")
            mb = b // n_pods
            pos = cache["pos"]
            # the JAX package embeds by a one-hot matmul (its gather
            # partitioner fails under the partial-manual pod submesh);
            # one_hot @ table picks each row exactly, so a gather is equal
            x = params["embed"]["tok"][token[:, None].long()]      # [B,1,d]
            stack = params["stack"][0]
            groups = cache["groups"][0]
            r_stage = layer_plan(cfg)[2] // n_pods
            layers = [_rows(_map(lambda t, s=s: stage_part(t, s), stack),
                            r_stage) for s in range(n_pods)]
            caches = [_map(lambda t, s=s: stage_part(t, s), groups)
                      for s in range(n_pods)]
            poss = [pos.to(d) for d in devs]
            home = params["embed"]["tok"].device

            def head(y):
                """A microbatch leaving the last stage: the final norm, the
                unembedding and the greedy token, on the tree's device."""
                h = L.apply_norm(params["final_norm"], y.to(home), cfg)
                return greedy(L.unembed(params["embed"], cfg, h)[:, 0])

            outs: List = [None] * n_pods
            buf: List = [None] * n_pods
            for t in range(2 * n_pods - 1):
                ys: Dict[int, torch.Tensor] = {}
                for s in range(n_pods):
                    m = t - s
                    if not 0 <= m < n_pods:
                        continue            # idle: the reference masks it
                    inp = x[m * mb:(m + 1) * mb].to(devs[0]) if s == 0 \
                        else buf[s]
                    rows = _rows(_map(lambda c: c.narrow(1, m * mb, mb),
                                      caches[s]), r_stage)
                    p_m = poss[s][m * mb:(m + 1) * mb]
                    with _on(devs[s]):
                        y = inp
                        for p_l, view in zip(layers[s], rows):
                            c_l = dict(view)
                            y = block_decode(p_l, cfg, kind, y, c_l, p_m)
                            for k, v in c_l.items():
                                if v is not view[k]:   # a rebound leaf
                                    view[k].copy_(v)
                    ys[s] = y
                    if s == n_pods - 1:
                        outs[m] = head(y)
                # ship each active stage's y to the next stage
                parts = np.empty(mesh.devices.shape, dtype=object)
                for s in range(n_pods):
                    for idx in slots_of[s]:
                        parts[idx] = ys.get(s, idle[s])
                shipped = spmd.ppermute(
                    parts, mesh, "pod", [(i, j) for i, j in perm if i in ys])
                buf = [shipped[slots_of[s][0]] for s in range(n_pods)]
            for s in range(n_pods):
                _map(lambda leaf, part, s=s: write_back(leaf, part, s),
                     groups, caches[s])
            cache["pos"] = pos + 1
            return torch.cat(outs), cache

    return serve_step


def _on(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, else nothing."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()
