"""Step builders of the port: the train, prefill and decode steps that the
launchers run (``src/repro/launch/steps.py``).

Decoder-only archs take the stacked parameter layout, the encoder-decoder
(whisper) the list layout, as in the JAX package.  The steps run eagerly:
autograd computes the gradients that ``jax.value_and_grad`` does, and
:func:`adamw_update` applies them in place (the JAX launcher donates the
parameters and state to its jitted step).

Each builder takes the mesh as the JAX package's does and installs
``{**activation_rules(cfg, mesh), "__mesh__": mesh}`` around the step, so
the modules with explicit collectives take their mesh paths: the
expert-parallel MoE and, for a config with ``ssm_seq_parallel``, the
sequence-parallel SSD (a (1, 1) host mesh has a ``model`` axis, so the
launcher's step takes them too, as the JAX launcher's does).  ``mesh=None``
installs nothing: the single-device paths.  The shape helpers of the
dry-run (``eval_*_shape``, ``input_specs``) belong to the analysis tools
(ROADMAP M14).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core.buffers import tree_flatten, tree_unflatten
from ..models.config import ModelConfig
from ..models.model import Model
from ..models.sharding import sharding_rules
from ..models.transformer import greedy
from ..optim import OptState, adamw_init, adamw_update, linear_warmup_cosine
from . import shardings as SH

# input shapes assigned to this paper (brief):
SHAPES: Dict[str, Dict] = {
    "train_4k": {"mode": "train", "seq": 4096, "global_batch": 256},
    "prefill_32k": {"mode": "prefill", "seq": 32_768, "global_batch": 32},
    "decode_32k": {"mode": "decode", "seq": 32_768, "global_batch": 128},
    "long_500k": {"mode": "decode", "seq": 524_288, "global_batch": 1},
}

# archs allowed to run long_500k (sub-quadratic decode state; DESIGN.md §4)
LONG_OK = {"mamba2-130m", "recurrentgemma-9b", "gemma3-4b", "mixtral-8x22b"}


def shape_applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and cfg.name not in LONG_OK:
        return False, "full-attention KV at 500k context (DESIGN.md §4 skip)"
    return True, ""


def value_and_grad(loss_fn: Callable, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, batch)`` for a
    tree of tensors -> ((loss, parts), grads), everything detached; grads
    have the tree's structure and each leaf's dtype, zeros for a leaf the
    loss does not reach.  The leaves require grad only inside the call."""
    leaves, treedef = tree_flatten(params)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, parts = loss_fn(params, batch)
            loss.backward()
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    for p in leaves:
        p.grad = None
    return (loss.detach(), {k: torch.as_tensor(v).detach()
                            for k, v in parts.items()}), \
        tree_unflatten(treedef, grads)


def train_loss_fn(model: Model, stacked: bool = True) -> Callable:
    """The loss the train step differentiates: ``loss_stacked`` for the
    stacked layout, else ``loss`` with per-block remat (not for the
    encoder-decoder), as the JAX package picks."""
    if stacked and model.supports_stacked:
        return model.loss_stacked
    return functools.partial(model.loss, remat=not model.cfg.enc_dec)


def step_rules(cfg: ModelConfig, mesh, shard_kv_seq: bool = False):
    """The sharding rules a step installs: the activation rules plus the
    live mesh, or nothing without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    return sharding_rules(**SH.activation_rules(cfg, mesh, shard_kv_seq),
                          __mesh__=mesh)


def make_train_step(model: Model, mesh=None, lr: float = 3e-4,
                    total_steps: int = 1000, stacked: bool = True
                    ) -> Callable:
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), params and state updated in place; metrics has the JAX
    package's keys (``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``) as
    device scalars.  ``mesh``: the module docstring."""
    schedule = linear_warmup_cosine(lr, warmup=min(100, total_steps // 10 + 1),
                                    total_steps=total_steps)
    loss_fn = train_loss_fn(model, stacked)
    cfg = model.cfg

    def train_step(params, opt_state, batch):
        with step_rules(cfg, mesh):
            (loss, parts), grads = value_and_grad(loss_fn, params, batch)
            lr_now = schedule(opt_state.step)
            params, opt_state, info = adamw_update(params, grads, opt_state,
                                                   lr=lr_now)
        return params, opt_state, {"loss": loss, **parts, **info,
                                   "lr": lr_now}

    return train_step


def make_prefill_step(model: Model, mesh=None, max_seq: Optional[int] = None,
                      stacked: bool = True) -> Callable:
    fn = model.prefill_stacked if (stacked and model.supports_stacked) \
        else model.prefill
    cfg = model.cfg

    def prefill_step(params, batch):
        with step_rules(cfg, mesh):
            return fn(params, batch, max_seq or batch["tokens"].shape[1])

    return prefill_step


def make_decode_step(model: Model, mesh=None, shard_kv_seq: bool = False,
                     stacked: bool = True) -> Callable:
    fn = model.decode_step_stacked if (stacked and model.supports_stacked) \
        else model.decode_step
    cfg = model.cfg

    def serve_step(params, token, cache):
        """ONE new token against a seq_len KV cache (the brief's decode)."""
        with step_rules(cfg, mesh, shard_kv_seq):
            logits, cache = fn(params, token, cache)
            return greedy(logits), cache

    return serve_step


def opt_shardings(mesh, params_sharding, opt_shape) -> Any:
    """OptState(step, m, v) specs: m and v mirror the params' specs (same
    tree; the dtype differs), the step is replicated."""
    return OptState(step=SH.NamedSharding(mesh, SH.P()), m=params_sharding,
                    v=params_sharding)


# ---------------------------------------------------------------------------
# shape plumbing of the analysis tools
# ---------------------------------------------------------------------------

META = torch.device("meta")


def eval_params_shape(model: Model, stacked: bool = True):
    """The parameter tree (stacked layout unless ``stacked=False`` or the
    model has none) as meta tensors."""
    init = model.init_stacked if (stacked and model.supports_stacked) \
        else model.init
    # a CPU generator: drawing on ``meta`` consumes none of it
    return init(torch.Generator().manual_seed(0), META)


def eval_cache_shape(model: Model, batch: int, seq: int,
                     stacked: bool = True):
    """The decode cache of ``batch`` rows and ``seq`` positions as meta
    tensors."""
    init = model.init_cache_stacked if (stacked and model.supports_stacked) \
        else model.init_cache
    return init(batch, seq, META)


def eval_opt_shape(params_shape) -> OptState:
    """``adamw_init`` over a meta parameter tree: OptState(step, m, v) of
    meta tensors."""
    return adamw_init(params_shape)


def input_specs(model: Model, shape_name: str) -> Dict[str, torch.Tensor]:
    """Meta tensors standing in for every model input of a named shape
    (``SHAPES``), the sequence clamped to the model's context."""
    info = SHAPES[shape_name]
    seq = model.clamp_seq(info["seq"])
    return {k: torch.empty(spec.shape, dtype=spec.dtype, device=META)
            for k, spec in model.input_specs(info["mode"],
                                             info["global_batch"],
                                             seq).items()}
