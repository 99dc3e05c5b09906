"""AdamW with global-norm clipping on trees of tensors: the port of
``src/repro/optim/adamw.py``.

Parameter trees are the port's nested dicts and lists (``None`` an empty
node).  Leaves are walked in the JAX package's flatten order, dict keys
sorted (``core.buffers.tree_flatten``), so the global norm sums its f32
leaf norms in the reference's order.  The state mirrors the parameters
with ``m`` and ``v`` in f32 whatever a parameter's dtype, and ``step`` an
int32 scalar tensor on the parameters' device.

:func:`adamw_update` updates the parameters, ``m`` and ``v`` IN PLACE and
returns them (the JAX launcher donates the same buffers to its jitted
step): a full-width model holds one copy of its weights and state.  Every
element goes through the reference's operations in its order, an IEEE
multiply, add or divide each, so an f32 leaf gets the reference's
arithmetic and a bf16 leaf is rounded once, from the f32 result, as
``astype`` rounds it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.buffers import tree_flatten, tree_unflatten


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def _zeros_f32(params):
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in leaves])


def adamw_init(params) -> OptState:
    leaves = tree_flatten(params)[0]
    dev = leaves[0].device if leaves else torch.device("cpu")
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=_zeros_f32(params), v=_zeros_f32(params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum, in flatten order, of each leaf's sum of squares in
    f32."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2)
                          for g in tree_flatten(grads)[0]))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled so their global norm is at most ``max_norm``, in
    f32 as the reference's ``g * scale`` promotes them; the norm)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    leaves, treedef = tree_flatten(grads)
    return tree_unflatten(treedef, [g.float() * scale for g in leaves]), \
        gnorm


@torch.no_grad()
def adamw_update(params, grads, state: OptState, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0
                 ) -> Tuple[Any, OptState, Dict]:
    """One AdamW step after clipping ``grads`` to ``max_grad_norm``: the
    parameters, ``m`` and ``v`` are updated in place and returned with the
    next step count and ``{"grad_norm": ...}``.  ``lr`` is a float or an
    f32 scalar tensor (a schedule's output)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_grad_norm)
    step = state.step + 1
    sf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=sf.device), sf)
    flat_p, treedef = tree_flatten(params)
    flat_g, flat_m, flat_v = (tree_flatten(t)[0]
                              for t in (grads, state.m, state.v))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("adamw_update: params, grads and state differ in "
                         "structure")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g32 = g.float() * scale                 # the clipped gradient
        m.mul_(b1).add_(g32 * (1 - b1))         # b1 m + (1 - b1) g
        tmp = g32 * (1 - b2)
        v.mul_(b2).add_(tmp.mul_(g32))          # b2 v + ((1 - b2) g) g
        torch.div(v, bc2, out=tmp).sqrt_().add_(eps)
        delta = torch.div(m, bc1).div_(tmp)     # m^ / (sqrt(v^) + eps)
        p32 = g32.copy_(p)
        delta.add_(p32 * weight_decay)
        p.copy_(p32.sub_(delta.mul_(lr)))       # p - lr delta, rounded once
    return params, OptState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gnorm}
