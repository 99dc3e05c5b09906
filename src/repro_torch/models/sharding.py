"""Logical-axis sharding annotations (``src/repro/models/sharding.py``).

Model code tags activations with logical axis names; a launcher installs
rules mapping them to mesh axes, and stashes the live mesh under
``"__mesh__"`` so the modules with explicit collectives (the expert-parallel
MoE, the sequence-parallel SSD) can reach it.  With no rules installed every
annotation is a no-op.

    with sharding_rules(batch="data", heads="model", __mesh__=mesh):
        loss = model.loss(params, batch)

The JAX package hands its annotations to XLA's partitioner.  The port runs
on one controller and places nothing from them: :func:`shard` checks the
annotation's rank and returns its input unchanged.

The installed rules are process-wide, not per thread (the JAX package
keeps them thread-local, where its tracing reads them): autograd runs a
CUDA backward, and with it remat's recomputation of a block, on a thread
of its own, and that recomputation must take the same mesh path as the
forward it replays.
"""
from __future__ import annotations

import types
from contextlib import contextmanager
from typing import Dict, Optional, Tuple, Union

from ..launch.mesh import P

__all__ = ["sharding_rules", "current_rules", "logical_spec", "shard"]

_state = types.SimpleNamespace(rules=None)


def _rules() -> Dict[str, Union[str, Tuple[str, ...], None]]:
    return getattr(_state, "rules", None) or {}


def current_rules() -> Dict[str, Union[str, Tuple[str, ...], None]]:
    """Installed logical-axis rules (empty dict when none), the live mesh
    under ``"__mesh__"``."""
    return _rules()


@contextmanager
def sharding_rules(**rules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def logical_spec(*names: Optional[str]) -> P:
    rules = _rules()
    return P(*[rules.get(n) if n is not None else None for n in names])


def shard(x, *names: Optional[str]):
    """Annotate ``x`` (rank == len(names)) with logical axes: a no-op when
    no rules are installed; raises ``ValueError`` on a rank mismatch when
    they are, as the JAX package does."""
    if not _rules():
        return x
    if x.ndim != len(names):
        raise ValueError(f"shard({tuple(x.shape)}) got {len(names)} names "
                         f"{names}")
    return x
