"""The launch shape helpers of the port (``repro_torch.launch.steps``:
``eval_params_shape``, ``eval_cache_shape``, ``eval_opt_shape``,
``input_specs``) against the JAX package's under ``jax.eval_shape``.

For every config in ``configs/`` at full width, stacked and not, both
trees have the same leaf paths (dict keys, list indices, named-tuple
fields; a ``None`` subtree has no leaf in either), and each leaf the same
shape and dtype, but for one leaf that differs by design: a decode cache's
``pos`` is int32 ``[batch]`` in the port (each row decodes at its own
position, which continuous batching needs) where the JAX package keeps
one scalar for the batch.  Every port leaf is a tensor on the ``meta`` device:
nothing is allocated, which is what lets a 236B-parameter tree be built
here.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget_config
from repro.launch import steps as JST
from repro.models.model import build_model as jbuild
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import steps as ST
from repro_torch.models.model import build_model


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def jax_leaves(tree):
    """{path: (shape, dtype name)} of a tree of ShapeDtypeStructs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(_key(k) for k in path): (tuple(leaf.shape),
                                           np.dtype(leaf.dtype).name)
            for path, leaf in flat}


def port_leaves(tree, path=()):
    """{path: (shape, dtype name)} of a tree of meta tensors; asserts each
    leaf is on ``meta``."""
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(port_leaves(v, path + (k,)))
    elif hasattr(tree, "_fields"):                      # a NamedTuple
        for f in tree._fields:
            out.update(port_leaves(getattr(tree, f), path + (f,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(port_leaves(v, path + (i,)))
    else:
        assert isinstance(tree, torch.Tensor), (path, type(tree))
        assert tree.device.type == "meta", (path, tree.device)
        out[path] = (tuple(tree.shape), str(tree.dtype).replace("torch.",
                                                                ""))
    return out


def same_tree(port, want, what, batch=None):
    """The trees agree leaf for leaf; with ``batch``, a cache whose ``pos``
    is the port's per-row [batch] against the JAX package's scalar."""
    got = port_leaves(port)
    if batch is not None:
        assert got[("pos",)] == ((batch,), "int32"), what
        assert want[("pos",)] == ((), "int32"), what
        want = {**want, ("pos",): got[("pos",)]}
    assert got.keys() == want.keys(), (
        what, sorted(set(got) ^ set(want), key=str)[:8])
    bad = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    assert not bad, (what, list(bad.items())[:8])
    assert got, what


def test_the_same_configs():
    assert tuple(ARCH_IDS) == tuple(J_ARCH_IDS)


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "list"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_cache_and_opt_shapes_match_jax(arch, stacked):
    model, jmodel = build_model(get_config(arch)), jbuild(jget_config(arch))
    params = ST.eval_params_shape(model, stacked=stacked)
    jparams = JST.eval_params_shape(jmodel, stacked=stacked)
    same_tree(params, jax_leaves(jparams), f"{arch} params")
    same_tree(ST.eval_cache_shape(model, 8, 64, stacked=stacked),
              jax_leaves(JST.eval_cache_shape(jmodel, 8, 64,
                                              stacked=stacked)),
              f"{arch} cache", batch=8)
    same_tree(ST.eval_opt_shape(params),
              jax_leaves(JST.eval_opt_shape(jparams)), f"{arch} opt")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax_for_every_applicable_shape(arch):
    model, jmodel = build_model(get_config(arch)), jbuild(jget_config(arch))
    names = [n for n in ST.SHAPES if ST.shape_applicable(model.cfg, n)[0]]
    assert names == [n for n in JST.SHAPES
                     if JST.shape_applicable(jmodel.cfg, n)[0]]
    for name in names:
        same_tree(ST.input_specs(model, name),
                  jax_leaves(JST.input_specs(jmodel, name)),
                  f"{arch} {name}")


def test_full_width_trees_allocate_nothing():
    """qwen1.5-110b's stacked params and AdamW state are ~1.3 TB of f32
    moments at full width: built on meta they hold no storage."""
    model = build_model(get_config("qwen1.5-110b"))
    params = ST.eval_params_shape(model)
    opt = ST.eval_opt_shape(params)
    leaves = list(port_leaves(params).values()) + \
        list(port_leaves(opt).values())
    n = sum(int(np.prod(s)) for s, _ in leaves)
    assert n > 3 * 100e9
    for t in torch.utils._pytree.tree_leaves((params, tuple(opt))):
        assert t.is_meta and t.data_ptr() == 0
