"""The port's checkpoints against the JAX package's, on the CPU: twins of
``test_substrates.py::TestCheckpoint``; one tree written by each package
gives the same manifest (keys, chunks, slots, shapes, dtypes); a
checkpoint written by either restores bitwise in the other, bf16 leaves
and ``OptState`` included, in the list and the stacked layout; chunking
past the size limit; a missing leaf raises."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.ckpt as jax_ckpt_mod
from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.optim import adamw_init as jax_init
from repro.optim import adamw_update as jax_update
import repro_torch.checkpoint.ckpt as ckpt_mod
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core.buffers import tree_flatten, tree_unflatten
from repro_torch.models import build_model
from repro_torch.models import transformer as tt
from repro_torch.optim import OptState, adamw_init, adamw_update

torch.set_num_threads(2)


def _bits(x):
    """A leaf's bytes: a tensor's or a JAX/numpy array's (bf16 through
    its uint16 view)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _same(jax_tree, port_tree):
    jl = jax.tree_util.tree_leaves(jax_tree)
    pl = tree_flatten(port_tree)[0]
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        (x, dx), (y, dy) = _bits(a), _bits(b)
        assert dx == dy and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


class TestCheckpoint:
    def test_roundtrip_with_optstate(self, tmp_path):
        params = {"layers": [{"w": torch.arange(6.0).reshape(2, 3)},
                             {"w": torch.ones((3,))}],
                  "emb": torch.zeros((4, 2), dtype=torch.bfloat16)}
        opt = adamw_init(params)
        d = str(tmp_path)
        save_checkpoint(d, 42, {"params": params, "opt": opt})
        assert latest_step(d) == 42
        step, restored = load_checkpoint(d, like={"params": params,
                                                  "opt": opt})
        assert step == 42
        assert isinstance(restored["opt"], OptState)
        for a, b in zip(tree_flatten({"params": params, "opt": opt})[0],
                        tree_flatten(restored)[0]):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_latest_of_many(self, tmp_path):
        d = str(tmp_path)
        for s in (1, 5, 3):
            save_checkpoint(d, s, {"x": torch.zeros(1)})
        assert latest_step(d) == 5


def _trees(arch="stablelm-1.6b", dtype="bfloat16", stacked=False):
    """``{"params", "opt"}`` of one smoke model in both packages: the JAX
    init, carried across by the weight bridge, and fresh AdamW states."""
    jcfg = dataclasses.replace(jax_config(arch).smoke(), dtype=dtype)
    pcfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    jm, pm = jax_build(jcfg), build_model(pcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if stacked:
        jp = jm.stack_params(jp)
    tp = tt.params_from_numpy(jax.device_get(jp), pcfg, "cpu")
    return {"params": jp, "opt": jax_init(jp)}, \
        {"params": tp, "opt": adamw_init(tp)}


def test_manifests_are_the_references(tmp_path):
    jt, pt = _trees()
    jax_save(str(tmp_path / "jax"), 3, jt)
    save_checkpoint(str(tmp_path / "port"), 3, pt)
    read = [json.loads((tmp_path / k / "step_00000003" /
                        "manifest.json").read_text()) for k in ("jax",
                                                                "port")]
    assert read[0] == read[1]
    assert "opt/step" in read[1]["leaves"]
    assert read[1]["leaves"]["params/embed/tok"]["dtype"] == "bfloat16"


@pytest.mark.parametrize("stacked", [False, True])
def test_jax_checkpoint_restores_bitwise_in_the_port(tmp_path, stacked):
    jt, pt = _trees(arch="recurrentgemma-9b", stacked=stacked)
    rng = np.random.default_rng(1)
    leaves = jax.tree_util.tree_leaves(jt["params"])
    g = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jt["params"]),
        [jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)
                     ).astype(x.dtype) for x in leaves])
    p, o, _ = jax_update(jt["params"], g, jt["opt"], lr=1e-2)
    jax_save(str(tmp_path), 7, {"params": p, "opt": o})
    step, got = load_checkpoint(str(tmp_path), like=pt)
    assert step == 7 and int(got["opt"].step) == 1
    _same({"params": p, "opt": o}, got)


@pytest.mark.parametrize("stacked", [False, True])
def test_port_checkpoint_restores_bitwise_in_jax(tmp_path, stacked):
    jt, pt = _trees(arch="mamba2-130m", stacked=stacked)
    rng = np.random.default_rng(2)
    leaves, treedef = tree_flatten(pt["params"])
    g = tree_unflatten(treedef, [
        torch.as_tensor(rng.standard_normal(tuple(x.shape)).astype(
            np.float32)).to(x.dtype) for x in leaves])
    p, o, _ = adamw_update(pt["params"], g, pt["opt"], lr=1e-2)
    save_checkpoint(str(tmp_path), 9, {"params": p, "opt": o})
    step, got = jax_load(str(tmp_path), like=jt)
    assert step == 9 and int(got["opt"].step) == 1
    _same(got, {"params": p, "opt": o})


def test_chunks_split_past_the_limit_in_both_packages(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(ckpt_mod, "_CHUNK_BYTES", 40_000)
    monkeypatch.setattr(jax_ckpt_mod, "_CHUNK_BYTES", 40_000)
    jt, pt = _trees(dtype="float32")
    save_checkpoint(str(tmp_path), 1, pt)
    d = tmp_path / "step_00000001"
    man = json.loads((d / "manifest.json").read_text())
    assert man["chunks"] > 3 and len(os.listdir(d)) == man["chunks"] + 1
    _, got = jax_load(str(tmp_path), like=jt)
    _same(got, pt)
    _, back = load_checkpoint(str(tmp_path), like=pt)
    _same(got, back)


def test_without_like_a_nested_dict_and_a_missing_leaf_raises(tmp_path):
    t = {"a": {"b": torch.ones(2, dtype=torch.bfloat16)},
         "c": [torch.arange(3)]}
    save_checkpoint(str(tmp_path), 2, t)
    _, got = load_checkpoint(str(tmp_path))
    assert got["a"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["c"]["0"], torch.arange(3))
    with pytest.raises(KeyError, match="z"):
        load_checkpoint(str(tmp_path), like={**t, "z": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))
