"""The port's pipeline-parallel decode across the pod axis
(``repro_torch.launch.pp_serve``) against the JAX package's.

* ``pp_applicable`` equals the JAX function for every config in
  ``configs/`` (and its smoke variant) on meshes with a ``pod`` axis of 2
  and 4 and on meshes without one (the JAX side reads an
  ``AbstractMesh``: the function looks only at axis names and sizes).
* On a (2, 2, 2) mesh of ``cpu`` slots, the port's step equals the JAX
  ``make_pp_serve_step`` on ``tests/test_distributed.py``'s config (4
  layers, d 64, 4/2 heads, vocab 97, fp32, batch 4, prompt 12, max_seq 20)
  on the JAX weights, for 3 steps in a row from the JAX prefill's cache:
  tokens equal, every cache leaf within 1e-5 (that test's atol).  The JAX
  side runs in a subprocess with 8 forged host devices.
* At P = 4 (and P = 2 on mamba2's SSD layers, whose decode rebinds its
  state), each microbatch's tokens and cache rows are bitwise the port's
  ``decode_step_stacked`` run on that microbatch alone, step after step.
* On the card (``cuda``): the same per-microbatch bitwise check in bf16
  under ``use_flash_attn``, and K6 launched exactly once a layer a
  microbatch: ``n_layers · P`` times a step; stages on ``cuda:0`` slots
  over a tree on the CPU work on copies written back into the CPU cache,
  equal to the all-CPU step (tokens, caches within 2e-5).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import pp_serve as PP
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig, reference_fields
from repro_torch.models.model import build_model
from repro_torch.models.transformer import params_from_numpy

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
#: tests/test_distributed.py::test_pp_pod_offload_serve's config
CFG = ModelConfig(name="t", arch_type="dense", n_layers=4, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=97,
                  dtype="float32")
BATCH, PROMPT, MAX_SEQ, STEPS = 4, 12, 20, 3


def pod_mesh(p, data=1, model=1, device="cpu"):
    return Mesh(np.array([device] * (p * data * model), dtype=object
                         ).reshape(p, data, model), ("pod", "data", "model"))


# -- pp_applicable ------------------------------------------------------------

MESHES = [((2, 2, 2), ("pod", "data", "model")),
          ((4, 1, 2), ("pod", "data", "model")),
          ((4, 2), ("data", "model")),
          ((2, 4), ("data", "model"))]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_pp_applicable_matches_jax(shape, axes, smoke):
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as jget_config
    from repro.launch import pp_serve as JPP
    from repro.models.model import build_model as jbuild
    mesh = Mesh(np.array(["cpu"] * int(np.prod(shape)), dtype=object
                         ).reshape(shape), axes)
    jmesh = AbstractMesh(shape, axes)
    got, want = {}, {}
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        if smoke:
            cfg, jcfg = cfg.smoke(), jcfg.smoke()
        got[arch] = PP.pp_applicable(build_model(cfg), mesh)
        want[arch] = JPP.pp_applicable(jbuild(jcfg), jmesh)
    assert got == want
    if "pod" in axes and not smoke:
        assert got["stablelm-1.6b"] and not got["whisper-large-v3"]


def test_a_mesh_without_pod_or_an_uneven_split_raises():
    model = build_model(CFG)
    flat = Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2),
                ("data", "model"))
    with pytest.raises(ValueError, match="pod"):
        PP.make_pp_serve_step(model, flat)
    with pytest.raises(ValueError, match="pod"):
        PP.make_pp_serve_step(model, pod_mesh(3))


# -- against the JAX package ----------------------------------------------------

def _jax_main(out_path):
    """Subprocess entry (8 forged devices): the JAX weights, the prefill's
    cache and 3 chained pp steps on a (2, 2, 2) mesh."""
    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import set_mesh
    from repro.launch.pp_serve import make_pp_serve_step
    from repro.models import ModelConfig as JCfg, build_model as jbuild
    cfg = JCfg(**reference_fields(CFG))
    m = jbuild(cfg)
    sp = m.stack_params(m.init(jax.random.PRNGKey(0)))
    toks = jax.random.randint(jax.random.PRNGKey(1), (BATCH, PROMPT), 0,
                              cfg.vocab)
    lp, cache = m.prefill_stacked(sp, {"tokens": toks}, max_seq=MAX_SEQ)
    tok = jnp.argmax(lp, -1).astype(jnp.int32)
    out = {"params": jax.device_get(sp), "tok0": np.asarray(tok),
           "cache0": jax.device_get(cache), "steps": []}
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    step = jax.jit(make_pp_serve_step(m, mesh))
    for _ in range(STEPS):
        with set_mesh(mesh):
            tok, cache = step(sp, tok, cache)
        tok, cache = np.asarray(tok), jax.device_get(cache)
        out["steps"].append((tok, cache))
        # the next step starts from host arrays, as the first one does (an
        # output typed on the mesh's Explicit axes would not trace again)
        tok, cache = jnp.asarray(tok), jax.tree.map(jnp.asarray, cache)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ppserve") / "ref.pkl")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src") + os.pathsep + HERE
    code = f"import test_torch_pp_serve as t; t._jax_main({path!r})"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=HERE)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _cache_from_jax(c, batch, device="cpu"):
    """A JAX stacked cache (numpy) -> the port's: the scalar ``pos`` as
    int32 [batch] (the port keeps a position a row)."""
    tree = params_from_numpy({k: v for k, v in c.items() if k != "pos"},
                             CFG, device)
    tree["pos"] = torch.full((batch,), int(c["pos"]), dtype=torch.int32,
                             device=device)
    return tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v,
                                                               path + (i,))]
    return [(path, tree)]


def test_pp_step_matches_jax_on_a_2x2x2_mesh(jax_ref):
    model = build_model(CFG)
    params = params_from_numpy(jax_ref["params"], CFG, "cpu")
    cache = _cache_from_jax(jax_ref["cache0"], BATCH)
    tok = torch.as_tensor(jax_ref["tok0"])
    mesh = pod_mesh(2, 2, 2)
    assert PP.pp_applicable(model, mesh)
    step = PP.make_pp_serve_step(model, mesh)
    for i, (jtok, jcache) in enumerate(jax_ref["steps"]):
        tok, cache = step(params, tok, cache)
        np.testing.assert_array_equal(tok.numpy(), jtok, err_msg=f"step {i}")
        assert cache["pos"].tolist() == [int(jcache["pos"])] * BATCH
        got = dict(_leaves({k: cache[k] for k in ("groups", "prefix",
                                                  "tail")}))
        want = dict(_leaves({k: jcache[k] for k in ("groups", "prefix",
                                                    "tail")}))
        assert got.keys() == want.keys()
        for path, leaf in want.items():
            np.testing.assert_allclose(got[path].numpy(), leaf, atol=1e-5,
                                       rtol=0, err_msg=f"step {i} {path}")


# -- against the port's stacked decode, microbatch by microbatch ----------------

def _micro(cache, m, mb):
    """Microbatch ``m``'s rows of a stacked cache, cloned."""
    rows = slice(m * mb, (m + 1) * mb)
    return {"pos": cache["pos"][rows].clone(),
            "prefix": [], "tail": [],
            "groups": [{k: v[:, rows].clone()
                        for k, v in cache["groups"][0].items()}]}


def run_per_microbatch(cfg, p, batch, steps, device="cpu", seed=0,
                       prompt=12, max_seq=24):
    """pp steps over P stages vs ``decode_step_stacked`` on each
    microbatch alone from the same prefill: tokens and cache rows must be
    bitwise equal after every step.  -> the pp step's outputs."""
    model = build_model(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = model.init_stacked(g, device)
    toks = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                         device=device)
    logits, cache = model.prefill_stacked(params, {"tokens": toks}, max_seq)
    tok = torch.argmax(logits, -1).to(torch.int32)
    mb = batch // p
    ref = [(tok[m * mb:(m + 1) * mb].clone(), _micro(cache, m, mb))
           for m in range(p)]
    step = PP.make_pp_serve_step(model, pod_mesh(p, device=device))
    for i in range(steps):
        tok, cache = step(params, tok, cache)
        for m in range(p):
            lt, c = model.decode_step_stacked(params, ref[m][0], ref[m][1])
            ref[m] = (torch.argmax(lt, -1).to(torch.int32), c)
            rows = slice(m * mb, (m + 1) * mb)
            assert torch.equal(tok[rows], ref[m][0]), (i, m)
            assert torch.equal(cache["pos"][rows], c["pos"]), (i, m)
            for k, v in c["groups"][0].items():
                assert torch.equal(cache["groups"][0][k][:, rows], v), \
                    (i, m, k)
    return tok, cache


def test_p4_is_bitwise_the_stacked_decode_per_microbatch():
    run_per_microbatch(CFG, 4, batch=8, steps=3)


def test_p2_ssd_layers_rebind_into_the_stacked_cache():
    cfg = get_config("mamba2-130m").smoke()
    assert cfg.kind(0) == "S" and cfg.n_layers % 2 == 0
    run_per_microbatch(dataclasses.replace(cfg, dtype="float32"), 2,
                       batch=4, steps=3)


def test_prefix_and_tail_pass_through_and_pos_advances():
    tok, cache = run_per_microbatch(CFG, 2, batch=4, steps=2)
    assert cache["prefix"] == [] and cache["tail"] == []
    assert cache["pos"].tolist() == [12 + 2] * 4
    assert tok.dtype == torch.int32 and tok.shape == (4,)


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield "cuda"


FLASH_BF16 = ModelConfig(name="t-flash", arch_type="dense", n_layers=4,
                         d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                         vocab=97, dtype="bfloat16", use_flash_attn=True)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4])
def test_cuda_bf16_flash_is_bitwise_per_microbatch(card, p):
    run_per_microbatch(FLASH_BF16, p, batch=8, steps=4, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4])
def test_cuda_k6_launches_once_a_layer_a_microbatch(card, p):
    from repro_torch.kernels import flash_attn as fa
    model = build_model(FLASH_BF16)
    g = torch.Generator(device=card)
    g.manual_seed(1)
    params = model.init_stacked(g, card)
    toks = torch.randint(0, 97, (8, 16), generator=g, device=card)
    logits, cache = model.prefill_stacked(params, {"tokens": toks}, 32)
    tok = torch.argmax(logits, -1).to(torch.int32)
    step = PP.make_pp_serve_step(model, pod_mesh(p, device=card))
    fa.reset_launches()
    tok, cache = step(params, tok, cache)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_decode"] == FLASH_BF16.n_layers * p
    assert fa.LAUNCHES["flash_attention"] == 0
    assert tok.device.type == "cuda" and cache["pos"].device.type == "cuda"


@pytest.mark.cuda
def test_cuda_stages_off_the_trees_device_write_back(card):
    cfg = dataclasses.replace(FLASH_BF16, dtype="float32")   # head dim 64
    model = build_model(cfg)
    g = torch.Generator().manual_seed(3)
    params = model.init_stacked(g, "cpu")
    toks = torch.randint(0, cfg.vocab, (4, 12), generator=g)
    runs = []
    for dev in ("cuda:0", "cpu"):
        logits, cache = model.prefill_stacked(params, {"tokens": toks}, 20)
        tok = torch.argmax(logits, -1).to(torch.int32)
        before = cache["groups"][0]["k"].clone()
        step = PP.make_pp_serve_step(model, pod_mesh(2, device=dev))
        for _ in range(3):
            tok, cache = step(params, tok, cache)
        assert cache["groups"][0]["k"].device.type == "cpu"
        assert not torch.equal(cache["groups"][0]["k"], before)
        runs.append((tok, cache))
    (tok_card, c_card), (tok_cpu, c_cpu) = runs
    assert tok_card.device.type == "cpu" and torch.equal(tok_card, tok_cpu)
    assert torch.equal(c_card["pos"], c_cpu["pos"])
    for k, v in c_cpu["groups"][0].items():
        torch.testing.assert_close(c_card["groups"][0][k], v, rtol=2e-5,
                                   atol=2e-5 * float(v.abs().max()))
