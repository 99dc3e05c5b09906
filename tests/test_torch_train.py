"""Training in the port (ROADMAP M13) against the JAX package, on the CPU.

* Every ``ARCH_IDS`` smoke config (fp32, the reference's weights through
  ``params_from_numpy``, a numpy-seeded batch of 2 x 64 tokens, so the
  Mamba-2 preset spans 4 of its 16-token chunks and S2's backward runs):
  the loss and EVERY gradient leaf of ``Model.loss`` against
  ``jax.value_and_grad(model.loss)``; then one AdamW step moves the
  parameters (the twin of ``test_arch_smoke.py::
  test_smoke_forward_and_train_step``).  Tolerance per gradient leaf:
  |port - jax| <= 1e-4 |jax| + 2e-5 max|jax leaf| (f32; einsum and
  reduction orders differ; the largest deviation measured is ~3e-6 of a
  leaf's largest element).  Mamba-2 runs the single-device SSD path in
  both packages (the JAX package's sequence-parallel one needs a mesh).
* ``remat=True`` == ``remat=False`` and ``loss_stacked`` == ``loss``
  (the stacked gradients == the list layout's, stacked), bitwise.
* The twin of ``test_system.py::TestTrainingLearns``: a 2-layer model
  learns the Markov corpus through ``make_train_step``.
* ``launch/train.py``: ``main(["--device", "cpu", ...])`` trains, writes a
  checkpoint, and a resumed run restores it bitwise and starts again at
  batch 0 (the reference's behaviour); ``--production-mesh`` raises with
  the count of visible CUDA devices, as ``jax.make_mesh`` does; without
  CUDA the default device raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.buffers import tree_flatten
from repro_torch.data import make_train_iterator
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw_init, adamw_update

torch.set_num_threads(2)

SEQ = 64
BATCH = 2


def _batch(cfg, seq=SEQ, seed=1):
    rng = np.random.default_rng(seed)
    seq = min(seq, cfg.max_seq) if cfg.max_seq else seq
    b = {"tokens": rng.integers(0, cfg.vocab, (BATCH, seq)).astype(np.int32)}
    if cfg.frontend == "vision":
        b["patches"] = rng.standard_normal(
            (BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _port(arch):
    cfg = get_config(arch).smoke()
    jm = jax_build(jax_config(arch).smoke())
    jp = jm.init(jax.random.PRNGKey(0))
    return cfg, jm, jp, build_model(cfg), \
        tt.params_from_numpy(jax.device_get(jp), cfg, "cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    cfg, jm, jp, pm, pp = _port(arch)
    assert cfg.dtype == "float32"
    if cfg.ssm_state:
        assert cfg.ssm_chunk < SEQ              # S2 spans several chunks
    jb, pb = _batch(cfg)
    (jl, jparts), jg = jax.value_and_grad(lambda p: jm.loss(p, jb),
                                          has_aux=True)(jp)
    (pl, pparts), pg = ST.value_and_grad(pm.loss, pp, pb)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(pparts["ce"]), float(jparts["ce"]),
                               rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    pleaves = tree_flatten(pg)[0]
    assert len(pleaves) == len(jleaves) == len(tree_flatten(pp)[0])
    for i, (a, b) in enumerate(zip(jleaves, pleaves)):
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == torch.float32
        np.testing.assert_allclose(
            b.numpy(), a, rtol=1e-4, atol=2e-5 * np.abs(a).max(),
            err_msg=f"{arch} gradient leaf {i}")
    # one real optimizer step moves the parameters
    before = [t.clone() for t in tree_flatten(pp)[0]]
    _, _, info = adamw_update(pp, pg, adamw_init(pp), lr=1e-3)
    assert np.isfinite(float(info["grad_norm"]))
    moved = sum(float((a - b).abs().sum())
                for a, b in zip(tree_flatten(pp)[0], before))
    assert moved > 0


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "recurrentgemma-9b",
                                  "mamba2-130m", "internvl2-76b",
                                  "deepseek-v2-236b"])
def test_remat_and_the_stacked_layout_are_bitwise_the_list_layout(arch):
    cfg, _, _, pm, pp = _port(arch)
    _, pb = _batch(cfg, seed=2)
    (l0, _), g0 = ST.value_and_grad(pm.loss, pp, pb)
    (l1, _), g1 = ST.value_and_grad(
        lambda p, b: pm.loss(p, b, remat=True), pp, pb)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_flatten(g0)[0], tree_flatten(g1)[0]):
        assert torch.equal(a, b)
    sp = pm.stack_params(pp)
    (ls, _), gs = ST.value_and_grad(pm.loss_stacked, sp, pb)
    assert torch.equal(ls, l0)
    for a, b in zip(tree_flatten(pm.stack_params(g0))[0],
                    tree_flatten(gs)[0]):
        assert torch.equal(a, b)
    if cfg.frontend != "vision":
        with torch.no_grad():
            assert torch.equal(
                tt.lm_train_stacked(sp, cfg, pb["tokens"], remat=False)[0],
                tt.lm_train(pp, cfg, pb["tokens"])[0])


def test_value_and_grad_gives_zeros_to_an_unreached_leaf():
    p = {"a": torch.ones(2), "b": torch.ones(3)}
    (loss, parts), g = ST.value_and_grad(
        lambda p, b: ((p["a"] * b).sum(), {"x": 1.0}), p, torch.ones(2) * 3)
    assert float(loss) == 6.0 and float(parts["x"]) == 1.0
    assert torch.equal(g["a"], torch.full((2,), 3.0))
    assert torch.equal(g["b"], torch.zeros(3))
    assert not p["a"].requires_grad and p["a"].grad is None


def test_shapes_and_long_context_rules_are_the_references():
    assert ST.SHAPES == jax_steps.SHAPES and ST.LONG_OK == jax_steps.LONG_OK
    for arch in ARCH_IDS:
        for shape in ST.SHAPES:
            assert ST.shape_applicable(get_config(arch), shape) == \
                jax_steps.shape_applicable(jax_config(arch), shape)


def test_prefill_and_decode_steps_are_the_models():
    cfg, _, _, pm, pp = _port("stablelm-1.6b")
    sp = pm.stack_params(pp)
    _, pb = _batch(cfg, seq=8)
    logits, cache = ST.make_prefill_step(pm, max_seq=12)(sp, pb)
    want, wcache = pm.prefill(pp, pb, 12)
    assert torch.equal(logits, want)
    tok = torch.argmax(logits, -1).to(torch.int32)
    nxt, cache = ST.make_decode_step(pm)(sp, tok, cache)
    wl, _ = pm.decode_step(pp, tok, wcache)
    assert nxt.dtype == torch.int32 and torch.equal(nxt, tt.greedy(wl))


class TestTrainingLearns:
    def test_loss_decreases_on_markov_data(self):
        cfg = ModelConfig(name="tiny", arch_type="dense", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                          vocab=128, dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        opt = adamw_init(params)
        it = make_train_iterator(vocab=128, global_batch=8, seq=32)
        losses = []
        for _ in range(60):
            batch = {"tokens": torch.as_tensor(next(it)["tokens"])}
            (loss, _), grads = ST.value_and_grad(model.loss, params, batch)
            params, opt, _ = adamw_update(params, grads, opt, lr=3e-3,
                                          weight_decay=0.0)
            losses.append(float(loss))
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        assert last < first - 0.5, (first, last)


def test_train_main_checkpoints_and_resumes_at_batch_zero(tmp_path):
    """4 steps with a checkpoint at 2 and 4, then a resumed run to 6: the
    restored tree is bitwise the first run's last state, and the first
    resumed loss is bitwise that state's loss on batch 0 (the resumed run
    makes a fresh iterator, as the reference's launcher does)."""
    d = str(tmp_path)
    argv = ["--device", "cpu", "--smoke", "--arch", "mamba2-130m",
            "--batch", "2", "--seq", "40", "--ckpt-dir", d,
            "--ckpt-every", "2", "--log-every", "2"]
    first = train.run(argv + ["--steps", "4"])
    assert first.start == 0 and len(first.losses) == 4
    assert all(np.isfinite(first.losses))
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000002", "step_00000004"]
    cfg = get_config("mamba2-130m").smoke()
    model = build_model(cfg)
    tokens = torch.as_tensor(next(make_train_iterator(
        vocab=cfg.vocab, global_batch=2, seq=40))["tokens"])
    with torch.no_grad():
        want = model.loss_stacked(first.params, {"tokens": tokens})[0]
    _, restored = load_checkpoint(
        d, like={"params": first.params, "opt": first.opt})
    for a, b in zip(tree_flatten(restored)[0],
                    tree_flatten({"params": first.params,
                                  "opt": first.opt})[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    second = train.run(argv + ["--steps", "6"])
    assert second.start == 4 and len(second.losses) == 2
    assert second.losses[0] == float(want)
    assert int(second.opt.step) == 6
    assert train.main(argv + ["--steps", "6"]) == []   # nothing left to do


def test_train_main_refuses_the_production_mesh():
    """The 16 x 16 pod mesh needs 256 CUDA devices: with fewer visible the
    launcher raises and names both counts."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"needs 256 CUDA devices; {n} "
                                         f"visible"):
        train.main(["--device", "cpu", "--smoke", "--production-mesh"])


def test_train_main_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA rule cannot be seen")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])


def test_the_encoder_decoder_trains_through_main():
    losses = train.main(["--device", "cpu", "--smoke", "--arch",
                         "whisper-large-v3", "--steps", "2", "--batch", "2",
                         "--seq", "8", "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
