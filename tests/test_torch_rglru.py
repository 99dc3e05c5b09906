"""The port's RG-LRU block and its scan kernel against the JAX package on
the CPU.

Weights come from the JAX package (``rglru_init(PRNGKey(0), cfg)``) and
cross through the port's weight bridge; inputs are numpy-seeded.  Each
piece runs in both packages in fp32:

* ``_conv4`` (with and without carried state), ``_gates``,
  ``rglru_train``, the prefill's decode state (the JAX
  ``_rglru_prefill_cache``) and a 16-step ``rglru_decode`` chain: atol
  1e-5 (two frameworks, same f32 arithmetic in different kernels);
* the scan's plain version (a step-by-step loop, the kernel's order)
  against ``jax.lax.associative_scan`` (a tree) at S = 64 and S = 2600:
  atol 1e-5, the two association orders' f32 rounding over |h| <= ~10;
* on the card (``cuda`` marker): the CUDA kernel against the plain
  version, bitwise (both multiply then add in sequence order), ragged
  widths included and S at one ring stage - 1, one stage and one stage + 1;
  a row alone and in a batch of 3 bitwise equal; a CUDA tensor never takes
  the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recurrentgemma_9b as jax_rg9b
from repro.models import rglru as jax_rg
from repro.models import transformer as jax_tf
from repro_torch.configs import recurrentgemma_9b
from repro_torch.kernels import rglru_scan as scan_mod
from repro_torch.models import rglru as rg
from repro_torch.models import transformer as tt
from repro_torch.models.config import reference_fields

torch.set_num_threads(2)

ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def block():
    jcfg = jax_rg9b.config().smoke()
    tcfg = recurrentgemma_9b.config().smoke()
    jp = jax_rg.rglru_init(jax.random.PRNGKey(0), jcfg)
    tp = tt.params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_config_matches_the_jax_package():
    import dataclasses
    assert reference_fields(recurrentgemma_9b.config()) == \
        dataclasses.asdict(jax_rg9b.config())


@pytest.mark.parametrize("with_prev", [False, True])
def test_conv4_matches_jax(block, with_prev):
    jcfg, jp, tcfg, tp = block
    x = _x((2, 9, 256), 1)
    prev = _x((2, 3, 256), 2) if with_prev else None
    out, state = rg._conv4(torch.as_tensor(x), tp["conv"],
                           None if prev is None else torch.as_tensor(prev))
    jout, jstate = jax_rg._conv4(jnp.asarray(x), jp["conv"],
                                 None if prev is None else jnp.asarray(prev))
    _close(out, jout)
    _close(state, jstate)


def test_gates_match_jax(block):
    jcfg, jp, tcfg, tp = block
    u = _x((2, 7, 256), 3)
    a, bx = rg._gates(tp, torch.as_tensor(u))
    ja, jbx = jax_rg._gates(jp, jnp.asarray(u))
    assert a.dtype == bx.dtype == torch.float32
    _close(a, ja)
    _close(bx, jbx)
    assert float(a.min()) > 0.0 and float(a.max()) < 1.0


@pytest.mark.parametrize("s", [1, 5, 40])
def test_rglru_train_and_prefill_state_match_jax(block, s):
    jcfg, jp, tcfg, tp = block
    x = _x((2, s, 256), 4 + s)
    y, state = rg.rglru_prefill(tp, tcfg, torch.as_tensor(x))
    _close(y, jax_rg.rglru_train(jp, jcfg, jnp.asarray(x)))
    _close(rg.rglru_train(tp, tcfg, torch.as_tensor(x)), y, 0)
    jstate = jax_tf._rglru_prefill_cache(jp, jcfg, jnp.asarray(x))
    assert list(state) == ["h", "conv"]
    _close(state["h"], jstate["h"])
    _close(state["conv"], jstate["conv"])
    assert state["h"].dtype == torch.float32
    # the state owns its memory: the sequence-long buffers are not kept
    assert state["h"].untyped_storage().nbytes() == 2 * 256 * 4


def test_sixteen_step_decode_chain_matches_jax(block):
    jcfg, jp, tcfg, tp = block
    x = _x((3, 6, 256), 5)
    _, cache = rg.rglru_prefill(tp, tcfg, torch.as_tensor(x))
    jcache = jax_tf._rglru_prefill_cache(jp, jcfg, jnp.asarray(x))
    for step in range(16):
        xt = _x((3, 1, 256), 100 + step)
        y = rg.rglru_decode(tp, tcfg, torch.as_tensor(xt), cache)
        jy, jcache = jax_rg.rglru_decode(jp, jcfg, jnp.asarray(xt), jcache)
        _close(y, jy)
        _close(cache["h"], jcache["h"])
        _close(cache["conv"], jcache["conv"])


def test_cache_init_matches_jax(block):
    jcfg, jp, tcfg, tp = block
    c = rg.rglru_cache_init(tcfg, 3, "cpu")
    jc = jax_rg.rglru_cache_init(jcfg, 3)
    for k in ("h", "conv"):
        assert tuple(c[k].shape) == tuple(jc[k].shape)
        assert str(c[k].dtype).rpartition(".")[2] == str(jc[k].dtype)


def _gate_inputs(block, s, seed):
    """Realistic scan inputs: the gates of a numpy-seeded conv output."""
    tp = block[3]
    u = _x((2, s, 256), seed, scale=0.5)
    return rg._gates(tp, torch.as_tensor(u))


def _assoc_scan(a, bx):
    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2
    return jax.lax.associative_scan(combine, (jnp.asarray(a.numpy()),
                                              jnp.asarray(bx.numpy())),
                                    axis=1)[1]


@pytest.mark.parametrize("s", [64, 2600])
def test_plain_scan_matches_associative_scan(block, s):
    a, bx = _gate_inputs(block, s, 6)
    before = scan_mod.LAUNCHES["rglru_scan"]
    h = scan_mod.rglru_scan(a, bx)              # CPU tensors: plain version
    assert scan_mod.LAUNCHES["rglru_scan"] == before
    want = np.asarray(_assoc_scan(a, bx))
    _close(h, want)
    assert 1.0 < np.abs(want).max() < 20.0      # not a trivial scan
    # h_0 = bx_0 (h_{-1} = 0), and the recurrence holds step by step
    np.testing.assert_array_equal(h[:, 0].numpy(), bx[:, 0].numpy())
    np.testing.assert_array_equal(h[:, 1:].numpy(),
                                  (a[:, 1:] * h[:, :-1] + bx[:, 1:]).numpy())


def test_scan_wrapper_checks_its_inputs():
    a = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError):
        scan_mod.rglru_scan(a, torch.zeros((1, 4, 9)))
    with pytest.raises(TypeError):
        scan_mod.rglru_scan(a.double(), a.double())
    with pytest.raises(ValueError):
        scan_mod.rglru_scan(a[0], a[0])
    from elsewhere import Elsewhere     # neither cpu, cuda nor meta
    with pytest.raises(ValueError):
        scan_mod.rglru_scan(Elsewhere(1, 4, 8), Elsewhere(1, 4, 8))


#: S at one ring stage - 1, one stage and one stage + 1, at widths that are
#: not a multiple of the block (or of 4 floats)
_STAGE_EDGES = [(1, scan_mod.STAGE_POSITIONS + d, w) for d in (-1, 0, 1)
                for w in (31, 33, 257)]


def _scan_inputs(rng, b, s, w, dev):
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (b, s, w)).astype(np.float32),
                        device=dev)
    bx = torch.as_tensor(rng.standard_normal((b, s, w)).astype(np.float32),
                         device=dev)
    return a, bx


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", [(1, 1, 100), (2, 7, 4096), (3, 64, 257),
                                   (1, 3000, 4096), (2, 33, 31)]
                         + _STAGE_EDGES)
def test_scan_kernel_matches_plain_on_card(cuda, b, s, w):
    rng = np.random.default_rng(b * s + w)
    a, bx = _scan_inputs(rng, b, s, w, cuda)
    before = scan_mod.LAUNCHES["rglru_scan"]
    h = scan_mod.rglru_scan(a, bx)
    torch.cuda.synchronize()
    assert scan_mod.LAUNCHES["rglru_scan"] == before + 1
    ref = scan_mod.rglru_scan_plain(a, bx)
    assert torch.equal(h, ref)
    with pytest.raises(ValueError):
        scan_mod.rglru_scan(a[:, :, ::2], bx[:, :, ::2])   # strided


@pytest.mark.cuda
@pytest.mark.parametrize("s,w", [(1, 4096), (700, 4096), (129, 257),
                                 (65, 33)])
def test_scan_rows_are_batch_invariant_on_card(cuda, s, w):
    """A row's h is bitwise the same alone (B = 1) and as row 1 of a batch
    of 3: the two launches differ in their grids, and the ragged widths put
    the row's last channels in a part-filled block."""
    rng = np.random.default_rng(s + w)
    a, bx = _scan_inputs(rng, 3, s, w, cuda)
    batch = scan_mod.rglru_scan(a, bx)
    alone = scan_mod.rglru_scan(a[1:2].contiguous(), bx[1:2].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(batch[1:2], alone)
    assert torch.equal(alone, scan_mod.rglru_scan_plain(a[1:2], bx[1:2]))


@pytest.mark.cuda
def test_scan_ring_geometry_on_card(cuda):
    """The stage length the edge cases above put S around is the compiled
    kernel's own."""
    ring = scan_mod.ring()
    assert ring["positions"] == scan_mod.STAGE_POSITIONS
    assert ring["stage_bytes"] == 2 * 4 * ring["channels"] * ring["positions"]
