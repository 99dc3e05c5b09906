"""DeepSeek-V2 as one expert-parallel rank (``deepseek-v2-236b-ep8``) on the
CPU, at smoke widths and seeded random weights:

* the held-expert share: the parts of all ranks add up to the uncut layer,
  the shared experts counted once, in the port and in the plain reference
  (``portbench/references/mla_moe.py``);
* DeepSeek-V2's ``group_limited_greedy`` router against a hand-written
  selection, unnormalised and scaled;
* YaRN's frequencies and the softmax scale's m^2 against the published
  formulas, and S5 with a YaRN table against its eager expression (bitwise
  on the card);
* the serve path's equations (a prefill, then decode steps through the
  latent cache, per row as the serve tick runs them) against the
  reference's full forward, on logits;
* the counters of ``models/moe.count_into`` and a dropless prefill;
* with the new ``ModelConfig`` fields at their defaults, every other serve
  preset keeps them so, and the small presets' weight trees and logits are
  bitwise what they were before the fields existed.
"""
import dataclasses
import hashlib
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.device import make_generator
from repro_torch.kernels import ref, rotary as kr
from repro_torch.launch import model_serve as ms
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as tt
from repro_torch.models.config import PORT_FIELDS, reference_fields

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

#: DeepSeek-V2's router, scale and YaRN at smoke widths: 16 experts in 4
#: groups (2 kept), top 4, this rank holding experts 4..7 (group 1)
SMOKE = dataclasses.replace(
    get_config("deepseek-v2-236b").smoke(), n_layers=3, n_experts=16,
    top_k=4, n_group=4, topk_group=2, experts_held=4, expert_first=4,
    norm_topk=False, routed_scale=16.0, capacity_factor=16 / 4,
    yarn_factor=40.0, yarn_original=4096, yarn_mscale=0.707)


def _reference():
    path = REPO / "portbench/references/mla_moe.py"
    spec = importlib.util.spec_from_file_location("mla_moe_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hf_config(c) -> dict:
    """The configuration file's keys (Hugging Face's names) of port config
    ``c``."""
    return {"num_hidden_layers": c.n_layers, "hidden_size": c.d_model,
            "num_attention_heads": c.n_heads, "q_lora_rank": c.q_lora_rank,
            "kv_lora_rank": c.kv_lora_rank, "qk_nope_head_dim": c.qk_nope_dim,
            "qk_rope_head_dim": c.qk_rope_dim, "v_head_dim": c.v_head_dim,
            "intermediate_size": c.d_ff, "vocab_size": c.vocab,
            "moe_intermediate_size": c.d_ff_expert,
            "n_shared_experts": c.n_shared_experts,
            "first_k_dense_replace": c.first_dense,
            "n_routed_experts": c.n_experts,
            "num_experts_per_tok": c.top_k, "n_group": c.n_group,
            "topk_group": c.topk_group,
            "topk_method": "group_limited_greedy" if c.n_group else "greedy",
            "norm_topk_prob": c.norm_topk,
            "routed_scaling_factor": c.routed_scale,
            "scoring_func": "softmax", "rms_norm_eps": 1e-6,
            "rope_theta": c.rope_theta,
            "rope_scaling": {"type": "yarn", "factor": c.yarn_factor,
                             "original_max_position_embeddings":
                                 c.yarn_original,
                             "beta_fast": 32, "beta_slow": 1,
                             "mscale": c.yarn_mscale,
                             "mscale_all_dim": c.yarn_mscale},
            "share": {"experts_held": c.held_experts,
                      "expert_first": c.expert_first}}


def _weights(cfg, seed=0):
    """The tree of ``cfg``, its routers at their fan-in's scale (as the
    benchmark draws them: scores far from ties)."""
    p = tt.init_params(cfg, make_generator(seed, torch.device("cpu")), "cpu")
    for layer in p["layers"]:
        if "moe" in layer:
            layer["moe"]["router"] *= 0.02 ** -1 * cfg.d_model ** -0.5
    return p


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def test_group_limited_routing_matches_a_hand_written_selection():
    rng = np.random.default_rng(0)
    probs = torch.softmax(torch.as_tensor(rng.standard_normal((40, 16)),
                                          dtype=torch.float32), -1)
    w, e = MOE.group_top_k(probs, SMOKE)
    for t in range(40):
        p = probs[t].tolist()
        groups = sorted(range(4), key=lambda g: -max(p[4 * g:4 * g + 4]))[:2]
        allowed = [i for g in groups for i in range(4 * g, 4 * g + 4)]
        want = sorted(allowed, key=lambda i: -p[i])[:4]
        assert e[t].tolist() == want
        assert w[t].tolist() == [p[i] for i in want]


def test_the_routed_weights_are_unnormalised_and_scaled():
    x = torch.randn(1, 12, SMOKE.d_model, generator=torch.Generator()
                    .manual_seed(1))
    router = torch.randn(SMOKE.d_model, 16, generator=torch.Generator()
                         .manual_seed(2)) * SMOKE.d_model ** -0.5
    w, e, _ = MOE._route(SMOKE, x, router)
    probs = torch.softmax(x.float() @ router, -1)
    assert torch.equal(w, torch.gather(probs, -1, e) * 16.0)
    plain = dataclasses.replace(SMOKE, n_group=0, norm_topk=True,
                                routed_scale=1.0)
    w1, e1, _ = MOE._route(plain, x, router)
    top, idx = MOE.top_k(probs, 4)
    assert torch.equal(e1, idx)
    assert torch.equal(w1, top / top.sum(-1, keepdim=True))


# ---------------------------------------------------------------------------
# the share
# ---------------------------------------------------------------------------

def _rank(p, cfg, r, held):
    """Rank r's share of an uncut layer's weights and config."""
    sl = slice(r * held, (r + 1) * held)
    return ({**p, **{k: p[k][sl] for k in ("w_up", "w_gate", "w_down")}},
            dataclasses.replace(cfg, experts_held=held,
                                expert_first=r * held))


def test_the_ranks_shares_add_up_to_the_uncut_layer():
    whole = dataclasses.replace(SMOKE, experts_held=0, expert_first=0)
    p = MOE.moe_init(make_generator(3, torch.device("cpu")), whole, "cpu")
    p["router"] = p["router"] * 50.0            # scores far from ties
    x = torch.randn(2, 9, whole.d_model, generator=torch.Generator()
                    .manual_seed(4))
    y, _ = MOE.apply_moe(p, whole, x)
    xt = x.reshape(-1, whole.d_model)
    sp = p["shared"]
    shared = ((torch.nn.functional.silu(xt @ sp["w_gate"]) * (xt @ sp["w_up"]))
              @ sp["w_down"]).reshape(x.shape)
    parts = [MOE.apply_moe(*_rank(p, whole, r, 4), x)[0] for r in range(4)]
    # f32, the same products; only the order of the adds differs
    torch.testing.assert_close(sum(parts) - 3 * shared, y, atol=2e-5,
                               rtol=1e-5)
    assert not torch.equal(parts[0], parts[1])
    # the reference's shares, the shared experts in one of them
    mr = _reference()
    cfg = hf_config(whole)
    full = mr.moe_layer(xt, p, cfg, range(16))
    ref_parts = [mr.moe_layer(xt, _rank(p, whole, r, 4)[0], cfg,
                              range(4 * r, 4 * r + 4), shared=r == 0)
                 for r in range(4)]
    torch.testing.assert_close(sum(ref_parts), full, atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(full.reshape(x.shape), y, atol=2e-5,
                               rtol=1e-5)


def test_a_held_layer_allocates_only_its_experts():
    p = MOE.moe_init(make_generator(0, torch.device("cpu")), SMOKE, "cpu")
    assert p["router"].shape == (SMOKE.d_model, 16)
    assert p["w_up"].shape[0] == p["w_down"].shape[0] == 4


def test_counters_and_a_dropless_prefill():
    p = MOE.moe_init(make_generator(5, torch.device("cpu")), SMOKE, "cpu")
    x = torch.randn(1, 40, SMOKE.d_model, generator=torch.Generator()
                    .manual_seed(6))
    buf = torch.full((2, 3), -1, dtype=torch.long)
    # 40 tokens x 4 choices over 16 experts: 10 an expert on average, 5
    # slots an expert at capacity factor 0.5
    capped = dataclasses.replace(SMOKE, capacity_factor=0.5)
    with MOE.count_into(buf):
        MOE.apply_moe(p, SMOKE, x)
        MOE.apply_moe(p, capped, x)
    _, topi, _ = MOE._route(SMOKE, x, p["router"])
    pairs = int(((topi >= 4) & (topi < 8)).sum())
    assert buf[0].tolist() == [40, pairs, 0]
    assert buf[1, :2].tolist() == [40, pairs] and buf[1, 2] > 0
    assert MOE.COUNTS is None
    with MOE.count_into(None):
        MOE.apply_moe(p, SMOKE, x)


def test_the_ep8_preset_gives_every_token_a_slot():
    # capacity factor E / k: a slot an expert for each token of a group, at
    # every prompt length the cell serves and at the tick's one token a row
    cfg = ms.SERVE_MODELS["deepseek-v2-236b-ep8"]()
    assert all(MOE.capacity(t, cfg) == t for t in range(1, 4097))
    # capacity never exceeds the group: slots past it could only be padding
    assert MOE.capacity(10, dataclasses.replace(cfg, capacity_factor=1e3)) \
        == 10


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------

def _published_yarn(rot, theta, s, l0, fast, slow):
    """Hugging Face's ``DeepseekV2YarnRotaryEmbedding`` in float64."""
    def corr(b):
        return rot * math.log(l0 / (b * 2 * math.pi)) / (2 * math.log(theta))
    lo = max(math.floor(corr(fast)), 0)
    hi = min(math.ceil(corr(slow)), rot - 1)
    out = []
    for i in range(rot // 2):
        extra = 1.0 / theta ** (2 * i / rot)
        ramp = min(max((i - lo) / (hi - lo), 0.0), 1.0)
        out.append(extra / s * ramp + extra * (1 - ramp))
    return out


@pytest.mark.parametrize("preset", ["deepseek-v2-236b-ep8", None])
def test_yarn_frequencies_and_scale_match_the_published_formulas(preset):
    cfg = ms.SERVE_MODELS[preset]() if preset else SMOKE
    f = MLA.yarn_freqs(cfg, "cpu")
    want = _published_yarn(cfg.qk_rope_dim, cfg.rope_theta, 40.0, 4096, 32.0,
                           1.0)
    np.testing.assert_allclose(f.numpy(), want, rtol=2e-6)
    m = 0.1 * 0.707 * math.log(40.0) + 1.0
    assert m == pytest.approx(1.2608, abs=1e-4)
    assert MLA.softmax_scale(cfg) == pytest.approx(
        (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5 * m * m, rel=1e-12)
    assert MLA.yarn_freqs(dataclasses.replace(cfg, yarn_factor=0.0),
                          "cpu") is None


def test_rotary_with_a_yarn_table_matches_its_eager_expression():
    f = MLA.yarn_freqs(SMOKE, "cpu")
    x = torch.randn(2, 7, 3, 16, generator=torch.Generator().manual_seed(7))
    pos = torch.tensor([[0, 5, 100, 4000, 4095, 9, 1]] * 2, dtype=torch.int32)
    got, none = kr.rotary(x, None, pos, 1.0, SMOKE.rope_theta, f)
    assert none is None
    # the angles in f32 (the kernel's contract: float(p) * f_i rounded once,
    # which at position 4095 is off the exact angle by ~1e-4 rad), rotated
    # as a complex product in float64: equal within f32 rounding of the
    # products
    ang = (pos[..., None].float() * f).double()
    z = torch.view_as_complex(x.double().reshape(2, 7, 3, 8, 2).contiguous())
    want = torch.view_as_real(z * torch.polar(torch.ones_like(ang),
                                              ang)[:, :, None])
    torch.testing.assert_close(got.double(), want.reshape(x.shape),
                               atol=2e-6, rtol=2e-6)
    assert not torch.equal(got, kr.rotary(x, None, pos, 1.0,
                                          SMOKE.rope_theta)[0])
    with pytest.raises(ValueError, match="freqs"):
        kr.rotary(x, None, pos, 1.0, SMOKE.rope_theta, f[:4])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rotary_with_a_yarn_table_is_bitwise_on_the_card(cuda):
    """DeepSeek-V2's rope parts (64 of a 192-wide query head, 64 after the
    512-wide latent) with YaRN's table, prefill and per-row decode."""
    cfg = ms.SERVE_MODELS["deepseek-v2-236b-ep8"]()
    f = MLA.yarn_freqs(cfg, cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(1, 300, 128, 192, generator=g, device=cuda).bfloat16()
    dkv = torch.randn(128, 1, 576, generator=g, device=cuda).bfloat16()
    pre = torch.arange(300, dtype=torch.int32, device=cuda)[None]
    dec = torch.randint(0, 4096, (128, 1), generator=g, device=cuda,
                        dtype=torch.int32)
    for x, pos in ((q[..., 128:], pre), (dkv[..., None, 512:], dec)):
        before = kr.LAUNCHES["rotary"]
        got = kr.rotary(x, None, pos, 1.0, cfg.rope_theta, f)[0]
        torch.cuda.synchronize()
        assert kr.LAUNCHES["rotary"] == before + 1
        assert torch.equal(got, ref.rotary_plain(x, pos, 1.0, cfg.rope_theta,
                                                 f))


# ---------------------------------------------------------------------------
# the serve path's equations against the plain reference
# ---------------------------------------------------------------------------

def test_prefill_then_decode_matches_the_reference_forward():
    params = _weights(SMOKE, 11)
    rng = np.random.default_rng(12)
    mr = _reference()
    for prompt, steps in ((9, 6), (20, 3)):
        seq = torch.as_tensor(rng.integers(0, SMOKE.vocab, prompt + steps),
                              dtype=torch.long)
        with torch.no_grad():
            logits, cache = tt.lm_prefill(params, SMOKE, seq[None, :prompt],
                                          32)
            got = [logits[0]]
            for j in range(prompt, prompt + steps - 1):
                lg, cache = tt.lm_decode(params, SMOKE, seq[j:j + 1], cache,
                                         per_row=True)
                got.append(lg[0])
        want, _ = mr.served_logits(params, hf_config(SMOKE),
                                   [seq[:prompt + steps - 1]],
                                   [prompt - 1])[0]
        # f32 throughout; the absorbed decode and the materialised
        # reference add in other orders (~1e-6 of logits of order 1)
        torch.testing.assert_close(torch.stack(got), want, atol=1e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# the new fields at their defaults
# ---------------------------------------------------------------------------

def test_every_other_preset_keeps_the_port_fields_at_their_defaults():
    for key, fn in ms.SERVE_MODELS.items():
        if key == "deepseek-v2-236b-ep8":
            cfg = fn()
            assert (cfg.n_layers, cfg.n_experts, cfg.held_experts,
                    cfg.expert_first) == (15, 160, 20, 0)
            with pytest.raises(ValueError, match="no JAX counterpart"):
                reference_fields(cfg)
            continue
        assert set(reference_fields(fn())) & set(PORT_FIELDS) == set(), key


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _digest(items) -> str:
    h = hashlib.sha256()
    for path, t in items:
        h.update(path.encode())
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:16]


#: preset -> (weight tree, prefill and 3 decode steps' logits), sha256
#: prefixes taken before the port's config had the share, router and YaRN
#: fields
DIGESTS = {
    "stablelm-smoke-flash": ("2df816bdf3244aad", "fe7130a0a22efd93"),
    "stablelm-smoke": ("2df816bdf3244aad", "7c8f271eea6afac8"),
    "recurrentgemma-smoke": ("2f2907b513806a65", "baee6c22e4d92998"),
    "stablelm-smoke-4l": ("a809ca5533f38b2e", "3455d42ec9e8cc29"),
    "qwen1.5-smoke": ("a76c78255b39fc5f", "e43c7e8632af0f05"),
    "granite-smoke": ("d75347c9ca9b5f58", "13fb93c8dd3cc34a"),
    "gemma3-smoke": ("05c946bad0e74b94", "6cf4edf2f112f331"),
    "mixtral-smoke": ("12da75a4772b95af", "647aaf6b113ae363"),
    "deepseek-smoke": ("1397d9d3da21c0a1", "5bfcb25243e6e4cc"),
    "internvl2-smoke": ("7ae5d3d614e4cba3", "257040503bf8e6a0"),
    "granite-int8kv-smoke": ("d75347c9ca9b5f58", "fa8928a67146cfb9"),
    "mamba2-smoke": ("fd5bd3b5d2fd8e40", "e39678ea3c171be0"),
}


@pytest.mark.parametrize("preset", sorted(DIGESTS))
def test_small_presets_are_bitwise_as_before(preset):
    cfg = ms.SERVE_MODELS[preset]()
    params = tt.init_params(cfg, make_generator(5, torch.device("cpu")),
                            "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 9),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        logits, cache = tt.lm_prefill(params, cfg, toks, 16)
        outs = [("prefill", logits)]
        tok = tt.greedy(logits)
        for i in range(3):
            lg, cache = tt.lm_decode(params, cfg, tok, cache, per_row=True)
            outs.append((f"d{i}", lg))
            tok = tt.greedy(lg)
    assert (_digest(_leaves(params)), _digest(outs)) == DIGESTS[preset]
