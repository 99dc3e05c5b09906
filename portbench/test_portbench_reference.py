"""The plain reference against the port's CPU path on smoke presets, and
the control's precision step."""
import numpy as np
import pytest
import torch

from portbench import harness, testcell
from portbench.references import dense_decoder


def _port(cfg):
    from repro_torch.launch import model_serve as ms
    from repro_torch.models import transformer
    key = harness.serve_preset(cfg)
    mc = ms.SERVE_MODELS[key]()
    g = torch.Generator(device="cpu")
    g.manual_seed(0)
    params = transformer.init_params(mc, g, "cpu")
    harness.draw_weights(params, 2 ** 31 + 5)
    return mc, params, transformer


@pytest.mark.parametrize("cfg", [testcell.SMOKE, testcell.SMOKE_MQA],
                         ids=["stablelm-equations", "granite-equations"])
def test_reference_matches_the_port_on_the_cpu(cfg):
    mc, params, transformer = _port(cfg)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 512, 40))
    want = transformer.lm_train(params, mc, toks[None])[0][0]
    (got, ctl), = dense_decoder.served_logits(params, cfg, [toks], [0])
    assert ctl is None
    assert got.shape == want.shape == (40, 512)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)
    # the prefill's last-position logits and the served decode path agree
    # with the reference too
    last, _ = transformer.lm_prefill(params, mc, toks[None])
    torch.testing.assert_close(got[-1], last[0], atol=2e-4, rtol=1e-4)


def test_reference_refuses_a_tree_it_cannot_read():
    cfg = dict(testcell.SMOKE, mlp_glu=False)
    _, params, _ = _port(testcell.SMOKE)
    with pytest.raises(KeyError, match="mlp"):
        dense_decoder.served_logits(params, cfg, [torch.arange(4)], [0])


def test_control_is_the_reference_in_fp8():
    _, params, _ = _port(testcell.SMOKE)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 512, 64))
    (ref, ctl), = dense_decoder.served_logits(params, testcell.SMOKE,
                                              [toks], [10], control=True)
    assert ref.shape == ctl.shape == (54, 512)
    err = (ref - ctl).abs().max().item()
    assert 1e-3 < err < 5.0
    w = torch.randn(64, 32)
    q = dense_decoder._fp8(w, 0)
    assert len(torch.unique(q / (w.abs().amax(0) / 448))) <= 256
