"""The port's serving launcher (``repro_torch.launch.serve``) against the
JAX package's (``repro.launch.serve``), on the CPU.

* ``LMQueryServer`` of each package on one parameter tree (the JAX
  package's ``init(PRNGKey(0))`` of mamba2-130m's smoke config, carried
  through ``params_from_numpy``), 4 edge clients, prompts from
  ``np.random.default_rng(0)`` as the JAX ``main`` draws them: every
  answer is the JAX server's, token for token, and each answer's chain of
  greedy choices has a top-2 logit margin above the 1e-4 logit tolerance
  of the other parity tests (so agreement is not luck);
* the decode step through the graph path (``GraphedCallable`` with the CPU
  stand-in graph of ``tests/test_torch_graphs.py``): a binding's first
  call eager, its second a capture, the rest replays, with the SSD
  layers' rebound state written back into the caller's cache: bitwise the
  ``jit=False`` twin;
* ``main(["--smoke", ...], device="cpu")`` answers every request, for
  mamba2-130m and a decoder with attention (stablelm-1.6b), and refuses
  whisper as the JAX package does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import Broker as JaxBroker
from repro.core import StreamBuffer as JaxBuffer
from repro.launch import serve as jax_serve
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.core import Broker
from repro_torch.core.graphs import GraphedCallable
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import transformer as tt

from test_torch_graphs import EagerGraph

torch.set_num_threads(2)

REQUESTS, PROMPT_LEN, GEN = 4, 20, 8
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def mamba():
    jm = jax_build(jax_config("mamba2-130m").smoke())
    pm = build_model(get_config("mamba2-130m").smoke())
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, pm, jp, tt.params_from_numpy(jax.device_get(jp), pm.cfg,
                                            "cpu")


def _jax_answers(jm, jp):
    """The JAX ``main``'s flow on given params -> (prompts, answers)."""
    from repro.edge import EdgeQueryClient
    broker = JaxBroker()
    srv = jax_serve.LMQueryServer(jm, jp, broker, "lm/generate",
                                  max_seq=PROMPT_LEN + GEN + 1, gen=GEN)
    rng = np.random.default_rng(0)
    clients = [EdgeQueryClient(broker, "lm/generate")
               for _ in range(REQUESTS)]
    prompts = []
    for c in clients:
        prompt = rng.integers(0, jm.cfg.vocab, PROMPT_LEN).astype(np.int32)
        prompts.append(prompt)
        srv.endpoint.requests.push(JaxBuffer(
            tensors=(jnp.asarray(prompt),),
            meta={"client_id": c.client_id, "codec": "none"}))
    srv.serve_pending()
    return prompts, [np.asarray(srv.endpoint.client_channel(c.client_id)
                                .pop().tensor) for c in clients]


def _port_server(pm, pp, jit=True):
    broker = Broker()
    return broker, serve.LMQueryServer(pm, pp, broker, "lm/generate",
                                       max_seq=PROMPT_LEN + GEN + 1,
                                       gen=GEN, jit=jit)


def _margins(pm, pp, prompts):
    """Smallest top-2 logit margin of each prompt's greedy chain."""
    logits, cache = pm.prefill(pp, {"tokens": torch.as_tensor(
        np.stack(prompts)).long()}, PROMPT_LEN + GEN + 1)
    worst = float("inf")
    for step in range(GEN):
        top2 = torch.topk(logits, 2, dim=-1).values
        worst = min(worst, float((top2[:, 0] - top2[:, 1]).min()))
        if step + 1 < GEN:
            logits, cache = pm.decode_step(
                pp, torch.argmax(logits, -1).to(torch.int32), cache)
    return worst


def test_answers_match_the_jax_server(mamba):
    jm, pm, jp, pp = mamba
    jprompts, janswers = _jax_answers(jm, jp)
    broker, srv = _port_server(pm, pp)
    prompts, answers = serve.request_all(srv, broker, pm.cfg.vocab, REQUESTS,
                                         PROMPT_LEN)
    for a, b in zip(prompts, jprompts):
        np.testing.assert_array_equal(a, b)
    assert _margins(pm, pp, prompts) > LOGIT_TOL
    assert [a.tolist() for a in answers] == [a.tolist() for a in janswers]
    assert srv.served == REQUESTS


def test_graph_path_is_bitwise_the_eager_twin(mamba):
    _, pm, _, pp = mamba
    broker, eager = _port_server(pm, pp, jit=False)
    _, want = serve.request_all(eager, broker, pm.cfg.vocab, REQUESTS,
                                PROMPT_LEN)
    broker, srv = _port_server(pm, pp)
    srv._decode = GraphedCallable(srv._decode_step, donate=True,
                                  graph_factory=EagerGraph)
    _, got = serve.request_all(srv, broker, pm.cfg.vocab, REQUESTS,
                               PROMPT_LEN)
    assert srv._decode.captures == 1           # one binding, GEN - 1 calls
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("arch", ["mamba2-130m", "stablelm-1.6b"])
def test_main_answers_every_request_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--requests", "5",
                       "--prompt-len", "12", "--gen", "6"],
                      device="cpu") == 5
    out = capsys.readouterr().out
    assert "5/5 requests answered" in out and "on cpu" in out


def test_main_refuses_the_encoder_decoder():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "whisper-large-v3", "--smoke"], device="cpu")
