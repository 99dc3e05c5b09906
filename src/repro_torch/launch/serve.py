"""Serving launcher of the port: an among-device inference service.

Port of ``src/repro/launch/serve.py``.  The LM runs as a query server (the
paper's Fig. 2 server); any number of clients (pipelines, edge processes)
offload token generation to it through the broker-discovered query
protocol.  On the card::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
        --requests 8 --prompt-len 32 --gen 16

and on the CPU (tests) ``main(["--smoke", ...], device="cpu")``.

Each request is (prompt tokens) -> greedy continuation; the server batches
the queued requests into one prefill and one decode loop.  The prefill
runs eagerly; the decode step is a ``core/graphs.py`` ``GraphedCallable``
(a CUDA graph per binding on the card, the eager function on the CPU), as
every entry the JAX package jits is one in the port.  ``LMQueryServer(...,
jit=False)`` makes the eager twin.  Weights are random from seed 0, as in
the JAX package, made on the serve device: nothing is downloaded.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..core import Broker, Caps, StreamBuffer
from ..core.graphs import GraphedCallable
from ..core.query import QueryServerEndpoint
from ..device import DeviceLike, make_generator, resolve_device
from ..models.model import Model, build_model


class LMQueryServer:
    """A query-protocol server whose payload is full LM generation."""

    def __init__(self, model: Model, params, broker: Broker, operation: str,
                 max_seq: int, gen: int, jit: bool = True):
        self.model = model
        self.params = params
        self.endpoint = QueryServerEndpoint(
            operation, {"inline_runner": self.serve_pending})
        self.registration = broker.register(
            f"query/{operation}", Caps.ANY, self.endpoint,
            model=model.cfg.name, version="1")
        self.max_seq = max_seq
        self.gen = gen
        step = self._decode_step
        self._decode = GraphedCallable(step, donate=True) if jit else step
        self.served = 0

    def _prefill(self, params, batch):
        return self.model.prefill(params, batch, self.max_seq)

    def _decode_step(self, params, cache, token):
        return self.model.decode_step(params, token, cache)

    def serve_pending(self):
        """Drain the queued requests and serve them as one batch."""
        reqs: List[StreamBuffer] = []
        while True:
            r = self.endpoint.requests.pop()
            if r is None:
                break
            reqs.append(r)
        if not reqs:
            return
        dev = self.params["embed"]["tok"].device
        prompts = torch.stack([torch.as_tensor(r.tensor) for r in reqs]
                              ).to(device=dev, dtype=torch.long)  # [B, S]
        logits, cache = self._prefill(self.params, {"tokens": prompts})
        tok = torch.argmax(logits, -1).to(torch.int32)
        out = [tok]
        for _ in range(self.gen - 1):
            logits, cache = self._decode(self.params, cache, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(tok)
        gen = torch.stack(out, dim=1)                         # [B, gen]
        for i, r in enumerate(reqs):
            ans = r.with_(tensors=(gen[i],))
            self.endpoint.client_channel(r.meta["client_id"]).push(ans)
            self.served += 1


def request_all(server: LMQueryServer, broker: Broker, vocab: int,
                requests: int, prompt_len: int
                ) -> Tuple[List[np.ndarray], List[torch.Tensor]]:
    """``requests`` edge clients each queue one prompt drawn from
    ``np.random.default_rng(0)`` (the JAX package's prompts), the server
    serves them as one batch, each client takes its answer -> (prompts,
    answers int32 [gen] each, in client order)."""
    from ..edge import EdgeQueryClient
    rng = np.random.default_rng(0)
    clients = [EdgeQueryClient(broker, "lm/generate")
               for _ in range(requests)]
    prompts = []
    for c in clients:          # enqueue every request first: they batch
        prompt = rng.integers(0, vocab, prompt_len).astype(np.int32)
        prompts.append(prompt)
        server.endpoint.requests.push(StreamBuffer(
            tensors=(torch.as_tensor(prompt),),
            meta={"client_id": c.client_id, "codec": "none"}))
    server.serve_pending()
    answers = []
    for c in clients:
        out = server.endpoint.client_channel(c.client_id).pop()
        if out is None or tuple(out.tensor.shape) != (server.gen,):
            raise RuntimeError(f"client {c.client_id}: no full answer")
        answers.append(out.tensor)
    return prompts, answers


def main(argv=None, device: DeviceLike = None) -> int:
    """The launcher: -> the number of requests answered.  Runs on the card
    unless ``device="cpu"``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=12)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if cfg.enc_dec or cfg.frontend == "vision":
        raise SystemExit("serve.py drives text-only archs; whisper/internvl "
                         "serve via examples/multicam_pubsub.py-style graphs")
    model = build_model(cfg)
    params = model.init(make_generator(0, dev), dev)
    print(f"[serve] {cfg.name} ({'smoke' if args.smoke else 'full'}) "
          f"params={model.param_count(params) / 1e6:.1f}M on {dev}")

    broker = Broker()
    server = LMQueryServer(model, params, broker, "lm/generate",
                           max_seq=args.prompt_len + args.gen + 1,
                           gen=args.gen)
    t0 = time.time()
    _, answers = request_all(server, broker, cfg.vocab, args.requests,
                             args.prompt_len)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    total_tokens = args.requests * args.gen
    print(f"[serve] {len(answers)}/{args.requests} requests answered, "
          f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s batched)")
    return len(answers)


if __name__ == "__main__":
    main()
