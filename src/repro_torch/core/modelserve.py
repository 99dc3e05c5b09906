"""Model serving elements — a real autoregressive LM behind the query fabric.

Port of ``ModelServeElement``, ``TokenPromptSrc`` and the preset registry of
``src/repro/core/modelserve.py``.  ``model_serve`` sits behind
``tensor_query_serversrc ! model_serve ! tensor_query_serversink``; its
decode state is PLAN STATE — a slot-stacked KV cache plus active / token /
remaining lanes — carried across ticks in the pipeline state dict, and
requests join and leave the decode batch mid-generation as data.

Differences from the JAX package, same results:

* The decode tick computes all S slots at once as one batch-S decode
  (``transformer.serve_decode_step``) with a per-slot position vector,
  where JAX vmaps a b=1 ``lm_decode`` over slots.  ``sequential_decode``
  (launch/model_serve.py) drives the same S-wide step with one active slot,
  so every GEMM has the same shape and continuous == sequential bitwise.
* The slot cache is updated IN PLACE on the device: an admitted stream's
  prefilled cache (kept on the device since its prefill) is copied into its
  slot rows with ``index_copy_``, and each decode step writes every slot's
  new K/V row at that slot's own position.  JAX assembles admit bundles on
  the host and selects ``where(mask, new, old)`` over the whole cache.
  Rows of inactive slots may be written with values nobody reads: a slot's
  rows are replaced wholesale when a stream is admitted into it.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from .buffers import StreamBuffer, tree_flatten
from .element import Element, PipelineContext, register_element
from .formats import Caps

__all__ = ["ModelServeElement", "TokenPromptSrc", "SERVE_MODELS",
           "register_serve_model"]

# Preset registry: ``model_serve model=<key>`` resolves through here.
# Values are zero-arg callables returning a ModelConfig.
SERVE_MODELS: Dict[str, Callable] = {}


def register_serve_model(key: str, cfg_fn: Callable):
    SERVE_MODELS[key] = cfg_fn
    return cfg_fn


def _default_presets():
    if "stablelm-smoke-flash" not in SERVE_MODELS:
        def _stablelm():
            import dataclasses
            from ..configs import stablelm_1_6b
            return dataclasses.replace(stablelm_1_6b.config().smoke(),
                                       use_flash_attn=True)
        SERVE_MODELS["stablelm-smoke-flash"] = _stablelm


@register_element("model_serve")
class ModelServeElement(Element):
    """Autoregressive decode as plan state with continuous batching.

    Props: ``model`` (SERVE_MODELS key), ``slots`` (decode-batch capacity
    S), ``max_seq`` (KV-cache length; prompt + generation must fit).

    State: ``cache`` (batch-S decode cache, ``pos`` int32 [S]), ``active``
    bool [S], ``token`` int32 [S] (next decode input), ``remaining`` int32
    [S].

    Input frame (injected by the batcher): ``(slots, token, remaining,
    *cache_leaves)`` for the streams joining this tick, or ``()`` with
    ``meta={"empty": True}`` when nobody joins.  Output frame: ``(token,
    emitted, finished)``, each [S], on the device.
    """

    is_stream_serve = True

    def __init__(self, name=None, model="stablelm-smoke-flash", slots=8,
                 max_seq=64, **props):
        super().__init__(name=name, **props)
        self.model = str(props.get("model", model))
        self.slots = int(props.get("slots", slots))
        self.max_seq = int(props.get("max_seq", max_seq))
        self._cfg = None
        self._device = None

    @property
    def cfg(self):
        if self._cfg is None:
            _default_presets()
            try:
                self._cfg = SERVE_MODELS[self.model]()
            except KeyError as e:
                raise KeyError(
                    f"model_serve model={self.model!r} not registered; "
                    f"known: {sorted(SERVE_MODELS)}") from e
        return self._cfg

    def negotiate(self, in_caps):
        return [Caps(media="other/tensors")]

    # -- params / state -------------------------------------------------------
    def init_params(self, generator, device) -> dict:
        from ..models import transformer
        return transformer.init_params(self.cfg, generator, device)

    def init_state(self, device) -> dict:
        from ..models import transformer
        self._device = device
        s = self.slots
        return {"cache": transformer.cache_init(self.cfg, s, self.max_seq,
                                                device),
                "active": torch.zeros((s,), dtype=torch.bool, device=device),
                "token": torch.zeros((s,), dtype=torch.int32, device=device),
                "remaining": torch.zeros((s,), dtype=torch.int32,
                                         device=device)}

    # -- the decode tick --------------------------------------------------------
    def apply(self, params, inputs: List[StreamBuffer],
              ctx: PipelineContext = None) -> List[StreamBuffer]:
        from ..models import transformer
        st = ctx.get_state(self.name)
        cache, token = st["cache"], st["token"]
        remaining, active = st["remaining"], st["active"]
        if not inputs[0].meta.get("empty"):
            # 1. admit: copy each joining stream's prefilled cache into its
            #    slot rows, in place (the docstring's in-place contract)
            slots, tok, rem, pos, *leaves = inputs[0].tensors
            cache["pos"].index_copy_(0, slots, pos)
            dst, _ = tree_flatten(cache["layers"])
            for d, src in zip(dst, leaves):
                d.index_copy_(0, slots, src)
            token = token.index_copy(0, slots, tok)
            remaining = remaining.index_copy(0, slots, rem)
            active = active.index_fill(0, slots, True)
        # 2. one decode step for every slot; inactive slots keep their token
        token = transformer.serve_decode_step(params, self.cfg, cache, token,
                                              active)
        # 3. retire: a slot leaves the batch the tick its budget hits zero
        rem_after = remaining - active.to(torch.int32)
        finished = active & (rem_after <= 0)
        ctx.set_state(self.name, {"cache": cache,
                                  "active": active & ~finished,
                                  "token": token,
                                  "remaining": rem_after.clamp_min(0)})
        return [StreamBuffer(tensors=(token, active, finished))]

    # -- host half (StreamingQueryBatcher calls) ------------------------------
    def host_prefill(self, params, prompt):
        """Prefill one request: prompt int[L] -> (first token int, batch-1
        decode cache on the serve device)."""
        from ..models import transformer
        toks = torch.as_tensor(prompt).to(device=self._device,
                                          dtype=torch.long)[None]
        logits, cache = transformer.lm_prefill(params, self.cfg, toks,
                                               self.max_seq)
        return int(transformer.greedy(logits)[0]), cache

    def empty_admit(self) -> StreamBuffer:
        """No-join tick: a fresh, tensor-free bundle (fresh meta dict every
        call, so no consumer's meta edit can leak into a later tick)."""
        return StreamBuffer(tensors=(), meta={"empty": True})

    def build_admit(self, admits) -> StreamBuffer:
        """The admit bundle for one tick from ``admits``, a list of
        ``(slot, first_token, remaining, batch-1 cache)``.  Cache leaves are
        stacked along the slot axis on the device (no host copy)."""
        if not admits:
            return self.empty_admit()
        dev = self._device
        slots = torch.tensor([a[0] for a in admits], dtype=torch.long,
                             device=dev)
        tok = torch.tensor([a[1] for a in admits], dtype=torch.int32,
                           device=dev)
        rem = torch.tensor([a[2] for a in admits], dtype=torch.int32,
                           device=dev)
        caches = [a[3] for a in admits]
        pos = torch.cat([c["pos"] for c in caches])
        cols = zip(*[tree_flatten(c["layers"])[0] for c in caches])
        leaves = [col[0] if len(col) == 1 else torch.cat(col) for col in cols]
        return StreamBuffer(tensors=(slots, tok, rem, pos, *leaves), meta={})


@register_element("token_prompt_src")
class TokenPromptSrc(Element):
    """Deterministic streaming-workload source: one prompt request per
    frame, cycling through ``prompts`` ("1,2,3;4,5") and ``gens`` ("6;4" —
    tokens to generate per request), ``gen`` tagged into meta.  The prompt
    is a host int32 tensor: the request payload that crosses the wire."""

    host_impure = True
    n_sink_pads = 0

    def __init__(self, name=None, prompts="1,2,3", gens="4", **props):
        super().__init__(name=name, **props)
        self.prompts = str(props.get("prompts", prompts))
        self.gens = str(props.get("gens", gens))
        self._prompt_list = [
            tuple(int(t) for t in p.split(",") if t)
            for p in self.prompts.split(";") if p]
        self._gen_list = [int(g) for g in self.gens.split(";") if g]

    def negotiate(self, in_caps):
        return [Caps(media="other/tensors")]

    def init_state(self, device):
        return {"frame": 0}

    def apply(self, params, inputs, ctx: PipelineContext = None):
        i = ctx.get_state(self.name)["frame"]
        prompt = self._prompt_list[i % len(self._prompt_list)]
        gen = self._gen_list[i % len(self._gen_list)]
        ctx.set_state(self.name, {"frame": i + 1})
        return [StreamBuffer(tensors=(torch.tensor(prompt, dtype=torch.int32),),
                             meta={"gen": gen})]
