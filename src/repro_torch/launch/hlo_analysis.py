"""The analysis tools' counts (``src/repro/launch/hlo_analysis.py``).

The JAX package reads FLOPs and bytes off XLA's ``cost_analysis()`` and
parses collective bytes out of the compiled HLO text.  The port has no
HLO: a step runs eagerly, op by op.  So it counts the step itself, under
:class:`CostCounter`, a ``TorchDispatchMode`` that sees every aten op the
step dispatches (on ``meta``, where nothing is computed, or on the card),
the kernel calls that ``kernels/cost.py`` books (a ctypes launch is
invisible to the dispatcher) and the collectives that ``launch/spmd.py``
books.

What is counted, and how it stands to XLA's numbers:

* **FLOPs.**  Products and attention by ``torch.utils.flop_counter``'s
  formulas (2·M·N·K); one FLOP per output element for elementwise ops;
  ``in - out`` elements for a reduction; exponentials, logarithms, roots
  and the like are transcendentals, counted apart and not as FLOPs.  Those
  are XLA's rules (``HloCostAnalysis``), so the count can be held to the
  JAX package's (``tests/test_torch_dryrun_parity.py``).  Data movement
  (copies, gathers, concatenation, padding, fills) is no FLOP.
* **Bytes.**  Each op's inputs read once and its outputs written once;
  views and metadata ops are free; an indexed write moves its values, not
  the whole destination.  These are the eager program's bytes.  XLA's
  "bytes accessed" are those of the fused TPU program, which keeps most
  intermediates out of HBM, so the two are not held to each other.
* **Peak bytes.**  The high-water mark of the live storages the counter
  has seen (the arguments registered with :meth:`CostCounter.track`, and
  every op's outputs), each freed when its storage dies (tracked weakly
  by storage, so it works on ``meta`` and on ``cuda``).
* **Kernels.**  Calls, FLOPs and bytes by kernel name.
* **Collectives.**  Bytes a device receives, under the HLO kinds of
  ``_COLLECTIVES``.

:func:`roofline_terms` turns a count into seconds on the H100 constants of
``launch/mesh.py``.
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from typing import Dict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels.cost import COUNTERS, peak_flops
from .mesh import H100_BF16_FLOPS, H100_HBM_BW, H100_NAME, H100_NVLINK_BW

__all__ = ["CostCounter", "collective_bytes", "roofline_terms",
           "dominant_term"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _names(*names):
    return frozenset(f"aten.{n}" for n in names)


#: no bytes, no FLOPs: metadata, aliasing and allocation without a write
_FREE = _names(
    "detach", "alias", "lift_fresh", "_unsafe_view", "view", "expand",
    "as_strided", "t", "transpose", "permute", "squeeze", "unsqueeze",
    "slice", "select", "split", "split_with_sizes", "unbind", "chunk",
    "narrow", "diagonal", "unfold", "_reshape_alias", "view_as_real",
    "view_as_complex", "_local_scalar_dense", "_assert_async",
    "_assert_tensor_metadata", "set_", "resize_", "empty", "empty_strided",
    "empty_like", "new_empty", "new_empty_strided", "record_stream",
    "sym_size", "sym_stride", "sym_numel", "is_same_size", "_to_dense",
    "_has_compatible_shallow_copy_type", "is_nonzero")
#: data movement: bytes, no FLOPs (XLA counts no FLOP for a copy, gather,
#: concatenate, pad, broadcast or iota either)
_MOVE = _names(
    "clone", "copy_", "_copy_from", "_copy_from_and_resize", "cat", "stack",
    "constant_pad_nd", "repeat", "expand_copy", "slice_scatter",
    "select_scatter", "index_put", "index_copy", "scatter", "zeros", "ones",
    "full", "zeros_like", "ones_like", "full_like", "fill_", "zero_",
    "fill", "arange", "new_zeros", "new_ones", "new_full", "scalar_tensor",
    "flip", "roll", "repeat_interleave", "masked_scatter", "permute_copy",
    "transpose_copy", "unsqueeze_copy", "view_copy", "narrow_copy",
    "split_copy", "unbind_copy", "lift",
    "_pin_memory", "linspace", "tril_indices", "triu_indices", "eye")
#: gathers: the rows they pick are read, not the whole source
_GATHER = _names("index_select", "gather", "embedding", "index", "take",
                 "_unsafe_index")
#: writes into part of a destination: the values move, the rest does not
_SCATTER = _names("index_put_", "_index_put_impl_", "index_copy_",
                  "scatter_", "scatter_add_", "index_add_",
                  "masked_scatter_", "index_fill_", "masked_fill_")
#: the destination's old values are not read
_WRITE_ONLY = _names("copy_", "fill_", "zero_", "normal_", "uniform_",
                     "random_", "bernoulli_", "exponential_")
#: no FLOP, one transcendental an output element
_TRANSCENDENTAL = _names(
    "exp", "exp_", "exp2", "log", "log_", "log2", "log10", "log1p", "expm1",
    "tanh", "tanh_", "sigmoid", "sigmoid_", "rsqrt", "rsqrt_", "sqrt",
    "sqrt_", "sin", "cos", "tan", "erf", "erfinv", "atan2", "asin", "acos",
    "atan", "sinh", "cosh", "lgamma", "digamma")
#: reductions: ``in - out`` FLOPs (XLA's count of a reduce)
_REDUCE = _names("sum", "amax", "amin", "max", "min", "argmax", "argmin",
                 "prod", "any", "all", "nansum", "count_nonzero")
#: FLOPs an input element of composite ops, as the JAX package writes them
#: (softmax: max, subtract, sum, divide; log-softmax: max, subtract, sum,
#: subtract; silu: one product beside the logistic; gelu's tanh form: seven)
_PER_ELEMENT = {
    "aten._softmax": 3, "aten._log_softmax": 4,
    "aten._softmax_backward_data": 3, "aten._log_softmax_backward_data": 3,
    "aten.logsumexp": 3, "aten.silu": 1, "aten.silu_": 1,
    "aten.silu_backward": 4, "aten.gelu": 7, "aten.gelu_backward": 12,
    "aten.softplus": 5, "aten.softplus_backward": 3, "aten.mean": 1,
    "aten.var": 4, "aten.std": 4, "aten.var_mean": 4,
    "aten.linalg_vector_norm": 2, "aten.norm": 2, "aten.cumsum": 1,
    "aten.cumprod": 1, "aten.sigmoid_backward": 2, "aten.tanh_backward": 2,
    "aten.threshold_backward": 1, "aten.mse_loss": 3}


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts a step's FLOPs, transcendentals, bytes, live-byte peak,
    kernel calls and collective bytes (module docstring).  Entering it also
    makes it ``kernels/cost.py``'s active counter."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.colls: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self.tracked = 0
        self._storages: Dict[int, int] = {}
        self._pause = 0

    # -- the context ---------------------------------------------------------
    def __enter__(self):
        COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        COUNTERS.remove(self)
        return super().__exit__(*exc)

    @contextmanager
    def paused(self):
        """Count no op inside (a kernel's plain version, a collective's own
        adds and copies: each is booked as a whole)."""
        self._pause += 1
        try:
            yield
        finally:
            self._pause -= 1

    # -- live bytes ------------------------------------------------------------
    def _free(self, key: int, nbytes: int):
        if self._storages.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, tensors):
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            nb = st.nbytes()
            self._storages[key] = nb
            self.live += nb
            weakref.finalize(st, self._free, key, nb)
        if self.live > self.peak:
            self.peak = self.live

    def track(self, tree) -> int:
        """Register the tensors of ``tree`` (a step's arguments) as live;
        -> their bytes not registered before."""
        before = self.live
        self._track(_tensors(tree))
        self.tracked += self.live - before
        return self.live - before

    # -- what the kernels and spmd book -----------------------------------------
    def kernel(self, name: str, count, outputs=None):
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += count.flops
        k["bytes"] += count.bytes
        self.flops += count.flops
        self.bytes += count.bytes
        if outputs is not None:
            self._track(_tensors(outputs))

    def collective(self, kind: str, nbytes: float):
        self.colls[kind] += nbytes

    # -- the ops -----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._pause:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = str(func.overloadpacket)
        outs = _tensors(out)
        if name in _FREE or func.is_view:
            if outs:
                self._track(outs)
            return
        ins = _tensors((args, kwargs))
        if name in _GATHER:
            idx = sum(_nbytes(t) for t in ins
                      if not t.is_floating_point() and t.dim())
            nbytes = idx + 2 * sum(_nbytes(t) for t in outs)
        elif name in _SCATTER:
            moved = sum(_nbytes(t) for t in ins[1:])
            nbytes = 2 * moved
        else:
            reads = ins[1:] if name in _WRITE_ONLY else ins
            nbytes = sum(_nbytes(t) for t in reads) + \
                sum(_nbytes(t) for t in outs)
        self.bytes += nbytes
        self.flops += self._flops(func, name, args, kwargs, out, ins, outs)
        self._track(outs)

    def _flops(self, func, name, args, kwargs, out, ins, outs) -> float:
        packet = func.overloadpacket
        n_out = outs[0].numel() if outs else 0
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            if name in ("aten.addmm", "aten.baddbmm"):
                f += n_out                  # the add of the bias
            return f
        if name in _MOVE or name in _GATHER or name in _WRITE_ONLY or \
                name in ("aten.index_put_", "aten._index_put_impl_",
                         "aten.index_copy_", "aten.scatter_",
                         "aten.masked_scatter_", "aten.index_fill_"):
            return 0.0
        if name == "aten._to_copy":
            return float(n_out) if ins[0].dtype != outs[0].dtype else 0.0
        if name in _TRANSCENDENTAL:
            self.transcendentals += n_out
            return 0.0
        if name == "aten.pow":
            exp = args[1] if len(args) > 1 else kwargs.get("exponent")
            if isinstance(exp, (int, float)) and float(exp).is_integer():
                return float(n_out) * max(1, abs(int(exp)) - 1)
            self.transcendentals += n_out
            return 0.0
        n_in = ins[0].numel() if ins else 0
        if name in _REDUCE:
            return float(max(n_in - n_out, 0))
        if name in _PER_ELEMENT:
            return float(_PER_ELEMENT[name] * max(n_in, n_out))
        if name in ("aten.sort", "aten.topk", "aten.argsort"):
            n = ins[0].shape[-1] if ins and ins[0].dim() else 1
            return float(n_in * max(1, (n - 1).bit_length()))
        if name in _SCATTER or name in ("aten.scatter_add", "aten.index_add",
                                        "aten.scatter_reduce"):
            return float(sum(t.numel() for t in ins[1:]
                             if t.is_floating_point()))
        return float(n_out)

    # -- the record ----------------------------------------------------------
    def kernel_calls(self) -> Dict[str, int]:
        return {k: int(v["calls"]) for k, v in sorted(self.kernels.items())}

    def record(self) -> Dict:
        """Everything counted, as plain numbers."""
        return {"flops": self.flops, "transcendentals": self.transcendentals,
                "bytes": self.bytes, "peak_bytes": self.peak, "tracked_bytes": self.tracked,
                "kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())},
                "collectives": collective_bytes(self)}


def collective_bytes(counter: CostCounter) -> Dict[str, int]:
    """Bytes a device receives by collective kind, the JAX package's five
    keys (its ``collective_bytes`` parses them out of HLO text)."""
    return {k: int(round(counter.colls.get(k, 0.0))) for k in _COLLECTIVES}


def roofline_terms(cost: Dict, colls: Dict[str, int], n_chips: int,
                   per_device: bool = True, dtype="bfloat16"
                   ) -> Dict[str, float]:
    """Three roofline terms in seconds on the H100 (``launch/mesh.py``):
    FLOPs at the peak of ``dtype`` (the dense bf16 tensor cores for a bf16
    config, float32 outside them for an f32 one), bytes at the HBM rate,
    collective bytes at NVLink 4's rate a direction.  ``cost`` has
    ``flops`` and ``bytes accessed``; with ``per_device=False`` they and
    ``colls`` are totals, divided evenly over ``n_chips``."""
    flops = float(cost.get("flops", 0.0))
    bytes_hbm = float(cost.get("bytes accessed", 0.0))
    coll_total = float(sum(colls.values()))
    if not per_device:
        flops /= n_chips
        bytes_hbm /= n_chips
        coll_total /= n_chips
    peak = peak_flops(dtype)
    return {
        "compute_s": flops / peak,
        "memory_s": bytes_hbm / H100_HBM_BW,
        "collective_s": coll_total / H100_NVLINK_BW,
        "flops_per_device": flops,
        "hbm_bytes_per_device": bytes_hbm,
        "collective_bytes_per_device": coll_total,
        "compute_peak": "bf16" if peak == H100_BF16_FLOPS else "f32",
        "card": H100_NAME,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    three = {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")}
    return max(three, key=three.get)
