"""CUDA-graph captures behind the executable cache (``core/plan.py``).

The JAX package jits every entry of its executable cache into one XLA
dispatch.  The port's counterpart on the card is a CUDA graph: one
``cudaGraphLaunch`` replays an entry's kernels.  :class:`GraphedCallable`
wraps one entry's eager function ``fn(params, state, *args, **static) ->
(out, next_state)``; on the CPU it calls ``fn`` itself.

On the card it keeps one graph per *binding*, keyed by
:func:`binding_key`: the trees' structure, every tensor's shape, dtype and
strides, the values of every host leaf (Python numbers, numpy arrays,
``static`` keywords; a graph bakes them in), and the addresses of the
params' tensors and, with donation, of the state's.  Two pipelines that
share a fingerprint share the entry, as the JAX package shares one jit,
but each gets its own graph over its own state.

* The first call of a binding runs ``fn`` eagerly.  It is real work, and
  it warms what must not happen under capture: the kernels' ctypes
  libraries load, cuBLAS makes its handles.
* The second call captures, then replays.  Capture records and runs
  nothing, so the state advances exactly once per call.  Python side
  effects of ``fn`` happen at capture only.
* Tensor ``args`` are copied into buffers the binding owns; the outputs
  are cloned out after every replay, since a replay rewrites the same
  buffers (the JAX package returns fresh arrays from every call).
* State, with donation (``donate=True``, the default on the card; the JAX
  package's donated, overwritten state buffers): a leaf ``fn`` updates in
  place needs nothing; a leaf it rebinds is copied back into the caller's
  leaf at the end of the same graph (:func:`write_back`), and the returned
  ``next_state`` holds the caller's own leaves.  Without donation the
  binding copies the caller's state into its own leaves before each call
  and clones ``next_state`` out, so the caller's tensors stay untouched.
* Kernel launch counts: each ``kernels/*.py`` wrapper counts in Python,
  which a replay does not run, so a capture's count is recorded and added
  on every replay.
* A capture that fails raises :class:`GraphCaptureError`; nothing runs
  ``fn`` eagerly in its place.
* With the tracer on (``core/trace.py``) a call's run, replay or eager,
  with its outputs' clones is a ``graph.launch`` span, and a capture a
  ``graph.capture`` span.
* All graphs on a device share one memory pool.  That is safe because no
  graph reads pool memory another graph wrote: a graph's inputs and state
  live outside the pool, and its outputs are cloned out right after its
  replay.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .buffers import tree_flatten, tree_unflatten
from .trace import TRACER

__all__ = ["GraphedCallable", "GraphCaptureError", "binding_key",
           "call_device", "write_back", "detach_outputs", "graph_stats"]

#: bindings a callable keeps (LRU); an evicted binding frees its graph
MAX_BINDINGS = 32


class GraphCaptureError(RuntimeError):
    """A binding could not be captured as a CUDA graph."""


# ---------------------------------------------------------------------------
# host logic (testable with CPU tensors)
# ---------------------------------------------------------------------------

def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _leaf_key(leaf, with_ptr: bool) -> Tuple:
    """A leaf's part of a binding key (a call's tensors share one device,
    which the key holds once)."""
    if _is_tensor(leaf):
        key = (leaf.shape, leaf.stride(), leaf.dtype)
        return key + (leaf.data_ptr(),) if with_ptr else key
    if isinstance(leaf, (np.ndarray, np.generic)):
        a = np.asarray(leaf)
        return ("numpy", a.dtype.str, a.shape, a.tobytes())
    return ("host", type(leaf).__name__, leaf)


def _key(flat_params, flat_state, flat_args, static: Dict,
         donate: bool, device=None) -> Tuple:
    (pl, ptd), (sl, std), (al, atd) = flat_params, flat_state, flat_args
    return (device, ptd, tuple(_leaf_key(l, True) for l in pl),
            std, tuple(_leaf_key(l, donate) for l in sl),
            atd, tuple(_leaf_key(l, False) for l in al),
            tuple(sorted(static.items())))


def binding_key(params, state, args: Tuple, static: Dict,
                donate: bool) -> Tuple:
    """The binding a call belongs to.  Params' tensors are keyed by address
    (a graph reads them where it was captured), the state's too when it is
    donated (the graph updates it there), the args' by shape only (they are
    copied into the binding's buffers); host leaves by value."""
    fp, fs, fa = tree_flatten(params), tree_flatten(state), \
        tree_flatten(args)
    return _key(fp, fs, fa, static, donate, _device_of(fp[0] + fs[0] + fa[0]))


def _device_of(leaves: List) -> Optional[torch.device]:
    dev = None
    for leaf in leaves:
        if _is_tensor(leaf):
            if dev is None:
                dev = leaf.device
            elif leaf.device != dev:
                raise ValueError(f"a cached executable got tensors on {dev} "
                                 f"and {leaf.device}")
    return dev


def call_device(*trees) -> Optional[torch.device]:
    """The device of the tensors in ``trees``; None when there are none.
    Tensors on two devices raise: a graph cannot capture CPU work."""
    return _device_of([l for t in trees for l in tree_flatten(t)[0]])


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def detach_outputs(out_leaves: List, state_leaves: List) -> List:
    """Clone every output tensor that shares memory with a state tensor:
    a later write-back or in-place update would change it under the
    caller."""
    stores = {_storage(s) for s in state_leaves if _is_tensor(s)}
    return [o.clone() if _is_tensor(o) and _storage(o) in stores else o
            for o in out_leaves]


def write_back(state_leaves: List, next_leaves: List):
    """Copy each rebound next-state tensor into the state tensor at its
    position, so that the state's leaves hold the next state in place.  A
    leaf ``fn`` kept (the same object) needs nothing; a rebound leaf that
    shares memory with any state tensor (a swap, a view) is cloned before
    the copies start.  Host leaves are not written (the caller takes them
    from ``next_leaves``).  Raises where a state tensor has no same-shape,
    same-dtype successor."""
    if len(state_leaves) != len(next_leaves):
        raise GraphCaptureError(f"next_state has {len(next_leaves)} leaves, "
                                f"state {len(state_leaves)}")
    stores = {_storage(s) for s in state_leaves if _is_tensor(s)}
    copies = []
    for s, n in zip(state_leaves, next_leaves):
        if not _is_tensor(s) or n is s:
            continue
        if not _is_tensor(n) or n.shape != s.shape or n.dtype != s.dtype:
            raise GraphCaptureError(
                f"a state tensor {tuple(s.shape)} {s.dtype} is followed by "
                f"{type(n).__name__} {getattr(n, 'shape', '')}: a donated "
                f"state must keep its leaves' shapes and dtypes")
        copies.append((s, n.clone() if _storage(n) in stores else n))
    for s, n in copies:
        s.copy_(n)


def _clone_leaves(leaves: List) -> List:
    return [l.clone() if _is_tensor(l) else l for l in leaves]


def _copy_into(dst: List, src: List):
    for d, s in zip(dst, src):
        if _is_tensor(d):
            d.copy_(s)


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

def _counters() -> List[Dict[str, int]]:
    from ..kernels import (flash_attn, norm, quant8, rglru_scan, rotary,
                           sparse_dec, sparse_enc, ssd_decode, ssd_scan)
    return [flash_attn.LAUNCHES, flash_attn.PREFILL_ROUTE_LAUNCHES,
            flash_attn.HEAD_DIM_LAUNCHES, flash_attn.KERNEL_LAUNCHES,
            quant8.LAUNCHES, sparse_enc.LAUNCHES,
            sparse_enc.ENC_ROUTE_LAUNCHES, sparse_dec.LAUNCHES,
            rglru_scan.LAUNCHES, ssd_scan.LAUNCHES, ssd_decode.LAUNCHES,
            norm.LAUNCHES, rotary.LAUNCHES]


def counter_snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in _counters()]


def counter_restore(snap: List[Dict[str, int]]):
    for c, s in zip(_counters(), snap):
        c.update(s)


def _counter_delta(snap) -> List[Dict[str, int]]:
    return [{k: c[k] - s.get(k, 0) for k in c if c[k] != s.get(k, 0)}
            for c, s in zip(_counters(), snap)]


def _counter_add(delta):
    for c, d in zip(_counters(), delta):
        for k, v in d.items():
            c[k] += v


# ---------------------------------------------------------------------------
# the graph backend
# ---------------------------------------------------------------------------

#: device index -> [the shared pool's handle, graphs alive in it].  A
#: handle is dropped with its last graph: the allocator retires a pool no
#: graph uses, and a retired pool's handle cannot take another capture.
_POOLS: Dict[int, List] = {}
#: process-wide totals: graphs captured, and the device bytes they hold
_STATS = {"captured": 0, "bytes": 0}


def graph_stats() -> Dict[str, int]:
    """Graphs captured in this process, and the device bytes that live
    captures hold (memory pool growth plus the bindings' own buffers)."""
    return dict(_STATS)


class CudaGraph:
    """One ``torch.cuda.CUDAGraph`` in its device's shared pool."""

    def __init__(self, device: torch.device):
        self.index = device.index if device.index is not None else \
            torch.cuda.current_device()
        self.graph = torch.cuda.CUDAGraph()
        self.pool_bytes = 0
        self.live = False

    def capture(self, body: Callable[[], Any]) -> Any:
        with torch.cuda.device(self.index):
            pool = _POOLS.get(self.index)
            if pool is None:
                pool = _POOLS[self.index] = [torch.cuda.graph_pool_handle(),
                                             0]
            try:
                with warnings.catch_warnings():
                    # a deferred segment that only routes its answer to a
                    # sink captures no kernel; replaying it is harmless
                    warnings.filterwarnings(
                        "ignore", message="The CUDA Graph is empty")
                    with torch.cuda.graph(self.graph, pool=pool[0]):
                        # read inside: entering may release cached memory
                        before = torch.cuda.memory_reserved(self.index)
                        res = body()
            except BaseException:
                if pool[1] == 0:        # the failed graph held it alone
                    del _POOLS[self.index]
                raise
            self.pool_bytes = max(0, torch.cuda.memory_reserved(self.index)
                                  - before)
        pool[1] += 1
        self.live = True
        return res

    def replay(self):
        with torch.cuda.device(self.index):
            self.graph.replay()

    def reset(self):
        self.graph.reset()
        self._leave_pool()

    def __del__(self):
        # a graph dropped without reset leaves its pool all the same
        self._leave_pool()

    def _leave_pool(self):
        if self.live:
            self.live = False
            pool = _POOLS.get(self.index)
            if pool is not None:
                pool[1] -= 1
                if pool[1] <= 0:
                    del _POOLS[self.index]


class _Binding:
    __slots__ = ("calls", "graph", "args", "state", "result", "launches",
                 "nbytes", "ptrs")

    def __init__(self, ptrs: frozenset):
        #: addresses the binding is keyed on (params; state when donated)
        self.ptrs = ptrs
        self.calls = 0
        self.graph = None       # a captured graph backend
        self.args = None        # static arg leaves
        self.state = None       # the binding's own state leaves (no donation)
        self.result = None      # static (out leaves, out treedef, next leaves,
        #                          next treedef)
        self.launches = None
        self.nbytes = 0


class GraphedCallable:
    """A cached executable: ``fn`` on the CPU, CUDA graphs on the card
    (module docstring).  ``graph_factory(device)`` makes the graph backend,
    :class:`CudaGraph` by default; a test may pass a stand-in, which then
    takes the graph path on any device."""

    def __init__(self, fn: Callable, donate: bool,
                 graph_factory: Optional[Callable] = None):
        self.fn = fn
        self.donate = bool(donate)
        self.graph_factory = graph_factory
        self._bindings: "OrderedDict[Tuple, _Binding]" = OrderedDict()
        #: graphs this callable captured, over its life
        self.captures = 0

    # -- introspection ---------------------------------------------------------
    def graphs(self) -> int:
        """Live captured graphs."""
        return sum(b.graph is not None for b in self._bindings.values())

    def release(self):
        """Free every binding and its graph (cache eviction)."""
        for b in self._bindings.values():
            self._free(b)
        self._bindings.clear()

    def release_on(self, ptrs) -> int:
        """Free the bindings keyed on any of the tensor addresses ``ptrs``
        (params or donated state a reconfiguration retired: no call can
        reach such a binding again).  Returns how many were freed."""
        gone = [k for k, b in self._bindings.items() if b.ptrs & ptrs]
        for k in gone:
            self._free(self._bindings.pop(k))
        return len(gone)

    @staticmethod
    def _free(b: _Binding):
        if b.graph is not None:
            b.graph.reset()
            _STATS["bytes"] -= b.nbytes
        b.graph = b.result = b.args = b.state = None

    # -- calls -----------------------------------------------------------------
    def __call__(self, params, state, *args, **static):
        on = TRACER.on
        fp, fs, fa = tree_flatten(params), tree_flatten(state), \
            tree_flatten(args)
        dev = _device_of(fp[0] + fs[0] + fa[0])
        if self.graph_factory is None and (dev is None or
                                           dev.type != "cuda"):
            if on:
                sp = TRACER.begin("graph.launch")
            res = self.fn(params, state, *args, **static)
            if on:
                TRACER.end(sp)
            return res
        key = _key(fp, fs, fa, static, self.donate, dev)
        b = self._bindings.get(key)
        if b is None:
            b = self._bindings[key] = _Binding(frozenset(
                l.data_ptr() for l in fp[0] + (fs[0] if self.donate else [])
                if _is_tensor(l)))
            while len(self._bindings) > MAX_BINDINGS:
                self._free(self._bindings.popitem(last=False)[1])
        else:
            self._bindings.move_to_end(key)
        b.calls += 1
        leaves, state_td = fs
        work = self._working_state(b, leaves)
        if b.calls == 1:
            if on:
                sp = TRACER.begin("graph.launch")
            res = self._body(params, work, state_td, args, static,
                             capturing=False)
            if len(res) != 2:       # 2: the state changed its structure
                res = self._finish(res, clone_outputs=not self.donate)
            if on:
                TRACER.end(sp)
            return res
        if b.graph is None:
            if on:
                sp = TRACER.begin("graph.capture")
            self._capture(b, dev or torch.device("cpu"), params, work,
                          state_td, args, static)
            if on:
                TRACER.end(sp)
        else:
            _copy_into(b.args, fa[0])
        if on:
            sp = TRACER.begin("graph.launch")
        b.graph.replay()
        _counter_add(b.launches)
        res = self._finish(b.result, clone_outputs=True)
        if on:
            TRACER.end(sp)
        return res

    def _working_state(self, b: _Binding, state_leaves: List) -> List:
        """The state leaves ``fn`` runs on: the caller's (donated), or the
        binding's own, refreshed from the caller's."""
        if self.donate:
            return state_leaves
        if b.state is None:
            b.state = _clone_leaves(state_leaves)
        else:
            _copy_into(b.state, state_leaves)
        return b.state

    def _body(self, params, work: List, state_td, args, static,
              capturing: bool):
        """One call of ``fn`` on the working state, finished as the graph
        finishes it: outputs that alias the state detached, then (with
        donation) the rebound leaves written back and the next state made
        of the working leaves.  Returns (out leaves, out treedef, next
        leaves, next treedef), or fn's own (outputs, next_state) when a
        donated state changes its structure on an eager call (nothing is
        written back then, and a second call of the binding raises)."""
        out, nxt = self.fn(params, tree_unflatten(state_td, work), *args,
                           **static)
        out_leaves, out_td = tree_flatten(out)
        nxt_leaves, nxt_td = tree_flatten(nxt)
        if self.donate and nxt_td != state_td:
            if capturing:
                raise GraphCaptureError(
                    "next_state's structure differs from the state's: a "
                    "donated state must keep its structure")
            return out, nxt
        out_leaves = detach_outputs(out_leaves, work)
        if self.donate:
            write_back(work, nxt_leaves)
            nxt_leaves = [w if _is_tensor(w) else n
                          for w, n in zip(work, nxt_leaves)]
        return out_leaves, out_td, nxt_leaves, nxt_td

    def _finish(self, res, clone_outputs: bool):
        """(outputs, next_state) from a body's leaves: outputs cloned out of
        the graph's buffers; a donated next state is the caller's leaves,
        an undonated one is cloned out of the binding's."""
        out_leaves, out_td, nxt_leaves, nxt_td = res
        if clone_outputs:
            out_leaves = _clone_leaves(out_leaves)
        if not self.donate:
            nxt_leaves = _clone_leaves(nxt_leaves)
        return (tree_unflatten(out_td, out_leaves),
                tree_unflatten(nxt_td, nxt_leaves))

    def _capture(self, b: _Binding, dev, params, work, state_td, args,
                 static):
        arg_leaves, args_td = tree_flatten(args)
        b.args = [torch.empty_like(a) if _is_tensor(a) else a
                  for a in arg_leaves]
        _copy_into(b.args, arg_leaves)
        static_args = tree_unflatten(args_td, b.args)
        graph = (self.graph_factory or CudaGraph)(dev)
        snap = counter_snapshot()
        try:
            b.result = graph.capture(lambda: self._body(
                params, work, state_td, static_args, static, capturing=True))
        except Exception as e:
            counter_restore(snap)
            b.args = None
            raise GraphCaptureError(
                f"CUDA-graph capture of {getattr(self.fn, '__name__', 'fn')}"
                f" failed: {e}") from e
        b.launches = _counter_delta(snap)
        counter_restore(snap)
        b.graph = graph
        b.nbytes = getattr(graph, "pool_bytes", 0) + sum(
            t.numel() * t.element_size() for t in b.args + (b.state or [])
            if _is_tensor(t))
        self.captures += 1
        _STATS["captured"] += 1
        _STATS["bytes"] += b.nbytes
