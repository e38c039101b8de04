"""Per-device cost counter of one step of the port: FLOPs, bytes and
collective bytes.

The JAX package's ``repro.launch.hlo_cost`` parses the post-partitioning
HLO text of a compiled step (its ``while`` bodies weighted by their trip
counts, fusion interiors free of bytes).  The port compiles no HLO: an
eager PyTorch step runs every ATen op as its own kernel, so there is no
module text to parse, no fusion boundary and no loop to weight.  The HLO
text parser therefore has no torch counterpart; :func:`analyze` runs the
step itself under a ``TorchDispatchMode`` and counts every ATen op this
rank executes, with the same :class:`HloCost` fields:

* **flops**: products (``mm``, ``bmm``, ``mv``, ``dot`` and their
  ``add`` forms) 2·M·N·K; elementwise
  ops by the JAX package's per-element weights (``_ELEMENTWISE``, keyed
  here by ATen op), reductions one a reduced element; the flash-attention
  and selective-scan kernels (K6, K7) on meta tensors their own
  operations (``kernels.sharded``), one op each;
* **bytes**: each op's operands read once and its result written once
  (eager runs each op as its own kernel); views and allocations are free;
* **collective_bytes**: the ``_c10d_functional`` (and ``c10d``) ops'
  result bytes times the ring multipliers of ``_COLLECTIVES``.

On ``DTensor`` operands the mode defers to the ``DTensor`` dispatch and
counts the local ops it runs, so the counts are this rank's; the ops
``DTensor`` runs under a fake-tensor mode to propagate global shapes are
not counted.  Run the step on meta tensors (shapes, no values) to count
a full-size configuration without memory.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

__all__ = ["HloCost", "analyze", "count"]

#: flops per result element of elementwise ops, the JAX package's weights
#: by HLO opcode, with the ATen ops that run each opcode
_ELEMENTWISE = {
    "add": 1, "subtract": 1, "multiply": 1, "divide": 3, "negate": 1,
    "abs": 1, "maximum": 1, "minimum": 1, "compare": 1, "select": 1,
    "and": 1, "or": 1, "xor": 1, "not": 1, "exponential": 6, "log": 6,
    "tanh": 8, "logistic": 6, "rsqrt": 4, "sqrt": 4, "power": 8,
    "cosine": 6, "sine": 6, "floor": 1, "round-nearest-afz": 1,
    "exponential-minus-one": 6, "clamp": 2, "sign": 1,
    "multiply-add": 2, "erf": 8,
}
_ATEN_OPCODE = {
    "add": "add", "sub": "subtract", "rsub": "subtract", "mul": "multiply",
    "div": "divide", "reciprocal": "divide", "neg": "negate", "abs": "abs",
    "maximum": "maximum", "minimum": "minimum", "clamp_min": "maximum",
    "clamp_max": "minimum", "eq": "compare", "ne": "compare",
    "lt": "compare", "le": "compare", "gt": "compare", "ge": "compare",
    "isnan": "compare", "where": "select", "masked_fill": "select",
    "logical_and": "and", "bitwise_and": "and", "logical_or": "or",
    "bitwise_or": "or", "logical_xor": "xor", "bitwise_xor": "xor",
    "logical_not": "not", "bitwise_not": "not", "exp": "exponential",
    "log": "log", "log1p": "log", "tanh": "tanh", "sigmoid": "logistic",
    "rsqrt": "rsqrt", "sqrt": "sqrt", "pow": "power", "cos": "cosine",
    "sin": "sine", "floor": "floor", "round": "round-nearest-afz",
    "expm1": "exponential-minus-one", "clamp": "clamp", "sign": "sign",
    "addcmul": "multiply-add", "erf": "erf", "square": "multiply",
}
#: reductions: flops a reduced (input) element
_REDUCE = {"sum": 1, "mean": 1, "amax": 1, "amin": 1, "max": 1, "min": 1,
           "cumsum": 1, "prod": 1, "argmax": 1, "logsumexp": 8,
           "_softmax": 9, "_log_softmax": 9, "norm": 2}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot", "vdot"}

#: traffic multiplier per collective kind (ring algorithms, payload-relative)
_COLLECTIVES = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "broadcast": "collective-permute",
    "broadcast_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute",
}
#: ops that move no bytes: allocations, waits and autograd wrappers
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
         "detach", "lift_fresh", "_local_scalar_dense", "set_", "resize_",
         "is_same_size", "sym_size", "sym_stride", "sym_numel"}

#: the cost ops of K6 and K7 on meta tensors, and their work
_KERNEL_COST = {"flash_attention_cost": "attention_cost",
                "mamba_scan_cost": "scan_cost",
                "flash_attention_backward_cost": "attention_backward_cost",
                "mamba_scan_backward_cost": "scan_backward_cost"}


@dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_count: float = 0.0
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    bytes_by_opcode: Dict[str, float] = field(default_factory=dict)
    flops_by_opcode: Dict[str, float] = field(default_factory=dict)


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a kernel reads or writes for ``t``: its elements, or its
    storage when that is smaller (a broadcast view)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cost = HloCost()
        self.live = {}              # id(storage) -> bytes, storages we saw made
        self.live_bytes = 0
        self.peak_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensorMode
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented         # count the local ops it runs
        out = func(*args, **kwargs)
        if not any(isinstance(m, FakeTensorMode)
                   for m in _get_current_dispatch_mode_stack()):
            self._count(func, args, kwargs, out)
        return out

    # -- counting ---------------------------------------------------------
    def _add(self, table: str, key: str, value: float) -> None:
        d = getattr(self.cost, table)
        d[key] = d.get(key, 0.0) + value

    def _track(self, out) -> None:
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = id(st)
            if key in self.live:
                continue
            nb = st.nbytes()
            self.live[key] = nb
            self.live_bytes += nb
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        ns = func.namespace
        self._track(out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if ns in ("_c10d_functional", "c10d") and name in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[name]
            res = outs if ns == "_c10d_functional" else _tensors(args[0])
            b = sum(_nbytes(t) for t in res) * _COLLECTIVES[kind]
            self.cost.collective_bytes += b
            self.cost.collective_count += 1
            self._add("collective_breakdown", kind, b)
        if name.rstrip("_") in _FREE or name in _FREE or (
                getattr(func, "is_view", False)):
            return
        if ns == "repro_torch" and name in _KERNEL_COST:
            from ..kernels import sharded
            ops, b = getattr(sharded, _KERNEL_COST[name])(*args)
            self.cost.flops += ops
            self._add("flops_by_opcode", name, ops)
            self.cost.bytes += b
            self._add("bytes_by_opcode", name, b)
            return
        b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.cost.bytes += b
        self._add("bytes_by_opcode", name, b)
        base = name.rstrip("_")
        f = 0.0
        if base in _MATMUL and outs:
            mat = args[1] if base in ("addmm", "baddbmm", "addmv") \
                else args[0]
            f = 2.0 * max(1, outs[0].numel()) * mat.shape[-1]
            key = "dot"
        elif base in _ATEN_OPCODE and outs:
            key = _ATEN_OPCODE[base]
            f = _ELEMENTWISE[key] * outs[0].numel()
        elif base in _REDUCE and ins:
            key = "reduce"
            f = _REDUCE[base] * ins[0].numel()
        if f:
            self.cost.flops += f
            self._add("flops_by_opcode", key, f)


def count(fn, *args, **kw) -> Tuple[HloCost, object, int]:
    """``fn(*args, **kw)`` run under the counter: its cost, its result,
    and the peak bytes of the storages the run made that were alive at
    once (its outputs among them; the arguments not)."""
    with _Counter() as c:
        out = fn(*args, **kw)
    return c.cost, out, c.peak_bytes


def analyze(fn, *args, **kw) -> HloCost:
    """The per-device cost of ``fn(*args, **kw)`` (see the module
    docstring)."""
    return count(fn, *args, **kw)[0]
