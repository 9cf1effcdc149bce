"""Operation costs of a PyTorch step, counted op by op as it runs: the
port's counterpart of ``repro/launch/hlo_cost.py``'s ``analyze`` and
``top_costs``, with the same keys.

``repro`` reads XLA's optimized HLO text; PyTorch produces none, so this
module reads the step itself. ``count(fn, *args)`` runs ``fn`` once under
one dispatch mode, best on ``meta`` tensors (shapes only, nothing
computed, no memory), and counts each aten op:

  * flops by ``torch.utils.flop_counter``'s formulas (matmuls,
    convolutions and attention products: 2 per multiply-add);
  * bytes: the op's operand and result bytes, views left out (they move
    nothing). An op that reads only its operands' shapes (``new_zeros``,
    ``fill_``, ...) counts its results; a gather (``gather``, ``index``,
    ``index_select``, ``embedding``) reads its source at the entries it
    picks, as many bytes as its result. Eager PyTorch runs op by op, unfused, as the card runs the
    port's ops outside its kernels; an op may read or write less than its
    operands' whole storage, and the 50 MB L2 may serve a small operand
    that the op before wrote, so this is an upper bound on those ops' HBM
    traffic, where ``repro``'s counts bytes at fusion boundaries;
  * transcendentals: the result elements of exp, log, tanh, sigmoid,
    rsqrt, sqrt, pow, sin, cos, erf and the softmaxes;
  * collectives: none. A step on one device makes no collective call, so
    ``collectives`` and ``collective_counts`` are empty and
    ``collective_bytes`` is 0.

Kernels: where ``kernels/ops.py`` runs a kernel's plain version on meta
(attention, the SSD scan, forward and backward), the count takes one row
``kernel.<name>`` with the kernel's own work at those shapes (each input
read once, each output written once; the flops of the products the
kernel computes, masked blocks left out), and keeps the plain version's
ops in rows of their own (``Row.within``). ``totals()`` and ``top()``
count the step as the card runs it: the kernels by their own work;
``totals(plain=True)`` by their plain versions' ops, as ``repro``'s HLO
counts them.

The port's layers are Python loops, so an op inside a loop is dispatched,
and counted, once a trip: trip scaling needs no trip counts here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import ops

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "pow", "sin", "cos", "erf",
                   "_softmax", "_log_softmax", "logsumexp", "silu", "gelu",
                   "softplus"}
# allocations without a read or a write of their own
_FREE = {"empty", "empty_strided", "empty_like", "lift_fresh", "detach",
         "alias", "_unsafe_view"}
# ops that read their operands' shapes only, and write their results
_SHAPE_ONLY = {"new_zeros", "new_ones", "new_full", "new_empty",
               "zeros_like", "ones_like", "full_like", "fill", "zero"}
# ops that read their first operand at the entries they pick
_GATHER = {"gather", "index", "index_select", "embedding"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


@dataclasses.dataclass
class Row:
    """One aten op's totals over a run (``within``: the kernel whose plain
    version ran it, if any), or with ``kernel`` a kernel's own work."""
    op: str
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0
    transcendental: float = 0.0
    within: str = ""
    kernel: bool = False


class _Count(TorchDispatchMode):
    """The counting mode; ``kernels/ops.py`` calls ``enter`` and ``leave``
    around a kernel's plain version (``work``: (name, bytes, flops), or
    None for ops that count nothing)."""

    def __init__(self):
        super().__init__()
        self.rows: Dict[str, Row] = {}
        self.within: list = []

    def _row(self, key: str, **kw) -> Row:
        if key not in self.rows:
            self.rows[key] = Row(**kw)
        return self.rows[key]

    def enter(self, work) -> None:
        self.within.append(work)

    def leave(self, work) -> None:
        self.within.pop()
        if work is not None:
            name, nbytes, flops = work
            row = self._row(f"kernel.{name}", op=name, kernel=True)
            row.calls += 1
            row.bytes += nbytes
            row.flops += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.is_view or packet.__name__ in _FREE:
            return out
        within = self.within[-1] if self.within else ("",)
        if within is None:
            return out
        op = str(packet)
        row = self._row(f"{within[0]}/{op}" if within[0] else op, op=op,
                        within=within[0])
        row.calls += 1
        results = tree_leaves(out)
        written = sum(_nbytes(x) for x in results)
        base = packet.__name__.rstrip("_")
        if base in _SHAPE_ONLY:
            read = 0
        elif base in _GATHER:
            read = written + sum(_nbytes(x) for x in
                                 tree_leaves((args[1:], kwargs)))
        else:
            read = sum(_nbytes(x) for x in tree_leaves((args, kwargs)))
        row.bytes += read + written
        if packet in flop_registry:
            row.flops += float(flop_registry[packet](*args, **kwargs,
                                                     out_val=out))
        if base in _TRANSCENDENTAL:
            row.transcendental += sum(x.numel() for x in results
                                      if isinstance(x, torch.Tensor))
        return out


@dataclasses.dataclass
class OpCost:
    """The rows of one run, keyed by aten op (``<kernel>/<op>`` for a
    kernel's plain version, ``kernel.<name>`` for a kernel's own work)."""
    rows: Dict[str, Row]

    def _rows(self, plain: bool) -> List[Row]:
        return [r for r in self.rows.values()
                if not (r.kernel if plain else r.within)]

    def totals(self, plain: bool = False) -> Dict:
        """``repro``'s ``hlo_cost.analyze`` keys: the kernels by their own
        work, or with ``plain`` by their plain versions' ops."""
        rows = self._rows(plain)
        return {
            "flops": float(sum(r.flops for r in rows)),
            "bytes": float(sum(r.bytes for r in rows)),
            "transcendentals": float(sum(r.transcendental for r in rows)),
            "collectives": {},
            "collective_counts": {},
            "collective_bytes": 0.0,
        }

    def top(self, k: int = 20) -> List[Dict]:
        """``repro``'s ``hlo_cost.top_costs`` rows, one an aten op or a
        kernel (its calls as ``trips``), by bytes."""
        rows = [{"bytes": r.bytes, "flops": r.flops, "collective": 0.0,
                 "op": r.op, "trips": float(r.calls), "where": r.op}
                for r in self._rows(plain=False) if r.bytes or r.flops]
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:k]


def count(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, counting; (its result, OpCost)."""
    mode = _Count()
    ops.COUNTS.append(mode)
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        ops.COUNTS.pop()
    return out, OpCost(mode.rows)


def analyze(fn, *args, **kwargs) -> Dict:
    """Totals of one run of ``fn``: flops, bytes, transcendentals and the
    (empty) collectives, under ``repro``'s keys."""
    return count(fn, *args, **kwargs)[1].totals()


def top_costs(fn, *args, k: int = 20, **kwargs) -> List[Dict]:
    """The top-``k`` aten ops and kernels of one run of ``fn`` by bytes."""
    return count(fn, *args, **kwargs)[1].top(k)
