"""Static analyzer of a traced step -> roofline terms: the port's counterpart
of ``repro/launch/hlo_analysis.py`` (the port has no HLO; it walks the aten
graph that ``make_fx(tracing_mode="fake")`` records, :func:`trace`).

Three quantities, as the reference's:

* **flops**: 2 · |result| · |contracted| for every ``mm`` / ``bmm`` /
  ``addmm`` / ``baddbmm``, and 2 · |result| · (C_in / groups) · |kernel|
  for a ``convolution``;
* **hbm bytes**, the reference's materialisation model: matmuls read their
  operands and write their result; ``index`` / ``gather`` /
  ``index_select`` / ``embedding`` read the bytes they return;
  ``index_put`` / ``scatter`` / ``slice_scatter`` / ``index_copy`` /
  ``index_add`` move 2x their update (in-place read-modify-write); a
  collective moves its operands and result; elementwise and layout ops are
  assumed fused into their consumers and move nothing. An op inside a
  ``fusedkernel_*`` scope (``common/scopes.py``) keeps its FLOPs but counts
  only the tensors that cross into the scope (the reference's ``in_kernel``
  rule): the kernel keeps its intermediates on chip;
* **collective bytes**, the ring model per device: all-reduce 2x its
  result, all-gather its result, reduce-scatter its largest operand,
  all-to-all its result (``_c10d_functional`` ops).

Python loops unroll into the graph, so there are no trip counts to weigh:
every layer and every block is there as often as it runs. The totals of
the ``expert_parallel`` scope (``models/moe.py``; also its ``_bwd``
recompute) are kept apart as well, since that region alone is a per-rank
program (``launch/dryrun.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute")
FUSED_KERNEL_MARKER = "fusedkernel_"
EP_SCOPE = "expert_parallel"

_MATMULS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2)}   # (lhs, rhs)
_READS = {"index", "gather", "index_select", "embedding"}
# op -> argument index of the update it writes
_WRITES = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2, "scatter": 3,
           "scatter_": 3, "scatter_add": 3, "scatter_add_": 3, "slice_scatter": 1,
           "index_copy": 3, "index_copy_": 3, "index_add": 3, "index_add_": 3}
_COLLECTIVES = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


@dataclass
class GraphStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=lambda: {o: 0.0 for o in COLL_OPS})
    coll_counts: Dict[str, int] = field(default_factory=lambda: {o: 0 for o in COLL_OPS})
    expert_parallel: Optional["GraphStats"] = None   # the totals inside that scope

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    def as_dict(self) -> dict:
        d = {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
             "total_bytes": self.total_coll_bytes}
        d.update({f"{k}_bytes": v for k, v in self.coll_bytes.items()})
        d.update({f"{k}_count": v for k, v in self.coll_counts.items()})
        return d


def trace(fn, *args) -> torch.fx.GraphModule:
    """``fn(*args)`` recorded as an aten graph on fake tensors, with the
    kernel marks entered."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.common.scopes import tracing
    with tracing():
        return make_fx(fn, tracing_mode="fake")(*args)


def _tensors(val):
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


def _bytes(val) -> int:
    return sum(t.numel() * t.dtype.itemsize for t in _tensors(val))


def _val(arg):
    return arg.meta.get("val") if isinstance(arg, torch.fx.Node) else None


def _arg_bytes(node, i: int) -> int:
    return _bytes(_val(node.args[i])) if len(node.args) > i else 0


def _name(node) -> str:
    return getattr(node.target, "__name__", str(node.target)).split(".")[0]


def _flops(node, op: str) -> float:
    out = _val(node)
    if op in _MATMULS:
        lhs = _val(node.args[_MATMULS[op][0]])
        return 2.0 * out.numel() * lhs.shape[-1]
    if op == "convolution":
        w = _val(node.args[1])
        return 2.0 * out.numel() * (w.numel() // w.shape[0])
    return 0.0


def _collective(node, op: str, st: GraphStats) -> None:
    kind = _COLLECTIVES[op]
    res = _bytes(_val(node))
    ops_b = [_bytes(_val(a)) for a in node.args if isinstance(a, torch.fx.Node)]
    if kind == "all-reduce":
        traffic = 2.0 * res
    elif kind == "reduce-scatter":
        traffic = float(max(ops_b or [res]))
    else:
        traffic = float(res)
    st.coll_bytes[kind] += traffic
    st.coll_counts[kind] += 1
    st.hbm_bytes += res + sum(ops_b)


def _node_bytes(node, op: str) -> float:
    if op in _MATMULS or op == "convolution":
        ins = [a for a in node.args if isinstance(a, torch.fx.Node)]
        return _bytes(_val(node)) + sum(_bytes(_val(a)) for a in ins)
    if op in _READS:
        return float(_bytes(_val(node)))
    if op in _WRITES:
        i = _WRITES[op]
        upd = node.args[i] if len(node.args) > i else None
        return 2.0 * (_bytes(_val(upd)) if isinstance(upd, torch.fx.Node) else _bytes(_val(node)))
    return 0.0


def analyze(gm: torch.fx.GraphModule) -> GraphStats:
    total, ep = GraphStats(), GraphStats()
    scopes: Dict[torch.fx.Node, str] = {}        # open record_function -> its name
    in_kernel: Dict[torch.fx.Node, bool] = {}
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        op = _name(node)
        if op == "_record_function_enter_new":
            scopes[node] = node.args[0]
            continue
        if op == "_record_function_exit":
            scopes.pop(node.args[0], None)
            continue
        names = scopes.values()
        kernel = any(FUSED_KERNEL_MARKER in n for n in names)
        in_kernel[node] = kernel
        targets = [total] + ([ep] if any(n.startswith(EP_SCOPE) for n in names) else [])
        if op in _COLLECTIVES:
            for st in targets:
                _collective(node, op, st)
            continue
        flops = _flops(node, op) if _val(node) is not None else 0.0
        if kernel:
            # only the tensors that cross into the kernel region are HBM reads
            bts = sum(_bytes(_val(a)) for a in node.all_input_nodes
                      if not in_kernel.get(a, False))
        else:
            bts = _node_bytes(node, op)
        for st in targets:
            st.flops += flops
            st.hbm_bytes += bts
    total.expert_parallel = ep
    return total
