"""Logical-axis sharding rules: the port of ``repro/common/sharding.py``.

Every parameter, cache and batch leaf carries a tuple of *logical* axis names
(e.g. ``("embed", "heads", "head_dim")``, ``models/layers.py::ParamSpec``). A
rules table maps logical names to mesh axes, and :func:`resolve_spec` applies
it with the reference's two fallbacks:

* a dimension whose size is not divisible by the mapped mesh-axis product is
  replicated, after trying shorter prefixes of a tuple rule (GQA kv-heads
  fewer than the model axis, batch=1 long-context decode);
* a mesh axis is never used twice within one spec (the first dim wins).

A mesh is anything with ``axis_names`` and a ``shape`` dict
(``launch/mesh.py::Mesh``, or a shape-only stand-in). The result is the
port's :class:`PartitionSpec`, a tuple of per-dimension entries (None, an
axis name, or a tuple of names) with trailing Nones trimmed, so it compares
equal to the reference's spec as a tuple (JAX's spec, too, stores a tuple of
one axis as its name). :func:`shard_shape` gives the
per-device shape and :func:`shard_tensor` this rank's block of a global
tensor (what ``NamedSharding`` and ``shard_map``'s ``in_specs`` do there).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

AxisName = Union[str, Tuple[str, ...]]
LogicalAxes = Tuple[Optional[str], ...]


class PartitionSpec(tuple):
    """Per-dimension mesh axes: None (replicated), a name, or a tuple of
    names; a tuple of one name is that name, as in JAX's PartitionSpec."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of logical names (or None)."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def default_rules(mesh, *, context_parallel: bool = False) -> Dict[str, AxisName]:
    """Logical-name -> mesh-axis table for the production meshes."""
    data_axes: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    data: AxisName = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)
    return {
        # activations
        "batch": data,
        "seq": None,
        "act_embed": None,
        # weights: tensor-parallel over `model`, replicated over `data`
        "vocab": "model",
        "embed": None,
        "embed_fsdp": data,      # MoE expert weights: d-sharded over the data
                                 # axes, gathered in the expert-parallel branch
        "opt_embed": data,       # optimizer moments: ZeRO over the data axes
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ffn": "model",
        "experts": "model",
        "expert_ffn": None,
        "ssm_heads": "model",
        "ssm_state": None,
        "ssm_inner": "model",
        "conv": None,
        "pred_hidden": "model",
        "bins": None,
        # kv cache
        "cache_seq": ("data" if context_parallel else None),
        "cache_kv_heads": "model",
        # the reference's scan-stacked layer axis (the port keeps a dict a layer)
        "layers": None,
        "stats": None,
    }


def _prod(mesh, axes: Sequence[str]) -> int:
    return int(np.prod([mesh.shape[a] for a in axes]))


def resolve_spec(axes: LogicalAxes, shape: Sequence[int], mesh,
                 rules: Dict[str, AxisName]) -> PartitionSpec:
    """Map logical axes to a PartitionSpec honoring divisibility + axis reuse."""
    assert len(axes) == len(shape), f"axes {axes} vs shape {tuple(shape)}"
    used: set = set()
    out = []
    for name, dim in zip(axes, shape):
        mapped = rules.get(name) if name is not None else None
        if mapped is None:
            out.append(None)
            continue
        axis_tuple = mapped if isinstance(mapped, tuple) else (mapped,)
        axis_tuple = tuple(a for a in axis_tuple if a in mesh.axis_names and a not in used)
        if not axis_tuple:
            out.append(None)
            continue
        prod = _prod(mesh, axis_tuple)
        if prod <= 1 or dim % prod != 0:
            # try progressively shorter prefixes before giving up
            ok = None
            for k in range(len(axis_tuple) - 1, 0, -1):
                p = _prod(mesh, axis_tuple[:k])
                if p > 1 and dim % p == 0:
                    ok = axis_tuple[:k]
                    break
            if ok is None:
                out.append(None)
                continue
            axis_tuple = ok
        used.update(axis_tuple)
        # the tuple form stays whenever the rule maps to a tuple, even after
        # the prefix fallback, as the reference's
        out.append(axis_tuple if isinstance(mapped, tuple) else axis_tuple[0])
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def map_axes(fn, axes_tree: Any, *trees: Any) -> Any:
    """``fn(axes, *leaves)`` over an axes tree and trees of its structure
    (dicts, lists, tuples of entries; an axes tuple is a leaf)."""
    if is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees)) for k, v in axes_tree.items()}
    return type(axes_tree)(map_axes(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(axes_tree))


def tree_shardings(axes_tree: Any, shape_tree: Any, mesh,
                   rules: Optional[Dict[str, AxisName]] = None) -> Any:
    """PartitionSpec tree from a logical-axes tree and a tree of tensors (or
    stand-ins) of matching rank."""
    rules = rules if rules is not None else default_rules(mesh)
    return map_axes(lambda ax, t: resolve_spec(tuple(ax), t.shape, mesh, rules),
                    axes_tree, shape_tree)


def shard_like(axes: LogicalAxes, arr, mesh, rules=None) -> PartitionSpec:
    rules = rules if rules is not None else default_rules(mesh)
    return resolve_spec(axes, arr.shape, mesh, rules)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape: Sequence[int], spec: PartitionSpec, mesh) -> Tuple[int, ...]:
    """The per-device block shape of a global ``shape`` under ``spec``."""
    out = list(shape)
    for i, entry in enumerate(spec):
        n = _prod(mesh, _entry_axes(entry))
        assert out[i] % n == 0, (tuple(shape), spec)
        out[i] //= n
    return tuple(out)


def shard_index(entry, mesh) -> int:
    """This rank's block index along a dim sharded over ``entry``'s axes
    (row-major over the axes, the first one outermost)."""
    idx = 0
    for a in _entry_axes(entry):
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
    return idx


def shard_tensor(t: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The block of the global tensor ``t`` at this rank's mesh coordinates."""
    block = shard_shape(t.shape, spec, mesh)
    for i, entry in enumerate(spec):
        if entry is not None:
            t = t.narrow(i, shard_index(entry, mesh) * block[i], block[i])
    return t
