"""Helpers over the port's parameter trees: nested dicts and lists with
tensor leaves (``models/transformer.py``'s params, an optimizer's state).

Counting, casting and finiteness, as ``repro.common.pytree``; and the flat
``"a/0/b"`` paths of the leaves, the names under which the trainer's
optimizer and ``training/checkpoint.py`` address them (the reference's
checkpoint key format). ``tree_shapes`` and ``tree_zeros_like_spec`` are the
reference's shape-only stand-ins: here empty tensors under one shared
``FakeTensorMode`` on the CPU, which the dry-run traces without allocating
(``launch/dryrun.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple

import torch


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in tree order: dict keys sorted, as ``jax.tree_util``
    orders them, list entries in order; the path joins keys and indices
    with ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def tree_flatten(tree: Any) -> Dict[str, Any]:
    """The leaves keyed by their paths, in tree order."""
    return dict(tree_items(tree))


def tree_unflatten(flat: Dict[str, Any]) -> Any:
    """Nested dicts from ``a/b/c`` paths; a level whose keys are all
    integers becomes a list."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *head, last = path.split("/")
        node = root
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_size(tree: Any) -> int:
    """Total number of elements across all leaves."""
    return sum(int(x.numel()) for _, x in tree_items(tree))


def tree_bytes(tree: Any) -> int:
    return sum(int(x.numel()) * x.element_size() for _, x in tree_items(tree))


def tree_cast(tree: Any, dtype: torch.dtype) -> Any:
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


_FAKE_MODE = None


def fake_mode():
    """The one ``FakeTensorMode`` every shape-only stand-in lives in, so that
    params, caches and batches made apart can meet in one trace."""
    global _FAKE_MODE
    if _FAKE_MODE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE_MODE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE_MODE


def fake_tensor(shape, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``shape`` and ``dtype`` with no storage behind it."""
    with fake_mode():
        return torch.empty(tuple(shape), dtype=dtype)


def tree_shapes(tree: Any) -> Any:
    """Replace every leaf with a shape-only stand-in (:func:`fake_tensor`)."""
    return tree_map(lambda x: fake_tensor(x.shape, x.dtype), tree)


def tree_zeros_like_spec(tree: Any) -> Any:
    """Materialize zeros from a tree of stand-ins (tests only)."""
    return tree_map(lambda s: torch.zeros(tuple(s.shape), dtype=s.dtype), tree)


def check_finite(tree: Any) -> bool:
    return all(bool(torch.isfinite(x).all()) for _, x in tree_items(tree)
               if x.is_floating_point())
