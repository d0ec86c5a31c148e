"""Helpers over the port's parameter trees: nested dicts and lists with
tensor leaves (``models/transformer.py``'s params, an optimizer's state).

Counting, casting and finiteness, as ``repro.common.pytree``; and the flat
``"a/0/b"`` paths of the leaves, the names under which the trainer's
optimizer and ``training/checkpoint.py`` address them (the reference's
checkpoint key format). ``tree_shapes`` and ``tree_zeros_like_spec`` exist
in the reference for lowering without allocation; they wait for the mesh
tooling (ROADMAP.md, queue 1 item 13).
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
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_size(tree: Any) -> int:
    """Total number of elements across all leaves."""
    return sum(int(x.numel()) for _, x in tree_items(tree))


def tree_bytes(tree: Any) -> int:
    return sum(int(x.numel()) * x.element_size() for _, x in tree_items(tree))


def tree_cast(tree: Any, dtype: torch.dtype) -> Any:
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def check_finite(tree: Any) -> bool:
    return all(bool(torch.isfinite(x).all()) for _, x in tree_items(tree)
               if x.is_floating_point())
