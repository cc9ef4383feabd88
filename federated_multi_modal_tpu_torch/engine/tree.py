"""Parameter trees of the port: nested dicts and lists of tensors, named by
dotted paths as the JAX package's checkpoints name them (counterpart of
``split_tree`` / ``merge_trees`` / ``cast_tree`` in
``federated_multi_modal_tpu/engine/trainer.py`` and ``flatten_params`` in
``engine/checkpoint.py``)."""

from __future__ import annotations

from itertools import zip_longest
from typing import Callable


def tree_map_with_path(fn, tree, prefix: str = ""):
    """Apply ``fn(dotted_name, leaf)`` to every non-None leaf."""
    def name(k):
        return f"{prefix}.{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, name(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, name(i))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


def split_tree(tree, predicate: Callable[[str], bool]):
    """Split one tree into (selected, rest); each keeps the full structure
    with ``None`` in the complementary slots."""
    selected = tree_map_with_path(lambda n, x: x if predicate(n) else None, tree)
    rest = tree_map_with_path(lambda n, x: None if predicate(n) else x, tree)
    return selected, rest


def merge_trees(a, b):
    """Inverse of :func:`split_tree`: the non-None leaf at each position
    (also joins two trees that each hold part of the names)."""
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, dict):
        return {k: merge_trees(a.get(k), b.get(k)) for k in {**a, **b}}
    if isinstance(a, (list, tuple)):
        return type(a)(merge_trees(x, y) for x, y in zip_longest(a, b))
    return a


def cast_tree(tree, dtype):
    return tree_map_with_path(lambda _, x: x.to(dtype), tree)


def to_device(tree, device):
    return tree_map_with_path(lambda _, x: x.to(device), tree)


def flatten(tree) -> dict:
    """``{dotted name: leaf}`` for every non-None leaf."""
    flat = {}
    tree_map_with_path(lambda n, x: flat.__setitem__(n, x), tree)
    return flat


def unflatten(flat: dict):
    """Inverse of :func:`flatten`: a level whose keys are all digits
    becomes a list (missing indices are None)."""
    root: dict = {}
    for name, leaf in flat.items():
        node = root
        *parents, last = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node.get(str(i)) for i in range(max(map(int, node)) + 1)]
        return node

    return listify(root)


def tree_map_multi(fn, tree, *rest):
    """``fn(leaf, *leaves at the same position in rest)`` over every
    non-None leaf of ``tree``; the other trees share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map_multi(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_multi(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def leaves(tree) -> list:
    """The non-None leaves in :func:`flatten`'s order."""
    return list(flatten(tree).values())
