"""Parameter trees of the port: nested dicts and lists of tensors.

The reference's trees are JAX pytrees whose per-layer entries are stacked
on a leading axis; the port keeps ``params["layers"]`` as a list of
per-layer dicts (``convert.model_params``). A list in a tree is such a
per-layer sequence. These helpers walk a tree in one fixed order (dict
keys as they are stored, list entries in order), so two trees of one
structure give their leaves in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves(tree: Any) -> list:
    """The tree's leaves, in its walk order."""
    return list(_iter(tree))


def _iter(tree: Any) -> Iterator:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter(v)
    else:
        yield tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """A tree of ``fn(leaf, *matching leaves of rest)`` with ``tree``'s
    structure; ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def unflatten(like: Any, flat: list) -> Any:
    """A tree of ``like``'s structure holding ``flat``'s entries, in walk
    order (the inverse of ``leaves``)."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more entries than the tree has leaves")
    return out


def walk_layers(fn: Callable, tree: Any, *rest: Any,
                stacked: bool = False) -> None:
    """Call ``fn(leaf, *matching leaves of rest, stacked)`` for every leaf;
    ``stacked`` is true under a per-layer list, where the reference holds
    the leaf with one more (layer) axis."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            walk_layers(fn, v, *(r[k] for r in rest), stacked=stacked)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            walk_layers(fn, v, *(r[i] for r in rest),
                        stacked=stacked or isinstance(tree, list))
    else:
        fn(tree, *rest, stacked)
