"""Walks over nested parameter trees: the one traversal the port uses.

A tree is dicts, ``NamedTuple``\\ s, lists and tuples nested in any way,
with a tensor (or any other object) at each leaf.  Every walk takes the
leaves in one order, depth first in each container's own order, and keys
a leaf as the JAX package's checkpoints do: dict keys and list indices as
they are, a ``NamedTuple``'s fields as ``.name`` (``str`` of JAX's
``GetAttrKey``), joined with ``/``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Tree = Any

SEP = "/"


def tree_items(tree: Tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of every leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from tree_items(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (str(i),))
    else:
        yield SEP.join(path), tree


def tree_leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_rebuild(tree: Tree, leaf_fn: Callable[[str, Any], Any],
                 path: Tuple[str, ...] = ()) -> Tree:
    """A tree shaped as ``tree`` whose leaves are ``leaf_fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_rebuild(v, leaf_fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_rebuild(getattr(tree, n), leaf_fn, path + (f".{n}",))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_rebuild(v, leaf_fn, path + (str(i),)) for i, v in enumerate(tree))
    return leaf_fn(SEP.join(path), tree)


def tree_map(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    return tree_rebuild(tree, lambda _, leaf: fn(leaf))
