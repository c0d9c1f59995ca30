"""Parameter trees as nested dicts: the few pytree operations the training
stack needs, in the order ``jax.tree_util`` flattens a nested dict (keys
sorted at every level), so leaves line up with the reference's."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Path = Tuple[str, ...]


def flatten(tree: Any, path: Path = ()) -> List[Tuple[Path, Any]]:
    """(key path, leaf) pairs in ``jax.tree_util``'s order for nested dicts."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in flatten(tree[key], path + (key,))]
    return [(path, tree)]


def unflatten(items) -> Any:
    """The nested dict of (key path, leaf) pairs; a single empty path is a
    bare leaf."""
    items = list(items)
    if len(items) == 1 and items[0][0] == ():
        return items[0][1]
    tree: Dict[str, Any] = {}
    for path, leaf in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``, which
    have its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
