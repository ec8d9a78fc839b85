"""Nested-container helpers standing in for ``jax.tree``.

The port's parameter, gradient and optimizer-state trees are nested dicts
(and, for caches and quantized gradients, tuples and lists) of tensors.
Leaves come out in ``jax.tree``'s order: dict entries sorted by key,
sequence entries by index. A leaf's path is the keys and indices that
reach it, the parts ``checkpoint/ckpt.py`` joins into a file name.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> List[Tuple[Any, Any]]:
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def _is_node(tree, is_leaf) -> bool:
    if is_leaf is not None and is_leaf(tree):
        return False
    return isinstance(tree, (dict, list, tuple))


def leaves_with_path(tree, is_leaf: Callable[[Any], bool] = None
                     ) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree`` order."""
    if not _is_node(tree, is_leaf):
        yield (), tree
        return
    for key, child in _children(tree):
        for path, leaf in leaves_with_path(child, is_leaf):
            yield (key, *path), leaf


def leaves(tree, is_leaf: Callable[[Any], bool] = None) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf)]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable[[Any], bool] = None):
    """``fn`` over the leaves of `tree` and the matching leaves of `rest`,
    in a tree of `tree`'s structure."""
    if not _is_node(tree, is_leaf):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    out = [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
           for i, t in enumerate(tree)]
    return tuple(out) if isinstance(tree, tuple) else out


def unflatten_like(template, new_leaves: List[Any]):
    """A tree of `template`'s structure holding `new_leaves` in leaf order."""
    it = iter(new_leaves)
    order = [path for path, _ in leaves_with_path(template)]
    by_path = {path: next(it) for path in order}
    return _rebuild(template, (), by_path)


def _rebuild(tree, prefix, by_path):
    if not _is_node(tree, None):
        return by_path[prefix]
    if isinstance(tree, dict):
        return {k: _rebuild(v, (*prefix, k), by_path) for k, v in tree.items()}
    out = [_rebuild(v, (*prefix, i), by_path) for i, v in enumerate(tree)]
    return tuple(out) if isinstance(tree, tuple) else out
