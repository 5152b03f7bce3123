"""Trees of tensors (nested dicts, lists and tuples) in JAX's leaf order.

The train state is the reference's pytree: ``{"params": …, "opt": {"m",
"v", "step"}, ["err_fb"]}``. JAX flattens a dict by its sorted keys, so
``item`` comes before ``user`` and ``table`` before ``w0``; the global
norm, the update and the checkpoint names all walk the leaves in that one
order, through ``flatten``. ``None`` holds no leaf, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(node):
    """(key, child) pairs of a dict or sequence in JAX's order, else None."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _walk(node, path, out):
    # Module-level recursion: a recursive closure would form a reference
    # cycle that keeps ``out`` (and its leaves, e.g. 10 GB gradients)
    # alive until the cyclic collector runs.
    if node is None:
        return
    children = _children(node)
    if children is None:
        out.append(("/".join(path), node))
        return
    for k, v in children:
        _walk(v, path + [str(k)], out)


def flatten(tree) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in JAX's order; a path joins the dict keys and
    sequence indices with ``/`` (the checkpoint's leaf names)."""
    out: list[tuple[str, Any]] = []
    _walk(tree, [], out)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` in JAX's order."""
    it = iter(new_leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees shaped like it."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
