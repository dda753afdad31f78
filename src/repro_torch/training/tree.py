"""Parameter trees: nested dicts, lists and tuples whose leaves are tensors
(or numbers and numpy arrays).

Leaves are visited in the reference's order, ``jax.tree_util``'s: a dict's
keys sorted, a list's or tuple's items in order; ``None`` is an empty
subtree.  A leaf's path is spelled as ``jax.tree_util.keystr`` spells it
(``[0]['layers']['wq']``), so a checkpoint's manifest names the same leaves
in the same order in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree):
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Every leaf of ``tree`` with its path, in the reference's order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pl for key, sub in kids for pl in leaves_with_paths(sub, prefix + key)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def leaves_like(tree, like) -> list:
    """The subtrees of ``tree`` at the places of ``like``'s leaves, in the
    reference's order (a compressed gradient's payload tuples, say)."""
    if like is None:
        return []
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in leaves_like(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [s for i in range(len(like)) for s in leaves_like(tree[i], like[i])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every leaf of ``tree`` (and the leaves at the same place in
    each of ``rest``, which have its structure); the structure is kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with ``new_leaves`` (in the reference's order) in
    place of its leaves."""
    it = iter(new_leaves)
    end = object()

    def rebuild(t):
        if t is None:
            return None
        if isinstance(t, dict):
            vals = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [rebuild(v) for v in t]
            return out if isinstance(t, list) else tuple(out)
        leaf = next(it, end)
        if leaf is end:
            raise ValueError("fewer leaves than the tree has")
        return leaf

    out = rebuild(like)
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree has")
    return out
