"""Nested containers of tensors ("trees"), walked in one fixed order.

The reference walks its params, optimizer state and checkpoints with
``jax.tree``; the port's trees are plain Python containers, and this module
is their one walker.  The order of the leaves, which the optimizer, the
checkpoint files and the gradient lists all follow, is:

  * a dict: its values by sorted key (as ``jax.tree`` orders dicts);
  * a NamedTuple: its fields in declaration order;
  * a list or tuple: its items in order;
  * None: no leaf (an empty subtree, as in ``jax.tree``);
  * anything else (a tensor, a numpy array, a Python number): one leaf.

So the port's params ``{"blocks": {"layers": [...]}, "embed", "final_norm",
["lm_head"]}`` flatten as blocks (layer 0's leaves first), embed,
final_norm, lm_head.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> List[Any]:
    """Every leaf of ``tree``, in the module's order."""
    out: List[Any] = []

    def walk(t):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            out.append(t)

    walk(tree)
    return out


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped as ``like`` whose leaves are ``leaves``, in order."""
    it: Iterator = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}  # keep the caller's key order
        if _is_namedtuple(t):
            return type(t)(*[build(v) for v in t])
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` (same
    structure), in a tree shaped as ``tree``."""
    others = [tree_leaves(r) for r in rest]
    leaves = tree_leaves(tree)
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees of different structures")
    return tree_unflatten(tree, [fn(*args) for args in zip(leaves, *others)])


def tree_structure(tree) -> str:
    """A text of the tree's containers (keys, lengths, NamedTuple types),
    leaves as ``*``: what a checkpoint's ``meta.json`` records."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {tree_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={tree_structure(v)}" for f, v in zip(tree._fields, tree)) \
            + ")"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(tree_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"
