"""Trees of tensors: nested dicts, lists and tuples, the port's pytrees.

Leaves are visited in the JAX package's order (``jax.tree_util``): dict
keys sorted, sequences by position, ``None`` and empty containers holding
no leaf. ``flatten_with_paths`` names each leaf by its path the way
``jax.tree_util.tree_flatten_with_path`` prints it (``['params']/[0]``),
so a checkpoint's manifest reads the same in both packages.

``nest`` / ``unnest`` turn a module's dotted parameter names
(``layers.0.w``) into a nested dict (``{"layers": {"0": {"w": ...}}}``)
and back.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Mapping, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    return [(f"[{i}]", v) for i, v in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """Every leaf with its path key, in leaf order."""
    out: List[Tuple[str, Any]] = []

    def walk(t, prefix: str) -> None:
        if t is None:
            return
        if not _is_node(t):
            out.append((prefix, t))
            return
        for key, child in _children(t):
            walk(child, f"{prefix}/{key}" if prefix else key)

    walk(tree, "")
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in leaf order."""
    it: Iterator = iter(leaves)

    def build(t):
        if t is None:
            return None
        if not _is_node(t):
            return next(it)
        if isinstance(t, dict):
            return type(t)((k, build(t[k])) for k in sorted(t))
        return type(t)(build(v) for v in t)

    return build(like)


def tree_map(fn: Callable, tree) -> Any:
    """``fn`` over the leaves of ``tree``, in a tree of its structure."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def nest(flat: Mapping[str, Any], sep: str = ".") -> dict:
    """Dotted names to a nested dict."""
    out: dict = {}
    for name, v in flat.items():
        node = out
        *head, last = name.split(sep)
        for part in head:
            node = node.setdefault(part, {})
        node[last] = v
    return out


def unnest(tree: Mapping, sep: str = ".") -> Dict[str, Any]:
    """A nested dict to dotted names (the inverse of ``nest``)."""
    out: Dict[str, Any] = {}

    def walk(t, prefix: str) -> None:
        for k, v in t.items():
            name = f"{prefix}{sep}{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, name)
            else:
                out[name] = v

    walk(tree, "")
    return out


__all__ = ["flatten_with_paths", "tree_leaves", "tree_unflatten", "tree_map", "nest", "unnest"]
