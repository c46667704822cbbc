"""Parameter trees (port of the parts of ``repro/utils/trees.py`` the
port needs): nested dicts and lists of tensors, walked in the
reference's leaf order (``jax.tree.flatten`` sorts dict keys), and
flattened to 'a/#0/b' paths for checkpoints."""

from __future__ import annotations

from typing import Any, Callable, Mapping


def leaves(tree: Any) -> list:
    """The leaves in the reference's order: dict keys sorted, lists in
    order."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten_like(tree: Any, flat: list) -> Any:
    """``tree``'s structure with its leaves replaced, in ``leaves``'s
    order, by ``flat``."""
    it = iter(flat)

    def rec(node):
        if isinstance(node, Mapping):
            done = {k: rec(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return next(it)
    out = rec(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    return unflatten_like(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves(r) for r in rest))])


def flatten_dict(tree: Mapping[str, Any], sep: str = "/") -> dict:
    """Nested dicts AND lists -> {path: leaf}; list indices become '#<i>'
    segments so ``unflatten_dict`` rebuilds lists."""
    out: dict = {}

    def rec(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                rec(f"{prefix}{sep}{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}{sep}#{i}" if prefix else f"#{i}", v)
        else:
            out[prefix] = node

    rec("", tree)
    return out


def unflatten_dict(flat: Mapping[str, Any], sep: str = "/") -> dict:
    """Inverse of ``flatten_dict``."""
    out: dict = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def fix(node):
        if isinstance(node, dict):
            if node and all(k.startswith("#") for k in node):
                return [fix(node[f"#{i}"]) for i in range(len(node))]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(out)


def tree_map_with_name(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a tree, ``path`` as the reference's
    ``tree_map_with_name`` renders it: dict keys and list indices joined
    by '/' ('blocks/attn/wq', 'layers/0/w')."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, Mapping):
        return {k: tree_map_with_name(fn, v, join(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_name(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
