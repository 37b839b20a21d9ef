"""Params trees: nested dicts and lists of tensors, walked as JAX walks a
pytree (dict keys sorted, list items in order), so a leaf's path and the
order of the leaves are the reference's."""
from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def leaves_with_path(tree, prefix: str = "") -> list:
    """[(path, leaf)]: the path joins keys and list indices with "/", as
    the reference's checkpoint keys do."""
    out = []
    for k, v in _children(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.extend(leaves_with_path(v, path))
        else:
            out.append((path, v))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(like, new_leaves) -> object:
    """``like``'s structure with its leaves replaced, in ``leaves`` order."""
    return _build(like, iter(new_leaves))


def _build(t, it):
    # a module function, not a closure that calls itself: that closure
    # would be a reference cycle holding ``it``, and with it the leaves,
    # until the cycle collector ran
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}          # the caller's key order
    if isinstance(t, (list, tuple)):
        return [_build(v, it) for v in t]
    return next(it)


def tree_map(fn, tree, *rest) -> object:
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])
