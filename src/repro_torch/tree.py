"""Nested containers of tensors (the port's pytrees): dicts, visited in
sorted-key order as ``jax.tree`` visits them, lists, tuples and named
tuples (``train.optimizer.Q8``); anything else is a leaf.  The param tree
of ``models.model.init_params``, the optimizer state and a checkpoint's
tree are such containers.

``flatten`` gives the leaves and a JSON-able description of the
structure, which ``unflatten`` rebuilds; checkpoints store it in their
manifest."""
from __future__ import annotations


def _named():
    from repro_torch.train.optimizer import Q8   # no tree -> train cycle
    return {"Q8": Q8}


def flatten(tree, is_leaf=None) -> tuple[list, object]:
    """(leaves, spec) of ``tree``; ``is_leaf(x)`` true keeps a container
    whole as one leaf."""
    leaves: list = []
    return leaves, _walk(tree, leaves, is_leaf)


# Module-level recursion: a nested function that calls itself is a
# reference cycle (the function and its closure cell), which would keep
# the leaves alive until the cyclic garbage collector ran, the previous
# train step's gathered weights among them.
def _walk(x, leaves: list, is_leaf):
    if is_leaf is not None and is_leaf(x):
        leaves.append(x)
        return None
    if isinstance(x, dict):
        return {"dict": [[k, _walk(x[k], leaves, is_leaf)]
                         for k in sorted(x)]}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {"named": type(x).__name__,
                "items": [_walk(v, leaves, is_leaf) for v in x]}
    if isinstance(x, (list, tuple)):
        return {type(x).__name__: [_walk(v, leaves, is_leaf) for v in x]}
    leaves.append(x)
    return None


def unflatten(spec, leaves: list):
    """The tree of ``spec`` with ``leaves`` in flatten's order."""
    it = iter(leaves)
    out = _build(spec, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return out


def _build(sp, it):
    if sp is None:
        return next(it)
    if "dict" in sp:
        return {k: _build(v, it) for k, v in sp["dict"]}
    if "named" in sp:
        return _named()[sp["named"]](*(_build(v, it) for v in sp["items"]))
    if "list" in sp:
        return [_build(v, it) for v in sp["list"]]
    return tuple(_build(v, it) for v in sp["tuple"])


def leaves(tree, is_leaf=None) -> list:
    return flatten(tree, is_leaf)[0]


def map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``, trees of the same structure), in a tree of its structure."""
    flat, spec = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])
