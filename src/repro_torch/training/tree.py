"""Trees of tensors: nested dicts, tuples, lists and NamedTuples.

The port's counterpart of the `jax.tree_util` calls the training code
makes. Leaves come in JAX's order (dict keys sorted, sequences and
NamedTuple fields in order) and carry JAX's path entries (a dict key, a
sequence index, a NamedTuple field name), so `path_key` names a leaf as
the JAX package's checkpoints do (`0/embed`, `1/m/layers/attn/wq`).
None is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_paths(tree[k], path + (k,))]
    if _is_namedtuple(tree):
        return [pl for name, v in zip(tree._fields, tree)
                for pl in leaves_with_paths(v, path + (name,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_paths(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_key(path: Path) -> str:
    return "/".join(str(p) for p in path)


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like `like` whose leaves, in flatten order, are
    `new_leaves`."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            # sorted, so leaves land in flatten order; the dict keeps it
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure)."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def is_axes(v) -> bool:
    """A logical-axes leaf: a tuple of axis names and Nones."""
    return isinstance(v, tuple) and not _is_namedtuple(v) and all(
        isinstance(x, (str, type(None))) for x in v)


def map_axes(fn: Callable, tree) -> Any:
    """fn over the logical-axes leaves of `tree` (dicts, sequences and
    NamedTuples of axes tuples), as `jax.tree.map` with the axes tuples
    as leaves."""
    if is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_axes(fn, v) for v in tree))
    return type(tree)(map_axes(fn, v) for v in tree)
