"""The port's pytrees: nested tuples, lists, dicts and dataclasses whose
leaves are tensors (or anything else that is none of those containers).

One walker serves the checkpoint (`runtime/checkpoint.py`) and the
scenario split (`parallel/sharding.py`).  Leaves come in the JAX
package's key-path order and spelling: ``[i]`` for tuples and lists,
``['k']`` for dict keys (sorted), ``.name`` for dataclass fields.
"""

from __future__ import annotations

import dataclasses


def flatten_with_path(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` in key-path order."""
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in flatten_with_path(v, f"{prefix}[{i}]")]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in flatten_with_path(getattr(tree, f.name),
                                           f"{prefix}.{f.name}")]
    return [(prefix, tree)]


def unflatten(template, leaves):
    """``template``'s structure with its leaves replaced, in order, from
    the iterator ``leaves``."""
    if isinstance(template, (tuple, list)):
        return type(template)(unflatten(v, leaves) for v in template)
    if isinstance(template, dict):
        return {k: unflatten(template[k], leaves) for k in sorted(template)}
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    return next(leaves)


def tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    return unflatten(tree, (fn(leaf) for _, leaf in flatten_with_path(tree)))
