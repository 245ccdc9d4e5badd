"""Nested containers of tensors (params, optimizer state, checkpoints):
dicts, lists and tuples, flattened in ``jax.tree_util``'s order (dict keys
sorted) so that both packages name and order the leaves alike."""
from __future__ import annotations

from typing import Any, Callable, Dict, List


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Slash-joined key paths -> leaves, in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        children = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        children = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix[:-1]: tree}
    flat = {}
    for k, v in children:
        flat.update(flatten(v, f"{prefix}{k}/"))
    return flat


def leaves(tree) -> List[Any]:
    return list(flatten(tree).values())


def map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of trees of one structure, into that
    structure."""
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(template, flat: Dict[str, Any], prefix: str = ""):
    """The leaves of ``flat`` (key path -> leaf) in ``template``'s
    structure."""
    if isinstance(template, dict):
        return {k: unflatten(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"missing leaf {key!r}")
    return flat[key]
