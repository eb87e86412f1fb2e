"""Helpers for the nested dicts of tensors that hold parameters (the
port's counterpart of a JAX pytree; leaves in insertion order)."""

from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves(tree: Any) -> Iterator[Any]:
    """Every leaf of a nested dict, depth first in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """The same nested dict with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_to(tree: Any, device) -> Any:
    """Every tensor leaf moved to ``device``."""
    return tree_map(lambda t: t.to(device), tree)
