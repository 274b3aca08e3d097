"""Parameter trees in JAX's pytree order, for trees of tensors or arrays.

Dict keys are walked **sorted** (JAX flattens dicts by sorted key;
``torch.utils._pytree`` keeps insertion order, which would move every wire
byte and every checkpoint leaf), lists and tuples in order, a NamedTuple
as its fields, ``None`` as an empty subtree, anything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in pytree order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    if tree is None:
        return []
    return [tree]


def named_leaves(tree: Any, prefix: tuple = ()) -> Iterator[tuple[str, Any]]:
    """``(name, leaf)`` in pytree order, each name the ``/``-joined path
    the reference's checkpointer gives (dict key, list index, NamedTuple
    field name)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from named_leaves(tree[key], prefix + (str(key),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, sub in zip(tree._fields, tree):
            yield from named_leaves(sub, prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from named_leaves(sub, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def rebuild(template: Any, leaves: Iterator) -> Any:
    """A tree shaped like ``template`` whose leaves come from ``leaves``,
    consumed in :func:`tree_leaves` order."""
    if isinstance(template, dict):
        out = {key: rebuild(template[key], leaves)
               for key in sorted(template)}
        return {key: out[key] for key in template}
    if isinstance(template, (list, tuple)):
        items = [rebuild(sub, leaves) for sub in template]
        if isinstance(template, list):
            return items
        if hasattr(template, "_fields"):          # namedtuple
            return type(template)(*items)
        return type(template)(items)
    if template is None:
        return None
    return next(leaves)


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` applied leafwise across trees shaped like ``trees[0]``."""
    groups = zip(*(tree_leaves(t) for t in trees))
    return rebuild(trees[0], iter([fn(*group) for group in groups]))
