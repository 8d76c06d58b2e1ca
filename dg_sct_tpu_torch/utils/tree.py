"""Nested dicts and lists of tensors (the port's parameter, state and
optimizer trees), walked in the JAX package's leaf order: dict keys sorted,
list items in order."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (and the same leaves of each tree in
    `rest`), keeping the structure of `tree`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_paths(tree, prefix=()):
    """[(path, leaf)] in leaf order; a path is the tuple of keys and indices."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in tree_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(template, leaves):
    """`template`'s structure with `leaves` hung on it in leaf order."""
    leaves = list(leaves)
    n = len(tree_paths(template))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a template of {n}")
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(template)
