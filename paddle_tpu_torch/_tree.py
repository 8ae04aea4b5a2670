"""Trees of tensors (nested dicts and lists): the port's stand-in for
``jax.tree`` over the parameter and optimizer-state trees.  Leaves go in
``jax.tree``'s order: lists by index, dicts by sorted key."""

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves in a fixed order: lists by index, dicts by sorted key."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]
