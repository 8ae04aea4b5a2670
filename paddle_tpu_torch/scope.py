"""Scope: name -> value store (parity: framework/scope.h:46).

The reference Scope owns Variables holding LoDTensors; here a Scope is a flat
dict of name -> ``torch.Tensor``, with parent-chain lookup like
Scope::FindVar.  A copy of the JAX package's ``scope.py`` with tensors in
place of jax arrays.  Where the JAX scope holds an array sharded over a
mesh, this one holds the rank's part and marks the name: its rows
(``set(..., row_shards=n, rows_group=g)``, kReduce's accumulators over the
data group) and its block of a tensor-parallel split (``split=(dim, n,
group)``, over the model group).  ``find_global`` gathers the global value,
a collective every rank of those groups calls, as does
``find_tensor_as_numpy`` for a split var; ``local_shape`` is the shape this
rank holds.
"""

import contextlib

import numpy as np
import torch


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self._row_shards = {}
        self._splits = {}
        self.parent = parent
        self.kids = []

    def var(self, name):
        """Find-or-create (parity: Scope::Var)."""
        if name not in self._vars:
            self._vars[name] = None
        return name

    def set(self, name, value, row_shards=1, rows_group=None, split=None):
        """``row_shards`` > 1: ``value`` is this rank's 1/row_shards of the
        var's rows (rank order over ``rows_group``, the world's when None).
        ``split``: ``(dim, n, group)``, ``value`` is this rank's 1/n block
        of ``dim`` (rank order over ``group``)."""
        self._vars[name] = value
        if row_shards > 1:
            self._row_shards[name] = (int(row_shards), rows_group)
        else:
            self._row_shards.pop(name, None)
        if split is not None and split[1] > 1:
            self._splits[name] = tuple(split)
        else:
            self._splits.pop(name, None)

    def _owner(self, name):
        scope = self
        while scope is not None:
            if name in scope._vars:
                return scope
            scope = scope.parent
        return None

    def row_shards(self, name):
        """Into how many ranks' rows the var found by ``find_var`` is cut
        (1: the whole value)."""
        scope = self._owner(name)
        if scope is None or name not in scope._row_shards:
            return 1
        return scope._row_shards[name][0]

    def split(self, name):
        """``(dim, n)`` of a var held as this rank's block of a
        tensor-parallel split, else None."""
        scope = self._owner(name)
        if scope is None or name not in scope._splits:
            return None
        return scope._splits[name][:2]

    def local_shape(self, name):
        """The shape of the part of the var this rank holds."""
        v = self.find_var(name)
        return None if v is None else tuple(v.shape)

    def find_global(self, name):
        """The var's global value: a row-sharded var's rows gathered over
        its group, a split var's blocks gathered over its model group
        (collectives every rank of those groups calls)."""
        import torch.distributed as dist

        from .parallel.collectives import backend_all_gather

        v = self.find_var(name)
        scope = self._owner(name)
        if v is None or scope is None:
            return v
        rows = scope._row_shards.get(name)
        split = scope._splits.get(name)
        if rows is not None:
            n, group = rows
            group = group if group is not None else (
                dist.group.WORLD if dist.is_initialized() else None)
            if group is None or dist.get_world_size(group) != n:
                raise RuntimeError(
                    "var %r holds 1/%d of its rows and its group has %s "
                    "ranks" % (name, n, "no" if group is None
                               else dist.get_world_size(group)))
            v = backend_all_gather(v.contiguous(), group, 0)
        if split is not None:
            dim, n, group = split
            v = backend_all_gather(v.contiguous(), group, dim)
        return v

    def find_var(self, name):
        scope = self
        while scope is not None:
            if name in scope._vars:
                return scope._vars[name]
            scope = scope.parent
        return None

    def has_var(self, name):
        scope = self
        while scope is not None:
            if name in scope._vars:
                return True
            scope = scope.parent
        return False

    def new_scope(self):
        kid = Scope(parent=self)
        self.kids.append(kid)
        return kid

    def drop_kids(self):
        self.kids = []

    def local_var_names(self):
        return list(self._vars.keys())

    def erase(self, names):
        for n in names:
            self._vars.pop(n, None)
            self._row_shards.pop(n, None)
            self._splits.pop(n, None)

    def find_tensor_as_numpy(self, name):
        """The value as a numpy array on the host (bf16 as float32, which
        holds it exactly, since numpy has no bfloat16); a tensor-parallel
        split var gathered whole (``find_global``), a kReduce one as this
        rank's rows."""
        v = self.find_var(name)
        if self.split(name) is not None:
            v = self.find_global(name)
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        return np.asarray(v)


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old
