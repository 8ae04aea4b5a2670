"""Scope: name -> value store (parity: framework/scope.h:46).

The reference Scope owns Variables holding LoDTensors; here a Scope is a flat
dict of name -> ``torch.Tensor``, with parent-chain lookup like
Scope::FindVar.  A copy of the JAX package's ``scope.py`` with tensors in
place of jax arrays.  Where the JAX scope holds an array sharded over a
mesh, this one holds the rank's rows and marks the name (``set(...,
row_shards=n)``, kReduce's accumulators): ``find_global`` gathers the
global value, a collective every rank of the world calls.
"""

import contextlib

import numpy as np
import torch


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self._row_shards = {}
        self.parent = parent
        self.kids = []

    def var(self, name):
        """Find-or-create (parity: Scope::Var)."""
        if name not in self._vars:
            self._vars[name] = None
        return name

    def set(self, name, value, row_shards=1):
        """``row_shards`` > 1: ``value`` is this rank's 1/row_shards of the
        var's rows (rank order over the world)."""
        self._vars[name] = value
        if row_shards > 1:
            self._row_shards[name] = int(row_shards)
        else:
            self._row_shards.pop(name, None)

    def row_shards(self, name):
        """Into how many ranks' rows the var found by ``find_var`` is cut
        (1: the whole value)."""
        scope = self
        while scope is not None:
            if name in scope._vars:
                return scope._row_shards.get(name, 1)
            scope = scope.parent
        return 1

    def find_global(self, name):
        """The var's global value: a row-sharded var's rows gathered from
        every rank (a collective over the world)."""
        v = self.find_var(name)
        n = self.row_shards(name)
        if n == 1 or v is None:
            return v
        import torch.distributed as dist

        from .parallel.collectives import backend_all_gather

        if not dist.is_initialized() or dist.get_world_size() != n:
            raise RuntimeError(
                "var %r holds 1/%d of its rows and the world has %s ranks"
                % (name, n, dist.get_world_size() if dist.is_initialized()
                   else "no"))
        return backend_all_gather(v.contiguous(), dist.group.WORLD, 0)

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

    def find_tensor_as_numpy(self, name):
        """The value as a numpy array on the host (bf16 as float32, which
        holds it exactly, since numpy has no bfloat16)."""
        v = self.find_var(name)
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
