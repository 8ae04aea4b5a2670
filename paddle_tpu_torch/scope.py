"""Scope: name -> value store (parity: framework/scope.h:46).

The reference Scope owns Variables holding LoDTensors; here a Scope is a flat
dict of name -> ``torch.Tensor``, with parent-chain lookup like
Scope::FindVar.  A copy of the JAX package's ``scope.py`` with tensors in
place of jax arrays.
"""

import contextlib

import numpy as np
import torch


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self.parent = parent
        self.kids = []

    def var(self, name):
        """Find-or-create (parity: Scope::Var)."""
        if name not in self._vars:
            self._vars[name] = None
        return name

    def set(self, name, value):
        self._vars[name] = value

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
