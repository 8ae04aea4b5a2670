"""Parameter trees and scopes between the JAX package's numpy form and the
port.

``params_from_numpy(jax.tree.map(np.asarray, params), device)`` gives the
port the JAX package's exact values (bf16 bit for bit), which is how the
parity tests run both sides on the same weights.  ``params_to_numpy`` goes
back; bf16 leaves come back as float32 arrays (lossless), since numpy has no
bfloat16 of its own.

For Fluid programs, ``scope_from_numpy(values, scope, device)`` loads
``{name: array}`` (for example every persistable of a JAX startup run, read
with ``scope.find_tensor_as_numpy``) into a port ``Scope``, and
``scope_to_numpy(scope, names)`` reads them back, so both executors start
from the same weights.
"""

import numpy as np
import torch

from ._tree import tree_map

__all__ = ["params_from_numpy", "params_to_numpy", "scope_from_numpy",
           "scope_to_numpy"]


def _leaf_from_numpy(a, device):
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16, as JAX hands it out
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree, device):
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def params_to_numpy(tree):
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, tree)


def scope_from_numpy(values, scope, device):
    """Set each ``name: array`` of ``values`` in ``scope`` as a tensor on
    ``device``; returns the scope."""
    device = torch.device(device)
    for name, a in values.items():
        scope.var(name)
        scope.set(name, _leaf_from_numpy(a, device))
    return scope


def scope_to_numpy(scope, names):
    """``{name: numpy array}`` of the named values in ``scope``."""
    return {n: scope.find_tensor_as_numpy(n) for n in names}
