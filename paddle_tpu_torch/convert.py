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

For host-RAM sparse tables, ``table_from_snapshot(snapshot, table)`` installs
a ``HostSparseTable.snapshot()`` of either package (``(rows, {"param",
"slot_*"}, meta)``, all numpy) into the other's table through
``adopt_rows``, and ``table_snapshot(table)`` takes one: a JAX table's
snapshot adopted by a port table (or back) leaves both holding the same
live rows and moment slots, bit for bit.
"""

import numpy as np
import torch

from ._tree import tree_map

__all__ = ["params_from_numpy", "params_to_numpy", "scope_from_numpy",
           "scope_to_numpy", "table_snapshot", "table_from_snapshot"]


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


def table_snapshot(table):
    """``(rows, arrays, meta)`` of a host-RAM sparse table of either
    package (a ``HostPSEmbedding`` hands over its table)."""
    return getattr(table, "table", table).snapshot()


def table_from_snapshot(snapshot, table):
    """Install a ``table_snapshot`` into ``table`` (either package's
    ``HostSparseTable``, or an embedding over one) verbatim: the rows
    become live with their values and moment slots.  The two tables must
    have the same vocabulary, width and optimizer slots.  Returns the
    number of rows installed."""
    rows, arrays, meta = snapshot
    t = getattr(table, "table", table)
    if (int(meta["vocab_size"]), int(meta["dim"])) != (t.vocab_size, t.dim):
        raise ValueError(
            "table_from_snapshot: snapshot is [%s x %s], table %r is "
            "[%d x %d]" % (meta["vocab_size"], meta["dim"], t.name,
                           t.vocab_size, t.dim))
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    install = getattr(table, "install_rows", None)
    if install is not None:
        return install(np.asarray(rows, np.int64), arrays)
    return t.adopt_rows(np.asarray(rows, np.int64), arrays)
