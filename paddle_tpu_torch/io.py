"""Checkpoint / model IO (parity: python/paddle/fluid/io.py —
save_vars :149 / save_params :273 / save_persistables :523, load_* :588-801,
save_inference_model :1011, load_inference_model :1215).

The counterpart of the JAX package's ``io.py``, in the same file format, so
that a directory either package writes loads into the other: whole tensors
as ``.npy`` files or one ``.npz`` container (``__params__.npz`` beside an
inference model, ``<path>.pdparams`` for ``save``), and the program as a
pickle of plain data (dicts, lists, strings and numbers: no class of either
package).  Scope values are tensors here; they go to numpy on the host to
be written, and come back as tensors on the executor's device (the CPU when
no executor is given; the executor moves them on its first run).

numpy has no bfloat16, and the port writes no format of its own, so a
bfloat16 value raises: bf16 persistables come with AMP (ROADMAP Queue 1
item 3, amp.py).
"""

import os
import pickle

import numpy as np
import torch

from .framework import Program, Parameter, Variable, default_main_program
from .scope import global_scope

__all__ = [
    "save",
    "load",
    "save_vars",
    "save_params",
    "save_persistables",
    "load_vars",
    "load_params",
    "load_persistables",
    "save_inference_model",
    "load_inference_model",
    "save_sparse_shards",
    "load_sparse_shards",
    "load_sparse_meta",
]


def _is_persistable(var):
    return var.persistable and not var.is_data


def _is_parameter(var):
    return isinstance(var, Parameter)


def _to_numpy(name, value):
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            raise NotImplementedError(
                "%s is bfloat16, which numpy (and so the .npy/.npz format "
                "shared with the JAX package) cannot hold: bf16 persistables "
                "wait (ROADMAP Queue 1 item 3, amp.py)" % name)
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _device_of(executor):
    return executor.device if executor is not None else torch.device("cpu")


def _to_tensor(array, device):
    return torch.from_numpy(np.array(array)).to(device)


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars() if predicate(v)]
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    if filename is not None:
        arrays = {}
        for v in vars:
            val = scope.find_var(v.name)
            if val is not None:
                arrays[v.name] = _to_numpy(v.name, val)
        np.savez(os.path.join(dirname, filename), **arrays)
    else:
        for v in vars:
            val = scope.find_var(v.name)
            if val is None:
                continue
            np.save(os.path.join(dirname, v.name + ".npy"),
                    _to_numpy(v.name, val))


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program, predicate=_is_parameter,
                     filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program, predicate=_is_persistable,
                     filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None, scope=None):
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars() if predicate(v)]
    scope = scope if scope is not None else global_scope()
    device = _device_of(executor)
    if filename is not None:
        with np.load(os.path.join(dirname, filename)) as data:
            for v in vars:
                if v.name in data:
                    scope.var(v.name)
                    scope.set(v.name, _to_tensor(data[v.name], device))
    else:
        for v in vars:
            path = os.path.join(dirname, v.name + ".npy")
            if os.path.exists(path):
                scope.var(v.name)
                scope.set(v.name, _to_tensor(np.load(path), device))


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return load_vars(executor, dirname, main_program, predicate=_is_parameter,
                     filename=filename, scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return load_vars(executor, dirname, main_program, predicate=_is_persistable,
                     filename=filename, scope=scope)


def save_inference_model(
    dirname,
    feeded_var_names,
    target_vars,
    executor,
    main_program=None,
    model_filename=None,
    params_filename=None,
    export_for_deployment=True,
):
    """Parity: io.py:1011 — prunes the program to the fetch targets, strips
    train-only ops, and saves program + params.  The pruning is the JAX
    package's ``Program._prune``, which walks the global block only: a var
    that only a sub-block reads is pruned away with its producer, as there
    (ROADMAP Queue 3)."""
    main_program = main_program or default_main_program()
    pruned = main_program._prune(target_vars)
    os.makedirs(dirname, exist_ok=True)
    model_path = os.path.join(dirname, model_filename or "__model__")
    payload = {
        "program": _program_to_desc(pruned),
        "feed_names": list(feeded_var_names),
        "fetch_names": [t.name if isinstance(t, Variable) else t for t in target_vars],
    }
    with open(model_path, "wb") as f:
        pickle.dump(payload, f)
    save_persistables(executor, dirname, main_program,
                      filename=params_filename or "__params__.npz")
    return payload["fetch_names"]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """Parity: io.py:1215 — returns (program, feed_names, fetch_vars)."""
    model_path = os.path.join(dirname, model_filename or "__model__")
    with open(model_path, "rb") as f:
        payload = pickle.load(f)
    program = _desc_to_program(payload["program"])
    load_persistables(executor, dirname, program,
                      filename=params_filename or "__params__.npz", scope=scope)
    block = program.global_block()
    fetch_vars = [block.vars[n] for n in payload["fetch_names"]]
    return program, payload["feed_names"], fetch_vars


# -- host sparse-table shards ------------------------------------------------
#
# Checkpoint format for host-RAM tables: only the initialized rows are
# written, in fixed-size row blocks, so a multi-GiB table never needs a
# second full-size buffer on save or load.  Layout: <name>.sparse.meta
# (pickle: vocab/dim/arrays/shard count) + <name>.sparse.<k>.npz per block,
# each holding "rows" plus one entry per named array (param + optimizer
# moment slots).  numpy throughout, as in the JAX package.

def save_sparse_shards(dirname, name, rows, arrays, meta=None,
                       rows_per_shard=1 << 20):
    """Write a (rows, {array_name: [N, ...] values}) sparse snapshot in row
    blocks.  Returns the number of shard files written."""
    rows = np.asarray(rows)
    os.makedirs(dirname, exist_ok=True)
    n = int(rows.shape[0])
    starts = list(range(0, n, int(rows_per_shard))) if n else []
    for k, start in enumerate(starts):
        sl = slice(start, start + int(rows_per_shard))
        np.savez(os.path.join(dirname, "%s.sparse.%05d.npz" % (name, k)),
                 rows=rows[sl],
                 **{a: np.asarray(arrays[a][sl]) for a in arrays})
    # the meta file is the loader's commit point: written LAST so a crash
    # mid-save leaves a snapshot load_sparse_shards refuses (no meta), never
    # a torn one it would accept
    payload = {
        "name": name,
        "num_rows": n,
        "num_shards": len(starts),
        "arrays": sorted(arrays),
        "meta": dict(meta or {}),
    }
    with open(os.path.join(dirname, name + ".sparse.meta"), "wb") as f:
        pickle.dump(payload, f)
    return len(starts)


def load_sparse_meta(dirname, name):
    with open(os.path.join(dirname, name + ".sparse.meta"), "rb") as f:
        return pickle.load(f)


def load_sparse_shards(dirname, name):
    """Yield (rows, {array_name: values}) one shard at a time (streaming, so
    restore never materializes the full table twice)."""
    meta = load_sparse_meta(dirname, name)
    for k in range(meta["num_shards"]):
        with np.load(os.path.join(
                dirname, "%s.sparse.%05d.npz" % (name, k))) as z:
            yield z["rows"], {a: z[a] for a in meta["arrays"]}


# -- program (de)serialization ----------------------------------------------

def _program_to_desc(program):
    """Plain-data description of a Program (the ProgramDesc analogue)."""
    blocks = []
    for b in program.blocks:
        vars_ = {
            name: {
                "shape": list(v.shape),
                "dtype": v.dtype,
                "persistable": v.persistable,
                "stop_gradient": v.stop_gradient,
                "is_data": v.is_data,
                "is_parameter": isinstance(v, Parameter),
            }
            for name, v in b.vars.items()
        }
        ops = [
            {"type": op.type, "inputs": op.inputs, "outputs": op.outputs, "attrs": op.attrs}
            for op in b.ops
        ]
        blocks.append({"idx": b.idx, "parent_idx": b.parent_idx, "vars": vars_, "ops": ops})
    return {"blocks": blocks, "random_seed": program.random_seed}


def _desc_to_program(desc):
    from .framework import Block, Operator

    program = Program()
    program.random_seed = desc.get("random_seed", 0)
    program.blocks = []
    for bd in desc["blocks"]:
        b = Block(program, bd["idx"], bd["parent_idx"])
        for name, vd in bd["vars"].items():
            if vd.get("is_parameter"):
                v = Parameter(b, shape=vd["shape"], dtype=vd["dtype"])
                v.name = name
                v.persistable = True
            else:
                v = Variable(b, name=name, shape=vd["shape"], dtype=vd["dtype"],
                             persistable=vd["persistable"],
                             stop_gradient=vd["stop_gradient"], is_data=vd["is_data"])
            b.vars[name] = v
        for od in bd["ops"]:
            op = Operator(b, od["type"], attrs=od["attrs"])
            op.inputs = {k: list(v) for k, v in od["inputs"].items()}
            op.outputs = {k: list(v) for k, v in od["outputs"].items()}
            b.ops.append(op)
        program.blocks.append(b)
    program._bump_version()
    return program


def save(program, model_path):
    """Parity: io.py:1493 fluid.save — every persistable of `program` into
    one npz at `model_path` + ".pdparams"."""
    scope = global_scope()
    arrays = {}
    for var in program.list_vars():
        if var.persistable and scope.find_var(var.name) is not None:
            arrays[var.name] = _to_numpy(var.name, scope.find_var(var.name))
    path = model_path + ".pdparams"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)      # exact filename (np.savez would add .npz)
    return path


def load(program, model_path, executor=None, var_list=None):
    """Parity: io.py:1547 fluid.load — restore persistables saved by save().
    Raises when a requested variable is missing from the checkpoint (the
    reference errors rather than silently keeping fresh-init values)."""
    path = model_path + ".pdparams"
    if not os.path.exists(path):
        path = path + ".npz"          # older dumps via bare np.savez
    scope = global_scope()
    names = ({v.name for v in var_list} if var_list
             else {v.name for v in program.list_vars() if v.persistable})
    device = _device_of(executor)
    with np.load(path) as data:
        missing = sorted(n for n in names if n not in data)
        if missing:
            raise RuntimeError(
                "fluid.load: variables %s not found in checkpoint %s (its "
                "keys: %s...)" % (missing, path, sorted(data.files)[:8]))
        for name in names:
            scope.set(name, _to_tensor(data[name], device))
