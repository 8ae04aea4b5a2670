"""Dygraph checkpointing (parity: dygraph/checkpoint.py:32 save_dygraph / :78
load_dygraph).

A copy of the JAX package's ``dygraph/checkpoint.py``, which imports no
JAX: the ``.npz`` files are the same in both packages."""

import os

import numpy as np

__all__ = ["save_dygraph", "load_dygraph"]


def save_dygraph(state_dict, model_path):
    """state_dict: Layer.state_dict() or optimizer state; writes
    <model_path>.npz."""
    arrays = {}
    for k, v in state_dict.items():
        arrays[k] = np.asarray(v.numpy() if hasattr(v, "numpy") else v)
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    np.savez(model_path + ".npz", **arrays)


def load_dygraph(model_path):
    """Returns (param_state_dict, optimizer_state_dict-or-None)."""
    path = model_path + ".npz" if not model_path.endswith(".npz") else model_path
    data = np.load(path)
    return {k: data[k] for k in data.files}, None
