"""Dtype handling (parity: reference framework/framework.proto VarType :105 and
python data-type conversion helpers).  The JAX package's ``dtypes.py`` with
``torch`` dtypes in place of ``jax.numpy``'s."""

import numpy as np
import torch

_STR_TO_TORCH = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "uint32": torch.uint32,
    "bool": torch.bool,
}

_TORCH_TO_STR = {v: k for k, v in _STR_TO_TORCH.items()}

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
    "fp16": "float16",
    "bf16": "bfloat16",
    "fp32": "float32",
    "fp64": "float64",
}


def normalize_dtype(dtype):
    """The canonical string name of a dtype given as a string, a numpy
    dtype or scalar type, or a ``torch.dtype``."""
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
    elif isinstance(dtype, torch.dtype):
        name = _TORCH_TO_STR.get(dtype)
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:                     # an array: its dtype
            name = np.dtype(dtype.dtype).name
        name = "bool" if name == "bool_" else name
    if name not in _STR_TO_TORCH:
        raise ValueError("unsupported dtype: %r" % (dtype,))
    return name


def convert_dtype(dtype):
    """string/numpy/torch dtype -> torch dtype."""
    return _STR_TO_TORCH[normalize_dtype(dtype)]


def numpy_dtype(dtype):
    """string/numpy/torch dtype -> numpy dtype (numpy has no bfloat16, so a
    bfloat16 declaration raises)."""
    name = normalize_dtype(dtype)
    if name == "bfloat16":
        raise ValueError("numpy has no bfloat16; feed such a var a "
                         "torch.Tensor")
    return np.dtype(name)


def is_floating(dtype):
    return normalize_dtype(dtype) in ("float16", "bfloat16", "float32", "float64")
