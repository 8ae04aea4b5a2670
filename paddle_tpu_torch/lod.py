"""LoDTensor compat types (parity: fluid.LoDTensor / LoDTensorArray /
Tensor from core — the C++ tensor handles the Python API re-exports).  A
copy of the JAX package's ``lod.py``.

The framework's runtime representation is dense arrays + lengths
(SURVEY §7 LoD translation); these classes exist for API compatibility with
code that constructs LoDTensors explicitly (set/lod/recursive_sequence_lengths
and numpy round-trip)."""

import numpy as np

__all__ = ["LoDTensor", "LoDTensorArray", "Tensor"]


class LoDTensor:
    def __init__(self, array=None, lod=None):
        self._array = None if array is None else np.asarray(array)
        self._lod = [list(l) for l in (lod or [])]

    def set(self, array, place=None):
        self._array = np.asarray(array)

    def set_lod(self, lod):
        self._lod = [list(l) for l in lod]

    def lod(self):
        return self._lod

    def set_recursive_sequence_lengths(self, lengths):
        """lengths -> offset-style LoD (core.LoDTensor contract)."""
        self._lod = []
        for lens in lengths:
            offsets = [0]
            for n in lens:
                offsets.append(offsets[-1] + int(n))
            self._lod.append(offsets)

    def recursive_sequence_lengths(self):
        return [[b - a for a, b in zip(l, l[1:])] for l in self._lod]

    def shape(self):
        return list(self._array.shape) if self._array is not None else []

    def __array__(self, dtype=None):
        a = self._array if self._array is not None else np.empty((0,))
        return a.astype(dtype) if dtype else a


# the dense tensor handle is the same object without LoD semantics
Tensor = LoDTensor


class LoDTensorArray(list):
    """Parity: core.LoDTensorArray — a growable list of LoDTensors."""
