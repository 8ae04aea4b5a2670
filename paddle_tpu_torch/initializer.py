"""Parameter initializers (parity: python/paddle/fluid/initializer.py —
Constant/Uniform/Normal/TruncatedNormal/Xavier/MSRA/Bilinear/NumpyArrayInitializer).

Each initializer appends an init op to the startup program; the op lowers to
seeded ``torch`` fills when the executor runs the startup program.  A
copy of the JAX package's ``initializer.py``.
"""

import math

import numpy as np

__all__ = [
    "Constant",
    "Uniform",
    "Normal",
    "TruncatedNormal",
    "Xavier",
    "MSRA",
    "NumpyArrayInitializer",
    "BilinearInitializer",
    "ConstantInitializer",
    "UniformInitializer",
    "NormalInitializer",
    "XavierInitializer",
    "MSRAInitializer",
]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant",
            outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "value": float(self.value)},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random",
            outputs={"Out": [var]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": float(self.low),
                "max": float(self.high),
                "seed": self.seed or block.program.next_seed(),
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            type="gaussian_random",
            outputs={"Out": [var]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed or block.program.next_seed(),
            },
        )


class TruncatedNormalInitializer(NormalInitializer):
    def __call__(self, var, block):
        block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": [var]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed or block.program.next_seed(),
            },
        )


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


class XavierInitializer(Initializer):
    """Glorot init (parity: initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He/Kaiming init (parity: initializer.py MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(
            type="assign_value",
            outputs={"Out": [var]},
            attrs={
                "shape": list(self.value.shape),
                "dtype": var.dtype,
                "values": self.value,
            },
        )


class BilinearInitializer(Initializer):
    """Parity: initializer.py:734 — bilinear-upsampling kernel init for
    conv2d_transpose filters [C_in, C_out, kh, kw] (the deconv upsample
    trick: each spatial tap is the product of two triangle weights)."""

    def __call__(self, var, block):
        shape = [int(s) for s in var.shape]
        if len(shape) != 4:
            raise ValueError("BilinearInitializer needs a 4-D filter")
        kh, kw = shape[2], shape[3]
        fh, fw = (kh + 1) // 2, (kw + 1) // 2
        # triangle weights per axis (ref: (1 - |x/f - c|))
        cy = (2 * fh - 1 - fh % 2) / (2.0 * fh)
        cx = (2 * fw - 1 - fw % 2) / (2.0 * fw)
        ys = (1 - np.abs(np.arange(kh) / fh - cy))
        xs = (1 - np.abs(np.arange(kw) / fw - cx))
        tap = np.outer(ys, xs).astype("f4")
        weight = np.zeros(shape, "f4")
        weight[:] = tap                       # broadcast over [C_in, C_out]
        NumpyArrayInitializer(weight)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Bilinear = BilinearInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
