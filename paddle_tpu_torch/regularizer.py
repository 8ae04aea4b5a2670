"""Weight decay regularizers (parity: python/paddle/fluid/regularizer.py —
L1Decay/L2Decay appended as grad-modifying ops in append_regularization_ops).
A copy of the JAX package's ``regularizer.py``."""

from . import unique_name
from .framework import default_main_program

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(
            name=unique_name.generate(param.name + ".l2decay"),
            shape=param.shape, dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": [param]}, outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        new_grad = block.create_var(
            name=unique_name.generate(grad.name + ".reg"),
            shape=grad.shape, dtype=grad.dtype, stop_gradient=True)
        block.append_op(type="sum", inputs={"X": [grad, decay]}, outputs={"Out": [new_grad]})
        return new_grad


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(name=unique_name.generate(param.name + ".sign"),
                                shape=param.shape, dtype=param.dtype)
        block.append_op(type="sign", inputs={"X": [param]}, outputs={"Out": [sign]})
        decay = block.create_var(name=unique_name.generate(param.name + ".l1decay"),
                                 shape=param.shape, dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": [sign]}, outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        new_grad = block.create_var(name=unique_name.generate(grad.name + ".reg"),
                                    shape=grad.shape, dtype=grad.dtype, stop_gradient=True)
        block.append_op(type="sum", inputs={"X": [grad, decay]}, outputs={"Out": [new_grad]})
        return new_grad


def append_regularization_ops(params_grads, regularization=None):
    """Parity: regularizer.py append_regularization_ops — per-param regularizer
    wins over the global one."""
    block = default_main_program().global_block()
    result = []
    for param, grad in params_grads:
        regular = getattr(param, "regularizer", None) or regularization
        if regular is None:
            result.append((param, grad))
        else:
            result.append((param, regular(param, grad, block)))
    return result


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
