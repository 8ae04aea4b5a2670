"""ParamAttr (parity: python/paddle/fluid/param_attr.py).  A copy of the JAX
package's ``param_attr.py``."""

from .initializer import Initializer, XavierInitializer

__all__ = ["ParamAttr", "WeightNormParamAttr"]


class ParamAttr:
    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate=1.0,
        regularizer=None,
        trainable=True,
        gradient_clip=None,
        do_model_average=False,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if arg is False:
            return False
        if arg is True:
            return ParamAttr()          # "use the default attr" (fluid)
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        raise TypeError("unsupported param_attr: %r" % (arg,))


class WeightNormParamAttr(ParamAttr):
    """Parity: param_attr.py:184 — weight normalization (arXiv:1602.07868):
    w = g * v / ||v||, decoupling magnitude from direction.  dim: the axis
    kept un-normalized (None = norm over every element).  LayerHelper
    detects this attr and creates the (g, v) pair plus the weight_norm op
    (ops/misc_ops5.py) instead of a raw parameter."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 gradient_clip=None, do_model_average=False):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate,
                         regularizer=regularizer, trainable=trainable,
                         gradient_clip=gradient_clip,
                         do_model_average=do_model_average)
        self.dim = dim
