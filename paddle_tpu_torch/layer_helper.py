"""LayerHelper (parity: python/paddle/fluid/layer_helper.py) — shared plumbing
for layer functions: parameter creation (main + startup program init ops),
temp-variable creation, activation append.  A copy of the JAX package's
``layer_helper.py``."""

from . import unique_name
from .framework import default_main_program, default_startup_program, Parameter
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def main_block(self):
        return self.main_program.current_block()

    def append_op(self, *args, **kwargs):
        return self.main_block.append_op(*args, **kwargs)

    # ------------------------------------------------------------------
    def param_attr(self, is_bias=False):
        key = "bias_attr" if is_bias else "param_attr"
        return ParamAttr._to_attr(self.kwargs.get(key))

    def create_parameter(
        self, attr, shape, dtype, is_bias=False, default_initializer=None, suffix=None
    ):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        from .param_attr import WeightNormParamAttr

        if isinstance(attr, WeightNormParamAttr):
            return self._create_weight_normed_parameter(
                attr, shape, dtype, default_initializer)
        suffix = suffix or ("b" if is_bias else "w")
        name = attr.name
        if name is None:
            name = unique_name.generate("%s.%s_0" % (self.name, suffix))
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()

        main_block = self.main_program.global_block()
        if name in main_block.vars:
            # shared parameter (attr.name reuse, e.g. tied embeddings)
            return main_block.vars[name]
        param = main_block.create_parameter(
            name=name,
            shape=shape,
            dtype=dtype,
            trainable=attr.trainable,
            regularizer=attr.regularizer,
            optimize_attr={"learning_rate": attr.learning_rate},
            gradient_clip_attr=attr.gradient_clip,
            do_model_average=attr.do_model_average,
            initializer=init,
        )
        # mirror into startup program with its init op
        sblock = self.startup_program.global_block()
        if name not in sblock.vars:
            svar = sblock.create_parameter(
                name=name, shape=shape, dtype=dtype, trainable=attr.trainable
            )
            init(svar, sblock)
        return param

    def _create_weight_normed_parameter(self, attr, shape, dtype,
                                        default_initializer):
        """WeightNormParamAttr (param_attr.py): create persistable (v, g)
        and return w = g * v / ||v|| computed by the weight_norm op — the
        reference's reparameterization decomposition
        (layer_helper.py append_weight_norm_params), TPU-fused into one op.
        Gradients flow to g and v; w itself is a derived temp."""
        base = attr.name or unique_name.generate("%s.wn_0" % self.name)
        dim = attr.dim
        if dim is not None and dim < 0:
            dim = dim % len(shape)          # -1 = last axis, like numpy
        v_attr = ParamAttr(name=base + "_v", initializer=attr.initializer,
                           learning_rate=attr.learning_rate,
                           regularizer=attr.regularizer,
                           trainable=attr.trainable,
                           gradient_clip=attr.gradient_clip,
                           do_model_average=attr.do_model_average)
        v = self.create_parameter(v_attr, shape, dtype,
                                  default_initializer=default_initializer)
        g_shape = [int(shape[dim])] if dim is not None else [1]
        g = self.create_parameter(
            ParamAttr(name=base + "_g",
                      initializer=ConstantInitializer(1.0),
                      learning_rate=attr.learning_rate,
                      regularizer=attr.regularizer,
                      trainable=attr.trainable,
                      gradient_clip=attr.gradient_clip,
                      do_model_average=attr.do_model_average),
            g_shape, dtype)
        w = self.create_variable_for_type_inference(dtype, tuple(shape))
        self.append_op(type="weight_norm", inputs={"V": [v], "G": [g]},
                       outputs={"Out": [w]},
                       attrs={"dim": -1 if dim is None else int(dim)})
        return w

    def create_variable_for_type_inference(self, dtype, shape=None, stop_gradient=False):
        return self.main_block.create_var(
            name=unique_name.generate(self.name + ".tmp"),
            shape=shape or (),
            dtype=dtype,
            stop_gradient=stop_gradient,
        )

    def create_global_variable(self, shape, dtype, name=None, persistable=True):
        block = self.main_program.global_block()
        return block.create_var(
            name=name or unique_name.generate(self.name + ".global"),
            shape=shape,
            dtype=dtype,
            persistable=persistable,
            stop_gradient=True,
        )

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(input_var.dtype, input_var.shape)
        self.append_op(type=act_type, inputs={"X": [input_var]}, outputs={"Out": [tmp]}, attrs=act)
        return tmp
