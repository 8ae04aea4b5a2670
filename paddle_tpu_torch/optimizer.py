"""Optimizers (parity: python/paddle/fluid/optimizer.py:54-3756 — Optimizer
base `minimize` = append_backward + apply_gradients, with LR scheduling,
regularization, and grad clip; then SGD :690, Momentum :761, DGCMomentum :870,
LarsMomentum :1167, Adagrad :1267, Adam :1377, Adamax :1567, Dpsgd :1727,
DecayedAdagrad :1806, Adadelta :1901, RMSProp :2007, Ftrl :2181, Lamb :2326,
ModelAverage :2484, EMA :2786, Pipeline :3020, Recompute :3313, Lookahead :3606).

Update rules themselves are ops (ops/optimizer_ops.py), which the executor
runs after the backward section.  A copy of the JAX package's
``optimizer.py``.  Under ``dygraph.guard()``, ``minimize`` runs the same
rules eagerly on the parameters' gradients, with the accumulators kept
per optimizer (``_dy_acc``); as in the JAX package, that path applies no
``regularization`` and no ``grad_clip``."""

import numpy as np

from . import unique_name
from .framework import (
    Variable,
    Parameter,
    Program,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .backward import append_backward
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .clip import append_gradient_clip_ops, error_clip_callback  # noqa: F401
from .regularizer import append_regularization_ops

__all__ = [
    "Optimizer",
    "SGD",
    "SGDOptimizer",
    "Momentum",
    "MomentumOptimizer",
    "DGCMomentumOptimizer",
    "LarsMomentum",
    "LarsMomentumOptimizer",
    "Adagrad",
    "AdagradOptimizer",
    "Adam",
    "AdamOptimizer",
    "Adamax",
    "AdamaxOptimizer",
    "Dpsgd",
    "DpsgdOptimizer",
    "DecayedAdagrad",
    "DecayedAdagradOptimizer",
    "Adadelta",
    "AdadeltaOptimizer",
    "RMSProp",
    "RMSPropOptimizer",
    "Ftrl",
    "FtrlOptimizer",
    "Lamb",
    "LambOptimizer",
    "ModelAverage",
    "ExponentialMovingAverage",
    "PipelineOptimizer",
    "RecomputeOptimizer",
    "LookaheadOptimizer",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None, grad_clip=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
        self.type = getattr(self, "type", "optimizer")
        self._accumulators = {}  # name -> {param_name: Variable}
        self._lr_var = None
        self.helper = None

    # -- learning rate -----------------------------------------------------
    def _create_lr_var(self):
        if self._lr_var is not None:
            return self._lr_var
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
        else:
            from .layers import tensor as T

            self._lr_var = T.create_global_var(
                [1], float(self._learning_rate), "float32", persistable=True,
                name=unique_name.generate("learning_rate"),
            )
        return self._lr_var

    def _global_learning_rate(self):
        return self._create_lr_var()

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None, dtype=None):
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        shape = shape if shape is not None else param.shape
        dtype = dtype or param.dtype
        var_name = unique_name.generate("%s_%s" % (param.name, name))
        block = default_main_program().global_block()
        var = block.create_var(
            name=var_name, shape=tuple(shape), dtype=dtype, persistable=True,
            stop_gradient=True,
        )
        # marks the var as optimizer state so BuildStrategy kReduce
        # (compiler.py) can shard it over the data axis (parallel/zero.py is
        # the functional-path counterpart)
        var._is_optimizer_accumulator = True
        # tensor-parallel params keep their moments sharded the same way
        if (getattr(param, "_tp_split", None)
                and tuple(shape) == tuple(param.shape)):
            var._tp_split = param._tp_split
        sblock = default_startup_program().global_block()
        svar = sblock.create_var(name=var_name, shape=tuple(shape), dtype=dtype,
                                 persistable=True)
        ConstantInitializer(fill_value)(svar, sblock)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- API ---------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None, checkpoints=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks,
                               checkpoints=checkpoints)

    def apply_gradients(self, params_grads):
        program = default_main_program()
        block = program.global_block()
        with program._optimized_guard():
            params_grads = append_gradient_clip_ops(params_grads, self._grad_clip)
            params_grads = append_regularization_ops(params_grads, self.regularization)
            self._create_lr_var()
            self._create_accumulators(block, [p for p, _ in params_grads])
            opt_ops = []
            for pg in params_grads:
                opt_ops.append(self._append_optimize_op(block, pg))
            self._finish_update(block, params_grads)
        return opt_ops

    def _finish_update(self, block, params_grads):
        pass

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .framework import in_dygraph_mode

        if in_dygraph_mode():
            return self._dygraph_minimize(loss, parameter_list)
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads

    # -- dygraph path (parity: optimizers run after loss.backward() on the
    # imperative tape; updates reuse the SAME op rules so static and
    # dygraph numerics are identical) --------------------------------------
    def _dygraph_minimize(self, loss, parameter_list):
        import torch

        from .registry import get_lowering, OpLoweringContext

        params = [p for p in (parameter_list or []) if p.trainable]
        if not params:
            raise ValueError("dygraph minimize requires parameter_list")
        if not hasattr(self, "_dy_acc"):
            self._dy_acc = {}
        lr = self._learning_rate() if callable(self._learning_rate) else self._learning_rate
        device = params[0]._value.device
        lr = torch.tensor([float(lr)], dtype=torch.float32, device=device)
        ctx = OpLoweringContext(None, torch.Generator(device).manual_seed(0))
        rule = get_lowering(self.type)
        for p in params:
            if p._grad is None:
                continue
            ins, outs_map = self._dygraph_slots(p)
            ins["Param"] = [p._value]
            ins["Grad"] = [p._grad.to(p._value.dtype)]
            ins["LearningRate"] = [lr]
            result = rule(ins, self._dygraph_attrs(), ctx)
            p.set_value(result["ParamOut"][0])
            for slot, key in outs_map.items():
                if slot in result:
                    self._dy_acc[key] = result[slot][0]
        return None, [(p, p._grad) for p in params]

    def _dygraph_slots(self, p):
        """Build accumulator input slots for the dygraph path; returns
        (ins, {out_slot: acc_key}).  Overridden per optimizer family via
        _DY_SLOTS: list of (in_slot, out_slot, acc_name, init)."""
        import torch

        ins = {}
        outs = {}
        for in_slot, out_slot, acc_name, init in getattr(self, "_DY_SLOTS", []):
            key = (acc_name, id(p))
            if key not in self._dy_acc:
                if acc_name.endswith("pow"):
                    self._dy_acc[key] = torch.tensor(
                        [init], dtype=torch.float32, device=p._value.device)
                else:
                    self._dy_acc[key] = torch.zeros_like(p._value)
            ins[in_slot] = [self._dy_acc[key]]
            outs[out_slot] = key
        return ins, outs

    def _dygraph_attrs(self):
        return {}


class SGDOptimizer(Optimizer):
    """Parity: optimizer.py:690 (sgd_op.cc)."""

    type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g], "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p]},
        )


class MomentumOptimizer(Optimizer):
    """Parity: optimizer.py:761 (momentum_op.cc)."""

    type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._DY_SLOTS = [("Velocity", "VelocityOut", "velocity", 0.0)]

    def _dygraph_attrs(self):
        return {"mu": self._momentum, "use_nesterov": self._use_nesterov}

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class DGCMomentumOptimizer(MomentumOptimizer):
    """Parity: optimizer.py:870 + operators/dgc_op.cc — Deep Gradient
    Compression: momentum correction (u = m*u + g), error accumulation
    (v += u), top-k selection on |v| with the ramped sparsity schedule,
    error feedback (selected entries cleared from u and v), SGD step with
    the sparsified gradient.

    Deviation (documented, as in the JAX package): the reference sparsifies
    each worker's LOCAL gradient before the allreduce to compress
    communication; here the top-k runs on the gradient that reaches the
    optimizer.  Training semantics (momentum correction + error feedback)
    are preserved."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False, **kwargs):
        super().__init__(learning_rate, momentum, use_nesterov, **kwargs)
        self._rampup_begin_step = int(rampup_begin_step)
        self._rampup_step = max(int(rampup_step), 1)
        self._sparsity = [float(s) for s in sparsity]

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)       # u (dgc_op.cc U)
            self._add_accumulator("dgc_error", p)      # v (error accum)
            self._add_accumulator("dgc_step", p, shape=(1,))

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        u = self._get_accumulator("velocity", p)
        v = self._get_accumulator("dgc_error", p)
        step = self._get_accumulator("dgc_step", p)
        return block.append_op(
            type="dgc_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [u],
                    "ErrorAccum": [v], "Step": [step],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "VelocityOut": [u],
                     "ErrorAccumOut": [v], "StepOut": [step]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   "rampup_begin_step": self._rampup_begin_step,
                   "rampup_step": self._rampup_step,
                   "sparsity": self._sparsity},
        )


class LarsMomentumOptimizer(Optimizer):
    """Parity: optimizer.py:1167 (lars_momentum_op.cc)."""

    type = "lars_momentum"

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay},
        )


class AdagradOptimizer(Optimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6, initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m], "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"epsilon": self._epsilon},
        )


class AdamOptimizer(Optimizer):
    """Parity: optimizer.py:1377 (adam_op.cc)."""

    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode
        self._DY_SLOTS = [
            ("Moment1", "Moment1Out", "moment1", 0.0),
            ("Moment2", "Moment2Out", "moment2", 0.0),
            ("Beta1Pow", "Beta1PowOut", "beta1_pow", beta1),
            ("Beta2Pow", "Beta2PowOut", "beta2_pow", beta2),
        ]

    def _dygraph_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon, "lazy_mode": self._lazy_mode}

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="adam",
            inputs={
                "Param": [p], "Grad": [g],
                "Moment1": [self._get_accumulator("moment1", p)],
                "Moment2": [self._get_accumulator("moment2", p)],
                "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
                "Beta2Pow": [self._get_accumulator("beta2_pow_acc", p)],
                "LearningRate": [self._lr_var],
            },
            outputs={
                "ParamOut": [p],
                "Moment1Out": [self._get_accumulator("moment1", p)],
                "Moment2Out": [self._get_accumulator("moment2", p)],
                "Beta1PowOut": [self._get_accumulator("beta1_pow_acc", p)],
                "Beta2PowOut": [self._get_accumulator("beta2_pow_acc", p)],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "lazy_mode": self._lazy_mode},
        )


class AdamaxOptimizer(Optimizer):
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="adamax",
            inputs={
                "Param": [p], "Grad": [g],
                "Moment": [self._get_accumulator("moment", p)],
                "InfNorm": [self._get_accumulator("inf_norm", p)],
                "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
                "LearningRate": [self._lr_var],
            },
            outputs={
                "ParamOut": [p],
                "MomentOut": [self._get_accumulator("moment", p)],
                "InfNormOut": [self._get_accumulator("inf_norm", p)],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
        )

    def _finish_update(self, block, params_grads):
        for p, _ in params_grads:
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op(
                type="scale", inputs={"X": [b1p]}, outputs={"Out": [b1p]},
                attrs={"scale": self._beta1},
            )


class DpsgdOptimizer(Optimizer):
    type = "dpsgd"

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0, sigma=1.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="dpsgd",
            inputs={"Param": [p], "Grad": [g], "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma,
                   "seed": default_main_program().next_seed()},
        )


class DecayedAdagradOptimizer(Optimizer):
    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m], "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    type = "adadelta"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("_avg_squared_grad", p)
            self._add_accumulator("_avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p], "Grad": [g],
                    "AvgSquaredGrad": [self._get_accumulator("_avg_squared_grad", p)],
                    "AvgSquaredUpdate": [self._get_accumulator("_avg_squared_update", p)]},
            outputs={"ParamOut": [p],
                     "AvgSquaredGradOut": [self._get_accumulator("_avg_squared_grad", p)],
                     "AvgSquaredUpdateOut": [self._get_accumulator("_avg_squared_update", p)]},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
        )


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon, self._momentum, self._centered = rho, epsilon, momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)
            self._add_accumulator("momentum", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [p], "Grad": [g],
                    "MeanSquare": [self._get_accumulator("mean_square", p)],
                    "MeanGrad": [self._get_accumulator("mean_grad", p)],
                    "Moment": [self._get_accumulator("momentum", p)],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p],
                     "MeanSquareOut": [self._get_accumulator("mean_square", p)],
                     "MeanGradOut": [self._get_accumulator("mean_grad", p)],
                     "MomentOut": [self._get_accumulator("momentum", p)]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered},
        )


class FtrlOptimizer(Optimizer):
    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p], "Grad": [g],
                    "SquaredAccumulator": [self._get_accumulator("squared", p)],
                    "LinearAccumulator": [self._get_accumulator("linear", p)],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p],
                     "SquaredAccumOut": [self._get_accumulator("squared", p)],
                     "LinearAccumOut": [self._get_accumulator("linear", p)]},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


class LambOptimizer(Optimizer):
    """Parity: optimizer.py:2326 (lamb_op.cc) — large-batch BERT optimizer."""

    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, exclude_from_weight_decay_fn=None, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._weight_decay = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        return block.append_op(
            type="lamb",
            inputs={
                "Param": [p], "Grad": [g],
                "Moment1": [self._get_accumulator("moment1", p)],
                "Moment2": [self._get_accumulator("moment2", p)],
                "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
                "Beta2Pow": [self._get_accumulator("beta2_pow_acc", p)],
                "LearningRate": [self._lr_var],
            },
            outputs={
                "ParamOut": [p],
                "Moment1Out": [self._get_accumulator("moment1", p)],
                "Moment2Out": [self._get_accumulator("moment2", p)],
                "Beta1PowOut": [self._get_accumulator("beta1_pow_acc", p)],
                "Beta2PowOut": [self._get_accumulator("beta2_pow_acc", p)],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd},
        )


class ExponentialMovingAverage:
    """Parity: optimizer.py:2786 — EMA of params updated each step; apply()/
    restore() swap params with their averages (built as separate programs)."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._ema_vars = {}
        self.apply_program = Program()
        self.restore_program = Program()
        self._params = []

    def update(self):
        program = default_main_program()
        block = program.global_block()
        from .layers import tensor as T

        with program._optimized_guard():
            for p in block.all_parameters():
                if not p.trainable:
                    continue
                ema_name = p.name + "." + self._name
                ema = block.create_var(name=ema_name, shape=p.shape, dtype=p.dtype,
                                       persistable=True, stop_gradient=True)
                sblock = default_startup_program().global_block()
                sv = sblock.create_var(name=ema_name, shape=p.shape, dtype=p.dtype,
                                       persistable=True)
                ConstantInitializer(0.0)(sv, sblock)
                self._ema_vars[p.name] = ema
                self._params.append(p)
                # ema = decay*ema + (1-decay)*p  (composed from scale+sum ops)
                tmp1 = block.create_var(name=unique_name.generate(ema_name + ".t1"),
                                        shape=p.shape, dtype=p.dtype)
                block.append_op(type="scale", inputs={"X": [ema]}, outputs={"Out": [tmp1]},
                                attrs={"scale": self._decay})
                tmp2 = block.create_var(name=unique_name.generate(ema_name + ".t2"),
                                        shape=p.shape, dtype=p.dtype)
                block.append_op(type="scale", inputs={"X": [p]}, outputs={"Out": [tmp2]},
                                attrs={"scale": 1.0 - self._decay})
                block.append_op(type="sum", inputs={"X": [tmp1, tmp2]}, outputs={"Out": [ema]})
        self._build_swap_programs()

    def _build_swap_programs(self):
        # apply: backup = param; param = ema / (1 - decay^t) approximated by ema
        for prog, to_backup in ((self.apply_program, True), (self.restore_program, False)):
            prog.blocks = [type(prog.global_block())(prog, 0)]
            block = prog.global_block()
            for p in self._params:
                ema_name = self._ema_vars[p.name].name
                backup = p.name + ".backup"
                for nm in (p.name, ema_name, backup):
                    block.create_var(name=nm, shape=p.shape, dtype=p.dtype, persistable=True)
                if to_backup:
                    block.append_op(type="assign", inputs={"X": [p.name]},
                                    outputs={"Out": [backup]})
                    block.append_op(type="assign", inputs={"X": [ema_name]},
                                    outputs={"Out": [p.name]})
                else:
                    block.append_op(type="assign", inputs={"X": [backup]},
                                    outputs={"Out": [p.name]})

    def apply(self, executor, need_restore=True):
        import contextlib

        @contextlib.contextmanager
        def guard():
            executor.run(self.apply_program)
            try:
                yield
            finally:
                if need_restore:
                    executor.run(self.restore_program)

        return guard()

    def restore(self, executor):
        executor.run(self.restore_program)


class ModelAverage(Optimizer):
    """Parity: optimizer.py:2484 — running average of params over a window;
    implemented as EMA-style accumulation with apply/restore programs."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self._ema = ExponentialMovingAverage(decay=1.0 - average_window_rate,
                                             name="model_average")

    def update(self):
        self._ema.update()

    def apply(self, executor, need_restore=True):
        return self._ema.apply(executor, need_restore)

    def restore(self, executor):
        self._ema.restore(executor)


class RecomputeOptimizer(Optimizer):
    """Parity: optimizer.py:3313 — activation recomputation: sets the
    backward section's use_remat attr, which the port's executor does not
    run yet (it raises; ROADMAP Queue 1 item 3)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        params_grads = self._optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set,
            checkpoints=self._checkpoints or True)
        opt_ops = self._optimizer.apply_gradients(params_grads)
        return opt_ops, params_grads

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


class PipelineOptimizer:
    """Parity: optimizer.py:3020 — program-splitting pipeline.

    The reference splits the program at `cut_list` variables into sections
    run by SectionWorker threads on different devices, with microbatches
    flowing through scope queues (device_worker.h:274-330).  The executor
    runs the sections over `num_microbatches` microbatches, accumulating
    the gradients, and the optimizer ops once a batch (executor.py
    ``_Plan._run_pipeline``).

    cut_list: list of cut-point Variables (or [Variable] lists, reference
    style); K cuts -> K+1 sections.
    """

    def __init__(self, optimizer, cut_list=None, place_list=None, concurrency_list=None,
                 queue_size=30, sync_steps=1, start_cpu_core_id=0,
                 num_microbatches=2):
        self._optimizer = optimizer
        self._cut_list = cut_list or []
        self._num_microbatches = num_microbatches

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        result = self._optimizer.minimize(loss, startup_program,
                                          parameter_list, no_grad_set)
        cut_names = []
        for cut in self._cut_list:
            if isinstance(cut, (list, tuple)):
                cut_names.extend(
                    c.name if isinstance(c, Variable) else c for c in cut)
            else:
                cut_names.append(cut.name if isinstance(cut, Variable) else cut)
        program = loss.block.program
        program._pipeline = {
            "cut_vars": cut_names,
            "num_microbatches": int(self._num_microbatches),
            "loss_name": loss.name,
        }
        program._bump_version()
        return result

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


class LookaheadOptimizer:
    """Parity: optimizer.py:3606 — slow/fast weights; every k steps
    slow += alpha*(fast-slow), fast = slow.  Implemented with a step counter
    and where-selects, as ops of the program."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        opt_ops, params_grads = self.inner_optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        program = default_main_program()
        block = program.global_block()
        from .layers import tensor as T

        with program._optimized_guard():
            step = T.create_global_var([1], 0.0, "float32", persistable=True,
                                       name=unique_name.generate("lookahead_step"))
            block.append_op(type="increment", inputs={"X": [step]}, outputs={"Out": [step]},
                            attrs={"step": 1.0})
            # is_sync = (step mod k == 0)
            modk = block.create_var(name=unique_name.generate("lookahead_mod"),
                                    shape=(1,), dtype="float32")
            kconst = T.fill_constant([1], "float32", float(self.k))
            block.append_op(type="elementwise_mod", inputs={"X": [step], "Y": [kconst]},
                            outputs={"Out": [modk]}, attrs={"axis": -1})
            zero = T.fill_constant([1], "float32", 0.0)
            is_sync = block.create_var(name=unique_name.generate("lookahead_sync"),
                                       shape=(1,), dtype="bool")
            block.append_op(type="equal", inputs={"X": [modk], "Y": [zero]},
                            outputs={"Out": [is_sync]})
            for p, _ in params_grads:
                slow_name = p.name + ".slow"
                slow = block.create_var(name=slow_name, shape=p.shape, dtype=p.dtype,
                                        persistable=True, stop_gradient=True)
                sblock = default_startup_program().global_block()
                if slow_name not in sblock.vars:
                    sv = sblock.create_var(name=slow_name, shape=p.shape, dtype=p.dtype,
                                           persistable=True)
                    # start slow weights equal to init params
                    sblock.append_op(type="assign", inputs={"X": [p.name]},
                                     outputs={"Out": [slow_name]})
                # candidate slow' = slow + alpha*(fast - slow)
                diff = block.create_var(name=unique_name.generate(p.name + ".la_diff"),
                                        shape=p.shape, dtype=p.dtype)
                block.append_op(type="elementwise_sub", inputs={"X": [p], "Y": [slow]},
                                outputs={"Out": [diff]}, attrs={"axis": -1})
                scaled = block.create_var(name=unique_name.generate(p.name + ".la_scaled"),
                                          shape=p.shape, dtype=p.dtype)
                block.append_op(type="scale", inputs={"X": [diff]}, outputs={"Out": [scaled]},
                                attrs={"scale": self.alpha})
                cand = block.create_var(name=unique_name.generate(p.name + ".la_cand"),
                                        shape=p.shape, dtype=p.dtype)
                block.append_op(type="sum", inputs={"X": [slow, scaled]}, outputs={"Out": [cand]})
                block.append_op(type="where", inputs={"Condition": [is_sync], "X": [cand],
                                                      "Y": [slow]},
                                outputs={"Out": [slow]})
                block.append_op(type="where", inputs={"Condition": [is_sync], "X": [slow],
                                                      "Y": [p]},
                                outputs={"Out": [p]})
        return opt_ops, params_grads


# short aliases (parity: fluid.optimizer.SGD etc.)
SGD = SGDOptimizer
Momentum = MomentumOptimizer
LarsMomentum = LarsMomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Dpsgd = DpsgdOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
