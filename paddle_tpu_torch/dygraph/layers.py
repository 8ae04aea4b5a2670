"""Dygraph Layer base (parity: python/paddle/fluid/dygraph/layers.py:33).

The counterpart of the JAX package's ``dygraph/layers.py``.  Initializers
run eagerly with a ``torch.Generator`` seeded from ``Layer._seed_counter``
on the CPU, then move to the tracer's device, so a seed gives the same
values on the card and on the CPU (not ``jax.random``'s: carry a JAX
layer's values across with ``state_dict`` / ``set_dict``)."""

import collections

import numpy as np
import torch

from .. import unique_name
from ..dtypes import convert_dtype
from ..initializer import XavierInitializer, ConstantInitializer
from ..param_attr import ParamAttr
from .base import VarBase, current_device

__all__ = ["Layer"]


def _uniform(gen, shape, dt, low, high):
    return torch.rand(shape, generator=gen, dtype=dt) * (high - low) + low


def _normal(gen, shape, dt):
    return torch.randn(shape, generator=gen, dtype=dt)


def _run_initializer(init, shape, dtype, seed):
    """Evaluate an Initializer eagerly (dygraph has no startup program)."""
    from .. import initializer as I

    dt = convert_dtype(dtype)
    gen = torch.Generator().manual_seed(seed)
    if isinstance(init, I.ConstantInitializer):
        return torch.full(shape, init.value, dtype=dt)
    if isinstance(init, I.UniformInitializer):
        return _uniform(gen, shape, dt, init.low, init.high)
    if isinstance(init, I.TruncatedNormalInitializer):
        t = torch.empty(shape, dtype=dt)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return init.loc + init.scale * t
    if isinstance(init, I.NormalInitializer):
        return init.loc + init.scale * _normal(gen, shape, dt)
    if isinstance(init, I.XavierInitializer):
        fi, fo = I._fan_in_out(_Meta(shape))
        fi = init.fan_in or fi
        fo = init.fan_out or fo
        if init.uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            return _uniform(gen, shape, dt, -limit, limit)
        return float(np.sqrt(2.0 / (fi + fo))) * _normal(gen, shape, dt)
    if isinstance(init, I.MSRAInitializer):
        fi, _ = I._fan_in_out(_Meta(shape))
        fi = init.fan_in or fi
        if init.uniform:
            limit = float(np.sqrt(6.0 / fi))
            return _uniform(gen, shape, dt, -limit, limit)
        return float(np.sqrt(2.0 / fi)) * _normal(gen, shape, dt)
    if isinstance(init, I.NumpyArrayInitializer):
        return torch.from_numpy(np.array(init.value)).to(dt)
    raise TypeError("unsupported initializer %r" % (init,))


class _Meta:
    def __init__(self, shape):
        self.shape = tuple(shape)


class Layer:
    """Parity: dygraph/layers.py:33 — sublayer registry, parameters(),
    train/eval mode, state_dict."""

    _seed_counter = 1000

    def __init__(self, name_scope=None, dtype="float32"):
        name_scope = name_scope or type(self).__name__.lower()
        self._full_name = unique_name.generate(name_scope)
        self._dtype = dtype
        self._parameters = collections.OrderedDict()
        self._sub_layers = collections.OrderedDict()
        self.training = True

    def full_name(self):
        return self._full_name

    # -- parameter management ---------------------------------------------
    def create_parameter(self, attr, shape, dtype=None, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtype or self._dtype
        init = (attr.initializer or default_initializer
                or (ConstantInitializer(0.0) if is_bias else XavierInitializer()))
        Layer._seed_counter += 1
        value = _run_initializer(init, tuple(int(s) for s in shape), dtype,
                                 Layer._seed_counter)
        name = attr.name or unique_name.generate(
            self._full_name + (".b" if is_bias else ".w"))
        p = VarBase(value.to(current_device()), name=name,
                    stop_gradient=not attr.trainable, persistable=True,
                    trainable=attr.trainable)
        return p

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    def parameters(self, include_sublayers=True):
        params = list(self._parameters.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                params.extend(l.parameters())
        return params

    def sublayers(self, include_sublayers=True):
        layers = list(self._sub_layers.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                layers.extend(l.sublayers())
        return layers

    def named_parameters(self, prefix=""):
        for name, p in self._parameters.items():
            yield (prefix + name if not prefix else prefix + "." + name), p
        for lname, l in self._sub_layers.items():
            sub_prefix = lname if not prefix else prefix + "." + lname
            yield from l.named_parameters(sub_prefix)

    # -- modes -------------------------------------------------------------
    def train(self):
        self.training = True
        for l in self._sub_layers.values():
            l.train()

    def eval(self):
        self.training = False
        for l in self._sub_layers.values():
            l.eval()

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # -- state dict --------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True, prefix=""):
        destination = destination if destination is not None else collections.OrderedDict()
        for name, p in self.named_parameters():
            destination[name] = p.numpy()
        return destination

    def set_dict(self, state_dict, include_sublayers=True):
        for name, p in self.named_parameters():
            if name in state_dict:
                p.set_value(state_dict[name])

    load_dict = set_dict

    # -- call --------------------------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, VarBase) and value.persistable:
            object.__getattribute__(self, "_parameters")[name] = value
        elif isinstance(value, Layer):
            object.__getattribute__(self, "_sub_layers")[name] = value
        object.__setattr__(self, name, value)

    def __call__(self, *inputs, **kwargs):
        return self.forward(*inputs, **kwargs)

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError
