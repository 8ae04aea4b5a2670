"""Gradient clipping (parity: python/paddle/fluid/clip.py —
GradientClipByValue/Norm/GlobalNorm + set_gradient_clip).  A copy of the JAX
package's ``clip.py``."""

from . import unique_name
from .framework import default_main_program

__all__ = [
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "set_gradient_clip",
    "append_gradient_clip_ops",
    "error_clip_callback",
]

_global_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    global _global_clip
    _global_clip = clip


class BaseGradientClip:
    def _append(self, params_grads, block):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClip):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _append(self, params_grads, block):
        result = []
        for p, g in params_grads:
            ng = block.create_var(name=unique_name.generate(g.name + ".clip"),
                                  shape=g.shape, dtype=g.dtype, stop_gradient=True)
            block.append_op(type="clip", inputs={"X": [g]}, outputs={"Out": [ng]},
                            attrs={"min": self.min, "max": self.max})
            result.append((p, ng))
        return result


class GradientClipByNorm(BaseGradientClip):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _append(self, params_grads, block):
        result = []
        for p, g in params_grads:
            ng = block.create_var(name=unique_name.generate(g.name + ".clip"),
                                  shape=g.shape, dtype=g.dtype, stop_gradient=True)
            block.append_op(type="clip_by_norm", inputs={"X": [g]}, outputs={"Out": [ng]},
                            attrs={"max_norm": self.clip_norm})
            result.append((p, ng))
        return result


class GradientClipByGlobalNorm(BaseGradientClip):
    """Parity: clip.py GradientClipByGlobalNorm — scale all grads by
    clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _append(self, params_grads, block):
        sq_norms = []
        for _, g in params_grads:
            sq = block.create_var(name=unique_name.generate(g.name + ".sq"),
                                  shape=(), dtype=g.dtype, stop_gradient=True)
            block.append_op(type="squared_l2_norm", inputs={"X": [g]}, outputs={"Out": [sq]})
            sq_norms.append(sq)
        total = block.create_var(name=unique_name.generate("global_norm_sq"),
                                 shape=(), dtype="float32", stop_gradient=True)
        block.append_op(type="sum", inputs={"X": sq_norms}, outputs={"Out": [total]})
        gnorm = block.create_var(name=unique_name.generate("global_norm"),
                                 shape=(), dtype="float32", stop_gradient=True)
        block.append_op(type="sqrt", inputs={"X": [total]}, outputs={"Out": [gnorm]})
        # denom = max(gnorm, clip_norm); factor = clip_norm / denom
        clipc = block.create_var(name=unique_name.generate("clip_const"),
                                 shape=(), dtype="float32", stop_gradient=True)
        block.append_op(type="fill_constant", outputs={"Out": [clipc]},
                        attrs={"shape": [], "dtype": "float32", "value": self.clip_norm})
        denom = block.create_var(name=unique_name.generate("clip_denom"),
                                 shape=(), dtype="float32", stop_gradient=True)
        block.append_op(type="elementwise_max", inputs={"X": [gnorm], "Y": [clipc]},
                        outputs={"Out": [denom]}, attrs={"axis": -1})
        factor = block.create_var(name=unique_name.generate("clip_factor"),
                                  shape=(), dtype="float32", stop_gradient=True)
        block.append_op(type="elementwise_div", inputs={"X": [clipc], "Y": [denom]},
                        outputs={"Out": [factor]}, attrs={"axis": -1})
        result = []
        for p, g in params_grads:
            ng = block.create_var(name=unique_name.generate(g.name + ".clip"),
                                  shape=g.shape, dtype=g.dtype, stop_gradient=True)
            block.append_op(type="elementwise_mul", inputs={"X": [g], "Y": [factor]},
                            outputs={"Out": [ng]}, attrs={"axis": -1})
            result.append((p, ng))
        return result


def append_gradient_clip_ops(params_grads, clip=None):
    clip = clip or _global_clip
    if clip is None:
        return params_grads
    block = default_main_program().global_block()
    return clip._append(params_grads, block)


def error_clip_callback(block, context):
    """Parity marker for the reference's error-clip mechanism."""
    return None
