"""fluid.dygraph_grad_clip namespace (parity: dygraph_grad_clip.py —
GradClipByValue/Norm/GlobalNorm applied to dygraph parameter gradients).

The counterpart of the JAX package's ``dygraph_grad_clip.py``: each
``_clip`` takes (param, grad tensor) pairs and returns the clipped pairs,
in torch on the gradients' device."""

import torch

__all__ = ["GradClipByValue", "GradClipByNorm", "GradClipByGlobalNorm"]


class GradClipByValue:
    def __init__(self, min_value, max_value=None):
        if max_value is None:
            min_value, max_value = -abs(min_value), abs(min_value)
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def _clip(self, params_grads):
        return [(p, None if g is None
                 else torch.clamp(g, self.min_value, self.max_value))
                for p, g in params_grads]


class GradClipByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g)))
            out.append((p, torch.where(norm > self.clip_norm,
                                       g * (self.clip_norm / norm), g)))
        return out


class GradClipByGlobalNorm:
    def __init__(self, max_global_norm):
        self.max_global_norm = float(max_global_norm)

    def _clip(self, params_grads):
        sq = sum(torch.sum(torch.square(g)) for _, g in params_grads
                 if g is not None)
        gnorm = torch.sqrt(torch.as_tensor(sq, dtype=torch.float32)
                           if not isinstance(sq, torch.Tensor) else sq)
        factor = self.max_global_norm / torch.clamp(gnorm,
                                                    min=self.max_global_norm)
        return [(p, None if g is None else g * factor)
                for p, g in params_grads]
