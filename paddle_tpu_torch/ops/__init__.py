"""Operators on tensors (counterpart of ``paddle_tpu/ops``).  So far the
beam-search step and backtrack that the NMT model decodes with; the
``@register_op`` wrappers of Fluid program mode come with that mode."""

from .beam_search_ops import beam_backtrack, beam_search_step

__all__ = ["beam_search_step", "beam_backtrack"]
