"""Beam-search steps and ops on tensors (counterpart of
``paddle_tpu/ops/beam_search_ops.py``: ``beam_search_step``,
``beam_backtrack`` and the ``beam_search`` / ``beam_search_decode`` op
rules that a program-mode decode loop runs; parity: math/beam_search.h,
beam_search_op.cc, beam_search_decode_op.cc).

Beams are a dense [B, K] axis.  One decode step keeps the best K of the
K * V accumulated candidate scores of each source sentence; the parent
pointers gathered step by step are walked back in one pass.

Ties go to the lower flat index, as ``lax.top_k`` breaks them: the
selection is a stable descending sort of the [B, K * V] scores cut to K.
``torch.topk`` promises no order among equal values.  Ties are real: a
frozen beam's non-EOS candidates all score ``pre_score - 1e9``, and at
1e9 one f32 ulp is 64, so ``-1e9 + logp`` collapses to a few values.
"""

import torch

from ..registry import register_op
from .common import x, out

__all__ = ["beam_search_step", "beam_backtrack"]

FROZEN = -1e9       # a frozen beam's score for any continuation but EOS


def beam_search_step(pre_scores, scores, beam_size, end_id, finished=None,
                     accumulated=False):
    """One beam advance, statically shaped.

    pre_scores: [B, K] accumulated log-probs; scores: [B, K, V], this
    step's per-token log-probs when ``accumulated`` is false (added to
    pre_scores), else the accumulated candidate scores, used as they are.
    finished: [B, K] bool; a finished beam admits only a zero-cost EOS
    continuation and keeps its pre_score.
    Returns (sel_scores [B, K], sel_tokens [B, K] int32, parent [B, K]
    int32), best first.
    """
    B, K, V = scores.shape
    total = scores if accumulated else pre_scores[..., None] + scores
    if finished is not None:
        eos_only = torch.full((V,), FROZEN, dtype=total.dtype,
                              device=total.device)
        eos_only[end_id] = 0.0
        frozen = pre_scores[..., None] + eos_only
        total = torch.where(finished[..., None], frozen, total)
    sel, idx = torch.sort(total.reshape(B, K * V), dim=1, descending=True,
                          stable=True)
    sel, idx = sel[:, :beam_size], idx[:, :beam_size]
    parent = torch.div(idx, V, rounding_mode="floor").to(torch.int32)
    return sel, (idx % V).to(torch.int32), parent


def beam_backtrack(step_tokens, step_parents, bos_id=None):
    """Sequences from per-step (token, parent) pairs, the tree walk of
    beam_search_decode_op.cc.  step_tokens / step_parents: [T, B, K].
    Returns [B, K, T]: column j is the history of final beam j (best first
    when the last step's selection is sorted, as ``beam_search_step``'s
    is).  ``bos_id`` is unused, as in the reference."""
    T, B, K = step_tokens.shape
    beam = torch.arange(K, device=step_tokens.device).expand(B, K)
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(torch.gather(step_tokens[t], 1, beam))
        beam = torch.gather(step_parents[t], 1, beam).long()
    return torch.stack(toks[::-1], dim=-1)


@register_op("beam_search")
def _beam_search(ins, attrs, ctx):
    """Inputs pre_ids [B, K], pre_scores [B, K], scores [B, K, V]: the
    accumulated candidate scores when is_accumulated (the default), else
    this step's probabilities, whose logs are added to pre_scores.  A beam
    whose pre_id is end_id is finished.  Outputs selected_ids,
    selected_scores and parent_idx, [B, K]."""
    pre_scores, scores, pre_ids = (x(ins, "pre_scores"), x(ins, "scores"),
                                   x(ins, "pre_ids"))
    beam_size = int(attrs.get("beam_size", scores.shape[1]))
    end_id = int(attrs.get("end_id", 0))
    finished = None if pre_ids is None else pre_ids == end_id
    if attrs.get("is_accumulated", True):
        sel_scores, tokens, parent = beam_search_step(
            pre_scores, scores, beam_size, end_id, finished, accumulated=True)
    else:
        logp = torch.log(scores.clamp_min(1e-20))
        sel_scores, tokens, parent = beam_search_step(
            pre_scores, logp, beam_size, end_id, finished)
    return out(selected_ids=tokens, selected_scores=sel_scores,
               parent_idx=parent)


@register_op("beam_search_decode")
def _beam_search_decode(ins, attrs, ctx):
    """Inputs Ids and ParentIdx [T, B, K], optional Scores [B, K].  Outputs
    SentenceIds [B, K, T] (best first, as beam_search's selection is
    sorted) and SentenceScores [B, K] when Scores is given."""
    res = {"SentenceIds": [beam_backtrack(x(ins, "Ids"), x(ins, "ParentIdx"))]}
    scores = x(ins, "Scores")
    if scores is not None:
        res["SentenceScores"] = [scores]
    return res
