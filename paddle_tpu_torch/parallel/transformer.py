"""Transformer building blocks (counterpart of
``paddle_tpu/parallel/transformer.py`` at tp = pp = 1, ``attn_mode="heads"``):
per-rank code whose loss sums over the dp axis (``collectives.psum``), with
the reference's param specs and gradient sync axes.  Tensor, sequence and
ring parallelism wait for ROADMAP.md Queue 1 item 5-C.

Parameters keep the JAX package's tree and layout: per-layer leaves are
stacked ``[L, ...]`` and matrices are ``[in, out]``, so a tree converted
from the JAX package (``convert.params_from_numpy``) drops in unchanged.

Behaviours kept from the reference:
- GELU is the tanh form (``jax.nn.gelu``'s default);
- LayerNorm eps is 1e-6; the final LN runs unfused;
- attention has no key-padding mask (``batch["mask"]`` only weights the loss);
- ``bqkv`` is ``[L, 3, E]`` and the LM head is tied to ``tok_emb``;
- the vocab loss streams over 4 chunks and its backward rounds the softmax
  gradient to bf16 even in f32 configs.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._tree import tree_map
from . import collectives as col
from .mesh import DP, PP, TP
from ..kernels.flash_attention import attention_reference, flash_attention_packed
from ..kernels.layer_norm import fused_layer_norm, layer_norm_reference
from ..kernels._common import resolve_device

__all__ = ["TransformerConfig", "init_transformer_params",
           "transformer_param_specs", "grad_sync_axes", "embed",
           "layer_norm", "transformer_layer", "run_layers",
           "final_logits_loss"]


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 32000
    hidden: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_hidden: int = 3072
    max_seq: int = 512
    dtype: str = "bfloat16"          # compute/param dtype
    causal: bool = False             # False = BERT (bidirectional), True = GPT
    attn_mode: str = "heads"         # "heads"; "ring" waits for item 5-C
    remat: bool = False              # torch.utils.checkpoint per layer
    tp: int = 1                      # tensor-parallel degree (1; item 5-C)
    pp: int = 1                      # pipeline stages (1; item 5-C)
    use_flash: bool = True           # the flash-attention kernel
    flash_block_q: int = 512         # TPU kernel block sizes: accepted, unused
    flash_block_k: int = 512
    scan_unroll: int = 1             # XLA compile knob: accepted, ignored

    @property
    def head_dim(self):
        return self.hidden // self.n_heads

    @property
    def tdtype(self):
        return getattr(torch, self.dtype)


# ---------------------------------------------------------------------------
# Parameter init: the reference's tree; values come from a torch.Generator
# (the streams differ from jax.random; parity tests carry JAX's values over).
# ---------------------------------------------------------------------------

def _dense_init(gen, fan_in, shape, dtype):
    std = 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, dtype=torch.float32) * std).to(dtype)


def init_transformer_params(generator, cfg: TransformerConfig, device=None):
    """The init_transformer_params tree of the JAX package, on ``device``."""
    device = resolve_device(device)
    E, Fh, L, V = cfg.hidden, cfg.ffn_hidden, cfg.n_layers, cfg.vocab_size
    dt = cfg.tdtype

    def stack(fan_in, shape):
        return torch.stack([_dense_init(generator, fan_in, shape, dt)
                            for _ in range(L)])

    layer = {
        "ln1_scale": torch.ones(L, E),
        "ln1_bias": torch.zeros(L, E),
        "wq": stack(E, (E, E)),
        "wk": stack(E, (E, E)),
        "wv": stack(E, (E, E)),
        "bqkv": torch.zeros(L, 3, E, dtype=dt),
        "wo": stack(E, (E, E)),
        "bo": torch.zeros(L, E, dtype=dt),
        "ln2_scale": torch.ones(L, E),
        "ln2_bias": torch.zeros(L, E),
        "w1": stack(E, (E, Fh)),
        "b1": torch.zeros(L, Fh, dtype=dt),
        "w2": stack(Fh, (Fh, E)),
        "b2": torch.zeros(L, E, dtype=dt),
    }
    params = {
        "tok_emb": _dense_init(generator, E, (V, E), dt),
        "pos_emb": _dense_init(generator, E, (cfg.max_seq, E), dt),
        "lnf_scale": torch.ones(E),
        "lnf_bias": torch.zeros(E),
        "params_layers": layer,
    }
    return tree_map(lambda t: t.to(device), params)


def _param_skeleton():
    """The init_transformer_params tree STRUCTURE without tensors — what the
    sharding rules resolve against when no live params exist yet."""
    from .rules import SkeletonLeaf

    layer = {k: SkeletonLeaf() for k in (
        "ln1_scale", "ln1_bias", "wq", "wk", "wv", "bqkv", "wo", "bo",
        "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")}
    return {"tok_emb": SkeletonLeaf(), "pos_emb": SkeletonLeaf(),
            "lnf_scale": SkeletonLeaf(), "lnf_bias": SkeletonLeaf(),
            "params_layers": layer}


def transformer_param_specs(cfg: TransformerConfig, params=None):
    """PartitionSpec tree matching init_transformer_params' structure,
    derived from the rule tree (``rules.transformer_rules``)."""
    from . import rules as shard_rules

    return shard_rules.match_partition_rules(
        shard_rules.transformer_rules(cfg),
        _param_skeleton() if params is None else params)


def grad_sync_axes(cfg: TransformerConfig):
    """Per-leaf tuple of mesh axes whose gradient contributions must be
    summed (the AllReduceOpHandle placement decision,
    details/all_reduce_op_handle.cc:48): dp always; tp for leaves
    replicated over tp; pp for leaves replicated over pp."""
    specs = transformer_param_specs(cfg)

    def axes(spec_leaf):
        used = {a for part in spec_leaf if part for a in
                ((part,) if isinstance(part, str) else tuple(part))}
        sync = [DP]
        if TP not in used:
            sync.append(TP)   # replicated over tp -> partial grads per seq shard
        if PP not in used:
            sync.append(PP)
        return tuple(sync)

    return tree_map(axes, specs)


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def gelu(x):
    """``jax.nn.gelu``: the tanh approximation (torch's default is erf)."""
    return F.gelu(x, approximate="tanh")


def layer_norm(x, scale, bias, eps=1e-6, fused=True):
    """fused=True runs the LayerNorm kernels; the final LN passes
    fused=False, as in the reference."""
    if fused:
        return fused_layer_norm(x, scale, bias, eps=eps)
    return layer_norm_reference(x, scale, bias, eps=eps)


def embed(params, ids, cfg: TransformerConfig):
    """Token + position embedding: [b, S] ids -> [b, S, E].  An id outside
    ``[0, vocab)`` gets a zero token row and sends no gradient into
    ``tok_emb``, as the reference's vocab-shard mask does at tp = 1."""
    V, S = params["tok_emb"].shape[0], ids.shape[1]
    ids = ids.long()
    hit = (ids >= 0) & (ids < V)
    tok = params["tok_emb"][ids.clamp(0, V - 1)]
    return tok * hit[..., None].to(tok.dtype) + params["pos_emb"][:S][None]


def _attention_heads_mode(pl, h, cfg):
    """q/k/v projections, attention on the packed [b, S, H*D] layout, and
    the output projection.  use_flash=False (the reference's XLA softmax
    path) runs the plain attention, on CPU tensors only."""
    q2 = h @ pl["wq"] + pl["bqkv"][0]
    k2 = h @ pl["wk"] + pl["bqkv"][1]
    v2 = h @ pl["wv"] + pl["bqkv"][2]
    if cfg.use_flash:
        o = flash_attention_packed(q2, k2, v2, cfg.n_heads, causal=cfg.causal)
    elif q2.device.type == "cpu":
        o = attention_reference(q2, k2, v2, cfg.n_heads, causal=cfg.causal)
    else:
        raise NotImplementedError(
            "use_flash=False on %s: on the card attention runs only through "
            "the flash kernels; a non-flash attention kernel (the reference's "
            "ring_attention at axis=None) is ROADMAP.md Queue 1 item 5-C"
            % q2.device)
    return o @ pl["wo"] + pl["bo"]


def transformer_layer(pl, x, cfg: TransformerConfig):
    """One pre-LN transformer block on [b, S, E]."""
    h = layer_norm(x, pl["ln1_scale"], pl["ln1_bias"])
    x = x + _attention_heads_mode(pl, h, cfg)
    h = layer_norm(x, pl["ln2_scale"], pl["ln2_bias"])
    y = gelu(h @ pl["w1"] + pl["b1"]) @ pl["w2"]
    return x + y + pl["b2"]


def run_layers(layer_params, x, cfg: TransformerConfig):
    """The stacked layers in order; remat checkpoints each layer."""
    n = next(iter(layer_params.values())).shape[0]

    def layer(x, i):
        return transformer_layer({k: v[i] for k, v in layer_params.items()},
                                 x, cfg)

    for i in range(n):
        if cfg.remat:
            x = checkpoint(layer, x, i, use_reentrant=False)
        else:
            x = layer(x, i)
    return x


# ---------------------------------------------------------------------------
# Streaming vocab loss
# ---------------------------------------------------------------------------

def _mm_f32(a, b):
    """a @ b with f32 products and output (``preferred_element_type=f32``):
    bf16 pairs go to cuBLAS with an f32 output, anything else runs in f32."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _vocab_chunks(V, n_chunks):
    base = V // n_chunks
    sizes = [base] * (n_chunks - 1) + [V - base * (n_chunks - 1)]
    offs = [sum(sizes[:i]) for i in range(n_chunks)]
    return list(zip(offs, sizes))


def _label_slot(labels, lo, sz):
    local = (labels - lo).clamp(0, sz - 1)
    hit = (labels >= lo) & (labels < lo + sz)
    return local, hit


class _ChunkedVocabNLL(torch.autograd.Function):
    """Per-token nll = lse - picked without materializing [N, V] logits:
    the vocab is processed in chunks with a running max/sum; the backward
    recomputes each chunk's logits and feeds bf16 gradients to the products.
    """

    @staticmethod
    def forward(ctx, x, emb, labels, n_chunks):
        shape = labels.shape
        x2 = x.reshape(-1, x.shape[-1])
        lab = labels.reshape(-1).long()
        N = lab.shape[0]
        m_run = torch.full((N,), -math.inf, device=x.device)
        s_run = torch.zeros(N, device=x.device)
        picked = torch.zeros(N, device=x.device)
        for lo, sz in _vocab_chunks(emb.shape[0], n_chunks):
            logits = _mm_f32(x2, emb[lo:lo + sz].t())               # [N, sz]
            m_new = torch.maximum(m_run, logits.amax(dim=1))
            s_run = s_run * torch.exp(m_run - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=1)
            m_run = m_new
            local, hit = _label_slot(lab, lo, sz)
            pc = logits.gather(1, local[:, None])[:, 0]
            picked = picked + torch.where(hit, pc, 0.0)
        lse = m_run + torch.log(s_run)
        ctx.save_for_backward(x2, emb, lab, lse)
        ctx.meta = (x.shape, n_chunks)
        return (lse - picked).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x2, emb, lab, lse = ctx.saved_tensors
        x_shape, n_chunks = ctx.meta
        g2 = g.reshape(-1).float()
        dx = torch.zeros(x2.shape, device=x2.device)
        demb = torch.empty(emb.shape, device=emb.device)
        for lo, sz in _vocab_chunks(emb.shape[0], n_chunks):
            w = emb[lo:lo + sz]
            p = torch.exp(_mm_f32(x2, w.t()) - lse[:, None])       # softmax chunk
            local, hit = _label_slot(lab, lo, sz)
            p.scatter_add_(1, local[:, None], -hit.float()[:, None])  # p - onehot
            # the reference rounds to bf16 here whatever the config's dtype
            d = (p * g2[:, None]).to(torch.bfloat16)
            dx += _mm_f32(d, w)
            demb[lo:lo + sz] = _mm_f32(d.t(), x2)
        return (dx.to(x2.dtype).reshape(x_shape), demb.to(emb.dtype),
                None, None)


def final_logits_loss(params, x, labels, mask, cfg: TransformerConfig,
                      positions=None):
    """Softmax cross-entropy with the tied embedding head: the token mean
    over the dp-split global batch (the sum of the NLL and the count each
    psum'd over dp, as the reference's ``:433-434``).  ``positions`` [b, P]
    selects the MLM label positions, and then labels/mask are [b, P]."""
    x = layer_norm(x, params["lnf_scale"], params["lnf_bias"], fused=False)
    if positions is not None:
        idx = positions.long()[..., None].expand(-1, -1, x.shape[-1])
        x = torch.gather(x, 1, idx)                               # [b, P, E]
    nll = _ChunkedVocabNLL.apply(x, params["tok_emb"], labels, 4) * mask
    total = col.psum(nll.sum(), DP)
    count = col.psum(mask.float().sum(), DP)
    return total / count.clamp_min(1.0)
