"""Transformer building blocks (counterpart of
``paddle_tpu/parallel/transformer.py``): per-rank code over the mesh of
``mesh.py``, in the reference's Megatron-SP layout.

- ``attn_mode="heads"`` (Megatron-SP): activations live sequence-sharded
  over the tp axis between blocks, [b, S/tp, E]; each block all-gathers
  the sequence, computes with heads and the FFN split over tp (column-
  parallel in, row-parallel out) and reduce-scatters back to the sequence
  shard: 2 all-gathers and 2 reduce-scatters a block.
- ``attn_mode="ring"`` (context parallel): activations stay
  sequence-sharded through attention; K/V go round the ring
  (``ring_attention.py``); the weights are replicated over tp.
- The embedding is vocab-parallel (each tp rank holds a vocab slice and
  masks the ids outside it; the vocab partial sums and the sequence scatter
  are one reduce-scatter), and at tp > 1 the LM loss is a vocab-parallel
  softmax cross-entropy over [b, *, V/tp] logits.

Parameters keep the JAX package's tree and layout: per-layer leaves are
stacked ``[L, ...]`` (``[pp, L/pp, ...]`` at pp > 1) and matrices are
``[in, out]``, so a tree converted from the JAX package
(``convert.params_from_numpy``) drops in unchanged, and each rank keeps its
shard (``train.shard_pytree``).

Behaviours kept from the reference:
- GELU is the tanh form (``jax.nn.gelu``'s default);
- LayerNorm eps is 1e-6; the final LN runs unfused;
- attention has no key-padding mask (``batch["mask"]`` only weights the loss);
- ``bqkv`` is ``[L, 3, E]`` and the LM head is tied to ``tok_emb``;
- at tp = 1 the vocab loss streams over 4 chunks and its backward rounds
  the softmax gradient to bf16 even in f32 configs;
- the position embedding enters the reduce-scatter as ``pos / tp``,
  rounded in the model's dtype.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._tree import tree_map
from . import collectives as col
from .mesh import DP, PP, TP
from ..kernels.flash_attention import flash_attention_packed
from ..kernels.layer_norm import fused_layer_norm, layer_norm_reference
from ..kernels._common import resolve_device
from .ring_attention import ring_attention

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
    attn_mode: str = "heads"         # "heads" (Megatron-SP) or "ring"
    remat: bool = False              # torch.utils.checkpoint per layer
    tp: int = 1                      # tensor-parallel degree (mesh tp size)
    pp: int = 1                      # pipeline stages (mesh pp axis size)
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

    @property
    def layers_per_stage(self):
        if self.n_layers % self.pp:
            raise ValueError("n_layers=%d does not divide over pp=%d"
                             % (self.n_layers, self.pp))
        return self.n_layers // self.pp


# ---------------------------------------------------------------------------
# Parameter init: the reference's tree; values come from a torch.Generator
# (the streams differ from jax.random; parity tests carry JAX's values over).
# ---------------------------------------------------------------------------

def _dense_init(gen, fan_in, shape, dtype):
    std = 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, dtype=torch.float32) * std).to(dtype)


def init_transformer_params(generator, cfg: TransformerConfig, device=None):
    """The init_transformer_params tree of the JAX package, on ``device``
    (the layer leaves ``[pp, L/pp, ...]`` at pp > 1)."""
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
    if cfg.pp > 1:
        lps = cfg.layers_per_stage
        layer = {k: v.reshape((cfg.pp, lps) + tuple(v.shape[1:]))
                 for k, v in layer.items()}
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
    """Vocab-parallel embedding lookup plus the position embedding: [b, S]
    ids -> the sequence-sharded activation [b, S/tp, E].  Each tp rank
    holds the vocab rows [lo, lo + V/tp) and zeroes the ids outside them,
    so an id outside ``[0, vocab)`` gets a zero token row and sends no
    gradient into ``tok_emb``; at tp > 1 the vocab partial sums and the
    sequence scatter are one reduce-scatter."""
    V, S = cfg.vocab_size, ids.shape[1]
    ntp = col.axis_size_in(TP)
    vshard = V // ntp if ntp > 1 else V
    lo = col.axis_index(TP) * vshard
    ids = ids.long()
    hit = (ids >= lo) & (ids < lo + vshard)
    tok = params["tok_emb"][(ids - lo).clamp(0, vshard - 1)]
    emb = tok * hit[..., None].to(tok.dtype)
    pos = params["pos_emb"][:S][None]
    if ntp > 1:
        return col.reduce_scatter(emb + pos / ntp, TP, dim=1)
    return emb + pos


def _attention_heads_mode(pl, h_full, cfg):
    """Megatron attention: the full sequence [b, S, E] in, the heads split
    over tp (wq/wk/wv/bqkv hold this rank's E/tp columns, wo its rows), the
    output projection's partial sums reduce-scattered back to the sequence
    shard.  Attention runs on the packed [b, S, hl*D] layout through the
    flash kernels (which take any S), or at ``use_flash=False`` through
    ``ring_attention(axis=None)``."""
    b, S, _ = h_full.shape
    ntp = col.axis_size_in(TP)
    hl = cfg.n_heads // ntp if ntp > 1 else cfg.n_heads
    q2 = h_full @ pl["wq"] + pl["bqkv"][0]                 # [b, S, hl*dh]
    k2 = h_full @ pl["wk"] + pl["bqkv"][1]
    v2 = h_full @ pl["wv"] + pl["bqkv"][2]
    if cfg.use_flash:
        o = flash_attention_packed(q2, k2, v2, hl, causal=cfg.causal)
    else:
        dh = cfg.head_dim
        o = ring_attention(q2.reshape(b, S, hl, dh), k2.reshape(b, S, hl, dh),
                           v2.reshape(b, S, hl, dh), axis=None,
                           causal=cfg.causal).reshape(b, S, hl * dh)
    out = col.reduce_scatter(o @ pl["wo"], TP, dim=1)      # sum + seq scatter
    return out + pl["bo"]


def _attention_ring_mode(pl, h_sp, cfg):
    """Context-parallel attention: the sequence stays sharded; K/V go
    round the tp ring."""
    b, Sl, _ = h_sp.shape
    H, dh = cfg.n_heads, cfg.head_dim

    def proj(w, bias):
        return (h_sp @ w + bias).reshape(b, Sl, H, dh)

    o = ring_attention(proj(pl["wq"], pl["bqkv"][0]),
                       proj(pl["wk"], pl["bqkv"][1]),
                       proj(pl["wv"], pl["bqkv"][2]), axis=TP,
                       causal=cfg.causal)
    return o.reshape(b, Sl, H * dh) @ pl["wo"] + pl["bo"]


def transformer_layer(pl, x_sp, cfg: TransformerConfig):
    """One pre-LN transformer block on the sequence-sharded [b, S/tp, E]."""
    heads_mode = cfg.attn_mode == "heads"
    h = layer_norm(x_sp, pl["ln1_scale"], pl["ln1_bias"])
    if heads_mode:
        attn = _attention_heads_mode(pl, col.all_gather(h, TP, dim=1), cfg)
    else:
        attn = _attention_ring_mode(pl, h, cfg)
    x_sp = x_sp + attn
    h = layer_norm(x_sp, pl["ln2_scale"], pl["ln2_bias"])
    if heads_mode:
        h = col.all_gather(h, TP, dim=1)
    y = gelu(h @ pl["w1"] + pl["b1"]) @ pl["w2"]          # partial if heads
    if heads_mode:
        y = col.reduce_scatter(y, TP, dim=1)
    return x_sp + y + pl["b2"]


def run_layers(layer_params, x, cfg: TransformerConfig):
    """The (local) stacked layers in order; remat checkpoints each layer."""
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


def final_logits_loss(params, x_sp, labels, mask, cfg: TransformerConfig,
                      positions=None):
    """Softmax cross-entropy with the tied embedding head: the token mean
    over the dp-split global batch (the sum of the NLL and the count each
    psum'd over dp, as the reference's).  ``x_sp`` is sequence-sharded over
    tp; labels/mask are the full [b, S] (or [b, P] when ``positions`` [b, P]
    selects the MLM label positions).  The head gathers the sequence; at
    tp = 1 the vocab loss streams over chunks (no [b, S, V] tensor), at
    tp > 1 the logits stay vocab-sharded [b, *, V/tp] in f32, with the max
    (without a gradient) pmax'd and the exp-sum and the picked logit
    psum'd over tp."""
    x = layer_norm(x_sp, params["lnf_scale"], params["lnf_bias"], fused=False)
    x = col.all_gather(x, TP, dim=1)                           # [b, S, E]
    if positions is not None:
        idx = positions.long()[..., None].expand(-1, -1, x.shape[-1])
        x = torch.gather(x, 1, idx)                               # [b, P, E]
    emb = params["tok_emb"]                                    # [V/tp, E]
    if col.axis_size_in(TP) == 1:
        nll = _ChunkedVocabNLL.apply(x, emb, labels, 4) * mask
    else:
        logits = (x @ emb.t()).float()                         # [b, S, V/tp]
        vshard = logits.shape[-1]
        lo = col.axis_index(TP) * vshard
        mx = col.pmax(logits.amax(dim=-1).detach(), TP)
        lse = torch.log(col.psum(torch.exp(logits - mx[..., None]).sum(
            dim=-1), TP)) + mx
        local, hit = _label_slot(labels.long(), lo, vshard)
        picked = logits.gather(-1, local[..., None])[..., 0]
        picked = col.psum(torch.where(hit, picked, 0.0), TP)
        nll = (lse - picked) * mask
    total = col.psum(nll.sum(), DP)
    count = col.psum(mask.float().sum(), DP)
    return total / count.clamp_min(1.0)
