"""Transformer NMT, an encoder-decoder with beam-search decode, at one device
(counterpart of ``paddle_tpu/models/transformer_nmt.py``; BASELINE config 4,
"Transformer NMT (variable-length seq, beam-search decode)").

Variable-length sentences are dense [B, S] ids with length masks.  A batch
is src_ids [B, Ss], src_mask [B, Ss], tgt_in [B, St] (bos-prefixed),
tgt_out [B, St], tgt_mask [B, St] (``datasets.wmt16.wmt16_batch``).  The
parameter tree is the JAX package's: ``src_emb``, ``tgt_emb`` (tied: the
target embedding and the output projection), ``pos_emb``, ``lnf`` and the
layer stacks ``enc`` and ``dec``, every leaf [n_layers, ...] and sliced per
layer, so ``convert.params_from_numpy`` carries the JAX tree across.

No kernel of the port runs here: the reference's LayerNorm (``_ln``, eps
1e-6) and attention (``_mha``) are plain code of the model, and so are
these, in eager ops and cuBLAS products.  They round where the reference
rounds: LayerNorm in f32 with the population variance, cast back to x's
dtype; the attention scores and ``p @ v`` in f32 from inputs cast to f32
(exact for bf16), the probabilities cast to v's dtype before the second
product; masked scores set to the finite -1e30, so a row with no valid key
gets a uniform softmax, not NaN; the logits rounded to the model's dtype,
then f32.  Embedding reads follow JAX's gather (``deepfm.take_rows``).

``beam_search`` keeps the reference's fixed shapes: every step runs the
decoder over all [B * K, T] positions (no KV cache) and projects position t
alone, and the loop never reads a value back to the host.
"""

import dataclasses

import torch

from .._tree import tree_leaves, tree_map
from ..convert import params_from_numpy
from ..kernels._common import resolve_device
from ..ops.beam_search_ops import beam_search_step
from ..parallel import optim
from ..parallel.mesh import DP, make_mesh
from ..parallel.rules import PartitionSpec as P
from ..parallel.train import TrainState, make_train_step
from .deepfm import take_rows

__all__ = ["NMTConfig", "nmt_tiny_config", "init_nmt_params", "encode",
           "decode_logits", "nmt_loss", "beam_search_steps", "rank_beams",
           "beam_search", "batch_to", "nmt_train_flops", "NMTTrainer",
           "build_nmt_trainer"]

NEG = -1e30         # masked attention score (finite, as the reference's)


@dataclasses.dataclass
class NMTConfig:
    src_vocab: int = 32000
    tgt_vocab: int = 32000
    hidden: int = 512
    n_layers: int = 6
    n_heads: int = 8
    ffn_hidden: int = 2048
    max_len: int = 256
    bos_id: int = 0
    eos_id: int = 1
    dtype: str = "float32"

    @property
    def head_dim(self):
        return self.hidden // self.n_heads

    @property
    def tdtype(self):
        return getattr(torch, self.dtype)


def nmt_tiny_config(**kw):
    d = dict(src_vocab=64, tgt_vocab=64, hidden=32, n_layers=2, n_heads=4,
             ffn_hidden=64, max_len=16)
    d.update(kw)
    return NMTConfig(**d)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _dense(gen, i, o, dt):
    return (torch.randn(i, o, generator=gen) / (i ** 0.5)).to(dt)


def _ln_params(E):
    return {"scale": torch.ones(E), "bias": torch.zeros(E)}


def _attn_params(gen, E, dt):
    return {k: _dense(gen, E, E, dt) for k in ("wq", "wk", "wv", "wo")}


def _layer_params(gen, cfg, cross):
    E, F, dt = cfg.hidden, cfg.ffn_hidden, cfg.tdtype
    p = {"ln1": _ln_params(E), "self_attn": _attn_params(gen, E, dt),
         "ln2": _ln_params(E),
         "w1": _dense(gen, E, F, dt), "b1": torch.zeros(F, dtype=dt),
         "w2": _dense(gen, F, E, dt), "b2": torch.zeros(E, dtype=dt)}
    if cross:
        p["lnc"] = _ln_params(E)
        p["cross_attn"] = _attn_params(gen, E, dt)
    return p


def init_nmt_params(gen, cfg: NMTConfig, device=None):
    """The reference's tree and scales from a ``torch.Generator`` (weights
    N(0, 1/fan_in) in the model dtype, LayerNorms f32 ones and zeros), on
    ``device`` (``cuda`` unless named)."""
    device = resolve_device(device)
    E, dt = cfg.hidden, cfg.tdtype

    def stack(cross):
        layers = [_layer_params(gen, cfg, cross) for _ in range(cfg.n_layers)]
        return tree_map(lambda *xs: torch.stack(xs), *layers)

    params = {"enc": stack(False), "dec": stack(True),
              "src_emb": _dense(gen, cfg.src_vocab, E, dt),
              "tgt_emb": _dense(gen, cfg.tgt_vocab, E, dt),
              "pos_emb": _dense(gen, cfg.max_len, E, dt),
              "lnf": _ln_params(E)}
    return tree_map(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layers(stacked):
    """Per-layer views of a stacked [n_layers, ...] layer tree, by one
    ``unbind`` a leaf: its backward stacks the layers' gradients in one
    kernel, where a slice per layer would add a zero-filled full-size
    gradient per layer."""
    views = tree_map(lambda t: t.unbind(0), stacked)
    n = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda v: v[i], views) for i in range(n)]


def _ln(x, p, eps=1e-6):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def _mha(p, xq, xkv, mask, cfg, causal=False):
    """mask: [B, Skv] validity of the kv positions, f32 or bool (nonzero
    counts as valid)."""
    B, Sq, E = xq.shape
    Skv = xkv.shape[1]
    H, D = cfg.n_heads, cfg.head_dim
    q = (xq @ p["wq"]).reshape(B, Sq, H, D)
    k = (xkv @ p["wk"]).reshape(B, Skv, H, D)
    v = (xkv @ p["wv"]).reshape(B, Skv, H, D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (D ** 0.5)
    if mask is not None:
        valid = mask if mask.dtype == torch.bool else mask != 0
        s = torch.where(valid[:, None, None, :], s, NEG)
    if causal:
        tril = torch.ones(Sq, Skv, dtype=torch.bool, device=s.device).tril()
        s = torch.where(tril, s, NEG)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, E).to(xq.dtype) @ p["wo"]


def _ffn(p, x):
    return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _enc_layer(p, x, src_mask, cfg):
    h = _ln(x, p["ln1"])
    x = x + _mha(p["self_attn"], h, h, src_mask, cfg)
    return x + _ffn(p, _ln(x, p["ln2"]))


def _dec_layer(p, x, memory, src_mask, cfg):
    h = _ln(x, p["ln1"])
    x = x + _mha(p["self_attn"], h, h, None, cfg, causal=True)
    x = x + _mha(p["cross_attn"], _ln(x, p["lnc"]), memory, src_mask, cfg)
    return x + _ffn(p, _ln(x, p["ln2"]))


def encode(params, src_ids, src_mask, cfg):
    S = src_ids.shape[1]
    x = take_rows(params["src_emb"], src_ids) + params["pos_emb"][:S][None]
    for pl in _layers(params["enc"]):
        x = _enc_layer(pl, x, src_mask, cfg)
    return x


def decode_logits(params, memory, src_mask, tgt_ids, cfg, position=None):
    """position=None: project every position (training), [B, T, V] f32.
    position=t: run the decoder stack but project ONLY position t through
    the vocab head, [B, 1, V] (clamped into [0, T) as ``dynamic_slice``
    does): beam search reads one step, so [B, T, V] never exists there."""
    S = tgt_ids.shape[1]
    x = take_rows(params["tgt_emb"], tgt_ids) + params["pos_emb"][:S][None]
    for pl in _layers(params["dec"]):
        x = _dec_layer(pl, x, memory, src_mask, cfg)
    x = _ln(x, params["lnf"])
    if position is not None:
        t = min(max(int(position), 0), S - 1)
        x = x[:, t:t + 1]
    return (x @ params["tgt_emb"].t()).float()


def nmt_loss(params, batch, cfg: NMTConfig):
    """Teacher-forced token NLL, averaged over the tgt_mask."""
    memory = encode(params, batch["src_ids"], batch["src_mask"], cfg)
    logits = decode_logits(params, memory, batch["src_mask"],
                           batch["tgt_in"], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, batch["tgt_out"].long()[..., None],
                                dim=-1)[..., 0]
    m = batch["tgt_mask"].float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# beam search (math/beam_search.h semantics: top-K over beam x vocab,
# length-normalised, finished beams frozen on EOS)
# ---------------------------------------------------------------------------

@torch.no_grad()
def beam_search_steps(params, src_ids, src_mask, cfg: NMTConfig, beam_size=4,
                      max_len=None):
    """``beam_search``'s decode loop, one step at a time.  Yields
    ``(t, cur, before, after)`` for t = 0 .. T - 1: ``cur`` [B, K, V] is
    step t's log-probs and ``before`` / ``after`` the state
    ``(seqs [B, K, T + 1] int32, logp [B, K], finished [B, K])`` around the
    step.  A checker can stop where two runs first part."""
    B, K, V = src_ids.shape[0], beam_size, cfg.tgt_vocab
    T = max_len or cfg.max_len
    dev = src_ids.device
    memory = encode(params, src_ids, src_mask, cfg)
    mem_k = memory.repeat_interleave(K, dim=0)                  # [B*K, Ss, E]
    mask_k = src_mask.repeat_interleave(K, dim=0)

    seqs = torch.full((B, K, T + 1), cfg.eos_id, dtype=torch.int32, device=dev)
    seqs[:, :, 0] = cfg.bos_id
    # only beam 0 live at first (the beams are identical otherwise)
    logp = (torch.where(torch.arange(K, device=dev)[None] == 0, 0.0, -1e9)
            * torch.ones((B, 1), device=dev))
    state = (seqs, logp, torch.zeros((B, K), dtype=torch.bool, device=dev))
    for t in range(T):
        seqs, logp, finished = state
        flat = seqs.reshape(B * K, T + 1)[:, :T]
        logits = decode_logits(params, mem_k, mask_k, flat, cfg, position=t)
        cur = torch.log_softmax(logits, dim=-1)[:, 0].reshape(B, K, V)
        top, tok, parent = beam_search_step(logp, cur, K, cfg.eos_id, finished)
        parent = parent.long()
        new_seqs = torch.take_along_dim(seqs, parent[..., None], dim=1)
        new_seqs[:, :, t + 1] = tok
        new_fin = (torch.take_along_dim(finished, parent, dim=1)
                   | (tok == cfg.eos_id))
        after = (new_seqs, top, new_fin)
        yield t, cur, state, after
        state = after


def rank_beams(seqs, logp, cfg: NMTConfig, alpha=0.6):
    """GNMT length penalty, score = logp / ((5 + len) / 6) ** alpha, then
    the beams best first (a stable sort, as ``jnp.argsort``).  Returns
    (sequences [B, K, T] without the bos column, scores [B, K])."""
    lengths = (seqs[:, :, 1:] != cfg.eos_id).sum(-1) + 1
    scores = logp / (((5.0 + lengths) / 6.0) ** alpha)
    order = torch.argsort(-scores, dim=1, stable=True)
    seqs = torch.take_along_dim(seqs, order[..., None], dim=1)
    return seqs[:, :, 1:], torch.take_along_dim(scores, order, dim=1)


def beam_search(params, src_ids, src_mask, cfg: NMTConfig, beam_size=4,
                max_len=None, alpha=0.6):
    """Returns (sequences [B, beam, T] int32, scores [B, beam]) best first.
    ``src_mask``: [B, Ss], bool or f32."""
    state = None
    for _, _, _, state in beam_search_steps(params, src_ids, src_mask, cfg,
                                            beam_size, max_len):
        pass
    return rank_beams(state[0], state[1], cfg, alpha)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def batch_to(batch, device):
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def nmt_train_flops(cfg: NMTConfig, batch, src_len, tgt_len):
    """Matrix-product FLOPs of one training step: 2 per multiply-add, and
    the backward twice the forward, so 6 x the forward's multiply-adds.
    Per source token: each encoder layer's q, k, v, o (4 E^2) and FFN
    (2 E F), its scores and p @ v over src_len keys (2 src_len E), and each
    decoder layer's cross-attention k, v of the memory (2 E^2).  Per target
    token: each decoder layer's self q, k, v, o and cross q, o (6 E^2), FFN
    (2 E F), self- and cross-attention over tgt_len and src_len keys (all
    of them: the reference masks, it does not skip), and the tied vocab
    head (E V)."""
    E, F, L, V = cfg.hidden, cfg.ffn_hidden, cfg.n_layers, cfg.tgt_vocab
    per_src = L * (4 * E * E + 2 * E * F + 2 * src_len * E + 2 * E * E)
    per_tgt = (L * (6 * E * E + 2 * E * F + 2 * (tgt_len + src_len) * E)
               + E * V)
    return 6 * batch * (src_len * per_src + tgt_len * per_tgt)


@dataclasses.dataclass
class NMTTrainer:
    cfg: NMTConfig
    mesh: object
    device: torch.device
    state: dict
    step_fn: object

    def step(self, batch, lr):
        self.state, loss = self.step_fn(self.state, batch, lr)
        return loss


def build_nmt_trainer(cfg, optimizer=None, seed=0, device=None, params=None):
    """Params on ``device`` (``cuda`` unless named), optimizer state (SGD
    unless given: ``p - lr * g`` cast to p's dtype, the step ``bench.py``'s
    NMT line takes) and the train step over a one-rank mesh.  ``params``: a
    tree to start from instead of a seeded init — torch tensors, or numpy
    arrays as ``jax.tree.map(np.asarray, params)`` gives them from the JAX
    package."""
    mesh = make_mesh(device=device)
    device = mesh.device
    optimizer = optimizer or optim.sgd()
    if params is None:
        params = init_nmt_params(torch.Generator().manual_seed(seed), cfg,
                                 device)
    else:
        params = params_from_numpy(params, device)
    state = TrainState.create(params, optimizer)
    build = make_train_step(
        lambda p, b: nmt_loss(p, b, cfg), mesh, tree_map(lambda _: P(), params),
        tree_map(lambda _: (DP,), params), optimizer,
        {k: P(DP) for k in ("src_ids", "src_mask", "tgt_in", "tgt_out",
                            "tgt_mask")})
    return NMTTrainer(cfg=cfg, mesh=mesh, device=device, state=state,
                      step_fn=build(state))
