"""DeepFM CTR training at one device (counterpart of
``paddle_tpu/models/deepfm.py`` and of ``bench.py``'s DeepFM step variants;
BASELINE config 5: sparse embedding lookup + SGD).

The parameter tree is the JAX package's: ``w_linear`` [V, 1] and ``embed``
[V, D] (the first- and second-order tables), ``bias`` [1], and ``mlp``, a
list of ``{"w", "b"}`` layers ending in a [., 1] logit layer.  A batch is
``feat_ids`` int32 [B, F] and ``label`` f32 [B].

``make_step_variants(cfg, lr)`` gives the bench's four SGD steps, the same
update through four table-update plumbings:

- ``dense``: gradients of the whole tree (two [V, *] dense table
  gradients);
- ``fused``: one [V, D+1] table (``fuse_tables``), one gather, one dense
  table gradient;
- ``rows``: the fused table, differentiated with respect to the gathered
  rows (the SelectedRows discipline), merged by ``sparse.merge_rows(via=
  "xla")`` (compacted unique rows) and added back once per unique row;
- ``segment``: as ``rows``, with the merge done by the segment-sum kernel
  (``kernels/segment_update.py``; unique rows at their first sorted
  position) — the trainer's default and the slice's main path.

``build_deepfm_trainer(cfg, mesh=make_mesh(dp=n))`` row-shards both
tables over the mesh's dp ranks (``deepfm_param_specs``, the reference's
``deepfm_loss_sharded`` through ``parallel/embedding.py``'s lookups, whose
backward merges duplicate ids with the segment-sum kernel) and psums the
MLP's gradients (``make_sharded_step``).

The steps are functional, as the reference's are: they return a new
parameter tree and leave the values they were given untouched, so the
autotune can time every variant from the same parameters.  Table gathers
read ids as JAX's jitted gather does (``take_rows``: negative ids count from
the end, the rest are clamped, out-of-range ids send no gradient); table
updates drop out-of-range rows without a host sync (``scatter_rows_drop``).
"""

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from .._tree import tree_leaves, tree_map
from ..convert import params_from_numpy
from ..kernels._common import resolve_device
from ..kernels.segment_update import dedup_segment_sum, scatter_rows_drop
from ..parallel.train import TrainState, grads_of
from ..sparse import merge_rows

__all__ = ["DeepFMConfig", "deepfm_tiny_config", "init_deepfm_params",
           "deepfm_forward", "deepfm_loss", "take_rows", "fuse_tables", "split_tables",
           "deepfm_loss_from_rows", "deepfm_loss_fused", "deepfm_param_specs",
           "deepfm_forward_sharded", "deepfm_loss_sharded",
           "make_sharded_step", "make_step_variants", "autotune_step", "synthetic_batch",
           "mlp_train_flops", "DeepFMTrainer", "build_deepfm_trainer"]

@dataclasses.dataclass
class DeepFMConfig:
    num_features: int = 1000000     # total sparse feature ids
    num_fields: int = 39            # slots per example (criteo-style)
    embed_dim: int = 10
    mlp_dims: tuple = (400, 400, 400)
    dtype: str = "float32"

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)


def deepfm_tiny_config(**kw):
    d = dict(num_features=1000, num_fields=8, embed_dim=4, mlp_dims=(16, 8))
    d.update(kw)
    return DeepFMConfig(**d)


def init_deepfm_params(gen, cfg, device):
    """The JAX package's tree, shapes, dtypes and scales on ``device``;
    ``gen`` is a CPU ``torch.Generator``."""
    dt = cfg.torch_dtype
    randn = lambda *shape: torch.randn(*shape, generator=gen)
    params = {
        "w_linear": (randn(cfg.num_features, 1) * 0.01).to(dt),
        "embed": (randn(cfg.num_features, cfg.embed_dim) * 0.01).to(dt),
        "bias": torch.zeros(1, dtype=dt),
        "mlp": [],
    }
    din = cfg.num_fields * cfg.embed_dim
    for d in tuple(cfg.mlp_dims) + (1,):
        params["mlp"].append({"w": (randn(din, d) / din ** 0.5).to(dt),
                              "b": torch.zeros(d, dtype=dt)})
        din = d
    return tree_map(lambda t: t.to(device), params)


def _deepfm_head(params, emb, lin):
    """FM + MLP + logit head: emb [B, F, D], lin [B, F] -> logits [B] f32."""
    # FM second-order: 0.5 * ((sum v)^2 - sum v^2)
    s = emb.sum(dim=1)                                  # [B, D]
    fm = 0.5 * (s.square() - emb.square().sum(dim=1)).sum(dim=-1)
    x = emb.reshape(emb.shape[0], -1)
    for layer in params["mlp"][:-1]:
        x = F.relu(x @ layer["w"] + layer["b"])
    deep = (x @ params["mlp"][-1]["w"] + params["mlp"][-1]["b"])[:, 0]
    return (lin.sum(dim=1) + fm + deep + params["bias"][0]).float()


def _sigmoid_xent(logits, label):
    """Mean sigmoid cross-entropy in the reference's stable form."""
    y = label.float()
    loss = (torch.clamp_min(logits, 0) - logits * y
            + torch.log1p(torch.exp(-logits.abs())))
    return loss.mean()


def take_rows(table, ids):
    """``table[ids]`` as JAX's gather takes it under ``jit``: an id below 0
    counts from the end (``id + V``), the row read is that id clamped to
    ``[0, V)``, and only ids that were in range after that send a gradient
    into ``table``.  Torch indexing would wrap every negative id and raise
    (on the card: a device assert) for an id of ``V`` or more.  The gather
    is ``F.embedding``, whose backward sums repeated ids in parallel:
    indexing's backward adds a run of equal ids serially, which took 15 ms
    a call on an H100 for the ~15,000 padding ids of an NMT batch."""
    V = table.shape[0]
    ids = ids.long()
    n = torch.where(ids < 0, ids + V, ids)
    rows = F.embedding(n.clamp(0, V - 1), table)
    hit = ((n >= 0) & (n < V)).view(*ids.shape, *([1] * (rows.dim() - ids.dim())))
    return torch.where(hit, rows, rows.detach())


def deepfm_forward(params, feat_ids, cfg):
    """feat_ids: [B, num_fields] int.  Returns logits [B]."""
    emb = take_rows(params["embed"], feat_ids)          # [B, F, D] gather
    lin = take_rows(params["w_linear"], feat_ids)[..., 0]   # [B, F]
    return _deepfm_head(params, emb, lin)


def deepfm_loss(params, batch, cfg):
    """Sigmoid cross-entropy on click labels."""
    return _sigmoid_xent(deepfm_forward(params, batch["feat_ids"], cfg),
                         batch["label"])


def fuse_tables(params):
    """[V, D+1] fused table: embedding columns ‖ first-order weight, so one
    gather serves the FM/deep inputs and the wide term."""
    return torch.cat([params["embed"], params["w_linear"]], dim=1)


def split_tables(params, fused):
    """Inverse of fuse_tables: the canonical tree with ``embed`` and
    ``w_linear`` as column views of ``fused``."""
    d = params["embed"].shape[1]
    out = dict(params)
    out["embed"] = fused[:, :d]
    out["w_linear"] = fused[:, d:]
    return out


def deepfm_loss_from_rows(params, rows, label, cfg):
    """Loss from pre-gathered fused rows [B, F, D+1]; its gradient with
    respect to ``rows`` is the per-occurrence row gradient."""
    emb = rows[..., :cfg.embed_dim]
    lin = rows[..., cfg.embed_dim]
    return _sigmoid_xent(_deepfm_head(params, emb, lin), label)


def deepfm_loss_fused(params, fused, batch, cfg):
    """deepfm_loss computed through the fused table (one gather)."""
    return deepfm_loss_from_rows(params, take_rows(fused, batch["feat_ids"]),
                                 batch["label"], cfg)


def deepfm_param_specs(cfg, axis="dp"):
    """PartitionSpecs matching ``init_deepfm_params``' tree: the tables
    row-sharded over ``axis`` (``rules.row_sharded_table_spec``, the layout
    the host parameter server's router shares), everything else
    replicated; derived from the rule tree (``parallel/rules.py``
    ``deepfm_rules``), not spec literals."""
    from ..parallel import rules as shard_rules

    leaf = shard_rules.SkeletonLeaf
    skeleton = {
        "w_linear": leaf(),
        "embed": leaf(),
        "bias": leaf(),
        "mlp": [{"w": leaf(), "b": leaf()}
                for _ in range(len(cfg.mlp_dims) + 1)],
    }
    return shard_rules.match_partition_rules(
        shard_rules.deepfm_rules(axis), skeleton)


def deepfm_forward_sharded(params, feat_ids_local, cfg, axis="dp"):
    """``deepfm_forward`` with row-sharded tables (this rank's row blocks)
    and a batch-sharded feed (this rank's rows): each gather is
    ``sharded_embedding_lookup_dp`` (the ids gathered over ``axis``, the
    owned rows gathered, each rank's slot summed back to it)."""
    from ..parallel.embedding import sharded_embedding_lookup_dp

    emb = sharded_embedding_lookup_dp(params["embed"], feat_ids_local, axis)
    lin = sharded_embedding_lookup_dp(
        params["w_linear"], feat_ids_local, axis)[..., 0]
    return _deepfm_head(params, emb, lin)


def deepfm_loss_sharded(params, batch, cfg, axis="dp"):
    """The global batch's mean loss through ``collectives.global_mean_loss``,
    so the row-sharded tables' gradients come out 1x on their owner rank.
    The replicated MLP's and bias's gradients are this rank's partials, to
    be psum'd by the train step (standard data parallelism)."""
    from ..parallel import collectives as col

    logits = deepfm_forward_sharded(params, batch["feat_ids"], cfg, axis)
    y = batch["label"].float()
    loss = (torch.clamp_min(logits, 0) - logits * y
            + torch.log1p(torch.exp(-logits.abs())))
    n = col.axis_size_in(axis)
    return col.global_mean_loss(loss.sum(), loss.numel() * n, axis)


def make_sharded_step(cfg, lr, mesh, axis="dp"):
    """The SGD step over ``mesh`` with the tables row-sharded over
    ``axis``: ``step(params, batch_local) -> (new_params, loss)``, where
    ``params`` holds this rank's table blocks and the replicated MLP and
    bias, and ``batch_local`` this rank's rows.  The MLP's and bias's
    gradients are psum'd over ``axis`` (``tests/test_sparse.py``'s step);
    each table block's gradient is its own rows' (``_OwnedRows``, which
    merges duplicate ids with the segment-sum kernel)."""
    from ..parallel import collectives as col

    def step(params, batch):
        with mesh:
            loss, g = grads_of(
                lambda p: deepfm_loss_sharded(p, batch, cfg, axis), params)
            with torch.no_grad():
                g["mlp"] = tree_map(lambda a: col.psum(a, axis), g["mlp"])
                g["bias"] = col.psum(g["bias"], axis)
        new = tree_map(lambda p, d: p - lr * d.to(p.dtype), params, g)
        return new, loss.detach()

    return step


# -- the step variants (bench.py _deepfm_step_variants) ------------------------

def make_step_variants(cfg, lr):
    """``{"dense", "fused", "rows", "segment"}`` -> ``step(params, batch)
    -> (new_params, loss)``: SGD at ``lr``, the same update through four
    table-update plumbings (module docstring)."""
    D = cfg.embed_dim

    def _head_side(params):
        return {"mlp": params["mlp"], "bias": params["bias"]}

    def _sgd(tree, grads):
        return tree_map(lambda p, g: p - lr * g.to(p.dtype), tree, grads)

    def _with_head(params, out, g_head):
        upd = _sgd(_head_side(params), g_head)
        out["mlp"], out["bias"] = upd["mlp"], upd["bias"]
        return out

    def dense(params, batch):
        loss, g = grads_of(lambda p: deepfm_loss(p, batch, cfg), params)
        return _sgd(params, g), loss.detach()

    def fused(params, batch):
        f = fuse_tables(params)
        loss, (g_f, g_head) = grads_of(
            lambda t: deepfm_loss_fused(t[1], t[0], batch, cfg),
            [f, _head_side(params)])
        out = split_tables(params, f - lr * g_f.to(f.dtype))
        return _with_head(params, out, g_head), loss.detach()

    def _row_grads(params, batch):
        f = fuse_tables(params)
        ids = batch["feat_ids"].reshape(-1)
        shape3 = tuple(batch["feat_ids"].shape) + (D + 1,)
        # differentiate with respect to the gathered rows [N, D+1]
        loss, (g_rows, g_head) = grads_of(
            lambda t: deepfm_loss_from_rows(t[1], t[0].reshape(shape3),
                                            batch["label"], cfg),
            [take_rows(f, ids), _head_side(params)])
        return f, ids, g_rows.contiguous(), g_head, loss.detach()

    def rows(params, batch):
        f, ids, g_rows, g_head, loss = _row_grads(params, batch)
        # the compacted, sorted layout of the XLA lowering
        mrows, mvals = merge_rows(ids, g_rows, f.shape[0], via="xla")
        scatter_rows_drop(f, mrows, (-lr * mvals).to(f.dtype))
        return _with_head(params, split_tables(params, f), g_head), loss

    def segment(params, batch):
        f, ids, g_rows, g_head, loss = _row_grads(params, batch)
        # the kernel's layout: unique rows at their first sorted position
        mrows, mvals = dedup_segment_sum(ids, g_rows, f.shape[0])
        scatter_rows_drop(f, mrows, (-lr * mvals).to(f.dtype))
        return _with_head(params, split_tables(params, f), g_head), loss

    return {"dense": dense, "fused": fused, "rows": rows, "segment": segment}


def _sync(params):
    dev = tree_leaves(params)[0].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def autotune_step(variants, params, batch, iters):
    """Time ``iters`` steps of each variant from ``params`` (after one
    warm-up step) and return ``(name, step_fn, {name: ms per step})`` for
    the fastest.  A variant that fails raises: it is a fault, not a loser."""
    timings, best = {}, None
    for name, step in variants.items():
        p, _ = step(params, batch)                       # warm-up
        _sync(p)
        t0 = time.perf_counter()
        for _ in range(iters):
            p, loss = step(p, batch)
        _sync(p)
        dt = (time.perf_counter() - t0) / iters
        if not torch.isfinite(loss):
            raise RuntimeError("deepfm step variant %r: loss %s" % (name, loss))
        timings[name] = dt * 1e3
        if best is None or dt < best[2]:
            best = (name, step, dt)
        del p
    return best[0], best[1], timings


def synthetic_batch(cfg, batch, seed=0):
    """One host batch as ``bench.py`` makes it: ids uniform in
    ``[0, num_features)`` then labels in {0, 1}, from one numpy stream."""
    rng = np.random.RandomState(seed)
    feat_ids = rng.randint(0, cfg.num_features,
                           (batch, cfg.num_fields)).astype(np.int32)
    label = rng.randint(0, 2, (batch,)).astype(np.float32)
    return {"feat_ids": feat_ids, "label": label}


def mlp_train_flops(cfg, batch):
    """The MLP's matmul FLOPs in one training step (forward, and twice that
    backward): 3 x 2 x B x sum(din x dout)."""
    dims = (cfg.num_fields * cfg.embed_dim,) + tuple(cfg.mlp_dims) + (1,)
    return 3 * 2 * batch * sum(a * b for a, b in zip(dims, dims[1:]))


@dataclasses.dataclass
class DeepFMTrainer:
    """``state``: ``{"params": tree}`` for a step variant (plain SGD), or
    ``{"params", "opt"}`` for a dense step with an optimizer.  With a
    ``mesh`` whose ``axis`` spans more than one rank, ``params`` holds this
    rank's table blocks and the replicated MLP, and ``step`` takes the
    global batch and trains on this rank's rows (``make_sharded_step``)."""
    cfg: DeepFMConfig
    device: torch.device
    variant: str
    state: dict
    optimizer: object = None
    mesh: object = None
    axis: str = "dp"
    _steps: dict = dataclasses.field(default_factory=dict)

    def step(self, batch, lr):
        if self.optimizer is not None:
            loss, grads = grads_of(lambda p, b: deepfm_loss(p, b, self.cfg),
                                   self.state["params"], batch)
            _, update = self.optimizer
            self.state["params"], self.state["opt"] = update(
                grads, self.state["opt"], self.state["params"], lr)
            return loss.detach()
        if lr not in self._steps:
            self._steps[lr] = (
                make_sharded_step(self.cfg, lr, self.mesh, self.axis)
                if self.mesh is not None
                else make_step_variants(self.cfg, lr)[self.variant])
        if self.mesh is not None:
            from ..parallel.rules import P
            from ..parallel.train import shard_batch

            batch = shard_batch(self.mesh, {k: P(self.axis) for k in batch},
                                batch)
        self.state["params"], loss = self._steps[lr](self.state["params"],
                                                     batch)
        return loss


def build_deepfm_trainer(cfg, variant="segment", optimizer=None, seed=0,
                         device=None, params=None, mesh=None, axis="dp"):
    """Params on ``device`` (``cuda`` unless named) and the train step.
    Without ``optimizer`` each step is the bench's SGD step ``variant``
    (``segment`` runs the segment-sum kernel); with one (``adam`` ...) it is
    the dense step through that optimizer, and ``variant`` must be
    ``dense``.  ``params``: a tree to start from instead of a seeded init —
    torch tensors, or numpy arrays as ``jax.tree.map(np.asarray, tree)``
    gives them from the JAX package.  ``mesh``: a mesh whose ``axis`` spans
    several ranks row-shards the tables over it (``deepfm_param_specs``;
    the vocabulary must divide) and trains each rank's rows of the global
    batch with the psum'd MLP (``make_sharded_step``, SGD, the ``segment``
    variant's merge); every rank must start from the same tree.  At one
    rank the mesh changes nothing."""
    if variant not in ("dense", "fused", "rows", "segment"):
        raise ValueError("unknown DeepFM step variant %r" % (variant,))
    if optimizer is not None and variant != "dense":
        raise ValueError("an optimizer runs the dense step; the %r variant "
                         "is plain SGD" % variant)
    if mesh is not None and mesh.shape.get(axis, 1) == 1:
        mesh = None
    if mesh is not None and (optimizer is not None or variant != "segment"):
        raise ValueError("row-sharded DeepFM trains with the segment "
                         "variant's SGD step")
    device = resolve_device(device)
    if params is None:
        params = init_deepfm_params(torch.Generator().manual_seed(seed), cfg,
                                    device)
    else:
        params = params_from_numpy(params, device)
    if mesh is not None:
        from ..parallel.train import shard_pytree

        params = shard_pytree(params, deepfm_param_specs(cfg, axis), mesh)
    state = (TrainState.create(params, optimizer) if optimizer is not None
             else {"params": params})
    return DeepFMTrainer(cfg=cfg, device=device, variant=variant, state=state,
                         optimizer=optimizer, mesh=mesh, axis=axis)
