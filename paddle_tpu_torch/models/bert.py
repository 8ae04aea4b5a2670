"""BERT-style transformer LM pretraining (counterpart of
``paddle_tpu/models/bert.py``): the vocab-parallel embedding, pre-LN blocks
through the flash attention and LayerNorm kernels in the Megatron-SP (or
ring, context-parallel) layout, the GPipe pipeline, the vocab loss, and
LAMB, on a mesh of ranks (``MeshSpec(dp, pp, tp)``; with ``zero=True`` the
optimizer state sharded over dp) or one device.

batch dict: ids/labels int32 [B, S], mask float32 [B, S] (1 where the label
position counts), optionally positions int32 [B, P] with labels/mask [B, P].
"""

import dataclasses

import numpy as np
import torch

from ..convert import params_from_numpy
from ..parallel import collectives as col
from ..parallel import optim
from ..parallel.mesh import DP, PP, MeshSpec
from ..parallel.pipeline import gpipe, split_microbatches
from ..parallel.rules import PartitionSpec as P
from ..parallel.train import (TrainState, make_train_step, shard_pytree,
                              state_specs)
from ..parallel.transformer import (TransformerConfig, embed,
                                    final_logits_loss, grad_sync_axes,
                                    init_transformer_params, run_layers,
                                    transformer_param_specs)

__all__ = ["bert_base_config", "bert_tiny_config", "make_loss_fn",
           "batch_specs", "batch_dtypes", "synthetic_batches", "BertTrainer",
           "build_bert_trainer"]

def bert_base_config(**kw):
    d = dict(vocab_size=30528, hidden=768, n_layers=12, n_heads=12,
             ffn_hidden=3072, max_seq=512, causal=False, dtype="bfloat16")
    d.update(kw)
    return TransformerConfig(**d)


def bert_tiny_config(**kw):
    """Tiny shapes for tests (heads 4)."""
    d = dict(vocab_size=128, hidden=32, n_layers=4, n_heads=4, ffn_hidden=64,
             max_seq=32, causal=False, dtype="float32")
    d.update(kw)
    return TransformerConfig(**d)


def make_loss_fn(cfg: TransformerConfig, n_microbatches=1):
    """Per-rank loss: embed, run the stack (at pp > 1 this stage's layers
    through ``gpipe`` over ``n_microbatches``), the vocab-parallel MLM loss
    over the dp-split global batch; at pp > 1 every rank computes the loss
    and the last stage's is psum'd over pp."""

    def loss_fn(params, batch):
        labels, positions = batch["labels"], batch.get("positions")
        mask = batch["mask"].float()
        x_sp = embed(params, batch["ids"], cfg)             # [b, S/tp, E]
        if cfg.pp > 1:
            lp = {k: v[0] for k, v in params["params_layers"].items()}
            outs = gpipe(lambda p, x: run_layers(p, x, cfg), lp,
                         split_microbatches(x_sp, n_microbatches), axis=PP)
            x_sp = outs.reshape((-1,) + tuple(outs.shape[2:]))
            loss = final_logits_loss(params, x_sp, labels, mask, cfg,
                                     positions=positions)
            is_last = float(col.axis_index(PP) == col.axis_size_in(PP) - 1)
            return col.psum(loss * is_last, PP)
        x_sp = run_layers(params["params_layers"], x_sp, cfg)
        return final_logits_loss(params, x_sp, labels, mask, cfg,
                                 positions=positions)

    return loss_fn


def batch_specs(keys=("ids", "labels", "mask")):
    """Each batch key split over dp on its batch dim."""
    return {k: P(DP) for k in keys}


def batch_dtypes(keys=("ids", "labels", "mask")):
    """The torch dtype of each batch key."""
    dtypes = {"ids": torch.int32, "labels": torch.int32,
              "mask": torch.float32, "positions": torch.int32}
    return {k: dtypes[k] for k in keys}


def synthetic_batches(cfg, n, batch, seq, seed=0):
    """``n`` host batches of random pretraining data, as ``bench.py`` makes
    them: ids and labels uniform over the vocab, every position counted."""
    rng = np.random.RandomState(seed)
    return [{"ids": rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
             "mask": np.ones((batch, seq), np.float32)} for _ in range(n)]


@dataclasses.dataclass
class BertTrainer:
    cfg: TransformerConfig
    mesh: object
    device: torch.device
    state: dict
    step_fn: object
    specs: dict
    multi_fn: object = None
    batch_keys: tuple = ("ids", "labels", "mask")

    def step(self, batch, lr):
        """One step over a global batch; each rank trains on its slice."""
        self.state, loss = self.step_fn(self.state, batch, lr)
        return loss

    def run_steps(self, batches, lr):
        """N steps over batches with a leading [N] step axis (staged with
        parallel.train.stack_batches).  Returns losses [N]."""
        if self.multi_fn is None:
            raise RuntimeError("trainer built without multi-step support")
        self.state, losses = self.multi_fn(self.state, batches, lr)
        return losses


def build_bert_trainer(cfg, mesh_spec: MeshSpec = None, optimizer=None,
                       n_microbatches=1, seed=0, device=None, params=None,
                       batch_keys=("ids", "labels", "mask")):
    """The mesh of this rank's world (``mesh_spec``, one rank by default;
    its pp and tp must be the config's), params on ``device`` (``cuda``
    unless named) placed by their specs (this rank's shard of a leaf split
    over tp or pp, rank 0's values of a replicated one), optimizer state
    (sharded over dp with ``MeshSpec(zero=True)``), and the train step over
    ``n_microbatches`` at pp > 1 — the ParallelExecutor-constructor
    analogue (parallel_executor.cc:393).  ``params``: the GLOBAL tree to
    start from instead of a seeded init — torch tensors, or numpy arrays as
    ``jax.tree.map(np.asarray, params)`` gives them from the JAX package's
    trainer (its layer leaves ``[pp, L/pp, ...]`` at pp > 1); each rank
    keeps its shard."""
    mesh_spec = mesh_spec or MeshSpec(dp=1, pp=cfg.pp, tp=cfg.tp)
    if mesh_spec.pp != cfg.pp or mesh_spec.tp != cfg.tp:
        raise ValueError("mesh %s against cfg pp=%d tp=%d"
                         % (mesh_spec, cfg.pp, cfg.tp))
    mesh = mesh_spec.build(device=device)
    device = mesh.device
    optimizer = optimizer or optim.lamb()
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = init_transformer_params(gen, cfg, device=device)
    else:
        params = params_from_numpy(params, device)
    pspecs = transformer_param_specs(cfg)
    state = TrainState.create(params, optimizer)
    syncs = grad_sync_axes(cfg)
    loss_fn = make_loss_fn(cfg, n_microbatches=n_microbatches)
    bspecs = batch_specs(batch_keys)
    if mesh_spec.zero:
        from ..parallel.zero import make_zero_train_step

        step_fn, sspecs = make_zero_train_step(
            loss_fn, mesh, pspecs, syncs, optimizer, bspecs)(state)
        multi_fn = None
    else:
        sspecs = state_specs(pspecs, state)
        build = make_train_step(loss_fn, mesh, pspecs, syncs, optimizer,
                                bspecs)
        step_fn, multi_fn = build(state), build.multi(state)
    state = shard_pytree(state, sspecs, mesh)
    return BertTrainer(cfg=cfg, mesh=mesh, device=device, state=state,
                       step_fn=step_fn, specs=sspecs, multi_fn=multi_fn,
                       batch_keys=tuple(batch_keys))
