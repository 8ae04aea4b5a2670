"""BERT-style transformer LM pretraining at one device (counterpart of
``paddle_tpu/models/bert.py``): embedding, pre-LN blocks through the flash
attention and LayerNorm kernels, the streaming vocab loss, and LAMB.

batch dict: ids/labels int32 [B, S], mask float32 [B, S] (1 where the label
position counts), optionally positions int32 [B, P] with labels/mask [B, P].
"""

import dataclasses

import numpy as np
import torch

from ..convert import params_from_numpy
from ..kernels._common import resolve_device
from ..parallel import optim
from ..parallel.train import TrainState, make_train_step
from ..parallel.transformer import (TransformerConfig, embed,
                                    final_logits_loss, init_transformer_params,
                                    run_layers)

__all__ = ["bert_base_config", "bert_tiny_config", "make_loss_fn",
           "batch_specs", "synthetic_batches", "BertTrainer",
           "build_bert_trainer"]

_UNSUPPORTED = ("%s=%d: the port runs at one device so far; data, tensor and "
                "pipeline parallelism are ROADMAP.md Queue 1 item 5 "
                "(multi-GPU engine)")


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


def _check_single_device(cfg, dp=1):
    for name, deg in (("dp", dp), ("tp", cfg.tp), ("pp", cfg.pp)):
        if deg > 1:
            raise NotImplementedError(_UNSUPPORTED % (name, deg))
    if cfg.attn_mode != "heads":
        raise NotImplementedError(
            "attn_mode=%r: ring attention is ROADMAP.md Queue 1 item 5"
            % cfg.attn_mode)


def make_loss_fn(cfg: TransformerConfig):
    """Loss: embed, run the stack, the MLM loss (pp = 1)."""
    _check_single_device(cfg)

    def loss_fn(params, batch):
        mask = batch["mask"].float()
        x = embed(params, batch["ids"], cfg)
        x = run_layers(params["params_layers"], x, cfg)
        return final_logits_loss(params, x, batch["labels"], mask, cfg,
                                 positions=batch.get("positions"))

    return loss_fn


def batch_specs(keys=("ids", "labels", "mask")):
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
    device: torch.device
    state: dict
    step_fn: object
    multi_fn: object = None

    def step(self, batch, lr):
        self.state, loss = self.step_fn(self.state, batch, lr)
        return loss

    def run_steps(self, batches, lr):
        """N steps over batches with a leading [N] step axis (staged with
        parallel.train.stack_batches).  Returns losses [N]."""
        self.state, losses = self.multi_fn(self.state, batches, lr)
        return losses


def build_bert_trainer(cfg, optimizer=None, seed=0, device=None, params=None,
                       dp=1):
    """Params on ``device`` (``cuda`` unless named), optimizer state, and the
    train step.  ``params``: a tree to start from instead of a seeded init —
    torch tensors, or numpy arrays as ``jax.tree.map(np.asarray, params)``
    gives them from the JAX package."""
    _check_single_device(cfg, dp)
    device = resolve_device(device)
    optimizer = optimizer or optim.lamb()
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = init_transformer_params(gen, cfg, device=device)
    else:
        params = params_from_numpy(params, device)
    state = TrainState.create(params, optimizer)
    build = make_train_step(make_loss_fn(cfg), optimizer)
    return BertTrainer(cfg=cfg, device=device, state=state,
                       step_fn=build(state), multi_fn=build.multi(state))
