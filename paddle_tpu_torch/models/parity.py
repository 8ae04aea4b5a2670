"""Parity recipes (counterpart of ``paddle_tpu/models/parity.py``).

BASELINE's NMT and DeepFM criteria are behavioural.
``nmt_copy_decode_parity`` overfits the tiny NMT model on a copy task with
Adam, beam-decodes, and returns the fraction of best-beam tokens equal to
the source; the reference's tests hold it above 0.9.
``deepfm_synthetic_auc`` trains the tiny DeepFM with Adam on a learnable
synthetic signal and returns the AUC over the trained ids; the reference's
tests hold it above 0.95.
"""

import numpy as np
import torch

__all__ = ["nmt_copy_decode_parity", "deepfm_synthetic_auc"]


def nmt_copy_decode_parity(seed=1, n=16, seq_len=8, steps=60, lr=3e-3,
                           beam_size=3, params=None, device=None):
    """Overfit ``nmt_tiny_config`` on a copy task (``n`` sentences of
    ``seq_len`` ids in [2, 20), every position counted), beam-decode the
    first four, and return the fraction of best-beam tokens equal to the
    source (1.0 = exact).  ``params``: the tree to start from (numpy arrays,
    e.g. the JAX package's ``init_nmt_params(PRNGKey(0), cfg)``; default a
    seeded init).  ``device``: ``cuda`` unless named."""
    from ..parallel import optim
    from . import transformer_nmt as nmt

    cfg = nmt.nmt_tiny_config()
    trainer = nmt.build_nmt_trainer(cfg, optimizer=optim.adam(),
                                    device=device, params=params)
    rng = np.random.RandomState(seed)
    S = seq_len
    src = rng.randint(2, min(cfg.src_vocab, 20), (n, S)).astype(np.int32)
    batch = nmt.batch_to({
        "src_ids": src,
        "src_mask": np.ones((n, S), np.float32),
        "tgt_in": np.concatenate([np.zeros((n, 1), np.int32), src[:, :-1]], 1),
        "tgt_out": src,
        "tgt_mask": np.ones((n, S), np.float32),
    }, trainer.device)
    for _ in range(steps):
        trainer.step(batch, lr)
    seqs, _ = nmt.beam_search(
        trainer.state["params"], batch["src_ids"][:4],
        torch.ones((4, S), dtype=torch.bool, device=trainer.device), cfg,
        beam_size=beam_size, max_len=S)
    return float(np.mean(seqs[:, 0, :S].cpu().numpy() == src[:4]))


def _auc(scores, label):
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    npos, nneg = label.sum(), (1 - label).sum()
    return float((ranks[label == 1].sum() - npos * (npos + 1) / 2)
                 / (npos * nneg))


def deepfm_synthetic_auc(seed=1, n=512, steps=80, lr=1e-2, params=None,
                         device=None):
    """Train tiny DeepFM on a synthetic learnable signal (clickable iff the
    feature id of field 0 is even) and return AUC over the TRAINED ids.

    ``params``: the tree to start from (numpy arrays, e.g. the JAX package's
    ``init_deepfm_params(PRNGKey(0), cfg)``; default a seeded init).
    ``device``: ``cuda`` unless named.  Scored on the training ids on
    purpose: sparse embeddings do not generalise to rows never gathered;
    the criterion is that the sparse path learns at all (1.0 = it does)."""
    from ..parallel import optim
    from . import deepfm

    cfg = deepfm.deepfm_tiny_config()
    trainer = deepfm.build_deepfm_trainer(cfg, variant="dense",
                                          optimizer=optim.adam(),
                                          device=device, params=params)
    rng = np.random.RandomState(seed)
    feats = rng.randint(0, cfg.num_features,
                        (n, cfg.num_fields)).astype(np.int32)
    label = (feats[:, 0] % 2 == 0).astype(np.float32)
    batch = {"feat_ids": torch.from_numpy(feats).to(trainer.device),
             "label": torch.from_numpy(label).to(trainer.device)}
    for _ in range(steps):
        trainer.step(batch, lr)
    with torch.no_grad():
        scores = torch.sigmoid(deepfm.deepfm_forward(
            trainer.state["params"], batch["feat_ids"], cfg))
    return _auc(scores.cpu().numpy(), label)
