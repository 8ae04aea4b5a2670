"""Parity recipes (counterpart of ``paddle_tpu/models/parity.py``).

BASELINE's DeepFM criterion is behavioural: the sparse lookup + update path
learns.  ``deepfm_synthetic_auc`` trains the tiny DeepFM with Adam on a
learnable synthetic signal and returns the AUC over the trained ids; the
reference's tests hold it above 0.95.
"""

import numpy as np
import torch

__all__ = ["deepfm_synthetic_auc"]


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
