"""DeepFM over a host-RAM sparse table: the step of the repo's
``bench_deepfm_hostps`` configuration (``bench.py``) as functions.

One ``HostSparseTable`` of width D + 1 carries each feature's embedding and
its first-order weight (one pull instead of two); the dense side is the
DeepFM head (``models/deepfm.py`` ``_deepfm_head``: FM + MLP + bias) with
plain SGD.  Ids are ``zipf(1.3) * 2654435761 % vocab`` (CTR-shaped: a hot
head the device cache earns its keep on), labels the parity of each row's
id sum.

Two routes push the table's gradient:

- ``"host"``: ``pull_unique`` -> the gradient with respect to the UNIQUE
  rows (autograd sums each row's occurrences) -> ``push``;
- ``"merge"``: the gradient per OCCURRENCE ([B * F, D + 1]) ->
  ``push_in_jit(merge=True)``, whose segment-sum kernel sums duplicate rows
  on the device before one copy to the host.

Both give the same update up to the order of the sums.  ``run_loop``
drives the step under ``parallel.train.TrainLoop`` with a
``CheckpointPolicy`` whose ``hostps=[emb]`` puts the table into each
checkpoint, so a preempted run resumes bit for bit.

Run a ShardPS shard owner of the table (a host-RAM server; it touches no
CUDA): ``python -m paddle_tpu_torch.tools.deepfm_hostps --owner --wire DIR
--rank R --world N --vocab V --dim D``; it serves rows
``parallel.rules.hostps_row_range(R, N, V)`` until a client's shutdown
request.  At the bench's
widths (``BENCH``) the table is 200M rows, 8.8 GB of virtual host memory of
which only the touched rows become resident.
"""

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..hostps import HostPSEmbedding, HostSGD, HostSparseTable
from ..hostps.cache import host_to_device
from ..models import deepfm

__all__ = ["BENCH", "zipf_ids", "labels", "make_embedding", "make_table",
           "init_dense", "loss_fn", "train_step", "run_loop", "serve_owner",
           "ROUTES"]

# bench.py bench_deepfm_hostps at its widths for the full-size run
BENCH = dict(vocab=200_000_000, batch=4096, fields=39, dim=10,
             mlp=(400, 400), cache_slots=1 << 18, lr=1e-3)
ROUTES = ("host", "merge")
LOOP_EVERY = 2          # run_loop's checkpoint cadence, in steps


def zipf_ids(rng, batch, fields, vocab):
    """[batch, fields] int64 ids: a zipf-hot head over the vocabulary."""
    z = rng.zipf(1.3, (batch, fields)).astype(np.int64)
    return (z * 2654435761) % vocab


def labels(ids):
    return (ids.sum(axis=1) % 2).astype(np.float32)


def make_table(vocab, dim, name="deepfm_hostps", row_range=None):
    """The [vocab, dim + 1] host table (``HostSGD``, the initializer's seed
    0, as the bench's), or the shard of it that ``row_range`` names."""
    return HostSparseTable(vocab, dim + 1, optimizer=HostSGD(), seed=0,
                           name=name, row_range=row_range)


def make_embedding(vocab, dim, cache_slots, device=None,
                   name="deepfm_hostps"):
    """``make_table``'s table behind a ``HostPSEmbedding`` with
    ``cache_slots`` slots on ``device``."""
    return HostPSEmbedding(make_table(vocab, dim, name),
                           cache_slots=cache_slots, device=device)


def init_dense(gen, fields, dim, mlp, device):
    """The dense DeepFM head (``mlp`` hidden widths, then the logit) and
    its bias, drawn as ``models/deepfm.init_deepfm_params`` draws them."""
    cfg = deepfm.DeepFMConfig(num_features=2, num_fields=fields,
                              embed_dim=dim, mlp_dims=tuple(mlp))
    p = deepfm.init_deepfm_params(gen, cfg, device)
    return {"mlp": p["mlp"], "bias": p["bias"]}


def loss_fn(v, dense, label):
    """v: [B, F, D + 1] rows of the batch -> mean sigmoid cross-entropy."""
    d = v.shape[-1] - 1
    head = dict(dense, w_linear=None, embed=None)
    logits = deepfm._deepfm_head(head, v[..., :d], v[..., d])
    return deepfm._sigmoid_xent(logits, label)


def _leaves(dense):
    return [l[k] for l in dense["mlp"] for k in ("w", "b")] + [dense["bias"]]


def _sgd(dense, grads, lr):
    it = iter(grads)
    mlp = [{k: l[k] - lr * next(it) for k in ("w", "b")}
           for l in dense["mlp"]]
    return {"mlp": mlp, "bias": dense["bias"] - lr * next(it)}


def train_step(emb, dense, ids, label, lr, route="host", next_ids=None,
               record=None):
    """One step: pull this batch's rows (a pending prefetch of ``ids`` is
    consumed), start the prefetch of ``next_ids``, forward and backward,
    push the table's gradient by ``route`` and SGD the dense head.
    Returns (loss tensor, new dense).  ``record``, a dict, receives the
    gradient per occurrence ([B * F, D + 1], ``"occ_grads"``) that either
    route's push sums."""
    if route not in ROUTES:
        raise ValueError("route %r: one of %s" % (route, ROUTES))
    rows, values, inv = emb.pull_unique(ids)
    if next_ids is not None:
        emb.prefetch(next_ids)
    device = values.device
    inv_t = host_to_device(inv, device)
    label_t = host_to_device(np.asarray(label, np.float32), device)
    dense = {"mlp": [{k: t.detach().requires_grad_() for k, t in l.items()}
                     for l in dense["mlp"]],
             "bias": dense["bias"].detach().requires_grad_()}
    leaves = _leaves(dense)
    if route == "host":
        values.requires_grad_()
        # F.embedding's backward sums a row's occurrences in parallel and
        # deterministically; indexing's adds a run of equal ids serially
        # (zipf's hottest id is ~1/4 of the batch) under deterministic
        # algorithms, and with contended atomics otherwise
        v = F.embedding(inv_t, values)
        if record is not None:
            v.register_hook(lambda g: record.__setitem__(
                "occ_grads", g.detach().reshape(-1, g.shape[-1]).clone()))
        loss = loss_fn(v, dense, label_t)
        g_vals, *g_dense = torch.autograd.grad(loss, [values] + leaves)
        emb.push(rows, g_vals[:rows.shape[0]], lr)
    else:
        occ = F.embedding(inv_t, values).detach().requires_grad_()
        loss = loss_fn(occ, dense, label_t)
        g_occ, *g_dense = torch.autograd.grad(loss, [occ] + leaves)
        if record is not None:
            record["occ_grads"] = g_occ.reshape(-1, g_occ.shape[-1])
        flat = np.asarray(ids).reshape(-1).astype(np.int64)
        occ_rows = np.where((flat >= 0) & (flat < emb.vocab_size), flat,
                            emb.vocab_size)
        emb.push_in_jit(host_to_device(occ_rows, device),
                        g_occ.reshape(flat.shape[0], -1), lr, merge=True)
    with torch.no_grad():
        new = _sgd(dense, g_dense, lr)
    return loss.detach(), new


def run_loop(emb, dense, batches, lr, route="host", ckpt=None,
             sigterm_at=None, losses=None):
    """Train ``batches`` ((ids, label) pairs) under ``TrainLoop``, each
    step prefetching the next batch's rows.  With ``ckpt``:
    ``CheckpointPolicy(ckpt, every_steps=LOOP_EVERY, hostps=[emb],
    resume=True)``, and ``sigterm_at`` arms the ``sigterm_step`` drill
    (the guard saves and raises ``SystemExit(PREEMPTED_RC)``).  Returns
    ``(dense, losses, resumed_step)``: the losses by step as float hex,
    filled into ``losses`` when given (a preempted run keeps what it
    trained there)."""
    from .. import ft
    from ..ft import chaos
    from ..parallel.train import TrainLoop

    losses = {} if losses is None else losses
    items = [(ids, label, batches[k + 1][0] if k + 1 < len(batches)
              else None) for k, (ids, label) in enumerate(batches)]

    def step_fn(state, batch):
        ids, label, nxt = batch
        return train_step(emb, state, ids, label, lr, route, next_ids=nxt)[::-1]

    def record(step, loss):
        losses[step] = float(loss.float().cpu()).hex()

    policy = None
    if ckpt is not None:
        policy = ft.CheckpointPolicy(ckpt, every_steps=LOOP_EVERY, keep=2,
                                     resume=True, hostps=[emb])
    loop = TrainLoop(step_fn, checkpoint=policy, on_step=record,
                     sentinel=False)
    if sigterm_at is not None:
        chaos.arm("sigterm_step", at=int(sigterm_at))
    try:
        dense, _ = loop.run(dense, items)
    finally:
        chaos.disarm()
    return dense, losses, loop.resumed_step


def serve_owner(wire, rank, world, vocab, dim):
    """Serve shard ``rank`` of ``world`` of ``make_table``'s table over the
    wire in ``wire`` until a client asks it to shut down."""
    from ..hostps import ShardServer
    from ..parallel.rules import hostps_row_range

    rr = hostps_row_range(rank, world, vocab)
    srv = ShardServer(make_table(vocab, dim, row_range=rr), wire, rank)
    srv.start(restore=False)
    print("deepfm_hostps owner %d: serving rows [%d, %d)" % (rank, *rr),
          flush=True)
    srv.serve_until_shutdown()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--owner", action="store_true", required=True)
    ap.add_argument("--wire", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--vocab", type=int, default=BENCH["vocab"])
    ap.add_argument("--dim", type=int, default=BENCH["dim"])
    args = ap.parse_args(argv)
    return serve_owner(args.wire, args.rank, args.world, args.vocab,
                       args.dim)


if __name__ == "__main__":
    sys.exit(main())
