"""Kill -> resume drill of ``parallel.train.TrainLoop`` over the BERT
trainer (``models.bert.build_bert_trainer``): one process of it.

A run trains ``--steps`` steps of synthetic pretraining batches (made from
``--seed``) under ``CheckpointPolicy(every_steps=--every,
asynchronous=True, keep=2, resume=True)`` in ``--ckpt``; ``--sigterm-at
k`` arms the ``sigterm_step`` drill (``ft/chaos.py``), so the guard makes
its preemption checkpoint at step k and the process exits with
``ft.PREEMPTED_RC`` (120).  Run again with the same ``--ckpt`` and it
resumes there.  ``--no-checkpoint`` runs the never-stopped control.

The process writes ``--out`` (JSON): every trained step's loss (as the
float's hex, bit for bit), a SHA-256 of every leaf of the final state
(params and optimizer state, each rank's blocks), the checkpoints' bytes,
the ms the train thread was blocked by each snapshot against the ms of its
file write, the restore ms, each step's ms and the port kernels' launches
a step.  On a card it runs PyTorch's deterministic algorithms, so two runs
are bit for bit alike.

``--size base`` is BERT-base at its published widths (12 x 768, bf16,
LAMB) and ``--size tiny`` the tests' config.  ``run(world=n)`` in a
process of an initialised n-rank world trains ZeRO over dp = n.

Run: ``python -m paddle_tpu_torch.tools.loop_drill --size tiny --device
cpu --steps 6 --sigterm-at 3 --ckpt /tmp/ck --out /tmp/a.json`` (rc 120),
then the same without ``--sigterm-at`` (resumes, rc 0).
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

SIZES = {
    "tiny": dict(batch=4, seq=16, lr=1e-3),
    "base": dict(batch=64, seq=512, lr=1e-4),
}


def _config(size):
    from ..models import bert

    if size == "base":
        return bert.bert_base_config()
    return bert.bert_tiny_config()


def state_digests(state):
    """{leaf path: sha256 of its bytes} of a state tree (a bf16 leaf by its
    bit pattern)."""
    from ..parallel.rules import leaf_paths

    out = {}
    paths, leaves, _ = leaf_paths(state)
    for p, v in zip(paths, leaves):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = np.ascontiguousarray(t.cpu().numpy())
        out[p] = "%s:%s:%s" % (a.dtype, list(a.shape),
                               hashlib.sha256(a.tobytes()).hexdigest())
    return out


def _events(mon_dir, kind):
    from ..monitor.timeline import read_events

    path = os.path.join(mon_dir, "timeline.jsonl")
    if not os.path.exists(path):
        return []
    return [e for e in read_events(path) if e.get("ev") == kind]


def run(size="tiny", device="cuda", steps=6, every=2, sigterm_at=None,
        ckpt=None, checkpoint=True, seed=0, init_seed=0, world=1,
        mon_dir=None, rec=None):
    """One process of the drill.  Fills and returns its record ``rec``; a
    preempted run raises ``SystemExit(120)`` with ``rec`` holding what it
    trained (``main`` writes it either way)."""
    from .. import ft, monitor
    from ..ft import chaos
    from ..kernels import _common
    from ..models import bert
    from ..parallel import MeshSpec
    from ..parallel.train import TrainLoop

    shape = SIZES[size]
    cfg = _config(size)
    spec = MeshSpec(dp=world, zero=world > 1)
    tr = bert.build_bert_trainer(cfg, spec, seed=init_seed, device=device)
    batches = [{k: torch.from_numpy(v).to(tr.device) for k, v in b.items()}
               for b in bert.synthetic_batches(cfg, steps, shape["batch"],
                                               shape["seq"], seed=seed)]
    lr = shape["lr"]
    rec = {} if rec is None else rec
    rec.update(size=size, world=world, device=str(tr.device), losses={},
               step_ms={}, launches={})
    if mon_dir is not None:
        monitor.enable(mon_dir)
    sync = (lambda: torch.cuda.synchronize(tr.device)) \
        if tr.device.type == "cuda" else (lambda: None)
    t_last = [None]

    def on_step(step, loss):
        rec["losses"][step] = float(loss.detach().float().cpu()).hex()
        sync()
        now = time.perf_counter()
        rec["step_ms"][step] = (now - t_last[0]) * 1e3
        t_last[0] = now

    policy = None
    if checkpoint:
        policy = ft.CheckpointPolicy(ckpt, every_steps=every,
                                     asynchronous=True, keep=2, resume=True)
    loop = TrainLoop(lambda st, b: tr.step_fn(st, b, lr), checkpoint=policy,
                     on_step=on_step, specs=tr.specs, mesh=tr.mesh,
                     sentinel=False)
    if loop.guard is not None:
        resume = loop.guard.maybe_resume

        def timed_resume(template):
            sync()
            t0 = time.perf_counter()
            out = resume(template)
            sync()
            rec["restore_ms"] = (time.perf_counter() - t0) * 1e3
            t_last[0] = time.perf_counter()
            return out

        loop.guard.maybe_resume = timed_resume
    if sigterm_at is not None:
        chaos.arm("sigterm_step", at=int(sigterm_at))
    _common.reset_launches()
    sync()
    t_last[0] = time.perf_counter()
    try:
        state, step = loop.run(tr.state, batches)
        rec["final_step"] = step
        rec["digests"] = state_digests(state)
    finally:
        chaos.disarm()
        rec["resumed_step"] = loop.resumed_step
        trained = max(len(rec["losses"]), 1)
        rec["launches"] = {k: v / trained for k, v in _common.launches.items()
                           if v}
        if mon_dir is not None:
            monitor.disable()           # flushes the timeline
            rec["ckpt_events"] = _events(mon_dir, "ckpt")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", choices=sorted(SIZES), default="tiny")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--every", type=int, default=2)
    ap.add_argument("--sigterm-at", dest="sigterm_at", type=int, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--no-checkpoint", dest="checkpoint",
                    action="store_false")
    ap.add_argument("--seed", type=int, default=0, help="the batches' seed")
    ap.add_argument("--init-seed", dest="init_seed", type=int, default=0,
                    help="the parameters' seed (a resumed run's init is "
                         "overwritten by the checkpoint)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.checkpoint and not args.ckpt:
        ap.error("--ckpt is needed unless --no-checkpoint")
    if args.device.startswith("cuda"):
        from .chaos_drill import deterministic_card

        deterministic_card()
    mon_dir = args.out + ".mon"
    rc = 0
    rec = {}
    try:
        run(size=args.size, device=args.device, steps=args.steps,
            every=args.every, sigterm_at=args.sigterm_at, ckpt=args.ckpt,
            checkpoint=args.checkpoint, seed=args.seed,
            init_seed=args.init_seed, mon_dir=mon_dir, rec=rec)
    except SystemExit as e:
        rc = e.code
        rec["preempted"] = True
    with open(args.out, "w") as f:
        json.dump(rec, f)
    return rc


if __name__ == "__main__":
    sys.exit(main())
