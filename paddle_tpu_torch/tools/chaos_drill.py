"""Fault-injection drill of the port: kill -> resume -> bit-parity, end to
end (the port's counterpart of the JAX package's ``scripts/chaos_drill.py``).

``--smoke --check``: a short monitored CTR-style ``train_from_dataset`` run
(the reference drill's model, built with the port's ``fluid``) is
preempted with a drill SIGTERM at step 4, restarted for free by the port's
launcher under ``--elastic_retries 1``, resumes from its preemption
checkpoint and must finish with parameters BIT-IDENTICAL to a
never-interrupted run, with ``ft.retry.giveups == 0``.  Without
``--smoke``: the same over the full shape, with a torn second save
(``ckpt_commit`` crash) before the preemption.

``--elastic --smoke --check`` (topology-portable checkpoints): an n=2
fleet commits ``ckpt-<2E>``, rank 1 is SIGKILLed, ``launch
--elastic_shrink 1`` relaunches at world size 1, which resumes the two-rank
checkpoint (the 2->1 re-shard), commits a world-1 save and is killed too;
a fresh n=2 fleet grows back from it (1->2).  The final params of both
grow-leg ranks must be bit-identical to a never-stopped n=2 fleet.

``--multiproc --check`` (the fleet drill): an n=2 fleet under ``launch
--elastic_retries 2`` sharing one checkpoint directory, over four
attempts — SIGTERM at SKEWED boundaries (rank 0 at step 8, rank 1 at 9)
converging on ONE agreed ``ckpt-9``; rank 1 SIGKILLed (the survivor's
agreement round falls back, its COMMIT barrier times out and DEGRADES);
the whole fleet SIGKILLed; a clean finish.  Per-rank params bit-identical
to an uninterrupted single-process run.

As in the reference drill, the ranks of a fleet are replicas that share
the checkpoint directory (no process group): the drill is about the
shard/COMMIT protocol, the agreement and the launcher.

``--device cpu|cuda`` (default ``cuda``): where the workers train.  On a
card the workers run PyTorch's deterministic algorithms and the segment
kernel's merge route (``PADDLE_TPU_SEGMENT_KERNEL=1``), so that two runs
are bit for bit alike.

``--hostps --check [--smoke]`` (ShardPS): a trainer (rank 0) trains a
DeepFM-style model through a ``ShardedHostPSEmbedding`` while rank 1 is a
pure shard owner serving its row range over the wire.  The trainer's wire
drops one push (the resend absorbs it), duplicates another (the owner's
sequence dedup applies it once) and delays a pull; the owner is SIGKILLed
a few requests after ``ckpt-<2E>`` commits, the trainer degrades (cached
reads, buffered pushes) while ``launch --solo_respawn_ranks 1`` respawns
the owner alone, which restores its rows from the trainer's last commit,
and the trainer replays the staleness window.  A live 2 -> 1 absorb ends
the run.  The dense head and the whole table must equal a single-host
HostPS run bit for bit, with no wire giveup, and the timeline must show the
degradation, the recovery, the repartition and the ``ps_wait`` phase.  The
shard owners touch no CUDA; on a card the trainer runs PyTorch's
deterministic algorithms.

``--fleet [--smoke]``, ``--online [--smoke]`` and ``--oom`` (the serving
fleet, the OnlineLoop and MemScope's induced OOM) live in
``tools/serving_drill.py``: its docstring gives their legs and the derived
bounds that stand in for the reference's fixed latency budgets.

The reference's WarmStart and overload drills print what they wait for
(ROADMAP Queue 1 items 8 and 10-C) and exit 2.

Run: ``python -m paddle_tpu_torch.tools.chaos_drill --smoke --check
--device cpu``.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FIELDS = 4
VOCAB = 60
BATCH = 16

# single-host drill shape (30 steps/pass): saves at 5,10,...; attempt-1
# SIGTERM at the 8th boundary = global step 13
FULL = dict(n_files=6, rows=80, every=5, sigterm_at=8)
# smoke shape (9 steps/pass): one preemption at step 4, resume, done
SMOKE = dict(n_files=3, rows=48, every=3, sigterm_at=4)
# multiproc shape: same 30 steps; skewed SIGTERMs at 8 (r0) / 9 (r1)
MULTI = dict(n_files=6, rows=80, every=5, sigterm_at=8)
# elastic shapes: sigterm_at is the RANK-1 SIGKILL boundary (gated on
# ckpt-<2*every>'s COMMIT); the post-shrink n=1 kill lands at global
# 3*every+2 (gated on ckpt-<3*every>) and the grow leg finishes the pass
ELASTIC = dict(n_files=6, rows=80, every=5, sigterm_at=12)      # 30 steps
ELASTIC_SMOKE = dict(n_files=4, rows=48, every=3, sigterm_at=8)  # 12 steps
# ShardPS shapes: sigterm_at is the shard owner's SIGKILL point counted in
# DEQUEUED WIRE REQUESTS (deterministic: same data, same seeds, same cache
# behavior => same request stream), placed a few requests past ckpt-<2E>'s
# snapshot so the staleness window holds real post-checkpoint pushes to
# replay, and gated on ckpt-<2E>'s COMMIT (await_path) for ordering
HOSTPS = dict(n_files=6, rows=80, every=5, sigterm_at=27)        # 30 steps
HOSTPS_SMOKE = dict(n_files=3, rows=48, every=3, sigterm_at=17)  # 9 steps
PS_VOCAB = 96
PS_DIM = 8
# wire budgets in drill seconds: short reply deadlines so the drop leg
# resends fast, a heartbeat verdict well under the respawn time, and a
# dead-wait budget that covers a fresh process's import + restore; the
# respawn delay models a production respawn (a page-cache-warm one answers
# in under a second and would short-circuit the degraded window)
PS_ENV = {"PADDLE_TPU_PS_DEADLINE_SECS": "0.4",
          "PADDLE_TPU_PS_HB_TIMEOUT": "1.5",
          "PADDLE_TPU_PS_DEAD_WAIT_SECS": "240",
          "PADDLE_TPU_PS_CHAOS_DELAY_SECS": "0.6",
          "PADDLE_TPU_PS_DRILL_RESPAWN_DELAY": "4.0"}

# degraded-path budgets in drill seconds, not the production defaults: a
# dead peer must time the agreement round and the COMMIT barrier out in
# seconds (the port compiles nothing, so ranks resume without seconds of
# skew between them)
FLEET_ENV = {"PADDLE_TPU_PREEMPT_AGREE_SECS": "4",
             "PADDLE_TPU_CKPT_BARRIER_SECS": "4",
             "PADDLE_TPU_PREEMPT_POLL_STEPS": "0"}
TIMEOUT_S = 600

UNPORTED = {
    "warmstart": "the restart-storm drill waits for ROADMAP Queue 1 item 8 "
                 "(WarmStart)",
    "overload": "the LoadShield overload drill waits for ROADMAP Queue 1 "
                "item 10-C (its goodput and shed-latency legs need bounds "
                "derived for the port)",
}


def _write_files(d, n_files, rows):
    import numpy as np

    rng = np.random.RandomState(7)
    files = []
    for fi in range(n_files):
        p = os.path.join(d, "part-%05d" % fi)
        with open(p, "w") as f:
            for _ in range(rows):
                ids = rng.randint(0, VOCAB, FIELDS)
                lab = 1.0 if ids.sum() % 3 == 0 else 0.0
                f.write("%d %s 1 %.1f\n"
                        % (FIELDS, " ".join(map(str, ids)), lab))
        files.append(p)
    return files


# ---------------------------------------------------------------- worker --

def _arm_plan(plan, attempt, args):
    from paddle_tpu_torch.ft import chaos

    if plan == "drill":
        if attempt == 0:
            chaos.arm("ckpt_commit", at=2)             # torn second save
        elif attempt == 1:
            chaos.arm("io_error", at=1, times=2)       # transient, retried
            chaos.arm("sigterm_step", at=args.sigterm_at)
    elif plan == "smoke":
        if attempt == 0:
            chaos.arm("io_error", at=1, times=2)
            chaos.arm("sigterm_step", at=args.sigterm_at)
    elif plan == "multiproc":
        if attempt == 0:
            # the headline skew: ranks observe preemption ONE boundary apart
            chaos.arm("sigterm_step", at=args.sigterm_at, rank=0)
            chaos.arm("sigterm_step", at=args.sigterm_at + 1, rank=1)
        elif attempt == 1:
            # lost rank, no ckpt — but only AFTER the fleet's cadence
            # ckpt commits, so the degraded save is provably not latest
            committed_step = args.sigterm_at + 1 + args.every
            chaos.arm("kill_step", at=9, rank=1,
                      await_path=os.path.join(
                          args.ckpt, "ckpt-%d" % committed_step, "COMMIT"))
        elif attempt == 2:
            chaos.arm("kill_step", at=3)               # whole-fleet loss
    elif plan == "oom":
        from paddle_tpu_torch.tools import serving_drill

        serving_drill.arm_oom(args.device)
    elif plan == "elastic":
        world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        every = args.every
        if world == 2 and attempt == 0:
            # host loss: rank 1 SIGKILLed (no checkpoint, no warning) — but
            # only AFTER the n=2 cadence ckpt-<2*every> COMMITs, so the
            # shrunken fleet provably resumes a checkpoint saved by BOTH
            # ranks (the 2->1 re-shard, not a lucky single-rank save)
            chaos.arm("kill_step", at=args.sigterm_at, rank=1,
                      await_path=os.path.join(
                          args.ckpt, "ckpt-%d" % (2 * every), "COMMIT"))
        elif world == 1:
            # the shrunken incarnation: let it commit ckpt-<3*every> (saved
            # at world=1 — the grow leg's 1->2 re-shard source), then kill
            # it too.  Local boundary hits count from the resume point
            # (2*every), so global 3*every+2 is local hit every+2
            chaos.arm("kill_step", at=every + 2,
                      await_path=os.path.join(
                          args.ckpt, "ckpt-%d" % (3 * every), "COMMIT"))


def build_program(fluid, files):
    """The reference drill's CTR-style model (an ``is_sparse`` embedding,
    an FM term and a deep tower, Adam) over a QueueDataset of ``files``."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        ids = L.data("feat_ids", shape=[FIELDS], dtype="int64")
        label = L.data("label", shape=[1], dtype="float32")
        ds = fluid.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(BATCH)
        ds.set_filelist(files)
        ds.set_use_var([ids, label])
        emb = L.embedding(ids, size=[VOCAB, 8], is_sparse=True)
        s = L.reduce_sum(emb, dim=1)
        sq = L.reduce_sum(L.elementwise_mul(emb, emb), dim=1)
        fm = L.reduce_sum(L.elementwise_sub(L.elementwise_mul(s, s), sq),
                          dim=1, keep_dim=True)
        deep = L.fc(L.reshape(emb, [-1, FIELDS * 8]), 16, act="relu")
        logit = L.elementwise_add(L.fc(deep, 1), L.scale(fm, 0.5))
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
        fluid.optimizer.Adam(5e-3).minimize(loss)
    return main, startup, ds, loss


def build_ctr(fluid, files, widths, batch):
    """The CTR program (``tools/ctr_program.py``) at ``widths`` (n_fields,
    vocab, embed, mlp...) over a QueueDataset of ``files``."""
    from paddle_tpu_torch.tools import ctr_program as cp

    n_fields, vocab, embed = widths[:3]
    prog = cp.build_ctr_program(fluid, n_fields=n_fields, vocab=vocab,
                                embed=embed, mlp=tuple(widths[3:]))
    ds = cp.make_dataset(fluid, "QueueDataset", files, prog, batch)
    return prog.main, prog.startup, ds, prog.loss


SEGMENT_TOL = 1e-4   # relative to the largest sum: chip_smoke.py's TOL_F32


def hold_segments(rec):
    """Hold every launch of the segment kernel (row 11, ``dedup_segment_sum``
    behind ``sparse.merge_rows``'s kernel route) against its plain version
    on the same inputs: the rows exactly, the sums within ``SEGMENT_TOL``
    of the largest; ``rec`` counts the calls and keeps the worst error."""
    import torch

    from paddle_tpu_torch.kernels import segment_update as seg

    real = seg.dedup_segment_sum
    rec.update(segment_calls=0, segment_max_rel_err=0.0)

    def held(ids, vals, height):
        rows, out = real(ids, vals, height)
        if rows.is_cuda:
            rows_p, out_p = seg.segsum_plain(ids, vals, height)
            err = float((out.float() - out_p.float()).abs().max())
            rel = err / max(float(out_p.float().abs().max()), 1e-30)
            rec["segment_calls"] += 1
            rec["segment_max_rel_err"] = max(rec["segment_max_rel_err"], rel)
            if not torch.equal(rows, rows_p) or rel > SEGMENT_TOL:
                raise AssertionError(
                    "segment_sum against its plain version: rows equal %s, "
                    "relative error %g (tolerance %g)"
                    % (bool(torch.equal(rows, rows_p)), rel, SEGMENT_TOL))
        return rows, out

    seg.dedup_segment_sum = held


def deterministic_card():
    """What makes two card runs of one program bit for bit alike: PyTorch's
    deterministic algorithms (a gather's backward, scatter-adds) and
    cuDNN's."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def worker(args):
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import ft, monitor

    attempt = int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0"))
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    mon_dir = os.path.join(args.out, "attempt-%d" % attempt)
    if world > 1:
        mon_dir = os.path.join(mon_dir, "rank-%d" % rank)
    if args.device == "cuda":
        deterministic_card()
    monitor.enable(mon_dir)

    _arm_plan(args.plan, attempt, args)

    files = sorted(os.path.join(args.data, n) for n in os.listdir(args.data))
    if args.ctr:
        main, startup, ds, _ = build_ctr(fluid, files, args.ctr, args.batch)
    else:
        main, startup, ds, _ = build_program(fluid, files)
    place = fluid.CPUPlace() if args.device == "cpu" else fluid.CUDAPlace(0)
    rec = {"attempt": attempt, "rank": rank}
    if args.device == "cuda":
        from paddle_tpu_torch.kernels import _common

        hold_segments(rec)
        _common.reset_launches()
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    # fleet plans save SYNCHRONOUSLY: steps are ~1 ms, so an async writer
    # would still be staging when the drill SIGKILLs the rank a few
    # boundaries later — the fleet drills are about the COMMIT protocol,
    # not the async overlap (the single-host plans keep async coverage)
    policy = ft.CheckpointPolicy(
        args.ckpt, every_steps=args.every,
        asynchronous=(args.plan not in ("multiproc", "elastic")
                      and world == 1),
        keep=3, resume=True)
    try:
        exe.train_from_dataset(main, ds, scope=scope, checkpoint=policy)
        params = {v.name: scope.find_tensor_as_numpy(v.name)
                  for v in main.list_vars()
                  if v.persistable and scope.has_var(v.name)}
        name = ("final_params.npz" if world == 1
                else "final_params_r%d.npz" % rank)
        np.savez(os.path.join(args.out, name), **params)
    finally:
        steps = [e.get("steps") for e in _read_events(
            os.path.join(mon_dir, "timeline.jsonl"))
            if e.get("ev") == "run_end"]
        monitor.disable()       # metrics.prom + timeline land per attempt
        if args.device == "cuda":
            rec["steps"] = steps[-1] if steps else None
            rec["launches"] = {k: v for k, v in _common.launches.items()
                               if v}
            with open(os.path.join(args.out, "record-a%d-r%d.json"
                                   % (attempt, rank)), "w") as f:
                json.dump(rec, f)
    return 0


# --------------------------------------------------------- hostps worker --

def _hostps_batches(data_dir):
    """The drill's CTR text files as (ids [B, F] int64, label [B] f32)
    batches: one deterministic stream the reference and the drill
    consume."""
    import numpy as np

    ids_all, lab_all = [], []
    for name in sorted(os.listdir(data_dir)):
        with open(os.path.join(data_dir, name)) as f:
            for line in f:
                parts = line.split()
                n = int(parts[0])
                ids_all.append([int(x) for x in parts[1:1 + n]])
                lab_all.append(float(parts[-1]))
    batches = []
    for k in range(0, len(ids_all) - len(ids_all) % BATCH, BATCH):
        batches.append((np.asarray(ids_all[k:k + BATCH], np.int64),
                        np.asarray(lab_all[k:k + BATCH], np.float32)))
    return batches


def _hostps_step(dense, values, inv, label, lr):
    """The drill's DeepFM-style step (FM term, one ReLU tower, sigmoid
    cross-entropy) with respect to the head and the pulled rows; returns
    (loss, new head, the rows' gradient)."""
    import torch

    dense = {k: v.detach().requires_grad_() for k, v in dense.items()}
    values.requires_grad_()
    e = values[inv]                                   # [B, F, D]
    s = e.sum(1)
    fm = 0.5 * (s * s - (e * e).sum(1)).sum(-1)
    h = torch.relu(e.reshape(e.shape[0], -1) @ dense["w1"] + dense["b1"])
    logit = (h @ dense["w2"])[:, 0] + dense["b2"][0] + fm
    loss = (torch.clamp_min(logit, 0) - logit * label
            + torch.log1p(torch.exp(-logit.abs()))).mean()
    names = sorted(dense)
    grads = torch.autograd.grad(loss, [dense[k] for k in names] + [values])
    with torch.no_grad():
        new = {k: dense[k] - lr * g for k, g in zip(names, grads)}
    return loss.detach(), new, grads[-1]


def hostps_worker(args):
    """ShardPS drill worker.  Rank 0 trains through a
    ShardedHostPSEmbedding (owning row shard 0 locally); every other rank
    is a pure shard owner serving its hostps_row_range over the wire — the
    reference's trainer/pserver split.  The trainer checkpoints as a
    world-1 saver (the merged snapshot covers every shard; owners never
    join the COMMIT barrier), so a respawned owner restores its rows from
    the trainer's last committed checkpoint.  Owners touch no CUDA."""
    import numpy as np

    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    attempt = int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0"))
    every = args.every
    V, D, LR = PS_VOCAB, PS_DIM, 0.1

    from paddle_tpu_torch.distributed.heartbeat import WorkerHeartbeat
    from paddle_tpu_torch.ft import chaos
    from paddle_tpu_torch.hostps import (HostPSEmbedding, HostSGD,
                                         HostSparseTable, ShardRouter,
                                         ShardServer, ShardedHostPSEmbedding)
    from paddle_tpu_torch.parallel.rules import hostps_row_ranges

    ranges = hostps_row_ranges(max(world, 1), V)

    def make_table(rr):
        return HostSparseTable(V, D, optimizer=HostSGD(), seed=11,
                               name="deepfm_emb", row_range=rr)

    if world > 1 and rank > 0:
        # ---------------- shard-owner role ----------------
        if attempt > 0:
            # a RESPAWN: model a production respawn's latency; heartbeats
            # start AFTER the delay — a corpse does not beat while it boots
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_PS_DRILL_RESPAWN_DELAY", "0")))
        hb = WorkerHeartbeat(args.hb, rank, interval=0.25,
                             world=world).start()
        if args.plan == "hostps" and attempt == 0:
            # SIGKILL mid-request at the shape's request count (a few
            # requests past ckpt-<2E>'s snapshot, so committed state lags
            # the pushes the client must replay), gated on its COMMIT
            chaos.arm("ps_shard_kill", at=args.sigterm_at,
                      await_path=os.path.join(
                          args.ckpt, "ckpt-%d" % (2 * every), "COMMIT"))
        srv = ShardServer(make_table(ranges[rank]), args.wire, rank,
                          ckpt_dir=args.ckpt, budget_bytes=args.ps_budget)
        srv.start(restore=True)
        print("hostps worker %d: serving rows [%d, %d)%s" % (
            rank, ranges[rank][0], ranges[rank][1],
            " (restored from last committed ckpt)"
            if attempt > 0 else ""), flush=True)
        srv.serve_until_shutdown()
        hb.complete()
        return 0

    # ---------------- trainer role (rank 0) ----------------
    import torch

    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.ft import ckpt as fckpt
    from paddle_tpu_torch.hostps.cache import host_to_device

    if args.device == "cuda":
        deterministic_card()
    device = torch.device(args.device)
    # checkpoint + monitor as a WORLD-1 saver: owners serve state, they do
    # not stage checkpoint shards (their rows ride the trainer's merged
    # snapshot), so the COMMIT barrier must not wait on them
    os.environ["PADDLE_TRAINERS_NUM"] = "1"
    os.environ["PADDLE_TRAINER_ID"] = "0"
    mon = monitor.enable(os.path.join(args.out, "attempt-%d" % attempt))
    hb = WorkerHeartbeat(args.hb, 0, interval=0.25, world=world).start()
    if args.plan == "hostps":
        # client-side wire chaos: hits count physical send attempts (1 =
        # the connect probe; the first steps run one cold-cache pull + one
        # push each, so hits 2..7 are stable): drop step 1's push (the
        # resend absorbs it), duplicate step 2's push (the owner's seq
        # dedup must apply it once — PROVEN by the final bit-parity gate),
        # delay step 3's pull (ps_wait grows)
        chaos.arm("ps_drop", at=3)
        chaos.arm("ps_dup", at=6)
        chaos.arm("ps_delay", at=7)

    if world > 1:
        full_bytes = V * D * 4
        shard_bytes = max(hi - lo for lo, hi in ranges) * D * 4
        assert full_bytes > args.ps_budget >= shard_bytes
        print("hostps: full table %dB exceeds the per-process budget %dB; "
              "largest shard %dB fits — the combined footprint only "
              "exists ACROSS %d processes" % (full_bytes, args.ps_budget,
                                              shard_bytes, world),
              flush=True)
        router = ShardRouter(make_table(ranges[0]), world=world, rank=0,
                             wire_dir=args.wire, client_id="trainer",
                             hb_dir=args.hb)
        router.connect(timeout=120)
        emb = ShardedHostPSEmbedding(router, cache_slots=48, device=device)
    else:
        router = None
        emb = HostPSEmbedding(make_table(None), cache_slots=48,
                              device=device)

    rng = np.random.RandomState(5)
    dense = {
        "w1": (rng.randn(FIELDS * D, 16) * 0.1).astype(np.float32),
        "b1": np.zeros(16, np.float32),
        "w2": (rng.randn(16, 1) * 0.1).astype(np.float32),
        "b2": np.zeros(1, np.float32),
    }
    dense = {k: torch.from_numpy(v).to(device) for k, v in dense.items()}

    start = 0
    rs = fckpt.restore_train_state(args.ckpt, dense, hostps=[emb])
    if rs is not None:
        dense = dict(rs.scope_state)
        start = rs.step
        mon.timeline.emit("resume", step=start, ckpt=rs.path)

    for k, (ids, label) in enumerate(_hostps_batches(args.data)):
        if k < start:
            continue                      # exact-batch resume
        t0 = time.perf_counter()
        rows, values, inv = emb.pull_unique(ids)
        loss, dense, g = _hostps_step(
            dense, values, host_to_device(inv, device),
            host_to_device(label, device), LR)
        emb.push(rows, g[: rows.shape[0]], LR)
        stepno = k + 1
        mon.record_step(stepno, (time.perf_counter() - t0) * 1e3,
                        batch=label.shape[0])
        if stepno % every == 0:
            if router is not None:
                router.flush()
            fckpt.save_train_state(args.ckpt, stepno, scope_state=dense,
                                   hostps=[emb], asynchronous=False,
                                   keep=3).finish()

    probe = np.arange(V)
    if router is not None and args.plan == "hostps":
        # live-shrink leg: repartition the LIVE table 2 -> 1 in-process;
        # pulled values must be identical before and after the absorb
        before = emb.pull(probe, use_cache=False).cpu().numpy()
        moved = router.absorb(1)
        after = emb.pull(probe, use_cache=False).cpu().numpy()
        assert np.array_equal(before, after), "absorb changed row values"
        print("hostps: live repartition OK (absorbed %d rows; table now "
              "whole on the trainer)" % moved, flush=True)

    np.savez(os.path.join(args.out, "final_params.npz"),
             **{n: v.cpu().numpy() for n, v in dense.items()})
    np.savez(os.path.join(args.out, "final_table.npz"),
             table=emb.pull(probe, use_cache=False).cpu().numpy())
    if router is not None:
        for s in range(1, world):
            router.shutdown_shard(s)
    monitor.disable()
    hb.complete()
    return 0


# ------------------------------------------------------------------ drills --

def _read_events(path):
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    return out


def _prom_value(path, metric):
    """Sum EVERY sample of `metric` in one exposition (a labeled counter —
    ft.retry.* split by surface — emits one line per label set).  None when
    the metric is absent."""
    if not os.path.exists(path):
        return None
    total = None
    with open(path) as f:
        for line in f:
            m = re.match(r"^(\S+?)(\{[^}]*\})?\s+([-+0-9.eE]+)\s*$", line)
            if m and metric in m.group(1):
                total = (total or 0.0) + float(m.group(3))
    return total


def _prom_sum(root, metric):
    total = 0.0
    for dirpath, _dirs, names in os.walk(root):
        if "metrics.prom" in names:
            total += _prom_value(
                os.path.join(dirpath, "metrics.prom"), metric) or 0.0
    return total


def _prom_labeled_sum(root, metric, label=None):
    """Sum ``metric`` over every metrics.prom under ``root``, optionally
    only the samples whose label string contains ``label`` (e.g.
    'surface="ps_wire"')."""
    total = 0.0
    pat = re.compile(r"^(\S+?)(\{[^}]*\})?\s+([-+0-9.eE]+)\s*$")
    for dirpath, _dirs, names in os.walk(root):
        if "metrics.prom" not in names:
            continue
        with open(os.path.join(dirpath, "metrics.prom")) as f:
            for line in f:
                m = pat.match(line)
                if not m or metric not in m.group(1):
                    continue
                if label is not None and label not in (m.group(2) or ""):
                    continue
                total += float(m.group(3))
    return total


def _fail(msg):
    print("chaos_drill: FAILED — %s" % msg, file=sys.stderr)
    return 2


def _assert_no_corpses(ck_dir):
    for name in os.listdir(ck_dir):
        full = os.path.join(ck_dir, name)
        if name.startswith("ckpt-") and os.path.isdir(full) \
                and not os.path.exists(os.path.join(full, "COMMIT")):
            return full
        if name.startswith(".tmp-ckpt-"):
            return full
    return None


def worker_env(device, fleet=False, every=None):
    """The workers' environment: the repo on the path, no inherited chaos
    spec; on a card the segment kernel's merge route and cuBLAS's
    deterministic workspace; for a fleet the drill's budgets."""
    env = dict(os.environ)
    env.pop("PADDLE_TPU_CHAOS", None)   # plans are armed in-process
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if device == "cuda":
        env["PADDLE_TPU_SEGMENT_KERNEL"] = "1"
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    if fleet:
        env.update(FLEET_ENV)
        env["PADDLE_TPU_PREEMPT_QUANTUM"] = str(every)
    return env



def worker_cmd(plan, data, ck, out, shape, device, ctr=None, batch=BATCH):
    """The worker's command line (a script path, as the launcher runs
    it)."""
    cmd = [os.path.abspath(__file__), "--worker", "--plan", plan,
           "--data", data, "--ckpt", ck, "--out", out,
           "--every", str(shape["every"]),
           "--sigterm-at", str(shape["sigterm_at"]), "--device", device]
    if ctr:
        cmd += ["--ctr", ",".join(map(str, ctr)), "--batch", str(batch)]
    return cmd


def _ps_cmd(plan, work, data, ck, out, shape, device):
    """A ShardPS drill worker's command line (``worker_cmd`` plus the
    wire, heartbeat and per-process budget arguments)."""
    budget = PS_VOCAB * PS_DIM * 4 * 6 // 10     # < the table, >= a shard
    return (worker_cmd(plan, data, ck, out, shape, device)
            + ["--wire", os.path.join(work, "wire"),
               "--hb", os.path.join(work, "hb"), "--ps-budget", str(budget)])



def _launch(nproc, port, cmd, env, extra=()):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(nproc), "--started_port", str(port)]
        + list(extra) + cmd,
        env=env, cwd=REPO, timeout=TIMEOUT_S, capture_output=True, text=True)


def _logs_tail(logs, ranks):
    for rnk in ranks:
        lg = os.path.join(logs, "worker.%d.log" % rnk)
        if os.path.exists(lg):
            sys.stderr.write("---- worker %d log tail ----\n" % rnk)
            sys.stderr.write("".join(open(lg).readlines()[-30:]))


def _same_params(ref, got, what):
    if sorted(ref.files) != sorted(got.files):
        return "%s: param sets differ: %s vs %s" % (
            what, sorted(ref.files), sorted(got.files))
    for k in ref.files:
        if not (ref[k].shape == got[k].shape
                and ref[k].tobytes() == got[k].tobytes()):
            return "%s: param %r differs (max abs delta %g)" % (
                what, k, abs(ref[k].astype("f8") - got[k].astype("f8")).max())
    return None


def _workdir(args, prefix):
    work = args.workdir or tempfile.mkdtemp(prefix=prefix)
    os.makedirs(work, exist_ok=True)
    return work


def _run_reference(work, data, env, shape, device):
    out = os.path.join(work, "ref")
    os.makedirs(out, exist_ok=True)
    ck = os.path.join(work, "ckpt-ref")
    r = subprocess.run(
        [sys.executable] + worker_cmd("none", data, ck, out, shape, device),
        env=env, cwd=REPO, timeout=TIMEOUT_S)
    return out, r.returncode


def run_drill(args):
    import numpy as np

    shape = SMOKE if args.smoke else FULL
    work = _workdir(args, "chaos_drill_")
    data = os.path.join(work, "data")
    os.makedirs(data, exist_ok=True)
    _write_files(data, shape["n_files"], shape["rows"])
    env = worker_env(args.device)

    print("chaos_drill: reference run (no chaos)...")
    t0 = time.perf_counter()
    ref_out, rc = _run_reference(work, data, env, shape, args.device)
    if rc != 0:
        return _fail("reference worker exited rc=%d" % rc)

    plan, retries = ("smoke", 1) if args.smoke else ("drill", 2)
    print("chaos_drill: %s drill under the elastic launcher (the reference "
          "took %.1f s)..." % (plan, time.perf_counter() - t0))
    t0 = time.perf_counter()
    out = os.path.join(work, "drill")
    os.makedirs(out, exist_ok=True)
    ck = os.path.join(work, "ckpt-drill")
    logs = os.path.join(work, "logs")
    res = _launch(1, 6321,
                  worker_cmd(plan, data, ck, out, shape, args.device), env,
                  ["--elastic_retries", str(retries),
                   "--elastic_reset_secs", "0", "--log_dir", logs])
    if res.returncode != 0:
        sys.stderr.write(res.stderr or "")
        _logs_tail(logs, [0])
        return _fail("elastic drill job exited rc=%d" % res.returncode)
    if "preempted (rc=120); free elastic restart" not in res.stderr:
        return _fail("launcher never took the free preemption-restart path:"
                     "\n%s" % res.stderr)

    # -- bit parity ------------------------------------------------------
    err = _same_params(np.load(os.path.join(ref_out, "final_params.npz")),
                       np.load(os.path.join(out, "final_params.npz")),
                       "kill->resume")
    if err:
        return _fail(err)
    print("chaos_drill: param bit-parity OK (the drill job took %.1f s)"
          % (time.perf_counter() - t0))

    every, sigterm_at = shape["every"], shape["sigterm_at"]
    last = 1 if args.smoke else 2
    if args.smoke:
        want = [(1, sigterm_at)]
    else:
        # the torn save at 2*every must not be latest: attempt 1 resumes
        # from ckpt-<every>; attempt 2 from the preemption checkpoint
        want = [(1, every), (2, every + sigterm_at)]
    for attempt, step in want:
        ev = _read_events(os.path.join(out, "attempt-%d" % attempt,
                                       "timeline.jsonl"))
        r = [e for e in ev if e.get("ev") == "resume"]
        if not r or r[0].get("step") != step:
            return _fail("attempt %d should resume from step %d; got %s"
                         % (attempt, step, r))
    pre_attempt = 0 if args.smoke else 1
    ev = _read_events(os.path.join(out, "attempt-%d" % pre_attempt,
                                   "timeline.jsonl"))
    if not [e for e in ev if e.get("ev") == "preempted"]:
        return _fail("attempt %d never emitted the `preempted` event"
                     % pre_attempt)
    print("chaos_drill: resume points OK %s" % want)

    corpse = _assert_no_corpses(ck)
    if corpse:
        return _fail("uncommitted checkpoint corpse survived: %s" % corpse)
    giveups = _prom_sum(out, "ft_retry_giveups")
    attempts = _prom_sum(out, "ft_retry_attempts")
    if giveups:
        return _fail("ft.retry.giveups == %d (must be 0)" % giveups)
    if attempts < 2:
        return _fail("the injected transient never exercised the retry "
                     "path (ft.retry.attempts == %d)" % attempts)
    print("chaos_drill: retries OK (attempts=%d, giveups=0)" % attempts)

    evN = _read_events(os.path.join(out, "attempt-%d" % last,
                                    "timeline.jsonl"))
    ckpts = [e for e in evN if e.get("ev") == "ckpt"]
    runs = [e for e in evN if e.get("ev") == "run_end"]
    wall_ms = sum(e.get("seconds", 0.0) for e in runs) * 1e3
    block = sum(e.get("block_ms", 0.0) for e in ckpts)
    print("chaos_drill: ckpt overhead: %d async saves, train-thread block "
          "%.1f ms of %.1f ms run wall (%s)"
          % (len(ckpts), block, wall_ms, args.device))
    if not args.keep and args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    print("chaos_drill: PASS")
    return 0


def run_multiproc(args):
    import numpy as np

    shape = MULTI
    every, sigterm_at = shape["every"], shape["sigterm_at"]
    work = _workdir(args, "chaos_drill_mp_")
    data = os.path.join(work, "data")
    os.makedirs(data, exist_ok=True)
    _write_files(data, shape["n_files"], shape["rows"])
    print("chaos_drill[mp]: reference run (single process, no chaos)...")
    ref_out, rc = _run_reference(work, data, worker_env(args.device), shape,
                                 args.device)
    if rc != 0:
        return _fail("reference worker exited rc=%d" % rc)

    env = worker_env(args.device, fleet=True, every=every)
    out = os.path.join(work, "drill")
    os.makedirs(out, exist_ok=True)
    ck = os.path.join(work, "ckpt-drill")
    logs = os.path.join(work, "logs")
    print("chaos_drill[mp]: n=2 fleet drill (skewed SIGTERM -> lost rank "
          "-> fleet kill -> finish) under the elastic launcher...")
    res = _launch(2, 6331,
                  worker_cmd("multiproc", data, ck, out, shape, args.device),
                  env,
                  ["--elastic_retries", "2", "--elastic_reset_secs", "0",
                   "--term_grace_secs", "30", "--log_dir", logs])
    if res.returncode != 0:
        sys.stderr.write(res.stderr or "")
        _logs_tail(logs, [0, 1])
        return _fail("elastic fleet job exited rc=%d" % res.returncode)
    if "preempted (rc=120); free elastic restart" not in res.stderr:
        return _fail("launcher never took the free preemption-restart "
                     "path:\n%s" % res.stderr)
    if len(re.findall(r"elastic restart \d+/", res.stderr)) < 2:
        return _fail("expected two budget-burning restarts (lost rank, "
                     "fleet kill):\n%s" % res.stderr)

    # -- the agreed boundary: skewed ranks committed ONE ckpt ------------
    agreed_step = sigterm_at + 1      # max over the skewed observations
    for rnk in (0, 1):
        ev = _read_events(os.path.join(
            out, "attempt-0", "rank-%d" % rnk, "timeline.jsonl"))
        ag = [e for e in ev if e.get("ev") == "preempt_agree"]
        if not ag or ag[0].get("agreed") != agreed_step \
                or ag[0].get("mode") != "agreed":
            return _fail("rank %d attempt 0: expected agreement on step %d;"
                         " got %s" % (rnk, agreed_step, ag))
        want_obs = sigterm_at if rnk == 0 else sigterm_at + 1
        if ag[0].get("observed") != want_obs:
            return _fail("rank %d observed step %s (expected the skewed "
                         "boundary %d)" % (rnk, ag[0].get("observed"),
                                           want_obs))
        pre = [e for e in ev if e.get("ev") == "preempted"]
        if not pre or pre[0].get("step") != agreed_step:
            return _fail("rank %d attempt 0: preempted at %s, expected the "
                         "agreed boundary %d"
                         % (rnk, pre and pre[0].get("step"), agreed_step))
        ev1 = _read_events(os.path.join(
            out, "attempt-1", "rank-%d" % rnk, "timeline.jsonl"))
        r1 = [e for e in ev1 if e.get("ev") == "resume"]
        if not r1 or r1[0].get("step") != agreed_step:
            return _fail("rank %d attempt 1: resumed from %s, expected the "
                         "agreed ckpt-%d"
                         % (rnk, r1 and r1[0].get("step"), agreed_step))
    print("chaos_drill[mp]: skewed SIGTERM OK — both ranks committed and "
          "resumed ckpt-%d" % agreed_step)

    # -- lost-rank degradation -------------------------------------------
    committed = agreed_step + every
    bt = _prom_sum(os.path.join(out, "attempt-1"), "ft_barrier_timeouts")
    if bt < 1:
        return _fail("attempt 1: expected >=1 ft.barrier.timeouts on the "
                     "surviving rank, got %s" % bt)
    ev0 = _read_events(os.path.join(
        out, "attempt-1", "rank-0", "timeline.jsonl"))
    lost = [e for e in ev0 if e.get("ev") == "fleet_lost"]
    if not lost or 1 not in lost[0].get("ranks", []):
        return _fail("attempt 1 rank 0: expected a fleet_lost event naming "
                     "rank 1; got %s" % lost)
    pre0 = [e for e in ev0 if e.get("ev") == "preempted"]
    if not pre0 or not pre0[0].get("degraded"):
        return _fail("attempt 1 rank 0: preemption save should have "
                     "DEGRADED (lost peer); got %s" % pre0)
    for attempt in (2, 3):
        for rnk in (0, 1):
            ev = _read_events(os.path.join(
                out, "attempt-%d" % attempt, "rank-%d" % rnk,
                "timeline.jsonl"))
            r = [e for e in ev if e.get("ev") == "resume"]
            if not r or r[0].get("step") != committed:
                return _fail("rank %d attempt %d: resumed from %s, expected "
                             "the last COMMITTED ckpt-%d"
                             % (rnk, attempt, r and r[0].get("step"),
                                committed))
    for rnk in (0, 1):
        ev3 = _read_events(os.path.join(
            out, "attempt-3", "rank-%d" % rnk, "timeline.jsonl"))
        if not [e for e in ev3 if e.get("ev") == "run_end" and e.get("ok")]:
            return _fail("rank %d attempt 3 never completed cleanly" % rnk)
    print("chaos_drill[mp]: lost-rank degradation OK — barrier timeout "
          "counted, fleet_lost emitted, fleet resumed from ckpt-%d"
          % committed)

    ref = np.load(os.path.join(ref_out, "final_params.npz"))
    for rnk in (0, 1):
        err = _same_params(ref, np.load(os.path.join(
            out, "final_params_r%d.npz" % rnk)), "rank %d" % rnk)
        if err:
            return _fail(err)
    print("chaos_drill[mp]: per-rank param bit-parity OK")
    corpse = _assert_no_corpses(ck)
    if corpse:
        return _fail("uncommitted checkpoint corpse survived: %s" % corpse)
    giveups = _prom_sum(out, "ft_retry_giveups")
    if giveups:
        return _fail("ft.retry.giveups == %d (must be 0)" % giveups)
    if not args.keep and args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    print("chaos_drill[mp]: PASS")
    return 0


def run_elastic(args):
    """Topology-portable checkpoints under a real shrink/grow:

      phase 1 (shrink): an n=2 fleet under ``launch --elastic_shrink 1``
              commits ckpt-<2E> (E = cadence); rank 1 is SIGKILLed; the
              launcher relaunches at world size 1, which RESUMES ckpt-<2E>
              saved by TWO ranks (the 2->1 re-shard), trains on, commits
              ckpt-<3E> (saved by ONE rank), and is killed as well —
              budgets exhausted, the job exits nonzero by design;
      phase 2 (grow):   a fresh n=2 fleet resumes ckpt-<3E> (the 1->2
              re-shard; the grown rank keeps fresh RNG streams) and
              completes the pass;
      reference:        an uninterrupted n=2 fleet over the same data."""
    import numpy as np

    shape = ELASTIC_SMOKE if args.smoke else ELASTIC
    every = shape["every"]
    work = _workdir(args, "chaos_drill_el_")
    data = os.path.join(work, "data")
    os.makedirs(data, exist_ok=True)
    _write_files(data, shape["n_files"], shape["rows"])
    env = worker_env(args.device, fleet=True, every=every)
    ck = os.path.join(work, "ckpt-drill")
    logs = os.path.join(work, "logs")

    print("chaos_drill[el]: reference run (uninterrupted n=2 fleet)...")
    ref_out = os.path.join(work, "ref")
    os.makedirs(ref_out, exist_ok=True)
    res = _launch(2, 6341,
                  worker_cmd("none", data, os.path.join(work, "ckpt-ref"),
                             ref_out, shape, args.device), env,
                  ["--log_dir", logs])
    if res.returncode != 0:
        sys.stderr.write(res.stderr or "")
        _logs_tail(logs, [0, 1])
        return _fail("n=2 reference fleet exited rc=%d" % res.returncode)
    ref0 = np.load(os.path.join(ref_out, "final_params_r0.npz"))
    err = _same_params(ref0, np.load(os.path.join(
        ref_out, "final_params_r1.npz")), "reference ranks")
    if err:
        return _fail(err + " — the drill model must be a pure replica")

    print("chaos_drill[el]: phase 1 — n=2 fleet, rank 1 SIGKILLed after "
          "ckpt-%d commits; launcher shrinks to n=1 (2->1 re-shard), which "
          "commits ckpt-%d and dies too..." % (2 * every, 3 * every))
    shrink_out = os.path.join(work, "shrink")
    os.makedirs(shrink_out, exist_ok=True)
    res1 = _launch(2, 6343,
                   worker_cmd("elastic", data, ck, shrink_out, shape,
                              args.device),
                   env, ["--elastic_retries", "0", "--elastic_reset_secs",
                         "0", "--elastic_shrink", "1",
                         "--term_grace_secs", "30", "--log_dir", logs])
    if res1.returncode == 0:
        return _fail("phase 1 should exhaust its budgets and exit nonzero "
                     "(the n=1 incarnation is killed by design)")
    if "elastic shrink 1/1: relaunching fleet at world size 1" \
            not in res1.stderr:
        _logs_tail(logs, [0, 1])
        return _fail("launcher never took the elastic-shrink path:\n%s"
                     % res1.stderr)
    ev1 = _read_events(os.path.join(shrink_out, "attempt-1",
                                    "timeline.jsonl"))
    r1 = [e for e in ev1 if e.get("ev") == "resume"]
    if not r1 or r1[0].get("step") != 2 * every:
        return _fail("shrunken fleet should resume the n=2-saved ckpt-%d; "
                     "got %s" % (2 * every, r1))
    if r1[0].get("saver_world") != 2 or r1[0].get("world") != 1 \
            or not r1[0].get("resharded"):
        return _fail("2->1 resume must carry the re-shard evidence "
                     "(saver_world=2 world=1 resharded); got %s" % r1)
    print("chaos_drill[el]: 2->1 OK — world-1 fleet resumed ckpt-%d "
          "(saver world 2)" % (2 * every))

    print("chaos_drill[el]: phase 2 — grow back to n=2 from the "
          "world-1-saved ckpt-%d..." % (3 * every))
    grow_out = os.path.join(work, "grow")
    os.makedirs(grow_out, exist_ok=True)
    res2 = _launch(2, 6345,
                   worker_cmd("none", data, ck, grow_out, shape, args.device),
                   env,
                   ["--log_dir", logs])
    if res2.returncode != 0:
        sys.stderr.write(res2.stderr or "")
        _logs_tail(logs, [0, 1])
        return _fail("grow fleet exited rc=%d" % res2.returncode)
    for rnk in (0, 1):
        ev = _read_events(os.path.join(grow_out, "attempt-0",
                                       "rank-%d" % rnk, "timeline.jsonl"))
        r = [e for e in ev if e.get("ev") == "resume"]
        if not r or r[0].get("step") != 3 * every:
            return _fail("grow rank %d should resume ckpt-%d; got %s"
                         % (rnk, 3 * every, r))
        if r[0].get("saver_world") != 1 or r[0].get("world") != 2 \
                or not r[0].get("resharded"):
            return _fail("grow rank %d: 1->2 resume must carry the "
                         "re-shard evidence; got %s" % (rnk, r))
        if not [e for e in ev if e.get("ev") == "run_end" and e.get("ok")]:
            return _fail("grow rank %d never completed cleanly" % rnk)
    print("chaos_drill[el]: 1->2 OK — both ranks resumed ckpt-%d "
          "(saver world 1)" % (3 * every))

    for rnk in (0, 1):
        err = _same_params(ref0, np.load(os.path.join(
            grow_out, "final_params_r%d.npz" % rnk)), "grow rank %d" % rnk)
        if err:
            return _fail(err)
    print("chaos_drill[el]: param bit-parity OK (2 ranks)")
    corpse = _assert_no_corpses(ck)
    if corpse:
        return _fail("uncommitted checkpoint corpse survived: %s" % corpse)
    giveups = (_prom_sum(shrink_out, "ft_retry_giveups")
               + _prom_sum(grow_out, "ft_retry_giveups"))
    if giveups:
        return _fail("ft.retry.giveups == %d (must be 0)" % giveups)
    # one reshard per grown rank; the shrunken incarnation's increment never
    # flushes (it is SIGKILLed — its evidence is the resume event above)
    reshards = _prom_sum(grow_out, "ft_ckpt_reshards")
    if reshards < 2:
        return _fail("expected >=2 ft.ckpt.reshards in the grow leg, "
                     "got %s" % reshards)
    if not args.keep and args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    print("chaos_drill[el]: PASS")
    return 0


def run_hostps(args):
    """The ShardPS drill (see the module docstring's ``--hostps``)."""
    import numpy as np

    shape = HOSTPS_SMOKE if args.smoke else HOSTPS
    every = shape["every"]
    work = _workdir(args, "chaos_drill_ps_")
    data = os.path.join(work, "data")
    os.makedirs(data, exist_ok=True)
    _write_files(data, shape["n_files"], shape["rows"])
    env = worker_env(args.device)
    env.update(PS_ENV)

    print("chaos_drill[ps]: reference run (single-host HostPS, same "
          "data)...")
    ref_out = os.path.join(work, "ref")
    os.makedirs(ref_out, exist_ok=True)
    r = subprocess.run(
        [sys.executable] + _ps_cmd("none", work, data,
                                   os.path.join(work, "ckpt-ref"), ref_out,
                                   shape, args.device),
        env=env, cwd=REPO, timeout=TIMEOUT_S)
    if r.returncode != 0:
        return _fail("reference worker exited rc=%d" % r.returncode)

    print("chaos_drill[ps]: n=2 drill — trainer + shard owner; wire chaos "
          "(drop/delay/dup), owner SIGKILLed after ckpt-%d, solo respawn + "
          "staleness-window replay, live 2->1 shrink..." % (2 * every))
    out = os.path.join(work, "drill")
    os.makedirs(out, exist_ok=True)
    ck = os.path.join(work, "ckpt-drill")
    logs = os.path.join(work, "logs")
    res = _launch(2, 6351,
                  _ps_cmd("hostps", work, data, ck, out, shape, args.device),
                  env, ["--elastic_retries", "2", "--elastic_reset_secs",
                        "0", "--solo_respawn_ranks", "1", "--log_dir", logs])
    if res.returncode != 0:
        sys.stderr.write(res.stderr or "")
        _logs_tail(logs, [0, 1])
        return _fail("hostps drill job exited rc=%d" % res.returncode)
    if "solo respawn" not in res.stderr \
            or "ps shard owner" not in res.stderr:
        return _fail("launcher never took the solo-respawn path:\n%s"
                     % res.stderr)
    print("chaos_drill[ps]: solo respawn OK (fleet kept running)")
    w0log = open(os.path.join(logs, "worker.0.log")).read()
    if "live repartition OK" not in w0log:
        return _fail("trainer never completed the live-shrink leg:\n%s"
                     % w0log[-2000:])
    if "exceeds the per-process budget" not in w0log:
        return _fail("beyond-one-process footprint evidence missing")

    err = _same_params(np.load(os.path.join(ref_out, "final_params.npz")),
                       np.load(os.path.join(out, "final_params.npz")),
                       "shardps")
    if err:
        return _fail(err)
    tref = np.load(os.path.join(ref_out, "final_table.npz"))["table"]
    tgot = np.load(os.path.join(out, "final_table.npz"))["table"]
    if tref.tobytes() != tgot.tobytes():
        return _fail("sharded table differs from single-host HostPS after "
                     "kill+respawn+replay (max abs delta %g over %d rows)"
                     % (np.abs(tref - tgot).max(),
                        int((tref != tgot).any(1).sum())))
    print("chaos_drill[ps]: bit-parity OK (dense params + full %d-row "
          "table vs single-host HostPS)" % tref.shape[0])

    a0 = os.path.join(out, "attempt-0")
    for point in ("ps_drop", "ps_delay", "ps_dup"):
        if _prom_labeled_sum(a0, "ft_chaos_fired",
                             'point="%s"' % point) < 1:
            return _fail("chaos point %s never fired" % point)
    if _prom_labeled_sum(a0, "ft_retry_attempts_total",
                         'surface="ps_wire"') < 1:
        return _fail("the wire never exercised its resend path")
    if _prom_labeled_sum(out, "ft_retry_giveups"):
        return _fail("ft.retry.giveups != 0")
    if _prom_labeled_sum(a0, "hostps_wire_dup_sent") < 1:
        return _fail("the duplicate push was never sent")
    if _prom_labeled_sum(a0, "hostps_wire_dead_waits") < 1:
        return _fail("the trainer never entered the dead-shard wait")
    if _prom_labeled_sum(a0, "hostps_wire_replayed") < 1:
        return _fail("no staleness-window push was replayed to the "
                     "respawned owner")
    print("chaos_drill[ps]: wire faults absorbed (attempts>0, giveups=0, "
          "dup deduped via parity) + degradation/replay counters OK")

    ev = _read_events(os.path.join(a0, "timeline.jsonl"))
    for kind in ("ps_degraded", "ps_recovered", "ps_repartition"):
        if not [e for e in ev if e.get("ev") == kind]:
            return _fail("timeline lacks the %s event" % kind)
    ps_steps = [e for e in ev if e.get("ev") == "step"
                and "ps_wait" in (e.get("phases") or {})]
    if not ps_steps:
        return _fail("no step event carries the ps_wait phase")
    print("chaos_drill[ps]: timeline evidence OK (%d steps carry ps_wait)"
          % len(ps_steps))

    summary = os.path.join(REPO, "scripts", "trace_summary.py")
    ts = subprocess.run(
        [sys.executable, summary, "--check", "--max-ps-wait-frac", "0.05",
         "--timeline", a0], env=env, cwd=REPO, timeout=120,
        capture_output=True, text=True)
    if ts.returncode == 0 or "ps_wait" not in ts.stderr \
            or "FAILED" not in ts.stderr:
        return _fail("--max-ps-wait-frac 0.05 should FAIL on the "
                     "chaos-stalled attempt, naming the phase:\n%s"
                     % ts.stderr)
    ts2 = subprocess.run(
        [sys.executable, summary, "--check", "--max-ps-wait-frac", "3.0",
         "--timeline", a0], env=env, cwd=REPO, timeout=120,
        capture_output=True, text=True)
    if ts2.returncode != 0:
        return _fail("generous ps_wait budget should pass:\n%s%s"
                     % (ts2.stdout, ts2.stderr))
    print("chaos_drill[ps]: ps_wait CI gate OK (tight budget fails naming "
          "the phase, generous budget passes)")
    corpse = _assert_no_corpses(ck)
    if corpse:
        return _fail("uncommitted checkpoint corpse survived: %s" % corpse)
    if not args.keep and args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    print("chaos_drill[ps]: PASS")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="CI gate mode (same checks; kept as an explicit "
                         "flag so pipelines read as intent)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced drill (tier-1 budget)")
    ap.add_argument("--multiproc", action="store_true",
                    help="n=2 fleet drill: agreed-boundary preemption, "
                         "lost-rank degradation, fleet kill, bit-parity")
    ap.add_argument("--elastic", action="store_true",
                    help="shrink/grow drill; combine with --smoke for the "
                         "tier-1 budget")
    ap.add_argument("--hostps", action="store_true",
                    help="ShardPS drill: trainer + shard owner, wire chaos, "
                         "owner SIGKILL + solo respawn + replay, live "
                         "shrink, bit-parity vs single-host HostPS")
    ap.add_argument("--fleet", action="store_true",
                    help="FleetServe drill: a replica SIGKILLed mid-trace "
                         "behind the router (tools/serving_drill.py)")
    ap.add_argument("--online", action="store_true",
                    help="OnlineLoop drill: streaming train -> delta "
                         "publish -> zero-drop flips, torn publish, "
                         "rollback, resume parity")
    ap.add_argument("--oom", action="store_true",
                    help="MemScope induced-OOM drill: one postmortem naming "
                         "the planted ballast, the predictor's warning first")
    for mode in UNPORTED:
        ap.add_argument("--" + mode, action="store_true",
                        help="not ported: %s" % UNPORTED[mode])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the workers train (default: the card)")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--plan", default="none",
                    choices=["none", "drill", "smoke", "multiproc",
                             "elastic", "hostps", "online", "fleetps",
                             "oom"])
    ap.add_argument("--data")
    ap.add_argument("--ckpt")
    ap.add_argument("--out")
    ap.add_argument("--every", type=int, default=FULL["every"])
    ap.add_argument("--sigterm-at", dest="sigterm_at", type=int,
                    default=FULL["sigterm_at"])
    ap.add_argument("--ctr", type=lambda v: [int(x) for x in v.split(",")],
                    default=None,
                    help="(worker) train tools/ctr_program.py's CTR program "
                         "at these widths (n_fields,vocab,embed,mlp...) "
                         "instead of the drill model")
    ap.add_argument("--batch", type=int, default=BATCH,
                    help="(worker) the CTR program's batch")
    ap.add_argument("--wire", default=None,
                    help="(worker) the ShardPS wire directory")
    ap.add_argument("--hb", default=None,
                    help="(worker) the heartbeat directory")
    ap.add_argument("--ps-budget", dest="ps_budget", type=int, default=None,
                    help="(worker) per-process table byte budget")
    ap.add_argument("--model", default=None,
                    help="(online worker) the serving artifact")
    ap.add_argument("--publish", default=None,
                    help="(online worker) the publish directory")
    ap.add_argument("--pub-every", dest="pub_every", type=int, default=3,
                    help="(online worker) publish every N steps")
    ap.add_argument("--idle-secs", dest="idle_secs", type=float, default=6.0,
                    help="(online worker) the stream's drain timeout")
    ap.add_argument("--publish-kill-at", dest="publish_kill_at", type=int,
                    default=None,
                    help="(online worker) SIGKILL inside the Nth publish")
    ap.add_argument("--workdir", default=None,
                    help="keep artifacts here instead of a temp dir")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        os.makedirs(args.out, exist_ok=True)
        if args.plan in ("online", "fleetps"):
            from paddle_tpu_torch.tools import serving_drill

            return (serving_drill.online_worker(args)
                    if args.plan == "online"
                    else serving_drill.fleetps_worker(args))
        if args.plan == "hostps" or (args.plan == "none"
                                     and args.wire is not None):
            return hostps_worker(args)
        return worker(args)
    for mode, why in UNPORTED.items():
        if getattr(args, mode):
            print("chaos_drill: --%s is not ported: %s" % (mode, why))
            return 2
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            return _fail("--device cuda and no CUDA device (pass --device "
                         "cpu)")
    if args.fleet or args.online or args.oom:
        from paddle_tpu_torch.tools import serving_drill

        if args.fleet:
            return serving_drill.run_fleet(args)
        if args.online:
            return serving_drill.run_online(args)
        return serving_drill.run_oom(args)
    if args.multiproc:
        return run_multiproc(args)
    if args.elastic:
        return run_elastic(args)
    if args.hostps:
        return run_hostps(args)
    return run_drill(args)


if __name__ == "__main__":
    sys.exit(main())
