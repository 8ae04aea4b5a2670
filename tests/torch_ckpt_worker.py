"""One rank of a gloo world for the sharded-checkpoint and fault-tolerance
tests (ROADMAP items 5-D and 6): ``tests/test_torch_checkpoint.py`` and
``tests/test_torch_ft.py``.

``python tests/torch_ckpt_worker.py RANK WORLD STORE IN OUT SCENARIO...``,
as ``torch_dp_worker.py`` runs (its ``spawn_world`` and ``join_world``
start this script with ``script=__file__``).  Every scenario exports the
launcher's ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` first, so the
checkpoint protocol sees the world's ranks, and works under its own
directory of ``IN["dir"]``, which every rank shares.
"""

import os
import sys

import numpy as np
import torch

import torch_dp_worker as base


def _fleet(world, name, inp):
    import torch.distributed as dist

    os.environ["PADDLE_TRAINER_ID"] = str(dist.get_rank())
    os.environ["PADDLE_TRAINERS_NUM"] = str(world)
    os.environ["PADDLE_RESTART_ATTEMPT"] = "0"
    d = os.path.join(inp["dir"], "%s-w%d" % (name, world))
    os.makedirs(d, exist_ok=True)
    return d


def _respawn():
    """What the launcher's restart guarantees: every rank's preempted
    attempt has exited before any rank starts the next incarnation, which
    carries the next restart attempt (and aborts the old agreement
    rounds)."""
    import torch.distributed as dist

    dist.barrier()
    os.environ["PADDLE_RESTART_ATTEMPT"] = "1"


def _np(tree):
    from paddle_tpu_torch._tree import tree_map

    return tree_map(lambda t: t.detach().cpu().clone().numpy(), tree)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- test_torch_checkpoint.py ---------------------------------------------------

def zero_resume(inp, world):
    """ZeRO (dp = world) tiny BERT with Adam: two steps, save at step 2 with
    the trainer's specs, three more losses; a fresh trainer (another init)
    restores and must give the same three losses, each rank's blocks the
    saved ones.  Also the global state at step 2 (gathered) and the rows of
    the token-embedding moment each rank's shard file holds."""
    import torch.distributed as dist

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import MeshSpec, optim
    from paddle_tpu_torch.parallel import checkpoint as ck
    from paddle_tpu_torch.parallel.train import gather_pytree

    d = _fleet(world, "zero", inp)
    cfg = bert.bert_tiny_config()
    batch = _torch(inp["batch"])
    spec = MeshSpec(dp=world, zero=True)
    tr = bert.build_bert_trainer(cfg, spec, optimizer=optim.adam(), seed=0,
                                 device="cpu")
    for _ in range(2):
        tr.step(batch, 1e-3)
    saved = _np(tr.state)
    gathered = _np(gather_pytree(tr.state, tr.specs, tr.mesh))
    ck.save_checkpoint(d, tr.state, step=2, specs=tr.specs, mesh=tr.mesh)
    ref = [float(tr.step(batch, 1e-3)) for _ in range(3)]
    dist.barrier()                  # rank 0's COMMIT has landed
    path = ck.latest_checkpoint(d)
    tr2 = bert.build_bert_trainer(cfg, spec, optimizer=optim.adam(), seed=1,
                                  device="cpu")
    state, step = ck.restore_checkpoint(path, tr2.state, specs=tr2.specs,
                                        mesh=tr2.mesh)
    back = _np(state)
    tr2.state = state
    got = [float(tr2.step(batch, 1e-3)) for _ in range(3)]
    z = np.load(os.path.join(path, "shards-p%d.npz" % dist.get_rank()))
    rows = sum(z[k].shape[0] for k in z.files
               if k.startswith("opt/m/tok_emb@"))
    z.close()
    return {"path": path, "step": step, "ref": ref, "got": got,
            "saved": saved, "restored": back, "moment_rows": rows,
            "local_moment_rows": int(tr2.state["opt"]["m"]["tok_emb"].shape[0]),
            "gathered": gathered if dist.get_rank() == 0 else None}


def authority_restore(inp, world):
    """A checkpoint two savers wrote (the test's manual fleet checkpoint)
    restored through a ShardingAuthority on a dp = world mesh: each rank
    gets its block of the table's rows and the whole bias."""
    from paddle_tpu_torch.parallel import checkpoint as ck
    from paddle_tpu_torch.parallel import rules
    from paddle_tpu_torch.parallel.mesh import make_mesh

    _fleet(world, "authority", inp)
    mesh = make_mesh(dp=world, device="cpu")
    auth = rules.ShardingAuthority(
        [(r"^embed$", rules.row_sharded_table_spec("dp")),
         (r"^bias$", rules.P())], mesh=mesh)
    st, step = ck.restore_checkpoint(
        ck.latest_checkpoint(inp["manual_fleet"]),
        {"embed": torch.zeros(16, 4), "bias": torch.zeros(1)},
        authority=auth)
    return {"step": step, "embed": st["embed"].numpy(),
            "bias": st["bias"].numpy()}


def cross_package(inp, world):
    """The JAX package's checkpoint (a [16, 3] f32 leaf over 8 devices, bf16,
    int32 and int64 leaves) restored at this world with the rows split over
    dp; and a checkpoint this world writes (f32 rows split over dp, a
    replicated int32 leaf, an int64 scalar) for the test to restore in
    JAX."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import checkpoint as ck
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel.rules import P

    d = _fleet(world, "cross", inp)
    mesh = make_mesh(dp=world, device="cpu")
    target = {"rows": torch.zeros(16 // world, 3), "half": torch.zeros(
        4, 2, dtype=torch.bfloat16), "i32": torch.zeros(5, dtype=torch.int32),
        "i64": np.int64(0)}
    specs = {"rows": P("dp", None), "half": P(), "i32": P(), "i64": P()}
    st, step = ck.restore_checkpoint(inp["jax_ckpt"], target, specs=specs,
                                     mesh=mesh)
    got = {"rows": st["rows"].numpy(),
           "half": st["half"].view(torch.int16).numpy(),
           "i32": st["i32"].numpy(), "i64": np.asarray(st["i64"]),
           "step": step}
    mine = inp["port_state"]
    r = dist.get_rank()
    k = mine["w"].shape[0] // world
    state = {"w": torch.from_numpy(mine["w"][r * k:(r + 1) * k].copy()),
             "ids": torch.from_numpy(mine["ids"]),
             "count": np.int64(mine["count"])}
    ck.save_checkpoint(d, state, step=9, mesh=mesh,
                       specs={"w": P("dp", None), "ids": P(), "count": P()})
    dist.barrier()
    got["port_ckpt"] = ck.latest_checkpoint(d)
    return got


# -- test_torch_ft.py ------------------------------------------------------------

def _ctr(files, tagged, reduce):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.tools import ctr_program as cp

    wrap = (lambda o: fleet._Fleet().distributed_optimizer(o)) \
        if tagged else None
    prog = cp.build_ctr_program(fluid, wrap_optimizer=wrap)
    program = prog.main
    if reduce:
        bs = fluid.BuildStrategy()
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
        program = fluid.CompiledProgram(prog.main).with_data_parallel(
            loss_name=prog.loss.name, build_strategy=bs)
    ds = cp.make_dataset(fluid, "QueueDataset", files, prog, 16)
    return fluid, prog, program, ds


def _ctr_attempt(inp, d, tagged, reduce, preempt_at=None):
    from paddle_tpu_torch import ft
    from paddle_tpu_torch.ft import chaos
    from paddle_tpu_torch.tools import ctr_program as cp

    fluid, prog, program, ds = _ctr(inp["ctr_files"], tagged, reduce)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(prog.startup, scope=scope)
    policy = ft.CheckpointPolicy(d, every_steps=2, asynchronous=True, keep=2,
                                 resume=True)
    if preempt_at is not None:
        chaos.arm("sigterm_step", at=preempt_at)
    rc = 0
    try:
        exe.train_from_dataset(program, ds, scope=scope, checkpoint=policy)
    except SystemExit as e:
        rc = e.code
    finally:
        chaos.disarm()
    names = cp.persistable_names(prog.main)
    local = {n: scope.find_var(n).detach().cpu().clone().numpy()
             for n in names}
    return rc, local, {n: scope.row_shards(n) for n in names}


def program_dp_resume(inp, world):
    """The fleet-tagged CTR program (and its kReduce form) trained by
    train_from_dataset: a never-stopped run, one preempted at step 3 (both
    ranks; the agreement commits one ckpt-3), and the respawn resuming it.
    Each rank's state (kReduce: its rows) after the respawn against the
    never-stopped run's."""
    out = {}
    for tagged, reduce in ((True, False), (False, True)):
        key = "reduce" if reduce else "tagged"
        d = _fleet(world, "pdp-" + key, inp)
        _, ref, _ = _ctr_attempt(inp, _fleet(world, "pdp-ref-" + key, inp),
                                 tagged, reduce)
        rc, _, _ = _ctr_attempt(inp, d, tagged, reduce, preempt_at=3)
        _respawn()
        from paddle_tpu_torch.parallel.checkpoint import latest_checkpoint

        killed_at = latest_checkpoint(d)
        rc2, got, rows = _ctr_attempt(inp, d, tagged, reduce)
        out[key] = {"rc": (rc, rc2), "ref": ref, "got": got, "rows": rows,
                    "killed_at": os.path.basename(killed_at)}
    return out


def tp_save(inp, world):
    """The tensor-parallel program (tp = world) trained two steps, saved
    as a unified TrainState of this rank's blocks (``scope_blocks``, the
    split metadata), with every var gathered whole for the test's world-1
    restore."""
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ft import ckpt as fckpt

    import torch_program_tp_worker as tpw

    d = _fleet(world, "tp", inp)
    main, startup, v = tpw.tp_program(fluid, lambda f: f.optimizer.Adam(1e-2))
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    compiled = tpw._compiled(fluid, main, v, tp=world)
    for feed in tpw.tp_feeds(steps=2):
        exe.run(compiled, feed=feed, fetch_list=[v["loss"]], scope=scope)
    names = sorted(n for n in scope.local_var_names()
                   if scope.find_var(n) is not None
                   and main.global_block()._find_var_recursive(n) is not None
                   and main.global_block()._find_var_recursive(n).persistable)
    splits = {n: scope.split(n) for n in names if scope.split(n)}
    fckpt.save_train_state(d, 2, scope_state=fckpt.scope_blocks(scope, names),
                           exec_step=exe._step, asynchronous=False)
    whole = {n: scope.find_tensor_as_numpy(n) for n in names}
    dist.barrier()
    return {"dir": d, "splits": splits, "whole": whole}


def loop_zero_resume(inp, world):
    """TrainLoop over the ZeRO (dp = world) tiny BERT trainer
    (``tools/loop_drill.py``): never stopped; preempted at step 3 by the
    drill SIGTERM on both ranks; the respawn (another init) resumes and
    must end on the never-stopped run's blocks and losses."""
    from paddle_tpu_torch.tools import loop_drill

    d = _fleet(world, "loop", inp)
    ref = loop_drill.run("tiny", "cpu", steps=6, checkpoint=False,
                         world=world)
    killed = {}
    try:
        loop_drill.run("tiny", "cpu", steps=6, sigterm_at=3, ckpt=d,
                       world=world, rec=killed)
        rc = 0
    except SystemExit as e:
        rc = e.code
    _respawn()
    got = loop_drill.run("tiny", "cpu", steps=6, ckpt=d, world=world,
                         init_seed=7)
    return {"ref": ref, "killed": killed, "rc": rc, "got": got}


SCENARIOS = {f.__name__: f for f in (
    zero_resume, authority_restore, cross_package, program_dp_resume,
    tp_save, loop_zero_resume)}


if __name__ == "__main__":
    base.main(sys.argv[1:], SCENARIOS)
