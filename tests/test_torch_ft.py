"""FaultGuard in the port (``paddle_tpu_torch/ft``): fault injection,
retry/backoff, preemption handling, the agreement, and the kill-at-step-k ->
resume -> bit-parity acceptance, against the JAX package's
``tests/test_ft.py`` contract.

Every test of ``tests/test_ft.py`` is here, the four HostPS ones with the
port's ``hostps`` package; the heartbeat re-arm's agreement sweep and the
launcher's elastic shrink are in ``test_torch_heartbeat.py`` and
``test_torch_launch.py``.  Added: kill -> resume with dropout on, for
QueueDataset and InMemoryDataset; the port's never-stopped run against the
JAX package's (the program-mode tolerance, rtol 1e-5 and atol 1e-6); a
resume under program-mode data parallelism at world 2 (fleet-tagged and
kReduce); a tensor-parallel TrainState saved at tp = 2 and restored at
world 1 (``Scope._splits``); ``TrainLoop`` over the tiny BERT trainer,
SIGTERM at step 3 -> rc 120 -> resume, at one rank and at world 2 with
ZeRO; a TrainState with a HostPS table saved by either package and
restored by the other, bit for bit; ``hostps=`` through the guarded
``train_from_dataset`` and through ``TrainLoop``; the launcher's solo
respawn of a shard owner while its peer keeps running.  The world-2
scenarios run in one gloo world started for the module
(``tests/torch_ckpt_worker.py``).
"""

import json
import os
import signal
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import ft
from paddle_tpu_torch.ft import chaos, retry
from paddle_tpu_torch.ft import ckpt as fckpt
from paddle_tpu_torch.ft.guard import PREEMPTED_RC
from paddle_tpu_torch.monitor import default_registry

import torch_ckpt_worker
import torch_dp_worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)   # test_torch_program_dp.py's
WORLD_SCENARIOS = ["program_dp_resume", "tp_save", "loop_zero_resume"]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    # torch's intra-op pool contends with XLA's in this process: the tiny
    # BERT loop runs ~50x slower at the default thread count
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    chaos.disarm()
    for k in ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID",
              "PADDLE_RESTART_ATTEMPT", "PADDLE_TPU_CHAOS"):
        monkeypatch.delenv(k, raising=False)
    yield
    chaos.disarm()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One gloo world of 2 for the module's distributed scenarios."""
    from paddle_tpu_torch.tools import ctr_program as cp

    tmp = tmp_path_factory.mktemp("ft_world")
    inputs = {"dir": str(tmp / "shared"),
              "ctr_files": cp.write_ctr_files(str(tmp / "data"), n_files=2,
                                              rows_per_file=64)}
    os.makedirs(inputs["dir"])
    out, procs = torch_dp_worker.spawn_world(
        tmp, 2, inputs, WORLD_SCENARIOS, script=torch_ckpt_worker.__file__)
    joined = []

    def get():
        if not joined:
            joined.append(torch_dp_worker.join_world(out, procs,
                                                     WORLD_SCENARIOS))
        return joined[0]

    yield get
    for p in procs:
        if p.poll() is None:
            p.kill()


def _counter(name):
    return sum(row["value"] for row in default_registry().snapshot()
               if row["name"] == name and row["kind"] == "counter")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


# -- data / model helpers ----------------------------------------------------

FIELDS, VOCAB, BATCH = 4, 50, 16


def _write_ctr_files(tmp_path, n_files=3, rows=48, seed=0):
    rng = np.random.RandomState(seed)
    files = []
    for fi in range(n_files):
        p = tmp_path / ("part-%05d" % fi)
        with open(p, "w") as f:
            for _ in range(rows):
                ids = rng.randint(0, VOCAB, FIELDS)
                lab = 1.0 if ids.sum() % 2 else 0.0
                f.write("%d %s 1 %.1f\n"
                        % (FIELDS, " ".join(map(str, ids)), lab))
        files.append(str(p))
    return files


def _build_deepfm(pkg, files, kind="QueueDataset", dropout=0.0):
    """The reference test's DeepFM-style program (on either package), with
    an optional dropout between its fcs."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        ids = L.data("feat_ids", shape=[FIELDS], dtype="int64")
        label = L.data("label", shape=[1], dtype="float32")
        ds = pkg.DatasetFactory().create_dataset(kind)
        ds.set_batch_size(BATCH)
        ds.set_filelist(files)
        ds.set_use_var([ids, label])
        emb = L.embedding(ids, size=[VOCAB, 8], is_sparse=True)
        h = L.fc(L.reshape(emb, [-1, FIELDS * 8]), 16, act="relu")
        if dropout:
            h = L.dropout(h, dropout)
        logit = L.fc(h, 1)
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
        pkg.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, ds, loss


def _params(main, scope):
    return {v.name: scope.find_tensor_as_numpy(v.name)
            for v in main.list_vars()
            if v.persistable and scope.has_var(v.name)}


def _train_guarded(files, ckpt_dir, preempt_at=None, kind="QueueDataset",
                   dropout=0.3, hostps=None):
    """One 'process attempt': a fresh build, train with auto-checkpoint
    (+resume), optionally chaos-SIGTERM'd at a boundary.  Returns (rc,
    params) — rc is PREEMPTED_RC when the guard exited for preemption."""
    main, startup, ds, _ = _build_deepfm(fluid, files, kind, dropout)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        ds.local_shuffle()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    policy = ft.CheckpointPolicy(ckpt_dir, every_steps=3, asynchronous=True,
                                 keep=2, resume=True, hostps=hostps)
    if preempt_at is not None:
        chaos.arm("sigterm_step", at=preempt_at)
    rc = 0
    try:
        exe.train_from_dataset(main, ds, scope=scope, checkpoint=policy)
    except SystemExit as e:
        rc = e.code
    finally:
        chaos.disarm()
    return rc, _params(main, scope)


# -- retry / backoff ---------------------------------------------------------

def test_retry_transient_absorbed_and_counted(tmp_path):
    p = tmp_path / "x.txt"
    p.write_text("ok")
    a0, g0 = _counter("ft.retry.attempts"), _counter("ft.retry.giveups")
    chaos.arm("io_error", at=1, times=2)
    with retry.open_retry(str(p)) as f:
        assert f.read() == "ok"
    assert _counter("ft.retry.attempts") - a0 == 2
    assert _counter("ft.retry.giveups") == g0


def test_retry_gives_up_after_budget():
    g0 = _counter("ft.retry.giveups")
    chaos.arm("io_error", at=1, times=99)
    with pytest.raises(OSError):
        retry.io_retry(lambda: 1, attempts=3, base=0.001)
    assert _counter("ft.retry.giveups") - g0 == 1


def test_chaos_crash_is_not_retried():
    calls = []

    def op():
        calls.append(1)
        raise chaos.ChaosError("boom")

    with pytest.raises(chaos.ChaosError):
        retry.io_retry(op, attempts=5, base=0.001)
    assert len(calls) == 1


# -- chaos injection points --------------------------------------------------

def test_chaos_feed_worker_surfaces_on_training_thread():
    from paddle_tpu_torch.feed_pipe import DeviceFeedPipe

    chaos.arm("feed_worker", at=3)
    pipe = DeviceFeedPipe(iter([{"a": i} for i in range(10)]))
    got = []
    with pytest.raises(chaos.ChaosError):
        for feed in pipe:
            got.append(feed["a"])
    assert got == [0, 1]


def test_ckpt_commit_crash_keeps_previous_latest_and_gc(tmp_path):
    from paddle_tpu_torch.parallel import checkpoint as base

    d = str(tmp_path)
    base.save_checkpoint(d, {"w": np.ones(3, np.float32)}, step=1)
    chaos.arm("ckpt_commit", at=1)
    with pytest.raises(chaos.ChaosError):
        base.save_checkpoint(d, {"w": np.full(3, 2.0, np.float32)}, step=2)
    assert os.path.exists(tmp_path / "ckpt-2" / "shards-p0.npz")
    assert not os.path.exists(tmp_path / "ckpt-2" / "COMMIT")
    assert base.latest_checkpoint(d).endswith("ckpt-1")
    chaos.disarm()
    base.save_checkpoint(d, {"w": np.full(3, 3.0, np.float32)}, step=3)
    assert not os.path.exists(tmp_path / "ckpt-2")
    assert base.latest_checkpoint(d).endswith("ckpt-3")
    st, _ = base.restore_checkpoint(
        base.latest_checkpoint(d), {"w": np.zeros(3, np.float32)})
    assert _same(st["w"], np.full(3, 3.0, np.float32))


# -- dataset cursor ----------------------------------------------------------

def test_queue_dataset_cursor_skip_to(tmp_path):
    files = _write_ctr_files(tmp_path)
    _, _, ds, _ = _build_deepfm(fluid, files)
    full = list(ds._iter_batches(with_cursor=True))
    assert [c for c, _ in full][:4] == [(0, 0), (0, 1), (0, 2), (1, 0)]
    tail = list(ds._iter_batches(with_cursor=True, skip_to=(1, 0)))
    assert [c for c, _ in tail] == [c for c, _ in full[4:]]
    for (_, a), (_, b) in zip(tail, full[4:]):
        for k in a:
            assert _same(a[k], b[k])
    assert list(ds._iter_batches(with_cursor=True,
                                 skip_to=full[-1][0])) == []


def test_inmemory_dataset_cursor_matches_plain_iteration(tmp_path):
    files = _write_ctr_files(tmp_path)
    _, _, ds, _ = _build_deepfm(fluid, files, kind="InMemoryDataset")
    ds.load_into_memory()
    ds.local_shuffle()
    plain = list(ds._iter_batches())
    cur = list(ds._iter_batches(with_cursor=True))
    assert len(plain) == len(cur)
    for a, (c, b) in zip(plain, cur):
        for k in a:
            assert _same(a[k], b[k])
    tail = list(ds._iter_batches(with_cursor=True, skip_to=(0, 1)))
    assert [c for c, _ in tail] == [c for c, _ in cur[2:]]


# -- the headline: kill at step k -> resume -> bit parity --------------------

@pytest.mark.parametrize("kind", ["QueueDataset", "InMemoryDataset"])
def test_kill_resume_bit_parity_dense(tmp_path, kind):
    """A run SIGTERM'd at step 4 and resumed from its auto-checkpoint ends
    with parameters IDENTICAL to an uninterrupted run — with a dropout
    between the fcs, whose masks come from the executor's seed counter."""
    data = tmp_path / "data"
    data.mkdir()
    files = _write_ctr_files(data)
    ck_a, ck_b = str(tmp_path / "ck_a"), str(tmp_path / "ck_b")
    rc, ref = _train_guarded(files, ck_a, kind=kind)
    assert rc == 0
    rc, _ = _train_guarded(files, ck_b, preempt_at=4, kind=kind)
    assert rc == PREEMPTED_RC
    from paddle_tpu_torch.parallel.checkpoint import latest_checkpoint
    assert latest_checkpoint(ck_b).endswith("ckpt-4")
    rc, got = _train_guarded(files, ck_b, kind=kind)
    assert rc == 0
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert _same(ref[k], got[k]), k


def test_never_stopped_run_matches_jax(tmp_path):
    """The port's never-stopped guarded run against the JAX package's, same
    program (no dropout: the packages' generators differ), same numpy
    parameters."""
    import paddle_tpu as jfluid
    from paddle_tpu_torch import convert

    data = tmp_path / "data"
    data.mkdir()
    files = _write_ctr_files(data)
    jmain, jstart, jds, _ = _build_deepfm(jfluid, files)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    init = {n: jscope.find_tensor_as_numpy(n) for n in names}
    pmain, _, pds, _ = _build_deepfm(fluid, files)
    pscope = convert.scope_from_numpy(init, fluid.Scope(), "cpu")
    pexe = fluid.Executor(fluid.CPUPlace())
    jexe.train_from_dataset(jmain, jds, scope=jscope, checkpoint=
                            jfluid.ft.CheckpointPolicy(str(tmp_path / "j"),
                                                       every_steps=3))
    pexe.train_from_dataset(pmain, pds, scope=pscope, checkpoint=
                            ft.CheckpointPolicy(str(tmp_path / "p"),
                                                every_steps=3))
    for n in names:
        np.testing.assert_allclose(pscope.find_tensor_as_numpy(n),
                                   jscope.find_tensor_as_numpy(n),
                                   err_msg=n, **TOL)


# -- preemption: real SIGTERM in a subprocess --------------------------------

def test_sigterm_checkpoint_and_exit_rc(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    _write_ctr_files(data, n_files=2, rows=32)
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out")
    worker = os.path.join(os.path.dirname(__file__), "torch_ft_worker.py")
    env = {**os.environ, "PADDLE_TPU_CHAOS": "sigterm_step@3",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, worker, str(data), ck, out],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == PREEMPTED_RC, (r.stdout, r.stderr)
    from paddle_tpu_torch.parallel.checkpoint import latest_checkpoint
    assert latest_checkpoint(ck) is not None
    events = [json.loads(line) for line in
              open(os.path.join(out, "timeline.jsonl"))]
    pre = [e for e in events if e.get("ev") == "preempted"]
    assert pre and pre[0]["rc"] == PREEMPTED_RC and pre[0]["step"] == 3
    env.pop("PADDLE_TPU_CHAOS")
    r2 = subprocess.run([sys.executable, worker, str(data), ck, out],
                        env=env, capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0 and "WORKER FINISHED" in r2.stdout, r2.stderr
    events = [json.loads(line) for line in
              open(os.path.join(out, "timeline.jsonl"))]
    res = [e for e in events if e.get("ev") == "resume"]
    assert res and res[0]["step"] == 3
    assert os.path.exists(os.path.join(out, "final_params.npz"))


# -- elastic launcher: preemption rc is a free restart -----------------------

_PREEMPT_ONCE = r"""
import os, sys
attempt = int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0"))
if attempt == 0:
    sys.exit(120)     # ft.PREEMPTED_RC: "I checkpointed, restart me"
print("DONE attempt=%d" % attempt)
"""


def test_launch_preempted_rc_does_not_burn_retries(tmp_path, capfd):
    from paddle_tpu_torch.distributed import launch as launch_mod

    script = tmp_path / "w.py"
    script.write_text(_PREEMPT_ONCE)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        rc = launch_mod.launch([
            "--nproc_per_node", "1", "--started_port", "6411",
            "--elastic_retries", "1", "--elastic_reset_secs", "0",
            str(script)])
    finally:
        signal.signal(signal.SIGTERM, prev)
    err = capfd.readouterr().err
    assert rc == 0
    assert "preempted (rc=120); free elastic restart, budget kept 0/1" in err


_CRASH_THEN_SLEEP = r"""
import os, sys, time
attempt = int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0"))
if attempt == 0:
    sys.exit(9)       # real crash: burns a retry
time.sleep(1.2)       # healthy stretch > --elastic_reset_secs
print("DONE attempt=%d" % attempt)
"""


def test_launch_elastic_reset_secs_refills_budget(tmp_path, capfd):
    from paddle_tpu_torch.distributed import launch as launch_mod

    script = tmp_path / "w.py"
    script.write_text(_CRASH_THEN_SLEEP)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        rc = launch_mod.launch([
            "--nproc_per_node", "1", "--started_port", "6412",
            "--elastic_retries", "1", "--elastic_reset_secs", "0.5",
            str(script)])
    finally:
        signal.signal(signal.SIGTERM, prev)
    err = capfd.readouterr().err
    assert rc == 0
    assert "elastic restart 1/1" in err
    assert "elastic retry budget reset (1/1 used -> 0/1)" in err


def test_launch_term_grace_default_and_solo_respawn_refusal(monkeypatch):
    from paddle_tpu_torch.distributed import launch as launch_mod

    monkeypatch.setenv("PADDLE_TPU_PREEMPT_AGREE_SECS", "7")
    monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER_SECS", "11")
    args = launch_mod._parse_args(["w.py"])
    assert args.term_grace_secs == 7 + 11 + 30.0
    assert launch_mod._parse_args(
        ["--term_grace_secs", "5", "w.py"]).term_grace_secs == 5.0
    assert args.solo_ranks == set()
    assert launch_mod._parse_args(
        ["--solo_respawn_ranks", "1", "w.py"]).solo_ranks == {1}
    assert launch_mod._parse_args(
        ["--solo_respawn_ranks", "1, 3", "w.py"]).solo_ranks == {1, 3}


_SOLO_OWNER = r"""
import os, sys, time
rank = int(os.environ["PADDLE_TRAINER_ID"])
attempt = int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0"))
d = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(d, "starts"), "a") as f:
    f.write("%d %d\n" % (rank, attempt))
if rank == 1 and attempt == 0:
    sys.exit(3)                      # the shard owner dies
if rank == 1:
    open(os.path.join(d, "respawned"), "w").close()
    sys.exit(0)
deadline = time.time() + 60          # the trainer outlives the owner
while not os.path.exists(os.path.join(d, "respawned")):
    if time.time() > deadline:
        sys.exit(4)
    time.sleep(0.05)
"""


def test_launch_solo_respawn_keeps_the_fleet_running(tmp_path, capfd):
    """A rank listed in ``--solo_respawn_ranks`` that crashes is respawned
    alone (one retry burnt); its peer is never restarted."""
    from paddle_tpu_torch.distributed import launch as launch_mod

    script = tmp_path / "w.py"
    script.write_text(_SOLO_OWNER)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        rc = launch_mod.launch([
            "--nproc_per_node", "2", "--started_port", "6413",
            "--elastic_retries", "1", "--elastic_reset_secs", "0",
            "--solo_respawn_ranks", "1", str(script)])
    finally:
        signal.signal(signal.SIGTERM, prev)
    err = capfd.readouterr().err
    assert rc == 0, err
    assert "worker 1 exited rc=3; solo respawn 1/1" in err
    starts = sorted((tmp_path / "starts").read_text().split("\n")[:-1])
    assert starts == ["0 0", "1 0", "1 1"]


# -- heartbeat re-arm --------------------------------------------------------

def test_heartbeat_rearm_clears_stale_marks(tmp_path):
    from paddle_tpu_torch.distributed.heartbeat import (
        COMPLETED, RUNNING, HeartBeatMonitor, WorkerHeartbeat)

    d = str(tmp_path)
    open(os.path.join(d, "done-0"), "w").write("1.0")
    open(os.path.join(d, "hb-0"), "w").write("7 123.0")
    mon = HeartBeatMonitor(d, n_workers=1, timeout=5.0)
    assert mon.worker_status()[0] == COMPLETED
    hb = WorkerHeartbeat(d, 0, interval=0.2).start()
    try:
        assert not os.path.exists(os.path.join(d, "done-0"))
        assert mon.worker_status()[0] == RUNNING
    finally:
        hb.complete()
    assert mon.worker_status()[0] == COMPLETED


def test_restore_raises_on_uncovered_scope_vars(tmp_path):
    d = str(tmp_path)
    fckpt.save_train_state(
        d, 2, scope_state={"w": np.ones(2, np.float32),
                           "b": np.zeros(1, np.float32)},
        hostps=[], asynchronous=False)
    with pytest.raises(RuntimeError, match="does not cover.*drifted"):
        fckpt.restore_train_state(d, {"w": np.zeros(2, np.float32)},
                                  hostps=[])


def test_save_without_rng_is_restorable(tmp_path):
    d = str(tmp_path)
    fckpt.save_train_state(d, 4, scope_state={"w": torch.ones(3)},
                           hostps=[], rng=False, asynchronous=False)
    state = np.random.get_state()
    rs = fckpt.restore_train_state(d, {"w": torch.zeros(3)}, hostps=[])
    assert rs.step == 4
    assert torch.equal(rs.scope_state["w"], torch.ones(3))
    assert np.array_equal(state[1], np.random.get_state()[1])


def test_infer_from_dataset_rejects_checkpoint(tmp_path):
    files = _write_ctr_files(tmp_path)
    main, startup, ds, _ = _build_deepfm(fluid, files)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="training only"):
        exe.infer_from_dataset(
            main, ds, scope=scope,
            checkpoint=ft.CheckpointPolicy(str(tmp_path / "ck")))


def test_hostps_tables_wait_for_item_7(tmp_path):
    """``hostps=[svc]`` rides the unified TrainState: saved by
    ``save_train_state`` and by the guarded ``train_from_dataset`` (its
    preemption save), restored into a fresh table bit for bit; ``None``
    takes every live embedding."""
    from paddle_tpu_torch.hostps import (HostAdagrad, HostPSEmbedding,
                                         HostSparseTable, service)

    def make(name="ft_tables"):
        return HostPSEmbedding(
            HostSparseTable(40, 3, optimizer=HostAdagrad(), seed=4,
                            name=name), cache_slots=4, device="cpu")

    svc = make()
    ids = np.arange(0, 40, 3)
    svc.pull(ids)
    svc.push(ids, np.full((ids.size, 3), 0.5, np.float32), 0.1)
    d = str(tmp_path / "direct")
    fckpt.save_train_state(d, 1, scope_state={}, hostps=[svc],
                           asynchronous=False)
    fresh = make()
    rs = fckpt.restore_train_state(d, {}, hostps=[fresh])
    assert rs.step == 1
    _same_table(fresh, svc)
    # hostps=None: every live embedding (here the two above, one name)
    with pytest.raises(ValueError, match="two HostPS tables named"):
        fckpt.save_train_state(d, 2, scope_state={}, asynchronous=False)
    service._LIVE_EMBEDDINGS.discard(fresh)
    fckpt.save_train_state(d, 2, scope_state={}, asynchronous=False)
    assert os.path.isdir(os.path.join(d, "ckpt-2", "hostps", "p0"))

    data = tmp_path / "data"
    data.mkdir()
    files = _write_ctr_files(data, n_files=1, rows=64)
    ck = str(tmp_path / "ck")
    rc, _ = _train_guarded(files, ck, preempt_at=2, hostps=[svc])
    assert rc == PREEMPTED_RC
    svc.push(ids, np.ones((ids.size, 3), np.float32), 1.0)   # drift
    again = make()
    rc, _ = _train_guarded(files, ck, hostps=[again])
    assert rc == 0
    _same_table(again, fresh)
    service._LIVE_EMBEDDINGS.clear()


def _same_table(got, want):
    gr, ga, gm = got.table.snapshot()
    wr, wa, wm = want.table.snapshot()
    np.testing.assert_array_equal(gr, wr)
    assert sorted(ga) == sorted(wa) and gm == wm
    for k in wa:
        np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)


# -- knobs -------------------------------------------------------------------

def test_ckpt_barrier_secs_env(monkeypatch):
    from paddle_tpu_torch.parallel import checkpoint as base

    monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER_SECS", "7.5")
    assert base.barrier_secs() == 7.5
    monkeypatch.delenv("PADDLE_TPU_CKPT_BARRIER_SECS")
    assert base.barrier_secs() == 120.0


# -- agreed-boundary preemption (ft/agree.py) --------------------------------

def test_agree_resolves_max_across_ranks(tmp_path):
    import threading

    from paddle_tpu_torch.ft import agree

    d = str(tmp_path)
    r0 = agree.StepAgreement(d, rank=0, world=2)
    r1 = agree.StepAgreement(d, rank=1, world=2)
    out = {}
    t = threading.Thread(
        target=lambda: out.setdefault("r0", r0.resolve(10, timeout=10)))
    t.start()
    out["r1"] = r1.resolve(11, timeout=10)
    t.join()
    assert out["r0"] == (11, "agreed") and out["r1"] == (11, "agreed")
    assert r0.steps_seen == {0: 10, 1: 11}


def test_agree_fallback_quantum_on_timeout(tmp_path, monkeypatch):
    from paddle_tpu_torch.ft import agree

    monkeypatch.setenv("PADDLE_TPU_PREEMPT_QUANTUM", "5")
    ag = agree.StepAgreement(str(tmp_path), rank=0, world=2)
    assert ag.resolve(13, timeout=0.2) == (15, "fallback")
    assert agree.next_quantum_step(15, 5) == 20


def test_agree_abort_stale_rounds(tmp_path, monkeypatch):
    from paddle_tpu_torch.ft import agree

    d = str(tmp_path)
    agree.StepAgreement(d, rank=0, world=2, attempt=0).publish(7)
    agree.StepAgreement(d, rank=1, world=2, attempt=0).publish(8)
    assert agree.round_open(d, attempt=0)
    monkeypatch.setenv("PADDLE_RESTART_ATTEMPT", "1")
    assert agree.abort_stale_rounds(d, rank=0) == 8
    assert not agree.round_open(d, attempt=0)
    g = [r for r in default_registry().snapshot()
         if r["name"] == "ft.preempt.agreed_step"]
    assert g and g[0]["value"] == 8
    monkeypatch.setenv("PADDLE_RESTART_ATTEMPT", "0")
    r0 = agree.StepAgreement(d, rank=0, world=2, attempt=0)
    r0.publish(5)
    path = r0._my_path()
    blob = json.load(open(path))
    blob["pid"] = 1
    json.dump(blob, open(path, "w"))
    agree.StepAgreement(d, rank=1, world=2, attempt=0).publish(6)
    agree.abort_stale_rounds(d, rank=0)
    assert not os.path.exists(path)
    steps, _ = agree.StepAgreement(d, rank=1, world=2,
                                   attempt=0)._read_round()
    assert steps == {1: 6}


def test_chaos_rank_targeting(monkeypatch):
    chaos.arm("feed_worker", at=1, rank=0)
    chaos.arm("feed_worker", at=1, rank=1)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    chaos.maybe_fire("feed_worker")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    chaos.arm("feed_worker", at=2, rank=1)
    with pytest.raises(chaos.ChaosError):
        chaos.maybe_fire("feed_worker")


def test_chaos_await_path_gates_firing(tmp_path):
    import threading
    import time as _time

    gate = tmp_path / "COMMIT"
    chaos.arm("feed_worker", at=1, await_path=str(gate))
    threading.Timer(0.3, lambda: gate.write_text("x")).start()
    t0 = _time.monotonic()
    with pytest.raises(chaos.ChaosError):
        chaos.maybe_fire("feed_worker")
    assert _time.monotonic() - t0 >= 0.25
    chaos.disarm("feed_worker")


def test_chaos_env_rank_spec(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CHAOS", "io_error@1:r0;io_error@2:r1")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    chaos.load_env()
    chaos.maybe_fire("io_error")
    with pytest.raises(chaos.ChaosIOError):
        chaos.maybe_fire("io_error")
    monkeypatch.delenv("PADDLE_TPU_CHAOS")
    chaos.load_env()


# -- multi-rank shard/COMMIT: cross-process barrier over the fleet env -------

def _fleet_env(monkeypatch, rank, world=2):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(world))
    monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))


def test_two_rank_commit_in_process(tmp_path, monkeypatch):
    from paddle_tpu_torch.parallel import checkpoint as base

    d = str(tmp_path)
    _fleet_env(monkeypatch, rank=1)
    base.save_checkpoint(d, {"w": torch.full((3,), 1.0)}, step=5)
    assert not os.path.exists(tmp_path / "ckpt-5" / "COMMIT")
    _fleet_env(monkeypatch, rank=0)
    monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER_SECS", "10")
    base.save_checkpoint(d, {"w": torch.full((3,), 1.0)}, step=5)
    assert os.path.exists(tmp_path / "ckpt-5" / "COMMIT")
    for k in range(2):
        assert os.path.exists(tmp_path / "ckpt-5" / ("index-p%d.json" % k))
    st, step = base.restore_checkpoint(base.latest_checkpoint(d),
                                       {"w": torch.zeros(3)})
    assert step == 5 and torch.equal(st["w"], torch.full((3,), 1.0))


def test_barrier_timeout_degrades_not_hangs(tmp_path, monkeypatch):
    from paddle_tpu_torch.parallel import checkpoint as base

    d = str(tmp_path)
    _fleet_env(monkeypatch, rank=1)
    base.save_checkpoint(d, {"w": np.ones(2, np.float32)}, step=1)
    _fleet_env(monkeypatch, rank=0)
    monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER_SECS", "10")
    base.save_checkpoint(d, {"w": np.ones(2, np.float32)}, step=1)
    assert base.latest_checkpoint(d).endswith("ckpt-1")
    monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER_SECS", "1")
    c0 = _counter("ft.barrier.timeouts")
    with pytest.raises(base.BarrierTimeout):
        base.save_checkpoint(d, {"w": np.full(2, 2.0, np.float32)}, step=2)
    assert _counter("ft.barrier.timeouts") - c0 == 1
    assert not os.path.exists(tmp_path / "ckpt-2")
    assert not any(n.startswith(".tmp-ckpt-") for n in os.listdir(d))
    assert base.latest_checkpoint(d).endswith("ckpt-1")


# -- guard: agreed-boundary exit ---------------------------------------------

class _StubExecutor:
    _step = 0

    def drain(self):
        pass


def _fleet_guard(monkeypatch, tmp_path, rank=0, world=2):
    _fleet_env(monkeypatch, rank, world)
    from paddle_tpu_torch.ft.guard import TrainGuard
    from paddle_tpu_torch.scope import Scope

    policy = ft.CheckpointPolicy(str(tmp_path), every_steps=1000,
                                 resume=False, hostps=[],
                                 save_on_preempt=False)
    g = TrainGuard(policy, _StubExecutor(), Scope())
    g.rank, g.world = rank, world
    return g


def test_fleet_wallclock_cadence_rank0_led(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PREEMPT_QUANTUM", "5")
    saved = {0: [], 1: []}
    guards = {}
    for rnk in (0, 1):
        g = _fleet_guard(monkeypatch, tmp_path, rank=rnk)
        g.policy.every_steps = None
        g.policy.every_secs = 0.0
        g._cadence_save = (lambda g=g, r=rnk: saved[r].append(g._step))
        guards[rnk] = g
    for step in range(1, 11):
        guards[0].after_step(step, None)
    assert saved[0] == [10]
    for step in range(1, 11):
        guards[1].after_step(step, None)
    assert saved[1] == [10]


def test_guard_trains_to_agreed_boundary(tmp_path, monkeypatch):
    from paddle_tpu_torch.ft import agree

    g = _fleet_guard(monkeypatch, tmp_path, rank=0)
    agree.StepAgreement(str(tmp_path), rank=1, world=2).publish(6)
    g.request_preempt()
    g.after_step(5, None)
    assert g._agreed_step == 6
    with pytest.raises(SystemExit) as e:
        g.after_step(6, None)
    assert e.value.code == PREEMPTED_RC


def test_guard_quantum_fallback_boundary(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PREEMPT_AGREE_SECS", "0.2")
    monkeypatch.setenv("PADDLE_TPU_PREEMPT_QUANTUM", "4")
    g = _fleet_guard(monkeypatch, tmp_path, rank=0)
    g.request_preempt()
    g.after_step(5, None)
    assert g._agreed_step == 8
    g.after_step(7, None)
    with pytest.raises(SystemExit) as e:
        g.after_step(8, None)
    assert e.value.code == PREEMPTED_RC


def test_guard_discovers_peer_round(tmp_path, monkeypatch):
    from paddle_tpu_torch.ft import agree

    g = _fleet_guard(monkeypatch, tmp_path, rank=0)
    assert not g.preempt_requested
    g.after_step(3, None)
    agree.StepAgreement(str(tmp_path), rank=1, world=2).publish(4)
    with pytest.raises(SystemExit) as e:
        g.after_step(4, None)
    assert e.value.code == PREEMPTED_RC
    assert g.preempt_requested


# -- elastic: save-on-N / resume-on-M ------------------------------------------

def test_restore_train_state_shrink_2_to_1(tmp_path, monkeypatch):
    """A unified checkpoint saved by TWO ranks restores on a ONE-rank fleet
    with the re-shard evidence (+ ft.ckpt.reshards)."""
    d = str(tmp_path)
    w = torch.arange(4, dtype=torch.float32)
    _fleet_env(monkeypatch, rank=1)
    fckpt.save_train_state(d, 7, scope_state={"w": w}, asynchronous=False)
    _fleet_env(monkeypatch, rank=0)
    monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER_SECS", "10")
    fckpt.save_train_state(d, 7, scope_state={"w": w}, asynchronous=False)
    assert os.path.exists(tmp_path / "ckpt-7" / "COMMIT")
    _fleet_env(monkeypatch, rank=0, world=1)
    c0 = _counter("ft.ckpt.reshards")
    rs = fckpt.restore_train_state(d, {"w": torch.zeros(4)})
    assert rs.step == 7
    assert (rs.saver_world, rs.world, rs.resharded) == (2, 1, True)
    assert _counter("ft.ckpt.reshards") - c0 == 1
    assert torch.equal(rs.scope_state["w"], w)


def test_restore_train_state_grow_1_to_2(tmp_path, monkeypatch):
    """A world-1 checkpoint resumes on a TWO-rank fleet: the grown rank has
    no saved RNG stream and keeps fresh host RNGs with a loud warning and
    counter."""
    d = str(tmp_path)
    _fleet_env(monkeypatch, rank=0, world=1)
    fckpt.save_train_state(d, 3, scope_state={"w": torch.ones(2)},
                           asynchronous=False)
    _fleet_env(monkeypatch, rank=1, world=2)
    c0 = _counter("ft.ckpt.rng_reseeded")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rs = fckpt.restore_train_state(d, {"w": torch.zeros(2)})
    assert (rs.saver_world, rs.world, rs.resharded) == (1, 2, True)
    assert any("no RNG stream for rank 1" in str(w.message) for w in caught)
    assert _counter("ft.ckpt.rng_reseeded") - c0 == 1
    assert torch.equal(rs.scope_state["w"], torch.ones(2))


def test_restore_train_state_same_world_not_resharded(tmp_path):
    d = str(tmp_path)
    fckpt.save_train_state(d, 2, scope_state={"w": torch.ones(3)},
                           asynchronous=False)
    rs = fckpt.restore_train_state(d, {"w": torch.zeros(3)})
    assert (rs.saver_world, rs.world, rs.resharded) == (1, 1, False)


def test_clear_stale_ranks_on_heartbeat_rearm(tmp_path):
    from paddle_tpu_torch.distributed.heartbeat import (WorkerHeartbeat,
                                                        clear_stale_ranks)

    d = str(tmp_path)
    for r in range(4):
        open(os.path.join(d, "hb-%d" % r), "w").write("1 0 0 0")
    open(os.path.join(d, "done-3"), "w").write("0")
    assert clear_stale_ranks(d, 2) == [2, 3]
    assert sorted(os.listdir(d)) == ["hb-0", "hb-1"]
    open(os.path.join(d, "hb-7"), "w").write("1 0 0 0")
    hb = WorkerHeartbeat(d, 0, interval=5.0, world=2).start()
    try:
        assert not os.path.exists(os.path.join(d, "hb-7"))
        assert os.path.exists(os.path.join(d, "hb-0"))
    finally:
        hb.complete()


# -- TrainLoop -----------------------------------------------------------------

def test_train_loop_sigterm_resume_bit_parity(tmp_path):
    """TrainLoop over the tiny BERT trainer: the drill SIGTERM at step 3
    exits with rc 120 after its checkpoint; a respawn with another init
    resumes and ends bit for bit on the never-stopped loop's state and
    losses."""
    from paddle_tpu_torch.tools import loop_drill

    ck = str(tmp_path / "ck")
    ref = loop_drill.run("tiny", "cpu", steps=6, checkpoint=False)
    killed = {}
    with pytest.raises(SystemExit) as e:
        loop_drill.run("tiny", "cpu", steps=6, sigterm_at=3, ckpt=ck,
                       rec=killed)
    assert e.value.code == PREEMPTED_RC
    assert killed["losses"] == {s: ref["losses"][s] for s in (1, 2, 3)}
    from paddle_tpu_torch.parallel.checkpoint import latest_checkpoint
    assert latest_checkpoint(ck).endswith("ckpt-3")
    got = loop_drill.run("tiny", "cpu", steps=6, ckpt=ck, init_seed=7)
    assert got["resumed_step"] == 3 and got["final_step"] == 6
    assert got["losses"] == {s: ref["losses"][s] for s in (4, 5, 6)}
    assert got["digests"] == ref["digests"]


def test_train_loop_feeds_the_sentinel(tmp_path):
    """TrainLoop hands its sampled loss to the sentinel's observe_loop: a
    finite loss is a health sample, a nonfinite one trips halt."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.monitor import sentinel
    from paddle_tpu_torch.parallel.train import TrainLoop

    monitor.enable(str(tmp_path / "mon"))
    try:
        sentinel.enable(policy="halt", sample_every=1)
        losses = [torch.tensor(1.5), torch.tensor(float("nan"))]
        loop = TrainLoop(lambda st, b: (st, losses[b]))
        with pytest.raises(monitor.NonFiniteError):
            loop.run({}, [0, 1])
        reg = monitor.default_registry()
        assert reg.gauge("monitor.health.loss").value == 0.0
    finally:
        monitor.disable()
    events = [json.loads(x) for x in open(tmp_path / "mon" / "timeline.jsonl")]
    assert [e["step"] for e in events if e.get("ev") == "health"] == [1, 2]


# -- the gloo world --------------------------------------------------------------

def test_program_dp_resume_bit_parity_at_world_2(world2):
    """The fleet-tagged CTR program and its kReduce form, SIGTERM'd at step 3
    on both ranks (one agreed ckpt-3) and resumed: each rank's state (its
    rows of the kReduce moments) bit for bit the never-stopped run's."""
    res = world2()["program_dp_resume"]
    for rank, rec in enumerate(res):
        for key in ("tagged", "reduce"):
            r = rec[key]
            assert r["rc"] == (PREEMPTED_RC, 0), (rank, key)
            assert r["killed_at"] == "ckpt-3"
            for n in r["ref"]:
                assert _same(r["ref"][n], r["got"][n]), (rank, key, n)
    assert any(v == 2 for v in res[0]["reduce"]["rows"].values())


def test_tp_state_saved_at_tp2_restores_at_world_1(world2, tmp_path):
    """A TrainState of a tp = 2 program (each rank's blocks of its split
    vars, ``Scope._splits``) restores through TrainGuard into a one-rank
    program's scope: every var whole, bit for bit the gathered state, with
    no split metadata (this world's layout, not the saver's)."""
    import torch_program_tp_worker as tpw
    from paddle_tpu_torch.ft.guard import TrainGuard

    res = world2()["tp_save"]
    assert res[0]["splits"] and res[0]["whole"].keys() == res[1]["whole"].keys()
    main, startup, _ = tpw.tp_program(fluid, lambda f: f.optimizer.Adam(1e-2))
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    guard = TrainGuard(ft.CheckpointPolicy(res[0]["dir"], resume=True), exe,
                       scope, program=main)
    cursor, step = guard.maybe_resume()
    assert step == 2 and cursor is None and exe._step == 2 + 1
    for n, want in res[0]["whole"].items():
        assert _same(scope.find_tensor_as_numpy(n), want), n
        assert scope.split(n) is None and scope.row_shards(n) == 1


def test_train_loop_zero_resume_bit_parity_at_world_2(world2):
    """TrainLoop over the ZeRO tiny BERT at world 2: SIGTERM at step 3 on
    both ranks, rc 120, the respawn resumes ckpt-3 and ends on the
    never-stopped run's blocks and losses, rank by rank."""
    res = world2()["loop_zero_resume"]
    for r in res:
        assert r["rc"] == PREEMPTED_RC
        ref, got = r["ref"], r["got"]
        assert r["killed"]["losses"] == {s: ref["losses"][s] for s in (1, 2, 3)}
        assert got["resumed_step"] == 3
        assert got["losses"] == {s: ref["losses"][s] for s in (4, 5, 6)}
        assert got["digests"] == ref["digests"]


# -- HostPS (tests/test_ft.py's four, and across the packages) ----------------

def _hostps_svc(name, vocab=30, dim=6, optimizer=None, cache_slots=0):
    from paddle_tpu_torch.hostps import (HostAdagrad, HostPSEmbedding,
                                         HostSparseTable)

    return HostPSEmbedding(
        HostSparseTable(vocab, dim, optimizer=optimizer
                        or HostAdagrad(epsilon=1e-6), seed=11, name=name),
        cache_slots=cache_slots, device="cpu")


@pytest.fixture
def _no_live_tables():
    from paddle_tpu_torch.hostps import service

    yield
    service._LIVE_EMBEDDINGS.clear()


def test_chaos_hostps_prefetch_surfaces_on_pull(_no_live_tables):
    svc = _hostps_svc("chaos_pf", vocab=32, dim=4)
    ids = np.array([[1, 2], [3, 4]])
    chaos.arm("hostps_prefetch", at=1)
    svc.prefetch(ids)
    with pytest.raises(chaos.ChaosError):
        svc.pull_unique(ids)
    chaos.disarm()
    rows, vals, inv = svc.pull_unique(ids)    # service healthy afterwards
    assert rows.shape[0] >= 4


def _hostps_train(svc, batches, w, lr=0.1):
    losses = []
    for ids, label in batches:
        rows, values, inv = svc.pull_unique(ids)
        values.requires_grad_()
        pred = torch.einsum("bfd,d->b", values[torch.from_numpy(inv)], w)
        loss = ((pred - torch.from_numpy(label)) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [values])
        svc.push(rows, g[: rows.shape[0]], lr)
        losses.append(float(loss.detach()))
    return losses


def test_kill_resume_bit_parity_hostps(tmp_path, _no_live_tables):
    """A pull/push training loop over a host-RAM sparse table, crashed
    mid-run and resumed through the unified TrainState checkpoint (dense
    w + sparse rows + moments + RNG), finishes bit-equal to an
    uninterrupted loop."""
    rng = np.random.RandomState(3)
    data = [(rng.randint(0, 30, (8, 3)), rng.rand(8).astype(np.float32))
            for _ in range(8)]
    w = torch.from_numpy(rng.randn(6).astype(np.float32))
    ref_svc = _hostps_svc("ft_parity_ref")
    ref_losses = _hostps_train(ref_svc, data, w)
    d = str(tmp_path)
    svc = _hostps_svc("ft_parity")
    losses_a = _hostps_train(svc, data[:5], w)
    fckpt.save_train_state(d, 5, scope_state={"w": w}, hostps=[svc],
                           asynchronous=False)
    del svc
    svc2 = _hostps_svc("ft_parity")
    rs = fckpt.restore_train_state(d, {"w": torch.zeros(6)}, hostps=[svc2])
    assert rs is not None and rs.step == 5
    assert torch.equal(rs.scope_state["w"], w)
    losses_b = _hostps_train(svc2, data[5:], w)
    assert losses_a + losses_b == ref_losses
    touched = np.unique(np.concatenate([i.ravel() for i, _ in data]))
    assert torch.equal(svc2.pull(touched, use_cache=False),
                       ref_svc.pull(touched, use_cache=False))


def test_unified_ckpt_verifies_hostps_crc(tmp_path, _no_live_tables):
    svc = _hostps_svc("crc_t", vocab=16, dim=3)
    svc.pull(np.arange(8))
    d = str(tmp_path)
    fckpt.save_train_state(d, 1, hostps=[svc], asynchronous=False)
    hp = os.path.join(d, "ckpt-1", "hostps", "p0")
    shard = next(os.path.join(hp, n) for n in os.listdir(hp)
                 if n.endswith(".npz"))
    blob = bytearray(open(shard, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(blob))
    with pytest.raises(RuntimeError, match="CRC"):
        fckpt.restore_train_state(d, {}, hostps=[svc])


def test_hostps_restore_resharded_matrix(tmp_path):
    """HostPS rows + moments across 2->1, 1->2, 2->4: saver shards written
    by the port AND by the JAX package, each loader keeping exactly its own
    row range, bit for bit against a reference table."""
    from paddle_tpu import hostps as jhostps
    from paddle_tpu_torch import hostps as phostps
    from paddle_tpu_torch.parallel.rules import hostps_row_range

    V, D = 10, 3
    rng = np.random.RandomState(5)
    ref = phostps.HostSparseTable(V, D, optimizer=phostps.HostAdagrad(1e-6),
                                  seed=7, name="el_t")
    ref.pull(np.arange(V))
    ref.push(np.arange(V), rng.randn(V, D).astype(np.float32), 0.1)
    for pkg in (phostps, jhostps):
        for n_save, n_load in ((2, 1), (1, 2), (2, 4)):
            work = tmp_path / ("%s_m%dto%d" % (pkg.__name__, n_save, n_load))
            dirs = []
            for r in range(n_save):
                lo, hi = hostps_row_range(r, n_save, V)
                t = pkg.HostSparseTable(V, D,
                                        optimizer=pkg.HostAdagrad(1e-6),
                                        seed=7, name="el_t",
                                        row_range=(lo, hi))
                t._param[lo:hi] = ref._param[lo:hi]
                t._live[lo:hi] = ref._live[lo:hi]
                for s in t._slots:
                    t._slots[s][lo:hi] = ref._slots[s][lo:hi]
                d = str(work / ("p%d" % r))
                os.makedirs(d)
                t.save(d)
                dirs.append(d)
            for r in range(n_load):
                lo, hi = hostps_row_range(r, n_load, V)
                t2 = phostps.HostSparseTable(
                    V, D, optimizer=phostps.HostAdagrad(1e-6), seed=7,
                    name="el_t", row_range=(lo, hi))
                t2.restore_resharded(dirs, "el_t")
                np.testing.assert_array_equal(t2._param[lo:hi],
                                              ref._param[lo:hi])
                np.testing.assert_array_equal(t2._live[lo:hi],
                                              ref._live[lo:hi])
                for s in t2._slots:
                    np.testing.assert_array_equal(t2._slots[s][lo:hi],
                                                  ref._slots[s][lo:hi])
                outside = np.ones(V, bool)
                outside[lo:hi] = False
                assert not t2._live[outside].any()
                assert not t2._param[outside].any()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hostps_train_state_crosses_packages(tmp_path, writer,
                                             _no_live_tables):
    """A TrainState with a HostPS table written by one package restores in
    the other: the dense leaf, the step, and the table's rows and moment
    slots bit for bit."""
    from paddle_tpu import hostps as jhostps
    from paddle_tpu.ft import ckpt as jckpt
    from paddle_tpu.hostps import service as jservice

    rng = np.random.RandomState(9)
    ids = rng.randint(0, 30, 12)
    g = rng.randn(12, 6).astype(np.float32)
    w = rng.randn(5).astype(np.float32)
    jsvc = jhostps.HostPSEmbedding(jhostps.HostSparseTable(
        30, 6, optimizer=jhostps.HostAdagrad(epsilon=1e-6), seed=11,
        name="x_t"))
    psvc = _hostps_svc("x_t")
    d = str(tmp_path)
    try:
        if writer == "jax":
            jsvc.pull(ids)
            jsvc.push(ids, g, 0.1)
            jckpt.save_train_state(d, 3, scope_state={"w": w},
                                   hostps=[jsvc], asynchronous=False)
            rs = fckpt.restore_train_state(d, {"w": torch.zeros(5)},
                                           hostps=[psvc])
            assert np.array_equal(rs.scope_state["w"].numpy(), w)
        else:
            psvc.pull(ids)
            psvc.push(ids, g, 0.1)
            fckpt.save_train_state(d, 3, scope_state={"w": torch.from_numpy(
                w)}, hostps=[psvc], asynchronous=False)
            rs = jckpt.restore_train_state(d, {"w": np.zeros(5, np.float32)},
                                           hostps=[jsvc])
            assert np.array_equal(np.asarray(rs.scope_state["w"]), w)
        assert rs.step == 3
        pr, pa, pm = psvc.table.snapshot()
        jr, ja, jm = jsvc.table.snapshot()
        np.testing.assert_array_equal(pr, jr)
        assert pm == jm
        for k in pa:
            np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
    finally:
        jservice._LIVE_EMBEDDINGS.clear()


def test_train_loop_hostps_sigterm_resume_bit_parity(tmp_path,
                                                     _no_live_tables):
    """``TrainLoop`` over DeepFM on a host table
    (``tools/deepfm_hostps.run_loop``, saves every 2 steps with
    ``hostps=[emb]``): the drill SIGTERM at step 3 exits rc 120; a fresh
    process's table and head resume and end bit for bit on the
    never-stopped run's losses, head and touched rows."""
    from paddle_tpu_torch.tools import deepfm_hostps as dh

    vocab, B, F, D, mlp, lr, steps = 3000, 16, 5, 4, (8,), 0.05, 6
    rng = np.random.RandomState(2)
    batches = []
    for _ in range(steps):
        ids = dh.zipf_ids(rng, B, F, vocab)
        batches.append((ids, dh.labels(ids)))

    def fresh(seed):
        gen = torch.Generator().manual_seed(seed)
        return (dh.make_embedding(vocab, D, 32, device="cpu"),
                dh.init_dense(gen, F, D, mlp, "cpu"))

    emb, dense = fresh(0)
    ref_dense, ref_losses, _ = dh.run_loop(emb, dense, batches, lr)
    ref_rows = emb.table.snapshot()
    from paddle_tpu_torch.hostps import service
    service._LIVE_EMBEDDINGS.clear()

    ck = str(tmp_path / "ck")
    emb, dense = fresh(0)
    killed = {}
    with pytest.raises(SystemExit) as e:
        dh.run_loop(emb, dense, batches, lr, ckpt=ck, sigterm_at=3,
                    losses=killed)
    assert e.value.code == PREEMPTED_RC
    assert killed == {s: ref_losses[s] for s in (1, 2, 3)}
    service._LIVE_EMBEDDINGS.clear()
    emb, dense = fresh(5)                       # another init: restored
    got_dense, got_losses, resumed = dh.run_loop(emb, dense, batches, lr,
                                                 ckpt=ck)
    assert resumed == 3
    assert got_losses == {s: ref_losses[s] for s in (4, 5, 6)}
    for a, b in zip(_flat(got_dense), _flat(ref_dense)):
        assert torch.equal(a, b)
    got_rows = emb.table.snapshot()
    np.testing.assert_array_equal(got_rows[0], ref_rows[0])
    for k in ref_rows[1]:
        np.testing.assert_array_equal(got_rows[1][k], ref_rows[1][k])


def _flat(dense):
    return [l[k] for l in dense["mlp"] for k in ("w", "b")] + [dense["bias"]]
