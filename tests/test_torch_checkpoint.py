"""The port's sharded, topology-portable checkpoint
(``paddle_tpu_torch/parallel/checkpoint.py``) against the JAX package's
``tests/test_checkpoint.py`` contract, and across the two packages.

The JAX package's 17 tests, ported: the sharded ones run in gloo worlds of
2 and 4 (``tests/torch_ckpt_worker.py``, each started once for the module,
beside the single-process tests), the fleet-GC and barrier ones set
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` as the reference's do.
Across the packages, bit for bit: a state the JAX package's
``save_checkpoint`` writes (f32, int32, int64 and bf16 leaves, one sharded
over the conftest's 8 CPU devices) restores in the port at worlds 1 and 2,
and a checkpoint the port writes at world 2 restores in the JAX package's
``restore_checkpoint``.  Also a bf16 round trip, a ZeRO state saved at
world 2 and restored at worlds 1 and 2, and the async save's snapshot.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.parallel import checkpoint as base
from paddle_tpu_torch.parallel.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)

import torch_ckpt_worker
import torch_dp_worker

WORLD_SCENARIOS = {2: ["zero_resume", "cross_package"],
                   4: ["zero_resume", "authority_restore"]}


def _batch(rng, b, s, vocab):
    return {"ids": rng.randint(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.randint(0, vocab, (b, s)).astype(np.int32),
            "mask": np.ones((b, s), np.float32)}


def _jax_ckpt(d):
    """A JAX package checkpoint: a [16, 3] f32 leaf sharded over the 8 CPU
    devices, a bf16, an int32 and an int64 leaf."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

    from paddle_tpu.parallel import checkpoint as jck

    rng = np.random.RandomState(21)
    vals = {"rows": rng.randn(16, 3).astype(np.float32),
            "half": rng.randn(4, 2).astype(np.float32),
            "i32": rng.randint(-9, 9, 5).astype(np.int32),
            "i64": np.int64(2 ** 40 + 3)}
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    state = {"rows": jax.device_put(vals["rows"],
                                    NamedSharding(mesh, JP("dp", None))),
             "half": jnp.asarray(vals["half"], jnp.bfloat16),
             "i32": jnp.asarray(vals["i32"]),
             "i64": vals["i64"]}
    jck.save_checkpoint(d, state, step=6)
    half_bits = np.asarray(state["half"]).view(np.int16)
    return jck.latest_checkpoint(d), vals, half_bits


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Gloo worlds of 2 and 4, started once; each test joins what it needs."""
    tmp = tmp_path_factory.mktemp("ckpt_worlds")
    rng = np.random.RandomState(3)
    inputs = {"dir": str(tmp / "shared"),
              "batch": _batch(rng, 8, 32, 128)}
    os.makedirs(inputs["dir"])
    inputs["jax_ckpt"], jvals, jhalf = _jax_ckpt(str(tmp / "jax"))
    inputs["port_state"] = {"w": rng.randn(8, 3).astype(np.float32),
                            "ids": rng.randint(0, 99, 6).astype(np.int32),
                            "count": 12345678901}
    leaves = {"embed": rng.randn(16, 4).astype(np.float32),
              "bias": rng.randn(1).astype(np.float32)}
    inputs["manual_fleet"] = str(tmp / "manual")
    os.makedirs(inputs["manual_fleet"])
    _write_manual_fleet_ckpt(inputs["manual_fleet"], 3, 2, leaves)
    started = {}
    for world, scen in WORLD_SCENARIOS.items():
        sub = tmp / ("w%d" % world)
        sub.mkdir()
        started[world] = (torch_dp_worker.spawn_world(
            sub, world, inputs, scen, script=torch_ckpt_worker.__file__),
            scen)
    joined = {}

    def get(world):
        if world not in joined:
            (out, procs), scen = started[world]
            joined[world] = torch_dp_worker.join_world(out, procs, scen)
        return joined[world]

    yield {"get": get, "inputs": inputs, "jax_vals": jvals,
           "jax_half": jhalf, "manual": leaves}
    for world, ((_, procs), _) in started.items():
        for p in procs:
            if p.poll() is None:
                p.kill()


def _fleet_env(monkeypatch, rank, world=2):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(world))
    monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_process(monkeypatch):
    """Outside the fleet tests, this process is a world of one."""
    for k in ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID",
              "PADDLE_RESTART_ATTEMPT", "PADDLE_TPU_CKPT_BARRIER_SECS"):
        monkeypatch.delenv(k, raising=False)


def _tiny_trainer(seed=0):
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import optim

    return bert.build_bert_trainer(bert.bert_tiny_config(),
                                   optimizer=optim.adam(), seed=seed,
                                   device="cpu")


def _leaves(tree):
    from paddle_tpu_torch._tree import tree_leaves

    return tree_leaves(tree)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


# -- the JAX package's tests, ported ------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_resume_parity_sharded_zero_state(worlds, world):
    """Save at step 2 of ZeRO training (the Adam moments genuinely split
    over dp), restore into a FRESH trainer (another init), and the next 3
    losses match a never-interrupted run exactly; each rank's restored
    blocks are the saved ones."""
    res = worlds["get"](world)["zero_resume"]
    for r in res:
        assert r["step"] == 2 and r["path"].endswith("ckpt-2")
        assert r["got"] == r["ref"]
        for a, b in zip(_leaves(r["saved"]), _leaves(r["restored"])):
            assert _same(a, b)


def test_restored_leaves_keep_shardings(worlds):
    """At dp = 4 the restored token-embedding moment is each rank's quarter
    of the rows, and the shard files hold it ONCE (not 4 replicas)."""
    res = worlds["get"](4)["zero_resume"]
    vocab = 128
    assert [r["local_moment_rows"] for r in res] == [vocab // 4] * 4
    assert sum(r["moment_rows"] for r in res) == vocab


def test_async_checkpoint_identical(tmp_path):
    rng = np.random.RandomState(5)
    tr = _tiny_trainer()
    batch = {k: torch.from_numpy(v) for k, v in _batch(rng, 8, 32, 128).items()}
    tr.step(batch, 1e-3)
    w = save_checkpoint(str(tmp_path / "a"), tr.state, step=7,
                        asynchronous=True)
    save_checkpoint(str(tmp_path / "b"), tr.state, step=7)
    w.wait()
    sa, _ = restore_checkpoint(latest_checkpoint(str(tmp_path / "a")), tr.state)
    sb, _ = restore_checkpoint(latest_checkpoint(str(tmp_path / "b")), tr.state)
    for a, b, c in zip(_leaves(sa), _leaves(sb), _leaves(tr.state)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_latest_checkpoint_picks_highest_committed(tmp_path):
    tr = _tiny_trainer()
    save_checkpoint(str(tmp_path), tr.state, step=1)
    save_checkpoint(str(tmp_path), tr.state, step=10)
    (tmp_path / "ckpt-99").mkdir()          # uncommitted: ignored
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt-10")


def test_crc_corruption_detected(tmp_path):
    state = {"w": np.arange(12, dtype=np.float32).reshape(3, 4)}
    save_checkpoint(str(tmp_path), state, step=1)
    ck = latest_checkpoint(str(tmp_path))
    shard = ck + "/shards-p0.npz"
    blob = bytearray(open(shard, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(blob))
    with pytest.raises(RuntimeError, match="CRC mismatch"):
        restore_checkpoint(ck, {"w": np.zeros((3, 4), np.float32)})


def test_uncommitted_corpse_gc_on_next_save(tmp_path):
    state = {"w": np.ones(4, np.float32)}
    save_checkpoint(str(tmp_path), state, step=1)
    corpse = tmp_path / "ckpt-2"
    corpse.mkdir()
    (corpse / "shards-p0.npz").write_bytes(b"torn")
    stale = tmp_path / ".tmp-ckpt-2-p0"
    stale.mkdir()
    (stale / "junk").write_text("x")
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt-1")
    save_checkpoint(str(tmp_path), state, step=3)
    assert not corpse.exists() and not stale.exists()
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt-3")


def test_retention_keeps_last_n_committed(tmp_path):
    state = {"w": torch.ones(2)}
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), state, step=s, keep=2)
    names = sorted(n for n in os.listdir(str(tmp_path))
                   if n.startswith("ckpt-"))
    assert names == ["ckpt-3", "ckpt-4"]
    _, step = restore_checkpoint(latest_checkpoint(str(tmp_path)),
                                 {"w": torch.zeros(2)})
    assert step == 4


def test_fleet_gc_spares_peer_inflight(tmp_path, monkeypatch):
    peer_stage = tmp_path / ".tmp-ckpt-7-p1"
    peer_stage.mkdir()
    (peer_stage / "part").write_text("inflight")
    peer_dir = tmp_path / "ckpt-7"
    peer_dir.mkdir()
    (peer_dir / "index-p1.json").write_text("{}")
    _fleet_env(monkeypatch, rank=0)
    monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER_SECS", "1")
    with pytest.raises(base.BarrierTimeout):
        base.save_checkpoint(str(tmp_path), {"w": np.ones(2, np.float32)},
                             step=8)
    assert peer_stage.exists() and peer_dir.exists()


def test_fleet_gc_reclaims_aged_corpse(tmp_path, monkeypatch):
    corpse = tmp_path / "ckpt-3"
    corpse.mkdir()
    (corpse / "index-p1.json").write_text("{}")
    old = time.time() - 3600
    os.utime(str(corpse), (old, old))
    _fleet_env(monkeypatch, rank=0)
    monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER_SECS", "1")
    with pytest.raises(base.BarrierTimeout):
        base.save_checkpoint(str(tmp_path), {"w": np.ones(2, np.float32)},
                             step=8)
    assert not corpse.exists()


def test_retention_and_gc_rank0_only(tmp_path, monkeypatch):
    state = {"w": np.ones(2, np.float32)}
    for s in (1, 2, 3):
        save_checkpoint(str(tmp_path), state, step=s)
    corpse = tmp_path / "ckpt-9"
    corpse.mkdir()
    old = time.time() - 3600
    os.utime(str(corpse), (old, old))
    _fleet_env(monkeypatch, rank=1)
    base.save_checkpoint(str(tmp_path), state, step=10, keep=1)
    assert os.path.exists(tmp_path / "ckpt-10" / "index-p1.json")
    assert not os.path.exists(tmp_path / "ckpt-10" / "COMMIT")
    assert corpse.exists()
    for s in (1, 2, 3):
        assert os.path.exists(tmp_path / ("ckpt-%d" % s) / "COMMIT")


def test_restore_closes_npz_handles(tmp_path):
    save_checkpoint(str(tmp_path), {"w": torch.ones(3)}, step=1)
    restore_checkpoint(latest_checkpoint(str(tmp_path)),
                       {"w": torch.zeros(3)})
    fd_dir = "/proc/self/fd"
    targets = set()
    for fd in os.listdir(fd_dir):
        try:
            targets.add(os.readlink(os.path.join(fd_dir, fd)))
        except OSError:
            pass
    assert not any(t.endswith("shards-p0.npz") for t in targets)


def _write_manual_fleet_ckpt(d, step, world, leaves, partition_dim=0):
    """A committed ckpt-<step> laid down the way an N-process fleet does:
    each rank's shards-pK.npz holds only ITS row slice of every
    partitioned leaf, its index-pK.json the global shape + absolute
    slices (the documented on-disk format)."""
    from paddle_tpu_torch.parallel import rules

    ckdir = os.path.join(d, "ckpt-%d" % step)
    os.makedirs(ckdir, exist_ok=True)
    for rank in range(world):
        index = {"step": int(step), "process": rank,
                 "process_count": world, "layout": 2, "leaves": {}}
        payload = {}
        for path, arr in leaves.items():
            arr = np.asarray(arr)
            index["leaves"][path] = {"shape": list(arr.shape),
                                     "dtype": str(arr.dtype), "shards": []}
            sl = [[0, s] for s in arr.shape]
            part = arr
            if arr.ndim and arr.size > 1:
                lo, hi = rules.hostps_row_range(rank, world,
                                                arr.shape[partition_dim])
                sl[partition_dim] = [lo, hi]
                part = arr[lo:hi]
            key = "%s@0" % path
            payload[key] = part
            index["leaves"][path]["shards"].append({"key": key, "slices": sl})
        shards = "shards-p%d.npz" % rank
        with open(os.path.join(ckdir, shards), "wb") as f:
            np.savez(f, **payload)
        index["files"] = {shards: base._crc32_file(
            os.path.join(ckdir, shards))}
        index["index_crc"] = base._index_crc(index)
        with open(os.path.join(ckdir, "index-p%d.json" % rank), "w") as f:
            json.dump(index, f)
    with open(os.path.join(ckdir, "COMMIT"), "w") as f:
        f.write(str(step))
    return ckdir


def test_reshard_reassembles_any_saver_topology(tmp_path):
    rng = np.random.RandomState(9)
    leaves = {"w": rng.randn(10, 3).astype(np.float32),
              "opt/m": rng.randn(10, 3).astype(np.float32),
              "step_scale": np.float32(0.125)}
    for world in (1, 2, 4):
        d = str(tmp_path / ("saved-on-%d" % world))
        os.makedirs(d)
        _write_manual_fleet_ckpt(d, 5, world, leaves)
        target = {"w": torch.zeros(10, 3), "opt": {"m": np.zeros(
            (10, 3), np.float32)}, "step_scale": np.float32(0)}
        st, step = restore_checkpoint(latest_checkpoint(d), target)
        assert step == 5
        assert _same(st["w"].numpy(), leaves["w"])
        assert _same(st["opt"]["m"], leaves["opt/m"])
        assert _same(st["step_scale"], leaves["step_scale"])


def test_reshard_restores_onto_authority_placement(worlds):
    """A two-saver checkpoint restores row-sharded over dp = 4 through a
    ShardingAuthority: each rank its 16 / 4 rows, the bias whole."""
    res = worlds["get"](4)["authority_restore"]
    embed, bias = worlds["manual"]["embed"], worlds["manual"]["bias"]
    for r, rec in enumerate(res):
        assert rec["step"] == 3
        assert _same(rec["embed"], embed[4 * r:4 * (r + 1)])
        assert _same(rec["bias"], bias)


def test_corrupt_layout_manifest_rejected(tmp_path):
    save_checkpoint(str(tmp_path),
                    {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
                    step=1)
    ck = latest_checkpoint(str(tmp_path))
    idx_path = os.path.join(ck, "index-p0.json")
    with open(idx_path) as f:
        idx = json.load(f)
    idx["leaves"]["w"]["shards"][0]["slices"][0][0] = 1
    with open(idx_path, "w") as f:
        json.dump(idx, f)
    with pytest.raises(RuntimeError, match="layout manifest"):
        restore_checkpoint(ck, {"w": np.zeros((2, 3), np.float32)})


def test_checkpoint_topology_reports_saver_world(tmp_path, monkeypatch):
    state = {"w": np.ones(3, np.float32)}
    _fleet_env(monkeypatch, rank=1)
    base.save_checkpoint(str(tmp_path), state, step=4)
    _fleet_env(monkeypatch, rank=0)
    monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER_SECS", "10")
    base.save_checkpoint(str(tmp_path), state, step=4)
    topo = base.checkpoint_topology(str(tmp_path / "ckpt-4"))
    assert topo == {"world": 2, "ranks": [0, 1], "step": 4, "layout": 2}


def test_barrier_timeout_names_missing_ranks_and_world(tmp_path,
                                                       monkeypatch):
    state = {"w": np.ones(2, np.float32)}
    _fleet_env(monkeypatch, rank=0, world=4)
    monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER_SECS", "2")

    def plant_stale():
        time.sleep(0.5)
        stale = {"step": 6, "process": 1, "process_count": 3,
                 "layout": 2, "leaves": {}, "files": {}}
        stale["index_crc"] = base._index_crc(stale)
        with open(tmp_path / "ckpt-6" / "index-p1.json", "w") as f:
            json.dump(stale, f)

    t = threading.Thread(target=plant_stale)
    t.start()
    with pytest.raises(base.BarrierTimeout) as ei:
        base.save_checkpoint(str(tmp_path), state, step=6)
    t.join()
    msg = str(ei.value)
    assert "expected world size 4" in msg
    assert "MISSING ranks [1, 2, 3]" in msg
    assert "TOPOLOGY SKEW" in msg and "1: 3" in msg


def test_save_purges_stale_topology_indexes(tmp_path, monkeypatch):
    state = {"w": np.arange(3, dtype=np.float32)}
    _fleet_env(monkeypatch, rank=1, world=2)
    base.save_checkpoint(str(tmp_path), state, step=5)
    assert os.path.exists(tmp_path / "ckpt-5" / "index-p1.json")
    assert not os.path.exists(tmp_path / "ckpt-5" / "COMMIT")
    hp1 = tmp_path / "ckpt-5" / "hostps" / "p1"
    os.makedirs(str(hp1))
    (hp1 / "t.sparse.meta").write_bytes(b"stale")
    _fleet_env(monkeypatch, rank=0, world=1)
    base.save_checkpoint(str(tmp_path), state, step=5)
    assert os.path.exists(tmp_path / "ckpt-5" / "COMMIT")
    assert not os.path.exists(tmp_path / "ckpt-5" / "index-p1.json")
    assert not os.path.exists(tmp_path / "ckpt-5" / "shards-p1.npz")
    assert not hp1.exists()
    st, step = restore_checkpoint(latest_checkpoint(str(tmp_path)),
                                  {"w": np.zeros(3, np.float32)})
    assert step == 5 and _same(st["w"], state["w"])


# -- across the packages ---------------------------------------------------------

def test_jax_checkpoint_restores_in_the_port_at_world_1(worlds):
    vals, half = worlds["jax_vals"], worlds["jax_half"]
    target = {"rows": torch.zeros(16, 3),
              "half": torch.zeros(4, 2, dtype=torch.bfloat16),
              "i32": torch.zeros(5, dtype=torch.int32), "i64": np.int64(0)}
    st, step = restore_checkpoint(worlds["inputs"]["jax_ckpt"], target)
    assert step == 6
    assert _same(st["rows"].numpy(), vals["rows"])
    assert st["half"].dtype == torch.bfloat16
    assert _same(st["half"].view(torch.int16).numpy(), half)
    assert _same(st["i32"].numpy(), vals["i32"])
    assert _same(st["i64"], np.int64(vals["i64"]))
    # a numpy target: the bf16 leaf as a CPU bfloat16 tensor, numpy having
    # none
    st2, _ = restore_checkpoint(worlds["inputs"]["jax_ckpt"], {
        "rows": np.zeros((16, 3), np.float32), "half": np.zeros((4, 2)),
        "i32": np.zeros(5, np.int32), "i64": np.int64(0)})
    assert _same(st2["half"].view(torch.int16).numpy(), half)


def test_jax_checkpoint_restores_in_the_port_at_world_2(worlds):
    vals, half = worlds["jax_vals"], worlds["jax_half"]
    res = worlds["get"](2)["cross_package"]
    for r, rec in enumerate(res):
        assert rec["step"] == 6
        assert _same(rec["rows"], vals["rows"][8 * r:8 * (r + 1)])
        assert _same(rec["half"], half)
        assert _same(rec["i32"], vals["i32"])
        assert _same(rec["i64"], np.int64(vals["i64"]))


def test_port_checkpoint_restores_in_jax(worlds):
    from paddle_tpu.parallel import checkpoint as jck

    mine = worlds["inputs"]["port_state"]
    path = worlds["get"](2)["cross_package"][0]["port_ckpt"]
    st, step = jck.restore_checkpoint(path, {
        "w": np.zeros((8, 3), np.float32), "ids": np.zeros(6, np.int32),
        "count": np.int64(0)})
    assert step == 9
    assert _same(st["w"], mine["w"])
    assert _same(st["ids"], mine["ids"])
    assert _same(st["count"], np.int64(mine["count"]))
    assert jck.checkpoint_topology(path)["world"] == 2


def test_bf16_round_trip_bit_for_bit(tmp_path):
    bits = torch.from_numpy(np.random.RandomState(4).randint(
        -32768, 32767, (5, 7)).astype(np.int16))
    bits[0, :4] = torch.tensor([0x7FC0, -128, 0x7F80, 1], dtype=torch.int16)
    state = {"p": bits.view(torch.bfloat16), "f": torch.randn(3)}
    save_checkpoint(str(tmp_path), state, step=1)
    with open(os.path.join(latest_checkpoint(str(tmp_path)),
                           "index-p0.json")) as f:
        assert json.load(f)["leaves"]["p"]["dtype"] == "bfloat16"
    st, _ = restore_checkpoint(latest_checkpoint(str(tmp_path)), {
        "p": torch.zeros(5, 7, dtype=torch.bfloat16), "f": torch.zeros(3)})
    assert st["p"].dtype == torch.bfloat16
    assert torch.equal(st["p"].view(torch.int16), bits)
    assert torch.equal(st["f"], state["f"])


def test_zero_state_saved_at_world_2_restores_gathered_at_world_1(worlds):
    """The world-2 ZeRO checkpoint restores into a one-rank trainer's state:
    every leaf is the two ranks' state gathered, bit for bit."""
    res = worlds["get"](2)["zero_resume"]
    tr = _tiny_trainer(seed=5)
    st, step = restore_checkpoint(res[0]["path"], tr.state)
    assert step == 2
    got, want = _leaves(st), _leaves(res[0]["gathered"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _same(a.numpy(), b)


def test_async_snapshot_is_taken_at_the_call(tmp_path):
    """The live state is updated in place right after an async save returns;
    the checkpoint holds the values at the call."""
    state = {"w": torch.arange(1000, dtype=torch.float32),
             "n": np.arange(4)}
    want = {"w": state["w"].clone(), "n": state["n"].copy()}
    gate = threading.Event()
    real = np.savez

    def slow_savez(*a, **kw):
        gate.wait(10)               # the file write starts after the update
        return real(*a, **kw)

    base.np.savez = slow_savez
    try:
        w = save_checkpoint(str(tmp_path), state, step=1, asynchronous=True)
        state["w"].mul_(-1)
        state["n"][:] = 7
        gate.set()
        w.wait()
    finally:
        base.np.savez = real
    st, _ = restore_checkpoint(latest_checkpoint(str(tmp_path)),
                               {"w": torch.zeros(1000),
                                "n": np.zeros(4, np.int64)})
    assert torch.equal(st["w"], want["w"]) and _same(st["n"], want["n"])
