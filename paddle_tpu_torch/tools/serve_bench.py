"""serve_bench: the ServeLoop receipts — static against continuous batching
(the port's counterpart of the main leg of ``scripts/serve_bench.py``).

Drives a mixed-size request trace (mostly 1-4 row CTR scoring requests,
every 5th one four times the largest bucket — the head-of-line-blocking
shape production traffic has) through the serving engine in BOTH modes
over one exported artifact:

- ``static``: one request at a time, run to completion;
- ``continuous``: per-step admit/evict on the pre-captured bucket lattice.

Both modes serve sparse CTR lookups through a READ-ONLY HostPS embedding
(HotRowCache in front, zero table writes) and capture every lattice point
at start, with the strict RecompileDetector armed.

Two configurations:

- ``--smoke``: the reference's smoke model (dense ``x`` [12] and the
  looked-up ``emb`` [16] -> fc(16, relu) -> score), lattice [2, 4, 8],
  30 requests, a 512 x 4 table, 64 cache slots;
- the full one: the DeepFM of ``tools/deepfm_hostps.BENCH`` (39 fields,
  D = 10, MLP 400-400, the logit) served from a 200,000,000 x 11 host
  table (embedding and first-order weight in one row) with 2**18 cache
  slots, lattice [4, 8, 16, 32, 64], 150 requests, each row 39 zipf ids.
  Its artifact (``build_deepfm_artifact``) has one feed, ``emb``
  [B, 39 * 11], and computes ``models/deepfm._deepfm_head`` op for op;
  ``deepfm_params`` carries a ``deepfm_hostps.init_dense`` tree into its
  parameter names.

Gates (``--check``):

  1. correctness: every large request and at least 12 others, of every
     size class, against ``create_predictor(AnalysisConfig(dir)).run`` on
     the same rows at the request's own shape: both within the bound
     ``tools/fp_bounds.BoundMode`` derives from the program's own ops in
     float64 (``program_bounds``), so within twice it of each other;
  2. zero recompiles and zero new captured signatures in both modes, and
     every lattice point captured;
  3. the read-only lookup never wrote the table (rows_initialized
     unchanged).

The reference's gates 4-5 compare wall-clock p99 and QPS between the
modes.  Here the anti-head-of-line property is held in dispatch steps
(``head_of_line``): in continuous mode a request of r rows, once a step
has taken its first rows, completes within ceil(r / max(1, B // n))
steps, n the largest in-flight count over those steps and B the largest
bucket (the fair allocation gives every in-flight request floor(B / n)
rows a step, and at least one to each request ahead of the B-th); in
static mode a request behind a large one waits every step of it.  p50,
p99 and QPS are printed, not gated.

``--profile-lookups`` serves no request: it times the trace's lookups as
static mode takes them (each request alone, in chunks of the largest
bucket) through a cold cache under ``cProfile``, then warm, after one
read of the rows (the table's first-touch faults paid apart).

``--fleet`` (the counterpart of the reference's ``fleet_leg``): the same
model served by 1 and then 3 ``ServeEngine`` replica processes
(``serving.FleetManager``) behind one ``FleetRouter``, the sparse rows
pulled read-only from one ShardPS owner process (``--ctr-owner``) through
each replica's ``FleetCTRView``.  Closed-loop clients (offered load rises
only as the fleet absorbs it, so QPS is capacity) drive each leg; QPS, p50
and p99 at 1 and 3 replicas and their ratio are printed, not gated: the
replicas share one card (or this host's cores), so the reference's "0.8x
linear" is no derived bound here.  Gated (``--check``): zero drops, every
replica's lattice captured by itself (no warm store: ``compiled`` for
every point) with zero recompiles and zero new signatures, a rolling swap
to a second weight set (then served and held to the predictor on those
weights), the owner's table never written (``rows_initialized`` 0), the
autoscale signal up under the clients and down (a real retire) when idle,
and sampled results held as gate 1 holds them.  ``--smoke`` uses the
smoke model and a 512-row table; the full one the DeepFM on the
200,000,000-row table, the phase-58 trace cycled by the clients.

Usage (the card unless ``--device cpu``):
    python -m paddle_tpu_torch.tools.serve_bench --smoke --check [--device cpu]
    python -m paddle_tpu_torch.tools.serve_bench --check
    python -m paddle_tpu_torch.tools.serve_bench --profile-lookups
    python -m paddle_tpu_torch.tools.serve_bench --fleet [--smoke] --check
"""

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

__all__ = ["SMOKE", "FULL", "build_program", "build_artifact",
           "build_deepfm_program", "build_deepfm_artifact", "deepfm_params",
           "write_params", "export", "request_trace", "deepfm_trace",
           "deepfm_head_bounds",
           "make_lookup", "make_deepfm_lookup", "run_mode", "program_bounds",
           "verify_sample", "head_of_line", "owner_table", "start_owner",
           "stop_owner", "fleet_drive", "fleet_leg", "main"]

SMOKE = dict(lattice=[2, 4, 8], requests=30, vocab=512, dim=4,
             cache_slots=64)
FULL = dict(lattice=[4, 8, 16, 32, 64], requests=150, vocab=200_000_000,
            fields=39, dim=10, mlp=(400, 400), cache_slots=1 << 18)
SMOKE_FEED_SPEC = {"x": ((12,), "float32"), "emb": ((16,), "float32")}
TABLE_NAME = "serve_ctr"

_OUT_LINES = []


def say(line):
    print(line)
    sys.stdout.flush()
    _OUT_LINES.append(line)


def _is_port(fluid):
    return fluid.__name__.split(".")[0] == "paddle_tpu_torch"


# ------------------------------------------------------------- artifacts --

def build_program(fluid):
    """The smoke model: dense x[12] + looked-up emb[16] -> fc(16, relu) ->
    score[1], with its MSE loss and SGD."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        xv = fluid.layers.data("x", shape=[12], dtype="float32")
        ev = fluid.layers.data("emb", shape=[16], dtype="float32")
        yv = fluid.layers.data("y", shape=[1], dtype="float32")
        cat = fluid.layers.concat([xv, ev], axis=1)
        h = fluid.layers.fc(cat, size=16, act="relu")
        pred = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, yv))
        fluid.optimizer.SGD(0.05).minimize(loss)
    return main, startup, pred, loss


def export(fluid, dirname, feed_shapes, device=None):
    """``fluid``'s ``export_inference_model`` with a symbolic batch dim, so
    that ONE artifact serves every lattice bucket (the port's on
    ``device``)."""
    if _is_port(fluid):
        return fluid.inference.export_inference_model(
            dirname, feed_shapes, poly_batch=True, device=device)
    return fluid.inference.export_inference_model(
        dirname, feed_shapes=feed_shapes, poly_batch=True)


def build_artifact(fluid, workdir, rng, exported=True, device=None):
    """Train the smoke model a little on the CPU, save it with ``fluid``'s
    ``save_inference_model`` and (``exported``) export it."""
    main, startup, pred, loss = build_program(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    for _ in range(3):
        exe.run(main, feed={"x": rng.rand(32, 12).astype("f4"),
                            "emb": rng.rand(32, 16).astype("f4"),
                            "y": rng.rand(32, 1).astype("f4")},
                fetch_list=[loss])
    fluid.io.save_inference_model(workdir, ["x", "emb"], [pred], exe,
                                  main_program=main)
    if exported:
        export(fluid, workdir, {"x": (4, 12), "emb": (4, 16)}, device)
    return workdir


def _pname(i, kind):
    return "deepfm_mlp_%d.%s" % (i, kind)


def build_deepfm_program(fluid, fields, dim, mlp):
    """The serving DeepFM: feed ``emb`` [B, fields * (dim + 1)] (each
    field's embedding then its first-order weight, a host-table row) ->
    the logit [B], computing ``models/deepfm._deepfm_head`` op for op: FM
    second order 0.5 * sum((sum v)^2 - sum v^2), the ReLU MLP and its
    logit layer, plus the first-order sum and the bias."""
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        emb = L.data("emb", shape=[fields * (dim + 1)], dtype="float32")
        v = L.reshape(emb, [-1, fields, dim + 1])
        e, first = L.split(v, [dim, 1], dim=2)
        s = L.reduce_sum(e, dim=1)                                 # [B, D]
        sq = L.reduce_sum(L.elementwise_mul(e, e), dim=1)          # [B, D]
        fm = L.scale(L.reduce_sum(
            L.elementwise_sub(L.elementwise_mul(s, s), sq), dim=1), 0.5)
        x = L.reshape(e, [-1, fields * dim])
        widths = tuple(mlp) + (1,)
        for i, width in enumerate(widths):
            x = L.fc(x, width, act="relu" if i < len(mlp) else None,
                     param_attr=fluid.ParamAttr(name=_pname(i, "w")),
                     bias_attr=fluid.ParamAttr(name=_pname(i, "b")))
        deep = L.reshape(x, [-1])
        lin = L.reduce_sum(L.reshape(first, [-1, fields]), dim=1)
        bias = L.create_parameter(
            [1], "float32", attr=fluid.ParamAttr(name="deepfm_bias"),
            default_initializer=fluid.initializer.Constant(0.0))
        logit = L.elementwise_add(
            L.elementwise_add(L.elementwise_add(lin, fm), deep), bias)
    return main, startup, emb, logit


def deepfm_params(dense):
    """A ``deepfm_hostps.init_dense`` tree (tensors or arrays) as
    ``{parameter name: f32 array}`` of ``build_deepfm_program``'s names —
    what the artifact's weight file holds and what the online leg
    publishes."""
    def host(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        return np.ascontiguousarray(np.asarray(t, np.float32))

    out = {}
    for i, layer in enumerate(dense["mlp"]):
        out[_pname(i, "w")] = host(layer["w"])
        out[_pname(i, "b")] = host(layer["b"])
    out["deepfm_bias"] = host(dense["bias"])
    return out


def write_params(dirname, params):
    """Put ``params`` into the saved model's weight file
    (``__params__.npz``, either package's format): the same names, shapes
    and dtypes as what ``save_inference_model`` wrote, or ValueError."""
    path = os.path.join(dirname, "__params__.npz")
    with np.load(path) as z:
        saved = {k: (z[k].shape, z[k].dtype) for k in z.files}
    got = {k: (np.shape(v), np.asarray(v).dtype) for k, v in params.items()}
    if saved != got:
        raise ValueError("write_params: the model saves %s but the "
                         "parameters are %s" % (saved, got))
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def build_deepfm_artifact(fluid, dirname, params, fields, dim, mlp,
                          exported=True, device=None):
    """Save the serving DeepFM with ``fluid``'s ``save_inference_model``,
    its weights ``params`` (``deepfm_params``), and (``exported``) export
    it with a symbolic batch dim."""
    main, startup, emb, logit = build_deepfm_program(fluid, fields, dim, mlp)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    fluid.io.save_inference_model(dirname, [emb.name], [logit], exe,
                                  main_program=main)
    write_params(dirname, params)
    if exported:
        export(fluid, dirname, {"emb": (4, fields * (dim + 1))}, device)
    return dirname


# ----------------------------------------------------------------- traffic --

def request_trace(n_requests, large_rows, rng, vocab, ids_per_row=4):
    """The smoke trace: mostly 1-4 row requests, every 5th a
    ``large_rows`` one, landing EARLY in each cycle so the static
    baseline's head-of-line blocking is exercised, not dodged."""
    trace = []
    for i in range(n_requests):
        rows = large_rows if i % 5 == 1 else int(rng.randint(1, 5))
        trace.append({
            "x": rng.rand(rows, 12).astype("f4"),
            "ids": rng.randint(0, vocab, size=(rows, ids_per_row)
                               ).astype("i8")})
    return trace


def deepfm_trace(n_requests, large_rows, rng, fields, vocab):
    """The full trace: the smoke trace's sizes, each row ``fields`` ids
    from ``deepfm_hostps.zipf_ids``."""
    from . import deepfm_hostps as dh

    trace = []
    for i in range(n_requests):
        rows = large_rows if i % 5 == 1 else int(rng.randint(1, 5))
        trace.append({"ids": dh.zipf_ids(rng, rows, fields, vocab)})
    return trace


def make_lookup(vocab, dim, cache_slots, seed=7, device=None,
                name=TABLE_NAME):
    """The smoke lookup: a read-only embedding over a fresh table."""
    from ..hostps import HostPSEmbedding, HostSparseTable
    from ..serving import CTRLookup

    table = HostSparseTable(vocab, dim, seed=seed, name=name)
    emb = HostPSEmbedding(table, cache_slots=cache_slots, read_only=True,
                          device=device)
    return table, emb, CTRLookup(emb, "ids", out_name="emb")


def make_deepfm_lookup(vocab, dim, cache_slots, device=None,
                       name=TABLE_NAME):
    """The full lookup: ``deepfm_hostps.make_table``'s [vocab, dim + 1]
    table (its initializer) behind a read-only embedding."""
    from ..hostps import HostPSEmbedding
    from ..serving import CTRLookup
    from . import deepfm_hostps as dh

    table = dh.make_table(vocab, dim, name=name)
    emb = HostPSEmbedding(table, cache_slots=cache_slots, read_only=True,
                          device=device)
    return table, emb, CTRLookup(emb, "ids", out_name="emb")


# ----------------------------------------------------------------- fleet --

OWNER_DONE = "OWNER_DONE"


def owner_table(kind, vocab, width, name=TABLE_NAME):
    """The read-only CTR table an owner serves, and its twin anywhere else,
    with rows ``width`` wide: ``make_lookup``'s (``kind`` "smoke", seed 7)
    or ``make_deepfm_lookup``'s (``kind`` "deepfm": each row an embedding
    of ``width - 1`` and its first-order weight)."""
    from ..hostps import HostSparseTable
    from . import deepfm_hostps as dh

    if kind == "smoke":
        return HostSparseTable(vocab, width, seed=7, name=name)
    return dh.make_table(vocab, width - 1, name=name)


def _rss():
    from ..monitor import memscope

    return memscope.host_accounting().get("rss_bytes", 0)


def owner_main(args):
    """``--ctr-owner``: one ShardPS owner process serving ``owner_table``'s
    rows over ``--wire-dir`` until an ``OWNER_DONE`` file appears there;
    then it writes ``owner-0.json`` (rows initialized, RSS at start and
    end) beside it.  It touches no card."""
    from ..hostps import ShardServer

    rss0 = _rss()
    table = owner_table(args.kind, args.vocab, args.width)
    srv = ShardServer(table, args.wire_dir, 0, poll=args.poll).start()
    done = os.path.join(args.wire_dir, OWNER_DONE)
    while not os.path.exists(done):
        time.sleep(0.05)
    srv.stop()
    rec = {"rows_initialized": int(table.rows_initialized),
           "rss_start_bytes": rss0, "rss_end_bytes": _rss(),
           "pid": os.getpid()}
    with open(os.path.join(args.wire_dir, "owner-0.json"), "w") as f:
        json.dump(rec, f)
    return 0


def start_owner(wire_dir, kind, vocab, width, poll=0.002, env=None):
    """Start ``owner_main`` as a fresh interpreter that sees no card."""
    os.makedirs(wire_dir, exist_ok=True)
    env = dict(os.environ if env is None else env, CUDA_VISIBLE_DEVICES="")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    import subprocess

    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.serve_bench",
         "--ctr-owner", "--wire-dir", wire_dir, "--kind", kind,
         "--vocab", str(vocab), "--width", str(width), "--poll",
         str(poll)],
        env=env, cwd=repo)


def stop_owner(wire_dir, proc, timeout=120):
    """Ask the owner to stop; returns its ``owner-0.json`` record."""
    open(os.path.join(wire_dir, OWNER_DONE), "w").close()
    rc = proc.wait(timeout=timeout)
    with open(os.path.join(wire_dir, "owner-0.json")) as f:
        rec = json.load(f)
    rec["rc"] = rc
    return rec


def fleet_drive(router, clients, seconds, next_feed, samples=None,
                mid_hook=None, keep=8):
    """Closed-loop fleet load: ``clients`` threads each submit-and-wait in
    a loop for ``seconds``; client c's k-th request is ``next_feed(c, k)``
    (a dict with a ``"key"`` the samples carry, and the feed).  Closed-loop
    is the honest shape for a scaling measurement: offered load rises only
    when the fleet absorbs it, so QPS is capacity, not an arrival-rate
    echo.  ``samples`` (a list) collects up to ``keep`` ``(key, feed,
    outputs)`` per client."""
    import threading

    lock = threading.Lock()
    lats, errors = [], []
    stop_at = [float("inf")]

    def one(cid):
        k, kept = 0, 0
        while time.perf_counter() < stop_at[0]:
            key, feed = next_feed(cid, k)
            k += 1
            t0 = time.perf_counter()
            try:
                outs = router.submit(dict(feed))
            except Exception as e:                  # a drop: gate trips
                with lock:
                    errors.append("client %d: %r" % (cid, e))
                return
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                lats.append(ms)
                if samples is not None and kept < keep:
                    samples.append((key, feed, outs))
                    kept += 1

    threads = [threading.Thread(target=one, args=(c,), daemon=True)
               for c in range(clients)]
    t0 = time.perf_counter()
    stop_at[0] = t0 + seconds
    for t in threads:
        t.start()
    if mid_hook is not None:
        time.sleep(seconds * 0.5)
        try:
            mid_hook()
        except Exception as e:
            with lock:
                errors.append("mid_hook: %r" % (e,))
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    arr = np.asarray(lats) if lats else np.zeros(1)
    return {"completed": len(lats), "errors": errors,
            "wall_s": round(wall, 3),
            "qps": round(len(lats) / wall, 2),
            "p50_ms": round(float(np.percentile(arr, 50)), 3),
            "p99_ms": round(float(np.percentile(arr, 99)), 3)}


def _fleet_model(cfg_name, workdir, device):
    """(feeds, dense params or None, kind, vocab, dim, feed factory) of
    the fleet bench's model, its artifact written to ``workdir``."""
    import paddle_tpu_torch as fluid

    rng = np.random.RandomState(0)
    if cfg_name == "smoke":
        c = SMOKE
        build_artifact(fluid, workdir, rng, device=device)

        def feed(cid, k):
            crng = np.random.RandomState(1000 + 7919 * cid + k)
            rows = int(crng.choice((2, 4)))
            return (cid, k), {
                "x": crng.rand(rows, 12).astype("f4"),
                "ids": crng.randint(0, c["vocab"], (rows, 4)).astype("i8")}
        return (["x:12:float32", "emb:16:float32"], None, "smoke",
                c["vocab"], c["dim"], feed, c["lattice"])
    from . import deepfm_hostps as dh

    c = FULL
    dense = dh.init_dense(torch.Generator().manual_seed(0), c["fields"],
                          c["dim"], c["mlp"], "cpu")
    build_deepfm_artifact(fluid, workdir, deepfm_params(dense), c["fields"],
                          c["dim"], c["mlp"], device=device)
    trace = deepfm_trace(c["requests"], 4 * max(c["lattice"]),
                         np.random.RandomState(58), c["fields"], c["vocab"])

    def feed(cid, k):
        i = (cid + 16 * k) % len(trace)
        return i, trace[i]
    return (["emb:%d:float32" % (c["fields"] * (c["dim"] + 1))], dense,
            "deepfm", c["vocab"], c["dim"] + 1, feed, c["lattice"])


def fleet_leg(args):
    """The fleet receipts (module docstring, ``--fleet``).  Returns the
    exit code."""
    from .. import monitor
    from ..inference import AnalysisConfig, create_predictor
    from ..kernels._common import resolve_device
    from ..serving import FleetManager, FleetRouter, autoscale_signal

    device = resolve_device(args.device)
    cfg_name = "smoke" if args.smoke else "full"
    leg_s = args.leg_secs or (4.0 if args.smoke else 10.0)
    clients = args.fleet_clients
    workdir = tempfile.mkdtemp(prefix="serve_bench_fleet_")
    fleet_wire = os.path.join(workdir, "fleet-wire")
    ps_wire = os.path.join(workdir, "ps-wire")
    mon_root = os.path.join(workdir, "monitor")
    art = os.path.join(workdir, "artifact")
    failures, samples, load_sig, stats = [], [], {}, {}
    res1 = res3 = post = None
    owner = mgr = None
    d_idle = action = rc_retired = owner_rec = None
    versions = {}
    mon = monitor.enable(os.path.join(mon_root, "router"))
    try:
        (feeds, _dense, kind, vocab, dim, next_feed,
         lattice) = _fleet_model(cfg_name, art, str(device))
        say("serve_bench[fleet]: config=%s device=%s clients=%d leg=%.0fs "
            "lattice=%s" % (cfg_name, device, clients, leg_s, lattice))
        owner = start_owner(ps_wire, kind, vocab, dim)
        say("serve_bench[fleet]: ShardPS owner pid %d serves the whole "
            "%d-row table read-only; the replicas hold no table"
            % (owner.pid, vocab))
        mgr = FleetManager(
            fleet_wire, art, mon_root, feeds,
            buckets=",".join(map(str, lattice)), workers=8,
            queue_capacity=512, device=str(device.type),
            env=(dict(os.environ, OMP_NUM_THREADS="1")
                 if device.type == "cpu" else None),
            ctr={"wire_dir": ps_wire, "world": 1, "vocab": vocab,
                 "dim": dim, "ids": "ids", "out": "emb"})
        router = FleetRouter(fleet_wire, poll=0.002, registry=mon.registry)
        t0 = time.perf_counter()
        mgr.spawn(0)
        mgr.wait_ready([0], timeout=args.timeout)
        router.add_replica(0)
        say("serve_bench[fleet]: replica 0 READY in %.1fs"
            % (time.perf_counter() - t0))
        res1 = fleet_drive(router, clients, leg_s, next_feed)
        say(json.dumps({"metric": "fleet_1", "serve": True, "unit": "ms",
                        "device": str(device), "replicas": 1,
                        "clients": clients, **{k: res1[k] for k in
                        ("qps", "p50_ms", "p99_ms", "completed")}}))
        t1 = time.perf_counter()
        mgr.spawn(1)
        mgr.spawn(2)
        mgr.wait_ready([1, 2], timeout=args.timeout)
        router.add_replica(1)
        router.add_replica(2)
        say("serve_bench[fleet]: replicas 1+2 READY in %.1fs (each captures "
            "its own lattice: no warm store)" % (time.perf_counter() - t1))

        def _mid():
            router.publish_gauges()
            d, why, ml = autoscale_signal(router.snapshot(), min_replicas=1,
                                          max_replicas=4, high_load=3.0,
                                          registry=mon.registry)
            load_sig.update(desired=d, reason=why, mean_load=round(ml, 2))

        res3 = fleet_drive(router, clients, leg_s, next_feed,
                           samples=samples, mid_hook=_mid)
        say(json.dumps({"metric": "fleet_3", "serve": True, "unit": "ms",
                        "device": str(device), "replicas": 3,
                        "clients": clients, **{k: res3[k] for k in
                        ("qps", "p50_ms", "p99_ms", "completed")}}))
        for rid in (0, 1, 2):
            try:
                stats[rid] = router.stats(rid)
            except Exception as e:
                failures.append("stats(%d) failed: %r" % (rid, e))

        # rolling deploy: every replica to a second weight set (the saved
        # weights halved — call-compatible by construction)
        with np.load(os.path.join(art, "__params__.npz")) as z:
            state2 = {k: (z[k] * np.float32(0.5)).astype(z[k].dtype)
                      for k in z.files}
        art2 = os.path.join(workdir, "artifact2")
        shutil.copytree(art, art2)
        write_params(art2, state2)
        router.rolling_swap(2, os.path.join(art2, "__params__.npz"),
                            deadline=max(30.0, args.timeout / 4))
        post_samples = []
        post = fleet_drive(router, 4, 1.5, next_feed, samples=post_samples,
                           keep=2)
        for rid in (0, 1, 2):
            try:
                versions[rid] = router.stats(rid).get("version")
            except Exception as e:
                failures.append("post-swap stats(%d): %r" % (rid, e))
        say("serve_bench[fleet]: rolling swap -> versions %s, %d requests "
            "served post-swap" % (versions, post["completed"]))
        shield = router.shield_snapshot()
        if (shield["sheds"] or shield["budget"]["spent"]
                or shield["degraded"]):
            failures.append("the inert shield acted on a clean run: %r"
                            % shield)

        # autoscale, both directions: the scale-up signal was sampled
        # under the clients; idle -> scale-down, actuated as a real retire
        router.stats_all()
        d_idle, why_idle, _ml = autoscale_signal(
            router.snapshot(), min_replicas=1, max_replicas=4,
            high_load=3.0, registry=mon.registry)
        action, rid_r = mgr.apply_autoscale(router, d_idle)
        rc_retired = (mgr.procs[rid_r].returncode
                      if action == "retire" else None)
        say("serve_bench[fleet]: autoscale under load -> %s; idle -> "
            "desired=%d (%s) -> %s replica %s (rc=%s)"
            % (load_sig, d_idle, why_idle, action, rid_r, rc_retired))
        for rid in list(router.replica_ids()):
            router.retire(rid)
            mgr.wait(rid, timeout=30.0)
        owner_rec = stop_owner(ps_wire, owner)
        owner = None

        # sampled correctness: the fleet's answers against the predictor
        # on a twin of the owner's table (gate 1's bounds)
        twin = owner_table(kind, vocab, dim)

        def lookup(feed):
            feed = dict(feed)
            ids = feed.pop("ids")
            feed["emb"] = twin.pull(ids, materialize=False).reshape(
                len(ids), -1)
            return feed

        for tag, d, got_samples in (("v1", art, samples[:6]),
                                    ("v2", art2, post_samples[:4])):
            pcfg = AnalysisConfig(d)
            if device.type == "cpu":
                pcfg.disable_gpu()
            pred = create_predictor(pcfg)
            loaded = _load_program(d)
            for key, feed, outs in got_samples:
                fed = lookup(feed)
                (ref, bound), = program_bounds(d, fed, _loaded=loaded)
                (want,) = pred.run(fed)
                h_f, h_p = _hold(outs[0], ref, bound), _hold(want, ref, bound)
                if not (h_f["ok"] and h_p["ok"]):
                    failures.append("%s sample %r: fleet %s, predictor %s"
                                    % (tag, key, h_f, h_p))
    finally:
        monitor.disable()
        if mgr is not None:
            mgr.stop_all()
        if owner is not None:
            try:
                stop_owner(ps_wire, owner, timeout=30)
            except Exception:
                owner.kill()
        shutil.rmtree(workdir, ignore_errors=True)

    if len(stats) < 3:
        failures.append("only %d/3 replicas answered stats" % len(stats))
    for rid, st in stats.items():
        src = st.get("precompile_sources", {})
        if src.get("compiled") != len(lattice) or src.get("disk"):
            failures.append("replica %d sources %s" % (rid, src))
        if st["recompiles"] or st.get("new_compiled_sigs"):
            failures.append("replica %d: recompiles %s, new signatures %s"
                            % (rid, st["recompiles"],
                               st.get("new_compiled_sigs")))
    for leg, r in (("1-replica", res1), ("3-replica", res3),
                   ("post-swap", post)):
        for err in r["errors"]:
            failures.append("%s leg dropped a request: %s" % (leg, err))
        if not r["completed"]:
            failures.append("%s leg completed zero requests" % leg)
    if set(versions.values()) != {2}:
        failures.append("rolling swap incomplete: versions %s" % versions)
    if load_sig.get("desired", 0) <= 3:
        failures.append("the fleet under its clients did not signal "
                        "scale-up: %s" % load_sig)
    if d_idle is None or d_idle >= 3:
        failures.append("idle fleet still wants %s replicas" % d_idle)
    if action != "retire" or rc_retired != 0:
        failures.append("autoscale retire did not happen cleanly: action=%s "
                        "rc=%s" % (action, rc_retired))
    if owner_rec is None or owner_rec["rc"] != 0 \
            or owner_rec["rows_initialized"]:
        failures.append("owner: %s" % owner_rec)
    qps1, qps3 = res1["qps"], res3["qps"]
    ratio = round(qps3 / qps1, 3) if qps1 else 0.0
    say("serve_bench[fleet]: qps 1-replica=%.1f 3-replica=%.1f -> ratio "
        "%.2fx (reported, not gated: the replicas share %s); p99 %.1fms -> "
        "%.1fms" % (qps1, qps3, ratio, "one card" if device.type == "cuda"
                    else "this host's cores", res1["p99_ms"],
                    res3["p99_ms"]))
    say(json.dumps({"metric": "fleet", "serve": True, "fleet": True,
                    "device": str(device), "config": cfg_name,
                    "replicas": 3, "clients": clients, "qps_1": qps1,
                    "qps_3": qps3, "ratio": ratio,
                    "p99_1_ms": res1["p99_ms"], "p99_3_ms": res3["p99_ms"],
                    "precompile_s": {r: s.get("precompile_s")
                                     for r, s in stats.items()},
                    "owner": owner_rec, "autoscale_up": load_sig,
                    "autoscale_idle": d_idle}))
    for f in failures:
        say("serve_bench[fleet]: FAIL %s" % f)
    if args.check and failures:
        return 1
    say("serve_bench[fleet]: %s" % ("PASS" if not failures else "done"))
    return 0


# ------------------------------------------------------------------ runs --

def run_mode(mode, artifact_dir, lattice, lookup, trace, timeout, feed_spec,
             device=None, name=None):
    """Serve ``trace`` through a fresh engine in ``mode``; returns
    (summary, requests, predictor).  The summary also holds the lookup
    cache's hit rate over this run alone (``cache_hit_rate``, None without
    a cache)."""
    from ..inference import load_exported_model
    from ..serving import ServeEngine

    ep = load_exported_model(artifact_dir, device=device)
    eng = ServeEngine(ep, lattice, feed_spec=feed_spec, lookups=[lookup],
                      mode=mode, queue_capacity=len(trace) + 2,
                      name=name or "serve_%s" % mode)
    cache = lookup.embedding.cache
    before = (cache.hits, cache.misses) if cache else None
    t0 = time.perf_counter()
    eng.start()
    precompile_s = time.perf_counter() - t0
    reqs = [eng.submit(dict(t)) for t in trace]
    for r in reqs:
        r.result(timeout=timeout)
    summary = eng.stop()
    summary["precompile_s"] = round(precompile_s, 3)
    summary["precompile_sources"] = eng.precompile_sources
    summary["largest_bucket"] = lattice.max_batch
    summary["cache_hit_rate"] = None
    if cache:
        hits, misses = cache.hits - before[0], cache.misses - before[1]
        summary["cache_hit_rate"] = (round(hits / (hits + misses), 4)
                                     if hits + misses else 0.0)
    return summary, reqs, ep


def _load_program(dirname):
    """(program, fetch names, {param: f32 array}) of a saved model."""
    from .. import io as _io

    with open(os.path.join(dirname, "__model__"), "rb") as f:
        import pickle

        payload = pickle.load(f)
    program = _io._desc_to_program(payload["program"])
    with np.load(os.path.join(dirname, "__params__.npz")) as z:
        params = {k: np.array(z[k]) for k in z.files}
    return program, payload["fetch_names"], params


def program_bounds(dirname, feed, _loaded=None):
    """The saved model's forward run by its own op rules in float64 on the
    CPU under ``fp_bounds.BoundMode``: ``[(reference, bound)]`` for each
    fetch — any f32 run of the same ops (the card's or the CPU's, in any
    order of each sum) lies within ``bound`` of ``reference``."""
    from ..executor import _Plan, _run_calls
    from .fp_bounds import BoundMode

    program, fetch_names, params = _loaded or _load_program(dirname)
    plan = _Plan(program, sorted(feed))
    env = {n: torch.as_tensor(np.asarray(v)).double()
           for n, v in {**params, **feed}.items()}
    mode = BoundMode()
    with mode:
        for v in env.values():
            if v.is_floating_point():
                mode.set_exact(v)
        ctx = plan.context(torch.Generator().manual_seed(0))
        _run_calls(plan.fwd, env, ctx)
        ctx.env = None
        out = [(env[n].detach(), mode.bound(env[n]).detach())
               for n in fetch_names]
    if mode.ambiguous:
        raise AssertionError("program_bounds: undecidable comparisons %s"
                             % mode.ambiguous)
    return out


def deepfm_head_bounds(dense, rows, dim):
    """``models/deepfm._deepfm_head`` on ``rows`` ([B, F, dim + 1] host
    rows) with the dense tree ``dense`` (``deepfm_params``' names or an
    ``init_dense`` tree), in float64 under ``BoundMode``: (reference,
    bound) of the logits [B]."""
    from ..models import deepfm
    from .fp_bounds import BoundMode

    if "mlp" not in dense:
        n = len([k for k in dense if k.endswith(".w")])
        dense = {"mlp": [{"w": dense[_pname(i, "w")],
                          "b": dense[_pname(i, "b")]} for i in range(n)],
                 "bias": dense["deepfm_bias"]}

    def f64(t):
        return torch.as_tensor(np.asarray(
            t.detach().cpu() if isinstance(t, torch.Tensor) else t)).double()

    head = {"mlp": [{k: f64(l[k]) for k in ("w", "b")} for l in dense["mlp"]],
            "bias": f64(dense["bias"]), "w_linear": None, "embed": None}
    v = f64(rows)
    mode = BoundMode()
    with mode:
        for t in [v, head["bias"]] + [l[k] for l in head["mlp"]
                                      for k in ("w", "b")]:
            mode.set_exact(t)
        out = deepfm._deepfm_head(head, v[..., :dim], v[..., dim])
        bound = mode.bound(out)
    if mode.ambiguous:
        raise AssertionError("deepfm_head_bounds: undecidable comparisons "
                             "%s" % mode.ambiguous)
    return out.detach(), bound.detach()


def _hold(got, ref, bound):
    from .fp_bounds import hold_to_bound

    return hold_to_bound(torch.as_tensor(np.asarray(got)), ref, bound)


def sample_indices(trace, k=12, large=None):
    """The requests ``verify_sample`` holds: every large one and the first
    ``k`` others, widened until each size of the trace is among them."""
    sizes = [len(next(iter(t.values()))) for t in trace]
    large = max(sizes) if large is None else large
    idx = [i for i, s in enumerate(sizes) if s >= large]
    small = [i for i, s in enumerate(sizes) if s < large]
    pick = small[:k]
    for s in sorted(set(sizes[i] for i in small)):
        if not any(sizes[i] == s for i in pick):
            pick.append(next(i for i in small if sizes[i] == s))
    return sorted(set(idx + pick))


def verify_sample(reqs, trace, artifact_dir, lookup, device=None, k=12,
                  memo=None):
    """Gate 1: each sampled request's engine result and a
    ``create_predictor(AnalysisConfig(dir))`` run on the same rows at the
    request's own shape, each within ``program_bounds``' bound of the
    float64 reference (so within twice it of each other).  Returns
    ``(ok, records)``; run it after the engines have stopped.  ``memo``
    (a dict) keeps each request's predictor result, reference and bound
    for the next call over the same trace (another mode's engine)."""
    from ..inference import AnalysisConfig, create_predictor

    memo = {} if memo is None else memo
    if "loaded" not in memo:
        cfg = AnalysisConfig(artifact_dir)
        if device is not None and torch.device(device).type == "cpu":
            cfg.disable_gpu()
        memo["pred"] = create_predictor(cfg)
        memo["loaded"] = _load_program(artifact_dir)
    recs, ok = [], True
    for i in sample_indices(trace, k):
        if i not in memo:
            feed = lookup(dict(trace[i]))
            (want,) = memo["pred"].run(dict(feed))
            (ref, bound), = program_bounds(artifact_dir, feed,
                                           _loaded=memo["loaded"])
            memo[i] = want, ref, bound
        want, ref, bound = memo[i]
        (got,) = reqs[i].result()
        h_eng, h_pred = _hold(got, ref, bound), _hold(want, ref, bound)
        gap = np.abs(np.asarray(got, np.float64)
                     - np.asarray(want, np.float64))
        pair_ok = bool((torch.as_tensor(gap) <= 2 * bound).all())
        rec = {"request": i, "rows": int(np.shape(got)[0]),
               "engine_ratio": h_eng["ratio"],
               "predictor_ratio": h_pred["ratio"],
               "max_abs_gap": float(gap.max(initial=0.0)),
               "ok": bool(h_eng["ok"] and h_pred["ok"] and pair_ok
                          and np.shape(got) == np.shape(want))}
        ok &= rec["ok"]
        recs.append(rec)
    return ok, recs


def head_of_line(reqs, largest_bucket, mode):
    """The anti-head-of-line property in dispatch steps (see the module
    docstring).  Continuous: every request completes within
    ceil(r / max(1, B // n)) steps of its first take.  Static: a request
    submitted right behind a large one takes its first rows only after
    every step of the large one.  Returns ``(ok, record)``."""
    B = int(largest_bucket)
    if mode == "continuous":
        spans = [(r.admit_step, r.done_step) for r in reqs]
        worst, bad = 0.0, []
        for r in reqs:
            n = max(sum(1 for a, d in spans if a <= s <= d)
                    for s in range(r.first_step, r.done_step + 1))
            allowed = math.ceil(r.rows / max(1, B // n))
            took = r.done_step - r.first_step + 1
            worst = max(worst, took / allowed)
            if took > allowed:
                bad.append((r.id, r.rows, n, took, allowed))
        small = [r for r in reqs if r.rows < B]
        return not bad, {"mode": mode, "worst_steps_over_allowed": worst,
                         "violations": bad[:5],
                         "small_max_steps": max(
                             (r.done_step - r.first_step + 1 for r in small),
                             default=0)}
    waits, bad = [], []
    for big, nxt in zip(reqs, reqs[1:]):
        if big.rows <= B:
            continue
        big_steps = big.done_step - big.first_step + 1
        waits.append(nxt.first_step - big.first_step)
        if nxt.first_step <= big.done_step or big_steps != math.ceil(
                big.rows / B):
            bad.append((big.id, nxt.id))
    return not bad, {"mode": mode, "steps_waited_behind_large": waits[:5],
                     "violations": bad[:5]}


def _record(mode, summary, n_requests, device):
    return {"metric": "serve_%s" % mode, "serve": True, "mode": mode,
            "unit": "ms", "device": str(device), "requests": n_requests,
            "p50_ms": summary["p50_ms"], "p99_ms": summary["p99_ms"],
            "qps": summary["qps"],
            "latency_mean_ms": summary["latency_mean_ms"],
            "occupancy": summary.get("occupancy_avg"),
            "steps": summary["steps"], "rows": summary["rows"],
            "recompiles": summary["recompiles"],
            "new_compiled_sigs": summary.get("new_compiled_sigs"),
            "lattice_points": summary["points"],
            "precompile_s": summary["precompile_s"],
            "precompile_sources": summary["precompile_sources"],
            "cache_hit_rate": summary["cache_hit_rate"]}


def gates(results, lattice, n_requests, table, rows_before):
    """Gates 2-3 over each mode's summary; returns the failures."""
    failures = []
    for mode, s in results.items():
        if s["recompiles"]:
            failures.append("%s: %d steady-state recompiles" %
                            (mode, s["recompiles"]))
        if s["points"] != len(lattice):
            failures.append("%s: %d/%d lattice points captured"
                            % (mode, s["points"], len(lattice)))
        if s["completed"] != n_requests:
            failures.append("%s: completed %d of %d requests"
                            % (mode, s["completed"], n_requests))
        if s.get("new_compiled_sigs") != 0:
            failures.append("%s: %r signatures captured after the lattice"
                            % (mode, s.get("new_compiled_sigs")))
    if table.rows_initialized != rows_before:
        failures.append("read-only CTR lookup WROTE the table: "
                        "rows_initialized %d -> %d"
                        % (rows_before, table.rows_initialized))
    return failures


def profile_lookups(cfg, device, rng, n_requests, top=12):
    """``--profile-lookups``: (cold seconds, warm seconds, chunks) of the
    static-mode lookups of the trace, printing the cold pass's ``top``
    functions by own time."""
    import cProfile
    import io
    import pstats

    B = max(cfg["lattice"])
    table, _emb, lookup = make_deepfm_lookup(cfg["vocab"], cfg["dim"],
                                             cfg["cache_slots"], device)
    trace = deepfm_trace(n_requests, 4 * B, rng, cfg["fields"],
                         cfg["vocab"])
    t0 = time.perf_counter()
    for t in trace:
        table.pull(t["ids"], materialize=False)
    say("serve_bench: first read of the rows %.3f s"
        % (time.perf_counter() - t0))
    chunks = [{"ids": t["ids"][i:i + B]} for t in trace
              for i in range(0, len(t["ids"]), B)]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for c in chunks:
        lookup(dict(c))
    sync()
    prof.disable()
    cold = time.perf_counter() - t0
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
    say(out.getvalue())
    t0 = time.perf_counter()
    for c in chunks:
        lookup(dict(c))
    sync()
    return cold, time.perf_counter() - t0, len(chunks)


def main(argv=None):
    ap = argparse.ArgumentParser(description="ServeLoop bench + gate")
    ap.add_argument("--check", action="store_true",
                    help="gate correctness/recompiles/read-only/steps; "
                         "exit 1 on failure")
    ap.add_argument("--smoke", action="store_true",
                    help="the small model, lattice and trace")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is named")
    ap.add_argument("--profile-lookups", action="store_true",
                    help="profile the full trace's cold and warm lookups")
    ap.add_argument("--fleet", action="store_true",
                    help="1 then 3 replica processes behind a FleetRouter")
    ap.add_argument("--fleet-clients", type=int, default=16)
    ap.add_argument("--leg-secs", type=float, default=None)
    ap.add_argument("--ctr-owner", action="store_true",
                    help="(internal) run one read-only ShardPS owner")
    ap.add_argument("--wire-dir", default=None)
    ap.add_argument("--kind", default="smoke", choices=("smoke", "deepfm"))
    ap.add_argument("--vocab", type=int, default=SMOKE["vocab"])
    ap.add_argument("--width", type=int, default=SMOKE["dim"],
                    help="(owner) the table's row width")
    ap.add_argument("--poll", type=float, default=0.002)
    args = ap.parse_args(argv)
    if args.ctr_owner:
        return owner_main(args)
    if args.fleet:
        return fleet_leg(args)

    from ..hostps.service import _LIVE_EMBEDDINGS
    from ..kernels._common import resolve_device
    from ..serving import BucketLattice

    device = resolve_device(args.device)
    rng = np.random.RandomState(0)
    cfg = SMOKE if args.smoke else FULL
    lattice = BucketLattice(cfg["lattice"])
    n_requests = args.requests or cfg["requests"]
    large_rows = 4 * lattice.max_batch
    if args.profile_lookups:
        cold, warm, n = profile_lookups(FULL, device, rng, n_requests)
        say(json.dumps({"metric": "serve_lookups", "device": str(device),
                        "chunks": n, "cold_s": cold, "warm_s": warm}))
        return 0
    workdir = tempfile.mkdtemp(prefix="serve_bench_")
    try:
        import paddle_tpu_torch as fluid

        say("serve_bench: lattice=%s requests=%d large_rows=%d device=%s "
            "config=%s" % (lattice.describe(), n_requests, large_rows,
                           device, "smoke" if args.smoke else "full"))
        if args.smoke:
            build_artifact(fluid, workdir, rng, device=device)
            trace = request_trace(n_requests, large_rows, rng, cfg["vocab"])
            table, emb, lookup = make_lookup(cfg["vocab"], cfg["dim"],
                                             cfg["cache_slots"],
                                             device=device)
            feed_spec = SMOKE_FEED_SPEC
        else:
            from . import deepfm_hostps as dh

            gen = torch.Generator().manual_seed(0)
            dense = dh.init_dense(gen, cfg["fields"], cfg["dim"],
                                  cfg["mlp"], "cpu")
            build_deepfm_artifact(fluid, workdir, deepfm_params(dense),
                                  cfg["fields"], cfg["dim"], cfg["mlp"],
                                  device=device)
            trace = deepfm_trace(n_requests, large_rows, rng, cfg["fields"],
                                 cfg["vocab"])
            table, emb, lookup = make_deepfm_lookup(
                cfg["vocab"], cfg["dim"], cfg["cache_slots"], device=device)
            feed_spec = {"emb": ((cfg["fields"] * (cfg["dim"] + 1),),
                                 "float32")}
        rows_before = table.rows_initialized
        results, failures = {}, []
        memo = {}
        for mode in ("static", "continuous"):
            summary, reqs, _ep = run_mode(mode, workdir, lattice, lookup,
                                          trace, args.timeout, feed_spec,
                                          device=device)
            ok, recs = verify_sample(reqs, trace, workdir, lookup, device,
                                     memo=memo)
            if not ok:
                failures.append("%s: sampled results off their bound: %s"
                                % (mode, [r for r in recs if not r["ok"]]))
            hol_ok, hol = head_of_line(reqs, lattice.max_batch, mode)
            if not hol_ok:
                failures.append("%s: head-of-line property: %s"
                                % (mode, hol))
            results[mode] = summary
            rec = _record(mode, summary, n_requests, device)
            rec["head_of_line"] = hol
            rec["verified"] = len(recs)
            rec["worst_bound_ratio"] = max(
                max(r["engine_ratio"], r["predictor_ratio"]) for r in recs)
            say(json.dumps(rec))
        failures += gates(results, lattice, n_requests, table, rows_before)
        _LIVE_EMBEDDINGS.discard(emb)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for f in failures:
        say("serve_bench: FAIL %s" % f)
    if args.check and failures:
        return 1
    say("serve_bench: %s" % ("PASS" if not failures else "done"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
