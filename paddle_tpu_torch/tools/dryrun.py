"""The multi-rank dry run and the one-device entry (counterpart of the JAX
package's root ``__graft_entry__.py``: ``entry`` and ``dryrun_multichip``).

``python -m paddle_tpu_torch.tools.dryrun N [--device cuda|cpu]`` (``cuda``
unless named) starts a gloo world of N processes (a ``FileStore`` in a
temporary directory; on ``cuda`` every rank shares the current card, gloo
taking CUDA tensors) and runs one step of each of the reference's four
blocks:

- the tiny BERT trainer at the (dp, pp, tp) ``_factorize_mesh(N)`` picks,
  with 2 microbatches at pp > 1 (LAMB);
- ZeRO with Adam over dp = N, asserting that each rank holds 1/N of the
  token embedding's moment rows (when dp > 1 and the vocabulary divides);
- an expert-parallel MoE loss and gradient over the dp axis;
- a Fluid program with ``tp_split`` marks under ``with_data_parallel`` at
  dp x tp with kReduce, asserting that ``pp_fc1`` is held as
  [in, out / tp] and ``pp_head_moment1_0`` as 1/dp of its rows.

Every loss must be finite.  Rank 0 prints the reference's lines; the run
exits with the first failing rank's code.  ``entry()`` returns the
BERT-base forward loss function and its arguments at ``max_seq = 128``,
B = 4, as the reference's does.
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip", "main"]


def entry(device=None):
    """``(fn, (params, batch))``: the BERT-base forward loss at max_seq 128
    on realistic shapes (B = 4, S = 128), params from a seeded init on
    ``device`` (``cuda`` unless named)."""
    from ..kernels._common import resolve_device
    from ..models import bert
    from ..parallel.transformer import init_transformer_params

    device = resolve_device(device)
    cfg = bert.bert_base_config(max_seq=128)
    params = init_transformer_params(torch.Generator().manual_seed(0), cfg,
                                     device=device)
    loss_fn = bert.make_loss_fn(cfg)
    rng = np.random.RandomState(0)
    B, S = 4, 128
    batch = {
        "ids": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "mask": np.ones((B, S), np.float32),
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    def fn(params, batch):
        return loss_fn(params, batch)

    return fn, (params, batch)


def _factorize_mesh(n):
    """(dp, pp, tp) using as many distinct parallelism modes as n allows."""
    tp = 2 if n % 2 == 0 else 1
    pp = 2 if n % (tp * 2) == 0 else 1
    dp = n // (tp * pp)
    return dp, pp, tp


def _say(*args):
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(*args, flush=True)


def _blocks(n, device):
    """The four blocks on this rank of a world of ``n``."""
    import paddle_tpu_torch as fluid
    from ..models import bert
    from ..parallel import MeshSpec, optim
    from ..parallel import collectives as col
    from ..parallel import moe as moe_lib
    from ..parallel.mesh import DP, make_mesh
    from ..parallel.rules import batch_spec
    from ..parallel.train import grads_of, shard_batch, shard_pytree

    dp, pp, tp = _factorize_mesh(n)
    _say("dryrun mesh: dp=%d pp=%d tp=%d" % (dp, pp, tp))

    # --- the BERT train step: dp + pp (2 microbatches) + tp + sp -----------
    cfg = bert.bert_tiny_config(pp=pp, tp=tp)
    trainer = bert.build_bert_trainer(
        cfg, MeshSpec(dp, pp, tp), optimizer=optim.lamb(),
        n_microbatches=2 if pp > 1 else 1, device=device)
    rng = np.random.RandomState(0)
    B, S = 4 * dp, 32
    batch = {
        "ids": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "mask": np.ones((B, S), np.float32),
    }
    to_dev = lambda b: {k: torch.from_numpy(v).to(trainer.device)
                        for k, v in b.items()}
    loss = float(trainer.step(to_dev(batch), 1e-3))
    assert np.isfinite(loss), loss
    _say("dp/pp/tp/sp train step OK, loss=%.4f" % loss)

    # --- ZeRO: dp-sharded optimizer state -----------------------------------
    if dp > 1 and bert.bert_tiny_config().vocab_size % n == 0:
        zcfg = bert.bert_tiny_config()
        ztr = bert.build_bert_trainer(zcfg, MeshSpec(dp=n, zero=True),
                                      optimizer=optim.adam(), device=device)
        zb = {
            "ids": rng.randint(0, zcfg.vocab_size, (2 * n, 32)).astype(np.int32),
            "labels": rng.randint(0, zcfg.vocab_size,
                                  (2 * n, 32)).astype(np.int32),
            "mask": np.ones((2 * n, 32), np.float32),
        }
        zl = float(ztr.step(to_dev(zb), 1e-3))
        assert np.isfinite(zl), zl
        rows = ztr.state["opt"]["m"]["tok_emb"].shape[0]
        assert rows == zcfg.vocab_size // n, (rows, zcfg.vocab_size)
        _say("zero (dp-sharded opt state) step OK, loss=%.4f" % zl)

    # --- expert parallelism: MoE ffn + grad over the dp ("ep") axis --------
    mesh = make_mesh(dp, pp, tp, device=device)
    E, F, nE = 16, 32, 2 * dp
    params = shard_pytree(
        moe_lib.init_moe_params(torch.Generator().manual_seed(1), nE, E, F,
                                device=mesh.device),
        moe_lib.moe_param_specs(DP), mesh)
    x = torch.from_numpy(rng.randn(8 * dp, E).astype(np.float32))
    x = shard_batch(mesh, {"x": batch_spec(DP)}, {"x": x})["x"].to(
        mesh.device)
    with mesh:
        def loss_fn(p):
            y = moe_lib.moe_ffn(p, x, ep_axis=DP)
            return (y * y).sum()

        l, g = grads_of(loss_fn, params)
        l = col.psum(l.detach(), DP)
        # the router is replicated over ep: its partial gradients summed;
        # w1 and w2 are expert-sharded and their gradients stay local
        g_router = col.psum(g["router"], DP)
        l = float(l + g_router.sum() * 0.0)
    assert np.isfinite(l), l
    _say("ep (MoE all_to_all) step OK, loss=%.4f" % l)

    # --- the program path: a Fluid model through CompiledProgram -----------
    prog_tp = 2 if n % 2 == 0 else 1
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        ids = L.data("ids", shape=[1], dtype="int64")
        lab = L.data("lab", shape=[1], dtype="int64")
        mark = lambda kind: kind if prog_tp > 1 else None
        emb = L.embedding(ids, size=[64, 32], param_attr="pp_emb",
                          tp_split=mark("col"))
        h = L.fc(emb, 64, act="gelu", param_attr="pp_fc1",
                 tp_split=mark("col"))
        h = L.fc(h, 32, param_attr="pp_fc2", tp_split=mark("row"))
        logits = L.fc(h, 64, param_attr="pp_head")
        ploss = L.mean(L.softmax_with_cross_entropy(logits, lab))
        fluid.optimizer.Adam(1e-2).minimize(ploss)
    bs = fluid.BuildStrategy()
    bs.tensor_parallel_degree = prog_tp
    bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=ploss.name, build_strategy=bs)
    place = (fluid.CPUPlace() if torch.device(device).type == "cpu"
             else fluid.CUDAPlace(0))
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    pl = None
    for step in range(2):
        ids_np = rng.randint(0, 64, (2 * n, 1)).astype(np.int64)
        lab_np = ((ids_np * 7 + 3) % 64).astype(np.int64)
        (pl,) = exe.run(compiled, feed={"ids": ids_np, "lab": lab_np},
                        fetch_list=[ploss.name], scope=scope)
        assert np.isfinite(float(pl)), (step, pl)
    # the layouts applied, not just a loss: the col-split fc's block of its
    # out dim over tp, and kReduce's rows of the whole head's moments
    prog_dp = n // prog_tp
    shape = scope.local_shape("pp_fc1")
    assert shape == (32, 64 // prog_tp), shape
    m1 = scope.local_shape("pp_head_moment1_0")
    if prog_dp > 1 and 32 % prog_dp == 0:
        assert m1 == (32 // prog_dp, 64), m1
    _say("program-path dp=%d x tp=%d (kReduce) step OK, loss=%.4f; "
         "tp+kReduce shardings verified" % (prog_dp, prog_tp, float(pl)))


def _rank_main(n, device, rank, store):
    import torch.distributed as dist

    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=n)
    try:
        _blocks(n, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices, device="cuda", timeout_s=600):
    """Run the four blocks over a gloo world of ``n_devices`` processes on
    ``device`` (``cuda`` unless named); rank 0's lines go to this process's
    standard output.  Raises ``RuntimeError`` naming the failing ranks'
    output."""
    with tempfile.TemporaryDirectory(prefix="dryrun") as tmp:
        store = os.path.join(tmp, "store")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.tools.dryrun",
             str(n_devices), "--device", device, "--rank", str(r),
             "--store", store], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n_devices)]
        try:
            logs = [p.communicate(timeout=timeout_s)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    sys.stdout.write(logs[0])
    sys.stdout.flush()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError("dryrun ranks %s failed:\n%s" % (
            bad, "\n".join(logs[r][-4000:] for r in bad)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--store", default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.n, args.device, args.rank, args.store)
        return 0
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
