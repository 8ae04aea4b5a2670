"""Steps over one card a rank, NCCL: weak scaling of the port's dp
trainers at a fixed batch a rank, and strong scaling of BERT-base over the
tp or pp axis at a fixed global batch.

    python -m paddle_tpu_torch.tools.dp_scaling
        [--model bert|resnet50|encoder] [--nprocs 1 2 4] [--steps 5]
        [--tp | --pp [--microbatches 4]] [--attn heads|ring]

With ``--tp`` (``--pp``) the world's ranks lie on the tp (pp) axis of
BERT-base's mesh, which trains the one-card batch (32 sequences) in the
Megatron-SP layout (``--attn ring``: ring attention) or as a GPipe pipeline
of ``--microbatches``, and the line's efficiency is the one-rank ms over n
times the world's.  ``--model encoder --tp`` trains the Fluid-layers
encoder with its Megatron marks (``bert_encoder_program(tp_split=True)``)
at ``tensor_parallel_degree`` = the world's size, the global batch fixed
at 16 sequences.

For each world size it starts that many workers through
``python -m paddle_tpu_torch.distributed.launch --nproc_per_node N`` (NCCL,
each rank on its own card); each worker joins through ``fleet.init()`` and
trains BERT-base (bf16, S = 512, 32 sequences a rank, LAMB with
``zero=True``), ResNet-50 (bf16, 224, 64 images a rank, ``fuse_bn`` with
``sync_bn``, momentum) or, in program mode, the Fluid-layers BERT-base
encoder (``tools/programs.py`` ``BERT_BASE_ENCODER``: f32, S = 512, 16
sequences a rank, dropout 0.1, Adam) under ``fleet.distributed_optimizer``
through the ``Executor``, each rank fed the global batch: a warm-up step,
then ``--steps`` timed steps (the
host clock around them, ending in a sync).  After the timed steps every
rank's parameters are gathered and compared, bit for bit.  Rank 0 prints
one JSON line a world size: ms a step, items a second, the scaling
efficiency against the one-rank line, the card's name and power limit.
Needs as many cards as the largest world size.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch

BERT_PER_RANK, SEQ = 32, 512
RESNET_PER_RANK, IMAGE = 64, 224
ENCODER_PER_RANK = 16


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(model, steps, axis="dp", attn="heads", microbatches=4):
    import torch.distributed as dist

    from paddle_tpu_torch._tree import tree_leaves
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import bert, resnet
    from paddle_tpu_torch.parallel import MeshSpec, optim
    from paddle_tpu_torch.parallel.train import gather_pytree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f = fleet.init()
    world, rank = f.worker_num(), f.worker_index()
    if model == "encoder":
        return _encoder_worker(f, world, rank, steps, tp=axis == "tp")
    if model == "bert":
        deg = {"dp": 1, "pp": 1, "tp": 1, axis: world}
        cfg = bert.bert_base_config(tp=deg["tp"], pp=deg["pp"], attn_mode=attn)
        tr = bert.build_bert_trainer(
            cfg, MeshSpec(dp=deg["dp"], pp=deg["pp"], tp=deg["tp"], zero=True),
            optimizer=optim.lamb(), seed=0, device=f.device,
            n_microbatches=microbatches if deg["pp"] > 1 else 1)
        per = BERT_PER_RANK * deg["dp"]
        host = bert.synthetic_batches(cfg, steps + 1, per, SEQ)
        items, lr = per * SEQ, 1e-4
    else:
        cfg = resnet.resnet50_config(dtype="bfloat16", fuse_bn=True,
                                     sync_bn=True, image_size=IMAGE)
        tr = resnet.build_resnet_trainer(cfg, MeshSpec(dp=world),
                                         optimizer=optim.momentum(0.9),
                                         seed=0, device=f.device)
        host = resnet.synthetic_batches(cfg, steps + 1,
                                        RESNET_PER_RANK * world)
        items, lr = RESNET_PER_RANK * world, 1e-2
    batches = [{k: torch.from_numpy(v).to(f.device) for k, v in b.items()}
               for b in host]
    if model == "resnet50":
        for b in batches:
            b["image"] = b["image"].to(torch.bfloat16)
    tr.step(batches[0], lr)                       # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    losses = [tr.step(b, lr) for b in batches[1:]]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    params = tr.state["params"]
    if model == "bert":            # the global tree from the ranks' shards
        params = gather_pytree(params, tr.specs["params"], tr.mesh)
    _report(model, world, rank, BERT_PER_RANK if model == "bert"
            else RESNET_PER_RANK, dt, items, losses, tree_leaves(params),
            extra={"axis": axis, "attn": attn,
                   "microbatches": microbatches if axis == "pp" else 1}
            if model == "bert" else None)


def _report(model, world, rank, per_rank, dt, items, losses, params,
            extra=None):
    """Every rank's (gathered) parameters against the others'; rank 0
    prints the line."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import collectives as col

    differ = 0
    for t in params:
        both = col.backend_all_gather(t.reshape(1, -1), dist.group.WORLD, 0)
        differ += not all(torch.equal(both[0], both[r]) for r in range(world))
    if rank == 0:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print("DP_SCALING " + json.dumps({
            "model": model, "world": world, "backend": dist.get_backend(),
            "per_rank_batch": per_rank, "ms_per_step": dt * 1e3,
            "items_per_sec": items / dt,
            "peak_memory_allocated": torch.cuda.max_memory_allocated(),
            "losses": [float(l) for l in losses],
            "replica_leaves_differ": differ, "nvidia_smi": smi,
            **(extra or {})}), flush=True)
    dist.destroy_process_group()


def _encoder_worker(f, world, rank, steps, tp=False):
    """The program-mode line: the Fluid-layers encoder under fleet, data
    parallel (16 sequences a rank) or, with ``tp``, at
    ``tensor_parallel_degree`` = the world (16 sequences in all)."""
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.tools.programs import (BERT_BASE_ENCODER,
                                                 bert_encoder_program,
                                                 encoder_feed)

    strategy = fleet.DistributedStrategy()
    strategy.tensor_parallel_degree = world if tp else 1
    cfg = BERT_BASE_ENCODER._replace(
        batch=ENCODER_PER_RANK * (1 if tp else world))
    main, startup, v = bert_encoder_program(
        fluid, cfg, tp_split=tp,
        wrap_optimizer=lambda opt: fleet.distributed_optimizer(opt, strategy))
    exe = fluid.Executor(fluid.CUDAPlace(f.device.index))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feeds = [encoder_feed(cfg, 700 + k) for k in range(steps + 1)]
    exe.run(main, feed=feeds[0], fetch_list=[v["loss"]], scope=scope)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    losses = [exe.run(main, feed=fd, fetch_list=[v["loss"]], scope=scope,
                      return_numpy=False)[0] for fd in feeds[1:]]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    # each parameter whole (a tp split's blocks gathered, a collective)
    _report("encoder", world, rank, cfg.batch // (1 if tp else world), dt,
            cfg.batch * cfg.seq, losses,
            [scope.find_global(p.name)
             for p in main.global_block().all_parameters()],
            extra={"axis": "tp" if tp else "dp",
                   "split_leaves": sum(scope.split(p.name) is not None for p
                                       in main.global_block().all_parameters())})


def main(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.tools.dp_scaling")
    p.add_argument("--model", choices=("bert", "resnet50", "encoder"),
                   default="bert")
    p.add_argument("--nprocs", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--steps", type=int, default=5)
    axes = p.add_mutually_exclusive_group()
    axes.add_argument("--tp", action="store_true",
                      help="the ranks on the tp axis")
    axes.add_argument("--pp", action="store_true",
                      help="the ranks on BERT-base's pp axis")
    p.add_argument("--attn", choices=("heads", "ring"), default="heads")
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    axis = "tp" if args.tp else "pp" if args.pp else "dp"
    if axis == "pp" and args.model != "bert":
        raise SystemExit("--pp trains BERT-base (--model bert)")
    if axis == "tp" and args.model == "resnet50":
        raise SystemExit("--tp trains BERT-base or the Fluid encoder")
    if args.worker:
        _worker(args.model, args.steps, axis, args.attn, args.microbatches)
        return 0
    from paddle_tpu_torch.kernels import _common

    _common.load_library()        # build once, before the workers load it
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    base = None
    for n in args.nprocs:
        if n > torch.cuda.device_count():
            raise RuntimeError("world %d needs %d cards, have %d"
                               % (n, n, torch.cuda.device_count()))
        out = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", str(n), "--started_port", str(_free_port()),
             os.path.abspath(__file__), "--worker", "--model", args.model,
             "--steps", str(args.steps), "--attn", args.attn,
             "--microbatches", str(args.microbatches)]
            + (["--" + axis] if axis != "dp" else []),
            capture_output=True, text=True, env=env, cwd=root)
        if out.returncode != 0:
            raise RuntimeError("world %d failed (rc %d):\n%s" % (
                n, out.returncode, out.stderr[-4000:]))
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("DP_SCALING ")][-1]
        rec = json.loads(line[len("DP_SCALING "):])
        base = base or rec
        # weak scaling over dp (the batch grows with the world), strong
        # over tp or pp (the same batch on n cards)
        rec["scaling_efficiency"] = (
            base["ms_per_step"] / rec["ms_per_step"]
            / (1 if axis == "dp" else rec["world"])
            if base["world"] == 1 else None)
        print(json.dumps(rec), flush=True)
        if rec["replica_leaves_differ"]:
            raise RuntimeError("world %d: replicas differ" % n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
