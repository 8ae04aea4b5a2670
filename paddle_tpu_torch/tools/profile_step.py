"""Where a training step's device time goes.

    python -m paddle_tpu_torch.tools.profile_step [--model bert|resnet50|deepfm] [--trace out.json]

Builds the same trainer and batches as ``chip_smoke.py``'s slice phases
(bf16 BERT-base with LAMB at B = 64, S = 512; bf16 ResNet-50 with fused
batch norm and momentum at B = 128, 224 x 224; f32 DeepFM, the ``segment``
SGD step at B = 8192, lr 1e-3; seed 0), takes a warm-up step, then traces
two steps with ``torch.profiler`` (CPU and CUDA activities).  Without
``--model`` it profiles all three.  Prints one JSON line per kernel group
(the port's kernels by name, cuBLAS products or cuDNN convolutions, for
DeepFM the gathers, the id sort and the row scatters, everything else) with
device milliseconds per step and share, each of the port's CUDA kernels on
its own, the top kernels by device time, and
the device's busy and idle share of the traced wall time; for ResNet-50
also the port's batch-norm kernels' summed device time per step beside
their byte bound.  Needs a CUDA card; fails rather than reading a CPU run
as device time.
"""

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

STEPS, SEED = 2, 0
BERT_BATCH, BERT_SEQ = 64, 512          # chip_smoke.py's slices
RN_BATCH, RN_IMAGE = 128, 224
DEEPFM_BATCH = 8192
HBM_BYTES_PER_S = 3.35e12               # H100 SXM (chip_smoke.py CARD_PEAKS)
GROUPS = {
    "bert": (
        ("port:flash_attention_fwd", ("flash_fwd_",)),   # both routes
        ("port:flash_attention_bwd", ("flash_bwd_", "flash_delta_kernel")),
        ("port:layer_norm_fwd", ("ln_fwd_kernel",)),
        ("port:layer_norm_bwd", ("ln_bwd_",)),          # both routes
        ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
    ),
    "resnet50": (
        ("port:bn_stats", ("bn_stats_kernel",)),
        ("port:bn_scale_shift", ("bn_scale_shift_kernel",)),
        ("port:bn_bwd_reduce", ("bn_bwd_reduce_kernel",)),
        ("port:bn_dx", ("bn_dx_kernel",)),
        ("port:bn_fold (stats and bwd_reduce)", ("bn_fold_kernel",)),
        ("convolution (cuDNN)", ("conv", "xmma", "cudnn", "implicit", "fprop",
                                 "dgrad", "wgrad", "cutlass", "sm90_", "nvjet",
                                 "gemm")),
    ),
    "deepfm": (
        ("port:segment_sum", ("segsum_",)),
        ("sort (ids)", ("radixsort", "sort", "onesweep")),
        ("scatter (row update)", ("index_add", "indexfunc", "scatter")),
        ("gather (table rows)", ("index_elementwise", "gather", "indexselect",
                                 "index_kernel")),
        ("MLP (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
    ),
}


def group_of(model, name):
    low = name.lower()
    for group, keys in GROUPS[model]:
        if any(k in low for k in keys):
            return group
    return "other"


def _bert():
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import optim
    from paddle_tpu_torch.parallel.train import stack_batches

    cfg = bert.bert_base_config()
    trainer = bert.build_bert_trainer(cfg, optimizer=optim.lamb(), seed=SEED)
    staged = stack_batches(bert.synthetic_batches(cfg, STEPS + 1, BERT_BATCH,
                                                  BERT_SEQ, SEED),
                           trainer.device, bert.batch_specs())
    return trainer, staged, 1e-4, {"batch": BERT_BATCH, "seq": BERT_SEQ}


def _resnet50():
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.parallel import optim
    from paddle_tpu_torch.parallel.train import stack_batches

    cfg = resnet.resnet50_config(dtype="bfloat16", fuse_bn=True,
                                 image_size=RN_IMAGE)
    trainer = resnet.build_resnet_trainer(cfg, optimizer=optim.momentum(0.9),
                                          seed=SEED)
    staged = stack_batches(resnet.synthetic_batches(cfg, STEPS + 1, RN_BATCH,
                                                    SEED),
                           trainer.device, {"image": torch.bfloat16})
    return trainer, staged, 1e-2, {"batch": RN_BATCH, "image": RN_IMAGE,
                                   "bn_byte_bound_ms": bn_byte_bound_ms(cfg)}


def _deepfm():
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.parallel.train import stack_batches

    cfg = deepfm.DeepFMConfig()
    trainer = deepfm.build_deepfm_trainer(cfg, variant="segment", seed=SEED)
    # the bench's one batch, taken every step
    staged = stack_batches([deepfm.synthetic_batch(cfg, DEEPFM_BATCH, SEED)]
                           * (STEPS + 1), trainer.device)
    return trainer, staged, 1e-3, {
        "batch": DEEPFM_BATCH,
        "mlp_train_flops_per_step": deepfm.mlp_train_flops(cfg, DEEPFM_BATCH)}


def bn_shapes(cfg, batch):
    """The [M, C] view of every batch norm in a ResNet forward, in order."""
    side = lambda n, s: -(-n // s)
    h = side(cfg.image_size, 2)                       # conv0, 7x7/2
    shapes = [(batch * h * h, cfg.width)]
    h = side(h, 2)                                    # max pool 3x3/2
    cin = cfg.width
    for si, nblocks in enumerate(cfg.blocks):
        cmid = cfg.width * 2 ** si
        cout = cmid * (4 if cfg.bottleneck else 1)
        for bi in range(nblocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            ho = side(h, stride)
            if cfg.bottleneck:
                # conv1 is 1x1 at stride 1; conv2 carries the stride
                shapes += [(batch * h * h, cmid), (batch * ho * ho, cmid),
                           (batch * ho * ho, cout)]
            else:
                shapes += [(batch * ho * ho, cmid), (batch * ho * ho, cout)]
            if bi == 0 and (cin != cout or stride != 1):
                shapes.append((batch * ho * ho, cout))
            h, cin = ho, cout
    return shapes


def bn_byte_bound_ms(cfg):
    """The four kernels' least device time a step at 2-byte elements: stats
    reads x (1 pass), scale_shift reads x and writes y (2), bwd_reduce reads
    dy and x (2), dx reads dy and x and writes dx (3)."""
    elements = sum(m * c for m, c in bn_shapes(cfg, RN_BATCH))
    return elements * 2 * 8 / HBM_BYTES_PER_S * 1e3


def cuda_kernels_per_call(fn, calls=5):
    """{CUDA kernel name: (launches a call, device ms a call)} from
    torch.profiler, after one untimed call of ``fn``: ``calls`` calls, each
    traced on its own.  The profiler now and then loses a kernel's record,
    so a kernel's launches a call are the most any one call showed, and its
    device ms the mean over the calls that showed it."""
    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen.setdefault(e.key, []).append(
                    (e.count, e.self_device_time_total / 1e3))
    return {k: (max(n for n, _ in v), sum(ms for _, ms in v) / len(v))
            for k, v in seen.items()}


def profile_model(model, card, trace=None):
    trainer, staged, lr, extra = {"bert": _bert, "resnet50": _resnet50,
                                  "deepfm": _deepfm}[model]()
    batches = [{k: v[i] for k, v in staged.items()} for i in range(STEPS + 1)]
    trainer.step(batches[0], lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            trainer.step(b, lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace:
        prof.export_chrome_trace(trace)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise SystemExit("profile_step: the profiler recorded no device time")
    groups = {}
    for e in kernels:
        g = groups.setdefault(group_of(model, e.key), [0.0, 0])
        g[0] += e.self_device_time_total
        g[1] += e.count
    for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(json.dumps({"model": model, "group": g,
                          "device_ms_per_step": us / 1e3 / STEPS,
                          "share_of_device_time": us / busy_us,
                          "launches_per_step": n / STEPS}))
    # the port's own kernels one by one: a group may hold several
    port = sorted((e for e in kernels if group_of(model, e.key).startswith("port:")),
                  key=lambda e: -e.self_device_time_total)
    print(json.dumps({"model": model, "port_kernels": [
        {"name": e.key[:90], "group": group_of(model, e.key),
         "device_ms_per_step": e.self_device_time_total / 1e3 / STEPS,
         "launches_per_step": e.count / STEPS} for e in port]}))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    print(json.dumps({"model": model, "top_kernels": [
        {"name": e.key[:90], "group": group_of(model, e.key),
         "device_ms_per_step": e.self_device_time_total / 1e3 / STEPS,
         "launches_per_step": e.count / STEPS} for e in top]}))
    summary = {"model": model, "device": torch.cuda.get_device_name(0),
               "nvidia_smi": card, "steps": STEPS,
               "wall_ms_per_step": wall_ms / STEPS,
               "device_busy_ms_per_step": busy_us / 1e3 / STEPS,
               "device_idle_share": max(0.0, 1 - busy_us / 1e3 / wall_ms),
               "note": "wall time includes the profiler's own cost", **extra}
    if model == "resnet50":
        summary["bn_kernels_device_ms_per_step"] = sum(
            us for g, (us, _) in groups.items() if g.startswith("port:bn")) / 1e3 / STEPS
    print(json.dumps(summary))
    del trainer, staged, batches
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(GROUPS), default=None,
                    help="profile one model (default: all three)")
    ap.add_argument("--trace", default=None,
                    help="write the chrome trace here (with --model)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    if args.trace and not args.model:
        raise SystemExit("profile_step: --trace needs --model")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    for model in [args.model] if args.model else ["bert", "resnet50", "deepfm"]:
        profile_model(model, card, args.trace)


if __name__ == "__main__":
    main()
