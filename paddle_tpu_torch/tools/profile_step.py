"""Where a training step's device time goes.

    python -m paddle_tpu_torch.tools.profile_step [--model bert|resnet50|deepfm|nmt|lenet|book|fluid_encoder|crnn_ctc|lac|dygraph_resnet] [--trace out.json]

Builds the same trainer and batches as ``chip_smoke.py``'s slice phases
(bf16 BERT-base with LAMB at B = 64, S = 512; bf16 ResNet-50 with fused
batch norm and momentum at B = 128, 224 x 224; f32 DeepFM, the ``segment``
SGD step at B = 8192, lr 1e-3; bf16 Transformer NMT with SGD at B = 128,
Ss = St = 128, lr 1e-4; f32 LeNet with Adam(1e-3) at B = 64 through the
Fluid ``Executor``, one ``run`` of the main program a step with the loss and
the accuracy fetched as numpy; seed 0; with ``--model book`` each of the
eleven book-suite programs of ``tools/book_suite.py`` in turn, as
``chip_smoke.py`` phase 24 trains them; with ``--model fluid_encoder`` the
Fluid-layers BERT-base encoder of ``tools/programs.py`` in f32, Adam at
1e-4, dropout 0.1, B = 16, S = 512, through ``Executor(CUDAPlace(0))``, as
``chip_smoke.py`` phase 41 trains it; with ``--model crnn_ctc`` the
CRNN-CTC recognizer of ``tools/programs.py`` at its published widths, f32,
B = 32, Momentum(1e-3, 0.9) with L2Decay, through
``Executor(CUDAPlace(0))``, as ``chip_smoke.py`` phase 43 trains it;
with ``--model lac`` the LAC lexical-analysis tagger of
``tools/programs.py`` at its published widths, f32, B = 300, T = 64,
Adam(1e-3), as ``chip_smoke.py`` phase 46 trains it; with ``--model
dygraph_resnet`` the dygraph ResNet-50 of ``tools/programs.py`` in f32,
B = 32, 224 x 224, Momentum over ``PiecewiseDecay``, one tape sweep and
``minimize`` a step, as ``chip_smoke.py`` phase 48 trains it),
takes a warm-up step, then traces
two steps with ``torch.profiler`` (CPU and CUDA activities).  Without
``--model`` it profiles all five.  Prints one JSON line per kernel group
(the port's kernels by name, cuBLAS products or cuDNN convolutions, for
DeepFM the gathers, the id sort and the row scatters, everything else) with
device milliseconds per step and share, each of the port's CUDA kernels on
its own, the top kernels by device time, and
the device's busy and idle share of the traced wall time; for ResNet-50
also the port's batch-norm kernels' summed device time per step beside
their byte bounds.  NMT's groups come from the op that launched each kernel
(``nmt_op_group``), since its f32 attention products and bf16 projections
run cuBLAS kernels whose names do not tell them apart; for NMT it also
traces one beam-search decode at ``chip_smoke.py``'s serving shape (16
sentences, beam 4, max_len 128) and prints its busy and idle share and
launches per decode step.  Every summary line carries the step's CUDA
launches.  Needs a CUDA card; fails rather than reading a CPU run as
device time.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

STEPS, SEED = 2, 0
BERT_BATCH, BERT_SEQ = 64, 512          # chip_smoke.py's slices
RN_BATCH, RN_IMAGE = 128, 224
DEEPFM_BATCH = 8192
NMT_BATCH, NMT_LEN = 128, 128
LENET_BATCH = 64                        # the book's (test_recognize_digits.py)
NMT_SERVE = dict(n=16, beam_size=4, max_len=128, alpha=0.6)
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
    "nmt": (),        # grouped by the launching op: nmt_op_group
    "fluid_encoder": (
        ("products (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
        ("softmax / log_softmax", ("softmax",)),
        ("reductions (layer_norm statistics, sums, means)", ("reduce",)),
        ("gather / scatter (embeddings, labels)", ("index", "gather",
                                                   "scatter")),
        ("random (dropout masks)", ("rand", "philox", "distribution")),
        ("copies and casts", ("copy", "cat", "fill")),
        ("elementwise (adds, gelu, dropout, Adam)", ("elementwise",
                                                     "vectorized",
                                                     "unrolled")),
    ),
    "crnn_ctc": (
        ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                                 "cudnn", "winograd", "fft", "im2col",
                                 "col2im")),
        ("products (cuBLAS: fcs, GRU steps)", ("gemm", "xmma", "cutlass",
                                              "sm90_", "nvjet")),
        ("batch norm statistics and other reductions", ("reduce", "norm")),
        ("pooling", ("pool",)),
        ("gather / scatter (CTC emissions, steps)", ("index", "gather",
                                                     "scatter")),
        ("copies and casts (step slices, stacks)", ("copy", "cat", "fill")),
        ("elementwise (GRU gates, CTC logaddexp, momentum)", (
            "elementwise", "vectorized", "unrolled")),
    ),
    "lac": (
        ("products (cuBLAS: fcs, GRU steps)", ("gemm", "xmma", "cutlass",
                                              "sm90_", "nvjet")),
        ("reductions (CRF log-sum-exp, Viterbi max, Adam norms)",
         ("reduce", "norm")),
        ("gather / scatter (embedding rows, sparse Adam, CRF labels)",
         ("index", "gather", "scatter")),
        ("sort (the sparse rows' merge)", ("sort", "radix")),
        ("copies and casts (step slices, stacks)", ("copy", "cat", "fill")),
        ("elementwise (GRU gates, CRF recursion, Adam)", (
            "elementwise", "vectorized", "unrolled")),
    ),
    "dygraph_resnet": (
        ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                                 "cudnn", "winograd", "fft", "xmma", "sm90_",
                                 "nvjet", "cutlass")),
        ("fc product (cuBLAS)", ("gemm",)),
        ("batch norm statistics and other reductions", ("reduce", "norm",
                                                        "welford")),
        ("pooling", ("pool",)),
        ("copies and casts", ("copy", "cat", "fill")),
        ("elementwise (batch norm, ReLU, adds, momentum)", (
            "elementwise", "vectorized", "unrolled")),
    ),
    "lenet": (
        ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                                 "cudnn", "winograd", "fft")),
        ("fc product (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
        ("pooling", ("pool",)),
        ("reductions (loss, mean, bias gradients)", ("reduce",)),
    ),
    "book": (
        ("port:segment_sum", ("segsum_",)),
        ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                                 "cudnn", "winograd", "fft")),
        ("products (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
        ("sort (ids)", ("radixsort", "sort", "onesweep")),
        ("gather / scatter (rows, ids)", ("index", "gather", "scatter")),
        ("reductions", ("reduce",)),
        ("copies and casts", ("copy", "cat", "fill")),
        ("elementwise", ("elementwise", "vectorized", "unrolled")),
        ("pooling", ("pool",)),
    ),
}
BOOK_PREFIX = "book:"
NMT_UPDATE_RANGE = "nmt:sgd_update"


def group_of(model, name):
    low = name.lower()
    for group, keys in GROUPS["book" if model.startswith(BOOK_PREFIX)
                              else model]:
        if any(k in low for k in keys):
            return group
    return "other"


def _bert():
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import optim
    from paddle_tpu_torch.parallel.train import stack_batches

    cfg = bert.bert_base_config()
    trainer = bert.build_bert_trainer(cfg, optimizer=optim.lamb(), seed=SEED)
    staged = stack_batches(trainer.mesh, bert.batch_specs(),
                           bert.synthetic_batches(cfg, STEPS + 1, BERT_BATCH,
                                                  BERT_SEQ, SEED),
                           bert.batch_dtypes())
    return trainer, staged, 1e-4, {"batch": BERT_BATCH, "seq": BERT_SEQ}


def _resnet50():
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.parallel import optim
    from paddle_tpu_torch.parallel.mesh import DP
    from paddle_tpu_torch.parallel.rules import P
    from paddle_tpu_torch.parallel.train import stack_batches

    cfg = resnet.resnet50_config(dtype="bfloat16", fuse_bn=True,
                                 image_size=RN_IMAGE)
    trainer = resnet.build_resnet_trainer(cfg, optimizer=optim.momentum(0.9),
                                          seed=SEED)
    staged = stack_batches(trainer.mesh, {"image": P(DP), "label": P(DP)},
                           resnet.synthetic_batches(cfg, STEPS + 1, RN_BATCH,
                                                    SEED),
                           {"image": torch.bfloat16})
    return trainer, staged, 1e-2, {"batch": RN_BATCH, "image": RN_IMAGE,
                                   "bn_byte_bounds_ms": bn_byte_bounds_ms(cfg)}


def _deepfm():
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel.train import stack_batches

    cfg = deepfm.DeepFMConfig()
    trainer = deepfm.build_deepfm_trainer(cfg, variant="segment", seed=SEED)
    # the bench's one batch, taken every step
    staged = stack_batches(make_mesh(device=trainer.device), {},
                           [deepfm.synthetic_batch(cfg, DEEPFM_BATCH, SEED)]
                           * (STEPS + 1))
    return trainer, staged, 1e-3, {
        "batch": DEEPFM_BATCH,
        "mlp_train_flops_per_step": deepfm.mlp_train_flops(cfg, DEEPFM_BATCH)}


def _nmt():
    from paddle_tpu_torch.datasets.wmt16 import wmt16_batch
    from paddle_tpu_torch.models import transformer_nmt as nmt
    from paddle_tpu_torch.parallel import optim
    from paddle_tpu_torch.parallel.train import stack_batches

    init, update = optim.sgd()

    def traced_update(*args):
        with record_function(NMT_UPDATE_RANGE):
            return update(*args)

    cfg = nmt.NMTConfig(dtype="bfloat16")
    trainer = nmt.build_nmt_trainer(cfg, optimizer=(init, traced_update),
                                    seed=SEED)
    # the bench's one batch, taken every step
    staged = stack_batches(trainer.mesh, {},
                           [wmt16_batch(cfg, NMT_BATCH, NMT_LEN, NMT_LEN)]
                           * (STEPS + 1))
    return trainer, staged, 1e-4, {
        "batch": NMT_BATCH, "src_len": NMT_LEN, "tgt_len": NMT_LEN,
        "train_flops_per_step": nmt.nmt_train_flops(cfg, NMT_BATCH, NMT_LEN,
                                                    NMT_LEN)}


def lenet_programs(fluid, optimizer, dtype="float32"):
    """The book's LeNet (``models/lenet.py``) with ``optimizer`` on the
    port's ``fluid``, its images and weights in ``dtype``: (main, startup,
    {"img", "label", "pred", "loss", "acc"})."""
    from paddle_tpu_torch.models.lenet import build_lenet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[1, 28, 28], dtype=dtype)
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        pred, loss, acc = build_lenet(img, label)
        optimizer.minimize(loss)
    return main, startup, {"img": img, "label": label, "pred": pred,
                           "loss": loss, "acc": acc}


class FluidStep:
    """One ``Executor.run`` of a Fluid main program as a trainer's step:
    ``step(batch, lr)`` feeds ``batch`` and fetches the loss and accuracy
    as numpy, as a user's loop does (the program carries its own lr)."""

    def __init__(self, exe, main, scope, fetch):
        self.exe, self.main, self.scope, self.fetch = exe, main, scope, fetch

    def step(self, batch, lr=None):
        return self.exe.run(self.main, feed=batch, fetch_list=self.fetch,
                            scope=self.scope)


def _lenet():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.datasets import mnist

    main, startup, v = lenet_programs(fluid, fluid.optimizer.Adam(1e-3))
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    feeder = fluid.DataFeeder([v["img"], v["label"]], program=main)
    rows = iter(mnist.train()())
    batches = [feeder.feed([next(rows) for _ in range(LENET_BATCH)])
               for _ in range(STEPS + 1)]
    # numpy, as the user's loop feeds it
    staged = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    return (FluidStep(exe, main, scope, [v["loss"], v["acc"]]), staged, None,
            {"batch": LENET_BATCH, "optimizer": "adam(1e-3)",
             "feed": "numpy, copied to the card by Executor.run"})


def _book(model):
    """A book model's training program (``tools/book_suite.py``: the JAX
    test's data, batch and optimizer, the builders' default widths) run by
    ``Executor()`` on the card, one batch fed every step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import datasets
    from paddle_tpu_torch.models import book
    from paddle_tpu_torch.tools import book_suite

    run = book_suite.build(fluid, book, datasets, model)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(run.startup, scope=scope)
    staged = {k: np.stack([v] * (STEPS + 1)) for k, v in run.feed.items()}
    return (FluidStep(exe, run.main, scope, run.fetch), staged, None,
            {"feed": "numpy, copied to the card by Executor.run"})


def _fluid_encoder():
    """The Fluid-layers BERT-base encoder (``tools/programs.py``) run by
    ``Executor(CUDAPlace(0))``, a fresh seeded batch every step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.programs import (BERT_BASE_ENCODER,
                                                 bert_encoder_program,
                                                 encoder_feed,
                                                 encoder_train_flops)

    cfg = BERT_BASE_ENCODER
    main, startup, v = bert_encoder_program(fluid, cfg)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    feeds = [encoder_feed(cfg, SEED + i) for i in range(STEPS + 1)]
    staged = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    return (FluidStep(exe, main, scope, [v["loss"]]), staged, None,
            {"batch": cfg.batch, "seq": cfg.seq, "dtype": "float32",
             "optimizer": "adam(1e-4)", "dropout": cfg.dropout,
             "train_flops_per_step": encoder_train_flops(cfg),
             "feed": "numpy, copied to the card by Executor.run"})


def nmt_op_group(chain, vocab):
    """The group of a kernel from the ops that launched it: ``chain`` is
    [(name, input shapes)] from the launching op outward (its callers, the
    autograd node, record_function ranges)."""
    names = [n for n, _ in chain]
    if NMT_UPDATE_RANGE in names:
        return "SGD update"
    if "aten::bmm" in names:
        return "attention products (f32 from bf16, cuBLAS)"
    for name, shapes in chain:
        if name in ("aten::mm", "aten::addmm"):
            if any(vocab in sh for sh in shapes):
                return "vocab head product (tied tgt_emb, cuBLAS)"
            return "FFN and projection products (cuBLAS)"
    if any(len(sh) >= 3 and sh[-1] == vocab for _, shapes in chain
           for sh in shapes):
        return "vocab log-softmax, NLL and casts ([B, T, V] f32)"
    return "other PyTorch ops"


def op_chain(event):
    """[(name, input shapes)] of a profiler CPU event and its callers."""
    chain = []
    while event is not None:
        chain.append((event.name, [list(sh) for sh in (event.input_shapes or [])
                                   if isinstance(sh, (list, tuple))]))
        event = event.cpu_parent
    return chain


def _nmt_op_groups(prof, vocab):
    """{group: [device us, launches]} over every CPU op with kernels."""
    groups = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        g = groups.setdefault(nmt_op_group(op_chain(e), vocab), [0.0, 0])
        g[0] += sum(k.duration for k in e.kernels)
        g[1] += len(e.kernels)
    return groups


def profile_nmt_decode(card, params, cfg):
    """One traced beam-search decode at chip_smoke.py's serving shape."""
    from paddle_tpu_torch.datasets.wmt16 import wmt16_batch
    from paddle_tpu_torch.models import transformer_nmt as nmt

    src = wmt16_batch(cfg, NMT_SERVE["n"], NMT_LEN, NMT_LEN, split="test")
    ids = torch.from_numpy(src["src_ids"]).cuda()
    mask = torch.from_numpy(src["src_mask"] > 0).cuda()
    kw = {k: NMT_SERVE[k] for k in ("beam_size", "max_len", "alpha")}
    nmt.beam_search(params, ids, mask, cfg, **kw)            # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nmt.beam_search(params, ids, mask, cfg, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise SystemExit("profile_step: the profiler recorded no device time")
    T = NMT_SERVE["max_len"]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    print(json.dumps({"model": "nmt_decode", "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": card, **NMT_SERVE,
                      "wall_ms_per_decode_step": wall_ms / T,
                      "device_busy_ms_per_decode_step": busy_us / 1e3 / T,
                      "device_idle_share": max(0.0, 1 - busy_us / 1e3 / wall_ms),
                      "launches_per_decode_step": sum(e.count for e in kernels) / T,
                      "top_kernels": [
                          {"name": e.key[:90],
                           "device_ms_per_decode_step": e.self_device_time_total / 1e3 / T,
                           "launches_per_decode_step": e.count / T} for e in top],
                      "note": "wall time includes the profiler's own cost"}))


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


# [M, C] passes each batch-norm kernel makes over 2-byte elements: stats
# reads x, scale_shift reads x and writes y, bwd_reduce reads dy and x, dx
# reads dy and x and writes dx
BN_PASSES = {"bn_stats": 1, "bn_scale_shift": 2, "bn_bwd_reduce": 2, "bn_dx": 3}


def bn_byte_bounds_ms(cfg):
    """Each batch-norm kernel's least device time a step at 2-byte
    elements, by BN_PASSES."""
    elements = sum(m * c for m, c in bn_shapes(cfg, RN_BATCH))
    return {k: elements * 2 * n / HBM_BYTES_PER_S * 1e3
            for k, n in BN_PASSES.items()}


def _crnn_ctc():
    """The CRNN-CTC recognizer (``tools/programs.py`` ``CRNN_CTC``) run by
    ``Executor(CUDAPlace(0))``, a fresh seeded batch every step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.programs import (CRNN_CTC, crnn_ctc_program,
                                                 crnn_feed, crnn_train_flops)

    cfg = CRNN_CTC
    main, startup, _, v = crnn_ctc_program(fluid, cfg)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    feeds = [crnn_feed(cfg, SEED + i) for i in range(STEPS + 1)]
    staged = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    return (FluidStep(exe, main, scope, [v["loss"]]), staged, None,
            {"batch": cfg.batch, "image": [cfg.height, cfg.width],
             "dtype": "float32", "optimizer": "momentum(1e-3, 0.9) + L2Decay",
             "train_flops_per_step": crnn_train_flops(cfg),
             "feed": "numpy, copied to the card by Executor.run"})


def _lac():
    """The LAC tagger (``tools/programs.py`` ``LAC``) run by
    ``Executor(CUDAPlace(0))``, a fresh seeded batch every step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.programs import (LAC, lac_feed, lac_program,
                                                 lac_train_flops)

    cfg = LAC
    main, startup, _, v = lac_program(fluid, cfg)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    feeds = [lac_feed(cfg, SEED + i) for i in range(STEPS + 1)]
    staged = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    return (FluidStep(exe, main, scope, [v["loss"]]), staged, None,
            {"batch": cfg.batch, "seq_len": cfg.seq_len, "dtype": "float32",
             "optimizer": "adam(1e-3), lr factors emb 5, crfw 0.2",
             "train_flops_per_step": lac_train_flops(cfg),
             "feed": "numpy, copied to the card by Executor.run"})


class DygraphStep:
    """A dygraph training step as a trainer: ``step(batch, lr)`` runs
    ``tools/programs.py``'s ``dygraph_resnet_step`` under a guard on the
    card (``lr`` unused: the optimizer holds its schedule)."""

    def __init__(self, fluid, net, opt):
        self.fluid, self.net, self.opt = fluid, net, opt

    def step(self, batch, lr=None):
        from paddle_tpu_torch.tools.programs import dygraph_resnet_step

        dy = self.fluid.dygraph
        with dy.guard():
            loss, _ = dygraph_resnet_step(self.fluid, self.net, self.opt,
                                          dy.to_variable(batch["img"]),
                                          dy.to_variable(batch["label"]))
        return loss


def _dygraph_resnet():
    """The dygraph ResNet-50 (``tools/programs.py`` ``DYGRAPH_RESNET50``)
    with Momentum over ``PiecewiseDecay``, the seeded batches staged on the
    card."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.programs import (
        DYGRAPH_RESNET50, dygraph_resnet, dygraph_resnet_feed,
        dygraph_resnet_optimizer, dygraph_resnet_train_flops)

    cfg = DYGRAPH_RESNET50
    with fluid.dygraph.guard():
        net = dygraph_resnet(fluid, cfg)
    feeds = [dygraph_resnet_feed(cfg, SEED + i) for i in range(STEPS + 1)]
    staged = {k: torch.from_numpy(np.stack([f[i] for f in feeds])).cuda()
              for i, k in enumerate(("img", "label"))}
    return (DygraphStep(fluid, net, dygraph_resnet_optimizer(fluid)), staged,
            None, {"batch": cfg.batch, "image": cfg.image, "dtype": "float32",
                   "optimizer": "momentum(piecewise 0.1, 0.9), dygraph",
                   "train_flops_per_step": dygraph_resnet_train_flops(cfg),
                   "feed": "seeded batches staged on the card"})


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
    if model.startswith(BOOK_PREFIX):
        trainer, staged, lr, extra = _book(model[len(BOOK_PREFIX):])
    else:
        trainer, staged, lr, extra = {"bert": _bert, "resnet50": _resnet50,
                                      "deepfm": _deepfm, "nmt": _nmt,
                                      "lenet": _lenet,
                                      "fluid_encoder": _fluid_encoder,
                                      "crnn_ctc": _crnn_ctc,
                                      "lac": _lac,
                                      "dygraph_resnet": _dygraph_resnet}[model]()
    batches = [{k: v[i] for k, v in staged.items()} for i in range(STEPS + 1)]
    trainer.step(batches[0], lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=model == "nmt") as prof:
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
    if model == "nmt":
        groups = _nmt_op_groups(prof, trainer.cfg.tgt_vocab)
        us, n = (sum(v[i] for v in groups.values()) for i in (0, 1))
        groups["not charged to an op"] = [
            busy_us - us, sum(e.count for e in kernels) - n]
    else:
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
               "launches_per_step": sum(e.count for e in kernels) / STEPS,
               "note": "wall time includes the profiler's own cost", **extra}
    if model == "resnet50":
        summary["bn_kernels_device_ms_per_step"] = sum(
            us for g, (us, _) in groups.items() if g.startswith("port:bn")) / 1e3 / STEPS
    print(json.dumps(summary))
    if model == "nmt":
        profile_nmt_decode(card, trainer.state["params"], trainer.cfg)
    del trainer, staged, batches
    torch.cuda.empty_cache()
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(GROUPS), default=None,
                    help="profile one model (default: all but the book), or "
                         "'book': each book-suite model in turn")
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
    if args.model == "book":
        from paddle_tpu_torch.tools.book_suite import MODELS

        models = [BOOK_PREFIX + m for m in MODELS]
    else:
        models = ([args.model] if args.model
                  else ["bert", "resnet50", "deepfm", "nmt", "lenet"])
    for model in models:
        profile_model(model, card, args.trace)


if __name__ == "__main__":
    main()
