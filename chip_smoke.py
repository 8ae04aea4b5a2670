#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``paddle_tpu_torch/kernels/csrc`` with
``nvcc`` (into the ignored ``build/kernels``), then:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit;
2. build: seconds; each kernel's registers, shared memory, stack and
   spills; the HMMA (tensor-core) instructions in each kernel's SASS, from
   ``cuobjdump -sass`` (the run fails unless every instantiation of the
   tensor-core kernels, ``TENSOR_CORE_KERNELS``, holds some);
3. every kernel against its plain PyTorch version at the BERT-base shapes
   (the plain version in f32 on the card, from the same bf16 inputs; the
   flash forward's f32 route too), and the ``[B, S, H, D]`` entry at
   D = 128 through autograd, with the error beside the stated tolerance and,
   for the kernels with two routes, the route that ran ("mma" tensor
   cores for bf16, "fma" f32 FMAs; for the LayerNorm backward "vec16"
   16-byte vectors or "scalar");
   the LayerNorm backward also at E = 100 (scalar route) and E = 1024, each
   twice, which must give the same bits;
4. the slice: ``build_bert_trainer(bert_base_config(), optimizer=lamb())``
   on the card (bf16, 12 x 768, vocab 30528, S = 512, B = 64), a warm-up
   step and timed steps; every kernel's launch count must rise by exactly
   its per-step count (0 for the batch-norm, segment and wgrad kernels);
   tokens/s, ms/step, peak memory and MFU;
5. whole-step parity: one f32 step at full widths (B = 2) through the
   kernels on the card and through the plain versions on the CPU, from the
   same weights and batch: the loss and every gradient leaf; then the
   times of each kernel, its plain version and the library call that
   computes the same function, with CUDA events, beside the kernel's bound
   (the flash forward's and backward's bf16 routes and their f32 routes at
   the same shape);
6. the batch-norm kernels against their plain versions at ResNet-50's
   largest bottleneck shape and its widest one, bf16 and f32, a ragged row
   count, and ``fused_bn_train`` / ``fused_scale_shift`` through autograd
   against the same functions on the CPU; the two reductions (statistics,
   backward reduce) give the same bits on a second call and leave their
   workspace's counters at 0;
7. the ResNet slice: ``build_resnet_trainer(resnet50_config(fuse_bn=True),
   optimizer=momentum(0.9))`` on the card (bf16, 224 x 224, B = 128,
   lr 1e-2), a warm-up step and timed steps; each batch-norm kernel's launch
   count must rise by exactly 53 a step and the others not at all;
   images/s, ms/step, peak memory and MFU;
8. ResNet whole-step parity: one f32 ResNet-50 step at 224, B = 2, through
   the kernels on the card and the plain versions on the CPU, from the same
   weights and batch: the loss, every gradient leaf and the new BN state;
9. times of the batch-norm kernels at both shapes and at ResNet-50's two
   smallest views, (6272, 512) and (25088, 256), beside their plain
   versions and library calls, as in 5, with each call's device time
   (``torch.profiler``) and stream time (a CUDA graph's replay) beside the
   CUDA-event time (``tools/bn_times.py``);
10. the segment-sum kernel against its plain version at the DeepFM step's
    shape (N = 8192 x 39 ids, D = 11), f32 and bf16, in four cases: ids
    uniform in [0, 1M), heavy duplicates, one id N times, 20 ids out of
    range; then runs crossing several tiles from mid-tile (also at D = 8
    and at D = 256, eight 32-column chunks), N = 1 and N off the 256-row
    tile; row ids must be exactly equal and a second call give the same
    bits;
11. the DeepFM slice: ``build_deepfm_trainer(DeepFMConfig(),
    variant="segment")`` on the card (f32, 1M features, 39 fields, embed 10,
    MLP 400-400-400, B = 8192, SGD lr 1e-3), a warm-up step and timed steps;
    the segment kernel's count must rise by exactly 1 a step and the others
    not at all; examples/s, ms/step, peak memory and MFU of the MLP; then
    all four step variants timed by ``autotune_step``;
12. DeepFM parity: one f32 ``segment`` step at full width through the
    kernel on the card and the plain versions on the CPU, from the same
    weights and batch (the loss, the touched table rows, the head); the
    four variants on the card against ``dense`` after one step; the
    synthetic AUC on the card;
13. ``conv2d``: its wgrad kernel against ``wgrad_plain`` at ResNet-50's
    eligible 3 x 3 shapes (B = 128, bf16), an f32 case, a k = 4 case, a
    k = 5 case at C, K = 72, 136 and a bf16 case at C = 36 (FMA route);
    the entry's forward and backward at both shapes on the card with the
    counts set to 0 (one wgrad launch per eligible backward, none for a
    stride-2 convolution); the autograd round trip against the CPU;
14. the flash backward at S = 1024 (B = 8, 12 heads, D = 64, bf16, causal
    and not), where the TPU takes its two-sweep backward, against its
    plain version;
15. the CUDA kernels one call of each kernel wrapper launches at the main
    paths' shapes, counted by ``torch.profiler``, with each one's device
    time: one for ``layer_norm_bwd``, the segment kernel and the two
    batch-norm reductions, or the run fails;
16. times of the segment kernel (CUDA events, with the device time by
    ``torch.profiler`` beside it and its library call's, since its wrapper
    is host-bound back to back), the wgrad kernel at both
    shapes (and its f32 route at 56 x 56), and the flash backward's dk/dv
    and dq kernels at S = 1024 (split by ``torch.profiler``; both routes),
    beside their plain versions, library calls and bounds;
17. the NMT training slice: ``build_nmt_trainer(NMTConfig(dtype=
    "bfloat16"))`` (vocab 32000 / 32000, 6 + 6 layers, hidden 512, 8 heads,
    FFN 2048) with SGD at lr 1e-4 on the card, B = 128, Ss = St = 128, the
    batch from ``wmt16_batch`` as ``bench.py``'s NMT line builds it; a
    warm-up step and timed steps, with no port kernel launched (the
    reference's NMT runs no Pallas kernel); tokens/s counted as
    B x (Ss + St) a step, as the bench counts them, ms/step, peak memory
    and MFU from ``nmt_train_flops``;
18. NMT serving: ``beam_search`` on that model (bf16, beam 4, alpha 0.6,
    max_len 128) answering 16 source sentences of the WMT16 test reader,
    padded to 128 with masks, after one warm-up decode; sentences/s, ms per
    decode step, peak memory; no port kernel launched;
19. NMT parity in f32 at full width, the same weights and batch on the card
    and through the plain run on the CPU: one training step at B = 2,
    Ss = St = 128 (the loss and every gradient leaf); ``beam_search`` at
    B = 2, beam 4, max_len 16, step by step: the beams must stay equal,
    unless they first part where the CPU's best K + 1 candidates lie
    within the score tolerance of each other (printed), and the scores
    agree; ``nmt_copy_decode_parity`` on the card above 0.9, the
    reference's threshold;
20. the LeNet slice (BASELINE config 1, the Fluid program mode): the book's
    LeNet (conv 5x5 x 20, pool 2; conv 5x5 x 50, pool 2; fc 10) with
    Adam(1e-3), built with ``import paddle_tpu_torch as fluid`` and run by
    ``fluid.Executor()`` on the card, f32, B = 64: the startup program,
    5 warm-up steps and 50 timed steps, each batch from the port's
    ``datasets/mnist.py`` (the synthetic stand-in unless the idx files are
    in the data home) through ``DataFeeder``, the loss and accuracy fetched
    as numpy as a user's loop does; ms/step and images/s; then
    ``tools/profile_step.py``'s ``lenet`` config: the step's device busy
    share and CUDA launches per step; no port kernel launched (the
    reference's LeNet runs no Pallas kernel);
21. LeNet parity: the port's f32 startup values (a CPU run) loaded into
    CPU and card scopes (``convert.scope_from_numpy``), in f32 and in
    float64; the test clone (``clone(for_test=True)``) on a held-out
    batch, then one SGD step (the loss, the accuracy, every
    ``<param>@GRAD`` fetched by name) and the parameters after 3 steps,
    card against CPU, with the ReLU inputs the two put on either side of 0
    counted; then LeNet + Adam(1e-3) on the card trained on the JAX
    package's synthetic digits (tests/test_models.py) until the accuracy
    reaches 0.9, within 150 steps; no port kernel launched;
22. the deploy path (BASELINE config 1 served): phase 20's trained LeNet
    saved by ``fluid.io.save_inference_model``; ``create_predictor`` on the
    card held to the CPU's predictor over the same files and to the
    training program's test clone at B = 1, 5 and 64; ``clone()`` shares
    the weight tensors; ``export_inference_model(poly_batch=True)`` and
    ``load_exported_model`` with buckets [1, 8, 64], one CUDA graph
    captured per bucket: B = 5 pads to 8 and slices back, the signature
    count stays 3 over 200 requests of mixed sizes, ``swap_state`` to the
    startup weights gives the fresh program's answers and a shape change is
    refused; ``metrics.Accuracy`` over the predictor's outputs equals the
    test clone's accuracy; one step through a one-device ``CompiledProgram``
    equals the plain program's; ms per request and requests/s at B = 1 and
    64 for both predictors, CUDA launches and device ms per request
    (``torch.profiler``), capture seconds per signature; no port kernel
    launched;
23. control flow: the program-mode While beam decode
    (``tools/programs.py``; the JAX package's tests/test_rnn_beam_ops.py:213)
    at NMT decode's width, 16 sentences, beam 4, V = 32000, T = 128, the
    [128, 16, 4, 32000] f32 probabilities (1.05 GB) made from a seed: its
    sentences equal a plain loop over ``beam_search_step`` /
    ``beam_backtrack`` on the card exactly, and at B 2, K 3, V 6, T 4 the
    CPU's; ms, CUDA launches and host syncs per iteration, the feed's copy
    timed apart; a ``cond`` in a trained program against the CPU's
    gradients and a ``Switch`` program against the CPU's values; no port
    kernel launched;
24. book training: each of the eleven book-suite programs of
    ``tools/book_suite.py`` (word2vec with softmax, hsigmoid and nce heads,
    the recommender, sentiment conv and stacked LSTM, semantic-role
    labelling at hidden 128 and depth 4, fit_a_line, ResNet-CIFAR depth 8,
    VGG, the RNN encoder-decoder: the builders' default widths, the JAX
    package's tests/test_book_models.py data, batch, optimizer, threshold
    and step budget) trained by ``fluid.Executor(fluid.CUDAPlace(0))`` to
    its threshold: the steps it took, ms per step on the host clock after
    warm-up, and from ``profile_step``'s ``book:<model>`` entry the CUDA
    launches and device-busy ms per step and the idle share; a model that
    misses its threshold fails the phase;
25. book parity: three f32 steps of each model on the card and on the CPU
    from the same values (nce's negatives fixed, VGG's dropout as in its
    test clone), ReLU flips counted; training-mode dropout's keep rate and
    scaling under both implementations on the card;
26. AMP: ResNet-CIFAR and word2vec under ``amp.decorate(Adam)`` on the
    card: the first loss against the card's f32 run and the CPU's bf16 run,
    masters, moments, LR state and batch-norm stats f32 and the gradients
    f32 after 5 steps, ``save_persistables`` / ``load_persistables`` in the
    JAX package's format with a bf16 persistable round-tripped bit for bit;
    no port kernel launched in 24-26;
27. sparse: the recommender (seven ``is_sparse`` tables, Adam) and word2vec
    with ``is_sparse=True`` under SGD on both ``merge_rows`` routes and with
    the dense gradient, from the same values: the segment kernel's launches
    on the kernel route (one per merging table a step: 7 for the
    recommender, 0 under SGD, whose sparse branch does not merge), the
    routes' tables and moments against each other and against the dense
    gradient, ms per step of each; its launches per step go into the
    segment kernel's record as ``sparse_executor_launches_per_step``;
28. op rules on the card: ``cast`` from f32 to uint8, int8 and int32 (NaN,
    infinities, 3e9 and other values out of range), to bool, f16 and bf16,
    ``fill_constant`` of out-of-range values, ``sequence_reverse`` with a
    length past T (f32, int32, bool), ``reduce_*`` over an empty ``dim``
    list, ``mean``, ``softmax`` and ``where`` on integer inputs,
    ``linear_chain_crf`` with a length past T and labels out of range,
    ``hierarchical_sigmoid`` and ``nce`` with labels out of range,
    ``batch_norm`` of int32, and one case of each of the 17 deterministic
    rules of ROADMAP Queue 1 item 3-A (the clips, ``sqrt``, ``sign``,
    ``elementwise_max`` / ``_mod``, ``weight_norm``, the nine optimizers,
    ``dpsgd`` at sigma 0, ``dgc_momentum`` before and after its ramp-up),
    each through the port's rule on CUDA tensors: the values equal the JAX
    rule's (written here as constants;
    ``tests/test_torch_op_rules_3a.py`` holds the CPU to the JAX package
    and to these constants on the same inputs) and the CPU's, with no
    device assert; no port kernel launched;
29. the op classes: every optimizer, clip, decay, initializer and
    weight-norm class of 3-A trains three steps of a small MLP on the card
    and on the CPU from the same values (losses and every persistable to
    1e-5 of the largest, RMSProp and Adadelta 1e-4 / 2e-4), and the
    truncated normal drawn on the card holds its support and first two
    moments at n = 1e5;
30. LeNet monitored: phase 20's LeNet, 50 steps after 5, with the monitor
    off, on, on with the sentinel (halt, sampled 1 in 8) and on with
    ``skip_batch``, four runs of each, interleaved (cuDNN deterministic):
    ms a step of each, the overheads of the medians, the losses of every
    run bit for bit those of the first run with the monitor off,
    ``scripts/trace_summary.py --timeline`` reading each monitored
    directory (55 steps, the sentinel's health samples);
31. the sentinel's drills on LeNet: ``nan_batch`` at the third step under
    ``halt`` raises ``NonFiniteError`` naming a tensor of the program, with
    a postmortem; under ``skip_batch`` the parameters equal a clean run's
    that never saw the batch, bit for bit, one skip counted;
    ``FLAGS_check_nan_inf`` names the tensor;
32. MemScope on LeNet: the plan's ledger (temp bytes from the allocator's
    peak), ``bytes_in_use`` above 0 and within ``bytes_limit``, the scope's
    owner bytes, the ``oom_step`` drill's postmortem with its memory
    section, and refuse mode at a configured 1 MB raising before the
    dispatch with the state unchanged; no port kernel launched in 30-32;
33. the book suite monitored: sentiment conv (dense), the recommender
    (sparse) and ResNet-CIFAR under AMP, 10 steps after 2 with the monitor
    off and on, four runs each, interleaved: ms a step and the overhead of
    the medians;
34. last, the profiler on the kernel path: phase 4's trainer, a warm-up
    step, then two steps under ``fluid.profiler.profiler()`` with the
    counts set to 0 (48 / 48 / 24 / 24 launches): the aggregate table must
    list ``ln_fwd_kernel``, ``ln_bwd_*_kernel``, ``flash_fwd_mma_kernel``
    and the three flash backward kernels, each with phase 15's CUDA kernels
    a call x its wrapper's launches a step x 2 calls (taken last: later
    card-only captures in the same process lost kernel records).

Phases 30-33 write their monitor directories under ``build/monitor``.
TF32 is switched off for matrix products and convolutions, so the f32
phases compare f32 with f32.  The last two lines are the kernels' JSON
record and ``{"ok": true, "device": {...}}``; any failure exits non-zero
without them.  Nothing here imports JAX or the JAX package.
"""

import json
import math
import re
import shutil
import subprocess
import sys
import time

import torch

# published peaks by card name: (bf16 dense tensor-core FLOP/s, device
# memory bytes/s).  MFU and every kernel's bound read the same entry.
# The third entry is the f32 rate of the CUDA cores (no tensor cores), the
# peak of the batch-norm kernels' elementwise arithmetic.
CARD_PEAKS = {"H100 80GB HBM3": (989e12, 3.35e12, 67e12)}      # H100 SXM
B, S = 64, 512                      # bench.py's BERT-base shapes
TIMED_STEPS = 5
PER_STEP = {"layer_norm_fwd": 24, "layer_norm_bwd": 24,
            "flash_attention_fwd": 12, "flash_attention_bwd": 12}
B_RN, IMAGE = 128, 224              # bench.py's ResNet-50 shapes
RN_PER_STEP = {"bn_stats": 53, "bn_scale_shift": 53, "bn_bwd_reduce": 53,
               "bn_dx": 53}         # one of each for every one of 53 BNs
RESNET50_FLOPS_PER_IMAGE = 3 * 4.09e9   # bench.py:259: fwd 4.09 GFLOP, train 3x
# [M, C] views timed and compared: the largest bottleneck BN (s0 conv3 /
# projection output at B = 128) and the fewest rows, widest channels (s3)
BN_SHAPES = ((401408, 256), (6272, 2048))
BN_SMALL_SHAPES = ((6272, 512), (25088, 256))   # its two smallest views
DFM_B, DFM_LR = 8192, 1e-3         # bench.py:969-974's DeepFM shapes
DFM_PER_STEP = {"segment_sum": 1}
AUTOTUNE_ITERS = 10
# conv2d's wgrad: ResNet-50's eligible 3x3 convolutions at B = 128, the
# widest-image (s0) and the widest-channel (s3) one: (B, H, W, C, K, k, pad)
CONV_SHAPES = ((128, 56, 56, 64, 64, 3, 1), (128, 7, 7, 512, 512, 3, 1))
FLASH_LONG = (8, 1024, 12, 64)      # B, S, heads, head dim
NMT_B, NMT_S, NMT_LR = 128, 128, 1e-4   # bench.py:612-613's NMT line
NMT_SERVE = dict(n=16, beam_size=4, max_len=128, alpha=0.6)
NMT_PARITY_B, NMT_PARITY_DECODE = 2, dict(beam_size=4, max_len=16)
# the tensor-core kernels: the build phase fails unless the SASS of every
# instantiation of each holds HMMA instructions
TENSOR_CORE_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dkv_mma_kernel",
                       "flash_bwd_dq_mma_kernel", "wgrad_mma_kernel")
SOURCES = {
    "layer_norm_fwd": ("paddle_tpu_torch/kernels/csrc/layer_norm.cu",
                       "paddle_tpu/kernels/layer_norm.py:36"),
    "layer_norm_bwd": ("paddle_tpu_torch/kernels/csrc/layer_norm.cu",
                       "paddle_tpu/kernels/layer_norm.py:47"),
    "flash_attention_fwd": ("paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                            "paddle_tpu/kernels/flash_attention.py:57"),
    "flash_attention_bwd": ("paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                            "paddle_tpu/kernels/flash_attention.py:239"),
    "bn_stats": ("paddle_tpu_torch/kernels/csrc/fused_bn.cu",
                 "paddle_tpu/kernels/fused_bn.py:80"),
    "bn_scale_shift": ("paddle_tpu_torch/kernels/csrc/fused_bn.cu",
                       "paddle_tpu/kernels/fused_bn.py:92"),
    "bn_bwd_reduce": ("paddle_tpu_torch/kernels/csrc/fused_bn.cu",
                      "paddle_tpu/kernels/fused_bn.py:97"),
    "bn_dx": ("paddle_tpu_torch/kernels/csrc/fused_bn.cu",
              "paddle_tpu/kernels/fused_bn.py:112"),
    "flash_attention_bwd_dq": ("paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                               "paddle_tpu/kernels/flash_attention.py:334"),
    "flash_attention_bwd_dkv": ("paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                                "paddle_tpu/kernels/flash_attention.py:376"),
    "segment_sum": ("paddle_tpu_torch/kernels/csrc/segment_update.cu",
                    "paddle_tpu/kernels/segment_update.py:59"),
    "conv_wgrad": ("paddle_tpu_torch/kernels/csrc/conv_wgrad.cu",
                   "paddle_tpu/kernels/conv.py:55"),
}
# tolerances on max|kernel - plain| / max|plain|: bf16 outputs carry a
# rounding of 2^-9 relative and the kernels round p and ds to bf16 where the
# f32 plain version does not; f32 outputs differ only in summation order
TOL_BF16, TOL_F32 = 2e-2, 1e-4
# whole-step parity (f32): loss relative error; per-leaf relative L2 of the
# gradients (the vocab-loss gradient is rounded to bf16 on both sides, and a
# value on a rounding edge may round apart: rare elements move by 2^-8)
TOL_LOSS, TOL_GRAD = 1e-5, 1e-3
# ResNet-50 whole-step parity (f32, B = 2).  The forward is well conditioned:
# on the CPU the port's f32 loss and BN state sit within 1e-6 of a float64
# run.  Its gradients are not: a few pre-activations lie within f32 rounding
# of 0, and where two f32 implementations (cuDNN and oneDNN convolutions)
# round them apart their ReLU masks differ; through every BN's channel-wide
# mean terms each such flip moves the gradients of all earlier layers.  On
# the CPU the f32 gradients sit 3.8e-2 (all leaves, relative L2) and up to
# 5.2e-2 (worst leaf) from float64 for that reason, while the fused and
# unfused f32 paths, which round the forward alike, agree to 1.5e-5.  A wrong
# pad, stride or backward formula moves them by O(1).  The kernels' own
# accuracy is held in the compare phase.
TOL_RN_LOSS, TOL_RN_STATE = 1e-5, 1e-4
TOL_RN_GRAD_ALL, TOL_RN_GRAD_LEAF = 0.1, 0.25
# DeepFM parity (f32, lr 1): the loss; the update (new - old) of the
# touched table rows and of each head leaf, as a relative L2 distance.  At
# the bench's lr 1e-3 an update is 1e-5 to 1e-7 of its weight, so f32's
# rounding of the new weight hides it; at lr 1 what is left is the f32
# gradients' own error (the MLP biases' gradients sum 8192 terms of both
# signs), which the phase prints as the CPU f32 step's distance from a
# float64 step on the same weights.  A wrong formula moves these by O(1).
# The variants against dense, on the card at lr 1 too: the new weights to
# the reference's own 1e-5 absolute (tests/test_segment_update.py), and,
# since at B = 8192 a table row moves by less than that even at lr 1, each
# update (the touched rows', each head leaf's) as a relative L2 distance.
# The variants merge duplicate ids in other orders, which moves an update
# by f32 rounding; a lost or mis-merged update moves it by O(0.1) or more.
TOL_DFM_LOSS, TOL_DFM_TABLE, TOL_DFM_HEAD, TOL_DFM_VARIANTS = 1e-5, 1e-3, 1e-2, 1e-5
TOL_DFM_VARIANTS_UPD = 1e-4
DFM_PARITY_LR = 1.0
# NMT parity (f32, B = 2, S = 128): the loss's relative error and each
# gradient leaf's relative L2 distance.  Both sides compute in f32 with no
# bf16 rounding and differ by summation order (cuBLAS against the CPU's
# products), a few 1e-6 a leaf, except where a pre-activation lies within
# f32 rounding of 0 and its ReLU mask flips between two f32 runs: at B = 2
# (about 20 real source tokens) one such flip in an encoder FFN moved the
# CPU's encoder leaves by up to 1.1e-3 from a float64 run, while the card's
# sat within 3.6e-6 of it.  1e-2 is ten such flips; a wrong formula moves a
# leaf by O(1).  The phase holds the card to the CPU's f32 and float64 runs
# and prints the CPU f32 run's own distance from float64 beside them.
# Decode scores, absolute: 16 steps add f32 log-probs of magnitude ~10,
# each off by summation order at the 1e-6 level, so the sums differ by
# ~1e-4 at most; 1e-3 leaves ten times that.  Where
# the two runs pick other beams, the CPU's best K + 1 candidates at that
# step must lie within this tolerance of each other: a near tie, not a
# fault.
TOL_NMT_LOSS, TOL_NMT_GRAD, TOL_NMT_SCORE = 1e-5, 1e-2, 1e-3
NMT_COPY_THRESHOLD = 0.9            # tests/test_models.py:60
# LeNet (B = 64, card against CPU from the same scope values), in f32 and
# in float64: the test clone's fetches, one SGD step's loss, accuracy and
# gradients, and the parameters after 3 SGD steps, to 1e-5 of the largest
# magnitude, the tolerance of tests/test_torch_lenet.py (cuDNN and the CPU
# sum the convolutions in other orders; TF32 is off).  Except in f32 where
# the devices disagree on the sign of a ReLU input, which the phase counts
# at each step and prints with the values: where a pre-activation cancels
# to within f32 rounding of 0 the two may put it on either side (on an
# H100, at one conv2 element of the second step's batch, the card gave
# -2.0e-9 where the CPU gave 1.9e-9), and one flipped mask drops or keeps
# a whole gradient term: that step's gradients parted by 4.7e-4 and the
# parameters after 3 steps by 2.3e-4, while the CPU's f32 run stayed
# within 5.3e-7 of float64 and the two float64 runs within 1e-15.  A step
# with a flip, and the parameters after it, are held to 1e-2 (tens of such
# flips; a wrong rule moves them by O(1)); the phase prints each f32 run's
# distance from the CPU's float64 run beside it.
# The book's contract: accuracy 0.9 within 150 Adam steps
# (tests/test_models.py).
LENET_B, LENET_WARMUP, LENET_TIMED = 64, 5, 50
LENET_TOL, LENET_F32_TRAJ_TOL = 1e-5, 1e-2
LENET_PARITY_STEPS, LENET_SGD_LR = 3, 0.05
LENET_ACC, LENET_MAX_STEPS = 0.9, 150
# The deploy phase: predictions of one set of weights through the card's
# predictors, the CPU's predictor and the training program's test clone,
# to 1e-5 of the largest magnitude (tests/test_torch_inference.py's
# tolerance: cuDNN and the CPU, or two batch sizes, sum the convolutions in
# other orders); a padded bucket's rows bit for bit against a run of the
# padded batch; the one-device CompiledProgram step against the plain
# program's to 1e-6 (the same ops on the same card; cuDNN's weight-gradient
# algorithm may add in another order between two runs).
DEPLOY_BUCKETS, DEPLOY_MIXED, DEPLOY_TIMED = [1, 8, 64], 200, 100
DEPLOY_TOL, DEPLOY_STEP_TOL = 1e-5, 1e-6
# The While decode at NMT decode's width (phase 18: 16 sentences, beam 4,
# vocab 32000, 128 steps), and the small case held to the CPU; the cond
# program's one-step gradients to 1e-5 (tests/test_torch_control_flow.py's
# tolerance), the Switch's values exactly.
DECODE_T, DECODE_B, DECODE_K, DECODE_V = 128, 16, 4, 32000
DECODE_SMALL = (4, 2, 3, 6)
COND_TOL, COND_STEPS = 1e-5, 4
# The book suite (phases 24-27, tools/book_suite.py: the JAX package's
# tests/test_book_models.py data, batches, optimizers, thresholds and step
# budgets, at the builders' default widths).  Phase 24 times BOOK_TIMED
# steps after BOOK_WARMUP more, past each model's threshold run.  Phase 25
# holds the card to the CPU over BOOK_PARITY_STEPS f32 steps from the same
# values, with nce's negatives and VGG's dropout pinned: each step's loss
# and the SGD-trained parameters and the sparse tables to 1e-5 of the
# largest magnitude (tests/test_torch_book.py's tolerance); under Adam, the
# elements whose CPU gradient stayed above BOOK_SMALL_G in every step to
# 1e-5 absolute (VGG: 1e-4, as in the test — convs and batch norms over a
# small batch, whose f32 gradients are ill-conditioned), and the others,
# where the gradient is rounding noise and Adam moves an element by
# lr * sign(noise), to 2 * lr a step.  Where the devices put a ReLU input
# on either side of 0 (counted over the global block's relu ops at every
# step) the f32 trajectory parts, as phase 21's LeNet did: its losses are
# then held to BOOK_FLIP_TOL and Adam's parameters to 2 * lr a step, and
# the same program runs in float64 on both devices, held to the strict
# tolerances above (the image nets: on the H100 both flipped at the first
# step, 1 and 4 ReLU inputs, and 1,779 and 8,637 by the third).  Dropout
# in training mode: the kept share within 5 standard errors
# of 1 - p over BOOK_DROPOUT_N values, and the kept values scaled as its
# implementation says, exactly.
BOOK_WARMUP, BOOK_TIMED = 2, 10
BOOK_PARITY_STEPS, BOOK_TOL, BOOK_TOL_VGG = 3, 1e-5, 1e-4
BOOK_SMALL_G, BOOK_FLIP_TOL = 1e-5, 1e-2
BOOK_DROPOUT_N, BOOK_DROPOUT_P = 1 << 20, 0.2
# AMP (phase 26): 5 steps under amp.decorate(Adam); the first step's loss
# against the card's f32 run and the CPU's bf16 run of the same program to
# AMP_LOSS_TOL (relative): each op rounds its result to bf16 (2^-8
# relative), and cuBLAS and the CPU accumulate the bf16 products in other
# orders, so the two bf16 runs part by a few roundings, and bf16 against
# f32 by about as much (tests/test_torch_amp.py holds JAX's bf16 step to
# the port's at the same 2e-2).
AMP_STEPS, AMP_LOSS_TOL = 5, 2e-2
AMP_MODELS = ("image_resnet", "word2vec_softmax")
# Sparse (phase 27): the same values on the default merge route
# (via="xla"), on the segment kernel's route (PADDLE_TPU_SEGMENT_KERNEL=1)
# and with is_sparse=False.  After the first step (the sparse step), every
# table, moment and parameter of the two routes to SPARSE_ROUTE_TOL of the
# largest magnitude (the kernel sums each run of equal ids in another
# order than index_add_'s atomics: on the H100 up to 3.9e-7 in a first
# moment over three runs), Adam's second moments, which hold g^2 and so
# twice g's relative rounding, to 2 x SPARSE_ROUTE_TOL (6.6e-7 seen, in
# the 2-row gender table, each row a sum of ~128 samples), and the sparse
# path against the dense
# gradient to BOOK_TOL; the launches counted over SPARSE_STEPS steps, and
# the distance after them printed, not held: it grows through the dense
# layers' Adam updates (on the H100, 1.3e-6 to 2.1e-6 over 5 recommender
# steps, in fc biases, with the default route itself not deterministic);
# SPARSE_TIMED steps of each route timed.
SPARSE_STEPS, SPARSE_TIMED, SPARSE_ROUTE_TOL = 5, 20, 1e-6


def emit(obj):
    print(json.dumps(obj), flush=True)


def model_flops_per_token(cfg, seq):
    """Training (fwd+bwd = 3x fwd) matmul FLOPs per token (bench.py's)."""
    E, L, F, V = cfg.hidden, cfg.n_layers, cfg.ffn_hidden, cfg.vocab_size
    per_layer_fwd = 8 * E * E + 4 * E * F + 4 * seq * E
    head_fwd = 2 * E * V
    return 3 * (L * per_layer_fwd + head_fwd)


def card_peaks(name):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError("no published peaks known for %r" % name)


def bound_ms(device_name, flops, nbytes, peak="bf16"):
    """(operations, bytes) lower bounds in ms: flops over the card's bf16
    tensor-core or f32 CUDA-core peak, bytes over its memory rate."""
    bf16, rate, f32 = card_peaks(device_name)
    return (flops / (bf16 if peak == "bf16" else f32) * 1e3,
            nbytes / rate * 1e3)


def rel_err(got, want):
    got, want = got.detach().float(), want.float()
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def check(name, pairs, route=None):
    """pairs: (label, got, want, tol).  Prints and raises on a miss.
    ``route``: which of a kernel's two routes ran ("mma" tensor cores,
    "fma" f32 FMAs), where it has two."""
    worst = 0.0
    rows = []
    for label, got, want, tol in pairs:
        err, rel = rel_err(got, want)
        worst = max(worst, err)
        rows.append({"out": label, "max_abs_err": err, "max_rel_err": rel,
                     "tol": tol, "ok": rel <= tol})
    rec = {"phase": "compare", "kernel": name, "outputs": rows}
    if route:
        rec["route"] = route
    emit(rec)
    bad = [r["out"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("%s disagrees with its plain version: %s"
                             % (name, bad))
    return worst


def cuda_time(fn, iters=20, warmup=3):
    """Milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# -- phases ---------------------------------------------------------------

def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    peak_flops, peak_bytes, _ = card_peaks(name)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "peak_bf16_flops": peak_flops,
          "peak_bytes_per_s": peak_bytes})
    return name, smi.splitlines()[0]


def _kernel_name(mangled):
    """A short name from a mangled one: kernel<dtype, template ints>."""
    m = re.search(r"\d((?:flash|ln|bn|segsum|wgrad)_\w+?_kernel|wgrad_kernel)",
                  mangled)
    base = m.group(1) if m else mangled
    return "%s<%s>" % (base, ", ".join(
        ["bf16" if "bfloat16" in mangled else "f32"]
        + re.findall(r"Li(\d+)E", mangled)))


def _hmma_counts(path):
    """HMMA (tensor-core) instructions in each kernel's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = _kernel_name(m.group(1))
            counts[kernel] = 0
        elif kernel and re.search(r"\bHMMA\b", line):
            counts[kernel] += 1
    return counts


def phase_build():
    from paddle_tpu_torch.kernels import _common

    t0 = time.perf_counter()
    _common.load_library()
    summary, kernel, spills = [], None, None
    for line in _common.build_info["ptxas"]:
        if "Compiling entry function" in line:
            kernel, spills = _kernel_name(line.split("'")[1]), None
        elif "spill stores" in line:
            spills = line
        elif kernel and "Used" in line:
            summary.append({"kernel": kernel, "ptxas": line.split(":", 1)[1].strip(),
                            "stack_and_spills": spills})
    hmma = _hmma_counts(_common.build_info["path"])
    for name, n in sorted(hmma.items()):
        print("HMMA %5d  %s" % (n, name), flush=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _common.build_info["seconds"], "kernels": summary,
          "hmma": hmma})
    for base in TENSOR_CORE_KERNELS:
        inst = {n: c for n, c in hmma.items() if n.startswith(base + "<")}
        if not inst or not all(inst.values()):
            raise AssertionError("%s: no HMMA instruction in its SASS (%s)"
                                 % (base, inst))


def _ln_inputs(gen, N=B * S, E=768):
    x = (torch.randn(N, E, generator=gen, device="cuda") * 2 + 1).bfloat16()
    scale = torch.rand(E, generator=gen, device="cuda") + 0.5
    bias = torch.randn(E, generator=gen, device="cuda")
    dy = torch.randn(N, E, generator=gen, device="cuda").bfloat16()
    return x, scale, bias, dy


def _qkv(gen, shape):
    return [(torch.randn(*shape, generator=gen, device="cuda") * 0.5).bfloat16()
            for _ in range(4)]


def phase_compare():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    x, scale, bias, dy = _ln_inputs(gen)
    y, mu, rstd = ln.layer_norm_fwd(x, scale, bias, 1e-6)
    y_p, mu_p, rstd_p = ln.layer_norm_fwd_plain(x.float(), scale, bias, 1e-6)
    errs["layer_norm_fwd"] = check("layer_norm_fwd", [
        ("y", y, y_p, TOL_BF16), ("mu", mu, mu_p, TOL_F32),
        ("rstd", rstd, rstd_p, TOL_F32)])
    errs["layer_norm_bwd"] = 0.0
    # BERT-base's backward, a width off the 16-byte vectors (scalar route),
    # and E = 1024; each twice, which must give the same bits
    for E in (768, 100, 1024):
        if E != 768:
            x, scale, bias, dy = _ln_inputs(gen, E=E)
            _, mu, rstd = ln.layer_norm_fwd(x, scale, bias, 1e-6)
        dx, ds, db = ln.layer_norm_bwd(x, scale, dy, mu, rstd)
        again = ln.layer_norm_bwd(x, scale, dy, mu, rstd)
        dx_p, ds_p, db_p = ln.layer_norm_bwd_plain(x.float(), scale,
                                                   dy.float(), mu, rstd)
        route = ln._bwd_route(x, scale, dy)
        errs["layer_norm_bwd"] = max(errs["layer_norm_bwd"], check(
            "layer_norm_bwd:%dx%d" % tuple(x.shape), [
                ("dx", dx, dx_p, TOL_BF16), ("dscale", ds, ds_p, TOL_F32),
                ("dbias", db, db_p, TOL_F32)], route=route))
        same = all(torch.equal(u, v) for u, v in zip((dx, ds, db), again))
        emit({"phase": "compare", "kernel": "layer_norm_bwd:%dx%d" % tuple(
            x.shape), "route": route, "bit_identical_twice": same})
        if not same:
            raise AssertionError("layer_norm_bwd: two calls differ (E = %d)" % E)
        del dx, again, dx_p

    fwd_err = bwd_err = 0.0
    # the kernel wrappers on the main path's packed case and a causal case
    # (bf16: the tensor-core forward, whose lse feeds the backward)
    for label, shape, H, causal in (("packed", (B, S, 768), 12, False),
                                    ("packed_causal", (8, S, 768), 12, True)):
        q, k, v, do = _qkv(gen, shape)
        scale_ = (shape[-1] // H) ** -0.5
        o, lse = fa.flash_fwd(q, k, v, H, scale_, causal)
        f32 = [t.float() for t in (q, k, v)]
        o_p, lse_p = fa.flash_fwd_plain(*f32, H, scale_, causal)
        fwd_err = max(fwd_err, check("flash_attention_fwd:" + label, [
            ("o", o, o_p, TOL_BF16), ("lse", lse, lse_p, TOL_F32)],
            route=fa._fwd_route(q.dtype)))
        grads = fa.flash_bwd(q, k, v, o, lse, do, H, scale_, causal)
        grads_p = fa.flash_bwd_plain(*f32, o.float(), lse, do.float(), H,
                                     scale_, causal)
        bwd_err = max(bwd_err, check("flash_attention_bwd:" + label, [
            (n, g, gp, TOL_BF16) for n, g, gp in zip(("dq", "dk", "dv"),
                                                     grads, grads_p)],
            route=fa._bwd_route(q.dtype)))
        del q, k, v, do, o, lse, grads, grads_p, f32
    # the f32 forward (FMA route) at the main path's widths, B = 8
    q, k, v, _ = (t.float() for t in _qkv(gen, (8, S, 768)))
    o, lse = fa.flash_fwd(q, k, v, 12, 64 ** -0.5, False)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, 12, 64 ** -0.5, False)
    fwd_err = max(fwd_err, check("flash_attention_fwd:packed_f32", [
        ("o", o, o_p, TOL_F32), ("lse", lse, lse_p, TOL_F32)],
        route=fa._fwd_route(q.dtype)))
    del q, k, v, o, lse, o_p, lse_p
    # the [B, S, H, D] entry at D = 128, through autograd
    Bd, H, D = 8, 6, 128
    q, k, v, do = _qkv(gen, (Bd, S, H, D))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*leaves)
    grads = torch.autograd.grad(o, leaves, do)
    packed = [t.float().reshape(Bd, S, H * D) for t in (q, k, v, do)]
    o_p, lse_p = fa.flash_fwd_plain(*packed[:3], H, D ** -0.5, False)
    grads_p = fa.flash_bwd_plain(*packed[:3], o_p, lse_p, packed[3], H,
                                 D ** -0.5, False)
    fwd_err = max(fwd_err, check("flash_attention_fwd:bshd_d128", [
        ("o", o.reshape(Bd, S, H * D), o_p, TOL_BF16)],
        route=fa._fwd_route(q.dtype)))
    bwd_err = max(bwd_err, check("flash_attention_bwd:bshd_d128", [
        (n, g.reshape(Bd, S, H * D), gp, TOL_BF16)
        for n, g, gp in zip(("dq", "dk", "dv"), grads, grads_p)],
        route=fa._bwd_route(q.dtype)))
    del q, k, v, do, leaves, o, grads, packed, o_p, grads_p
    errs["flash_attention_fwd"], errs["flash_attention_bwd"] = fwd_err, bwd_err
    torch.cuda.synchronize()
    return errs


def timed_steps(trainer, batches, lr, per_step):
    """Counts set to 0, a warm-up step, then the timed steps; every count
    must end at exactly its per-step count times the steps run (0 for a
    kernel the path does not run).  Returns (seconds, losses, counts)."""
    from paddle_tpu_torch.kernels import _common

    _common.reset_launches()
    trainer.step(batches[0], lr)                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [trainer.step(b, lr) for b in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_common.launches)

    losses = [float(l) for l in losses]
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError("non-finite loss: %s" % losses)
    want = {k: per_step.get(k, 0) * len(batches) for k in counts}
    if counts != want:
        raise AssertionError("launch counts %s, expected %s" % (counts, want))
    return dt, losses, counts


def _bert_slice():
    """Phase 4's trainer (BERT-base, bf16, LAMB) and TIMED_STEPS + 1 of its
    batches on the card."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import optim
    from paddle_tpu_torch.parallel.train import stack_batches

    cfg = bert.bert_base_config()
    trainer = bert.build_bert_trainer(cfg, optimizer=optim.lamb(), seed=0)
    staged = stack_batches(bert.synthetic_batches(cfg, TIMED_STEPS + 1, B, S),
                           trainer.device, bert.batch_specs())
    batches = [{k: v[i] for k, v in staged.items()} for i in range(TIMED_STEPS + 1)]
    return cfg, trainer, batches


def phase_slice(device_name):
    cfg, trainer, batches = _bert_slice()
    torch.cuda.reset_peak_memory_stats()
    dt, losses, counts = timed_steps(trainer, batches, 1e-4, PER_STEP)
    tok_s = B * S * TIMED_STEPS / dt
    peak_flops = card_peaks(device_name)[0]
    emit({"phase": "slice", "config": "bert_base", "batch": B, "seq": S,
          "steps_timed": TIMED_STEPS, "ms_per_step": dt / TIMED_STEPS * 1e3,
          "tokens_per_sec": tok_s,
          "mfu": tok_s * model_flops_per_token(cfg, S) / peak_flops,
          "peak_bf16_flops": peak_flops,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "losses": losses, "launches": counts})
    del trainer, batches
    torch.cuda.empty_cache()
    return {k: counts[k] for k in PER_STEP}


def phase_parity():
    from paddle_tpu_torch._tree import tree_leaves, tree_map
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.transformer import init_transformer_params

    cfg = bert.bert_base_config(dtype="float32")
    params = init_transformer_params(torch.Generator().manual_seed(1), cfg,
                                     device="cpu")
    batch = bert.synthetic_batches(cfg, 1, 2, S, seed=1)[0]
    loss_fn = bert.make_loss_fn(cfg)

    def run(device):
        p = tree_map(lambda t: t.to(device).requires_grad_(True), params)
        leaves = tree_leaves(p)
        loss = loss_fn(p, {k: torch.from_numpy(v).to(device)
                           for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), [g.detach().cpu() for g in grads]

    loss_k, grads_k = run("cuda")
    loss_p, grads_p = run("cpu")
    rels = [float((a - b).norm() / b.norm().clamp_min(1e-30))
            for a, b in zip(grads_k, grads_p)]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    ok = loss_rel <= TOL_LOSS and max(rels) <= TOL_GRAD
    emit({"phase": "parity", "config": "bert_base f32", "batch": 2, "seq": S,
          "loss_kernels": loss_k, "loss_plain_cpu": loss_p,
          "loss_rel_err": loss_rel, "tol_loss": TOL_LOSS,
          "grad_rel_l2_max": max(rels), "tol_grad": TOL_GRAD,
          "leaves": len(rels), "ok": ok})
    if not ok:
        raise AssertionError("whole-step parity failed")


def phase_times(errs, launches, device_name):
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = []

    def record(name, ms, plain_ms, library_ms, nbytes, flops, **extra):
        t_ops, t_bytes = bound_ms(device_name, flops, nbytes)
        src, rep = SOURCES[name]
        rec = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": launches[name], "max_abs_err": errs[name],
               "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library_ms, "bytes": nbytes, "flops": flops,
               **extra}
        emit({"phase": "times", **rec})
        out.append(rec)

    x, scale, bias, dy = _ln_inputs(gen)
    N, E = x.shape
    w16, b16 = scale.bfloat16(), bias.bfloat16()
    _, mean, rs = torch.ops.aten.native_layer_norm(x, [E], w16, b16, 1e-6)
    y, mu, rstd = ln.layer_norm_fwd(x, scale, bias, 1e-6)
    record("layer_norm_fwd",
           cuda_time(lambda: ln.layer_norm_fwd(x, scale, bias, 1e-6)),
           cuda_time(lambda: ln.layer_norm_fwd_plain(x, scale, bias, 1e-6)),
           cuda_time(lambda: F.layer_norm(x, (E,), w16, b16, 1e-6)),
           nbytes=2 * N * E * 2 + 2 * E * 4 + 2 * N * 4, flops=8 * N * E)
    lib = _common.load_library()
    route = ln._bwd_route(x, scale, dy)
    record("layer_norm_bwd",
           cuda_time(lambda: ln.layer_norm_bwd(x, scale, dy, mu, rstd)),
           cuda_time(lambda: ln.layer_norm_bwd_plain(x, scale, dy, mu, rstd)),
           cuda_time(lambda: torch.ops.aten.native_layer_norm_backward(
               dy, x, [E], mean, rs, w16, b16, [True, True, True])),
           nbytes=3 * N * E * 2 + E * 4 + 2 * N * 4 + 2 * E * 4,
           flops=12 * N * E, kernel_route=route,
           blocks_per_sm=lib.ptt_layer_norm_bwd_blocks_per_sm(
               E, 1, int(route == "vec16")))
    del x, dy, y

    H, D = 12, 64
    q, k, v, do = _qkv(gen, (B, S, H * D))
    sc = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, H, sc, False)
    heads = [t.view(B, S, H, D).transpose(1, 2) for t in (q, k, v)]
    io = B * S * H * D * 2
    fwd_flops = 4 * B * H * S * S * D
    # the main path's bf16 route (tensor cores), and the f32 route (FMAs) at
    # the same shape against its own bound
    ms = cuda_time(lambda: fa.flash_fwd(q, k, v, H, sc, False))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    fma = {"ms": cuda_time(lambda: fa.flash_fwd(q32, k32, v32, H, sc, False),
                           iters=5),
           **_bound(device_name, fwd_flops, 2 * (4 * io) + B * H * S * 4, "f32")}
    del q32, k32, v32
    record("flash_attention_fwd", ms,
           cuda_time(lambda: fa.flash_fwd_plain(q, k, v, H, sc, False), iters=5),
           cuda_time(lambda: F.scaled_dot_product_attention(*heads)),
           nbytes=4 * io + B * H * S * 4, flops=fwd_flops,
           kernel_route=fa._fwd_route(q.dtype),
           tensor_core_share=fwd_flops / (ms * 1e-3) / card_peaks(device_name)[0],
           fma_f32=fma)
    lq, lk, lv = (t.detach().requires_grad_() for t in heads)
    lo = F.scaled_dot_product_attention(lq, lk, lv)
    ldo = do.view(B, S, H, D).transpose(1, 2)
    # the bound counts the reference's 5 products; the kernels do 7 (dq
    # recomputes s and dp rather than sum across blocks by atomics), which
    # the tensor-core share counts
    ms = cuda_time(lambda: fa.flash_bwd(q, k, v, o, lse, do, H, sc, False))
    f32 = [t.float() for t in (q, k, v, o, do)]
    fma = {"ms": cuda_time(lambda: fa.flash_bwd(*f32[:4], lse, f32[4], H, sc,
                                                False), iters=5),
           **_bound(device_name, 10 * B * H * S * S * D,
                    2 * (8 * io) + B * H * S * 4, "f32")}
    del f32
    record("flash_attention_bwd", ms,
           cuda_time(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, H, sc, False),
                     iters=5),
           cuda_time(lambda: torch.autograd.grad(lo, (lq, lk, lv), ldo,
                                                 retain_graph=True)),
           nbytes=8 * io + B * H * S * 4, flops=10 * B * H * S * S * D,
           kernel_route=fa._bwd_route(q.dtype),
           tensor_core_share=14 * B * H * S * S * D / (ms * 1e-3)
           / card_peaks(device_name)[0],
           fma_f32=fma)
    return out


# -- ResNet-50 phases -----------------------------------------------------------

def _check_reduction_repeats(name, fn):
    """A one-launch BN reduction called twice: the same bits, and its
    workspace's counters back at 0 after each call."""
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.kernels import fused_bn as fbn

    first = [t.clone() for t in fn()]
    second = fn()
    torch.cuda.synchronize()
    counters = fbn._WORK[(torch.cuda.current_device(),
                          _common.stream_ptr(torch.device("cuda")))][1]
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    left = int(counters.abs().sum())
    emit({"phase": "compare", "kernel": name, "same_bits_over_two_calls": same,
          "counters_after": left})
    if not same or left:
        raise AssertionError("%s: two calls differ (%s) or the counters "
                             "were left at %d" % (name, not same, left))


def phase_compare_bn():
    """Each BN kernel against its plain version on the same inputs: the two
    timed shapes in bf16 and f32 and a ragged row count; then the autograd
    round trip against the same functions on the CPU."""
    from paddle_tpu_torch.kernels import fused_bn as fbn
    from paddle_tpu_torch.tools.bn_times import inputs as _bn_inputs

    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = dict.fromkeys(RN_PER_STEP, 0.0)
    cases = [(M, C, dt) for M, C in BN_SHAPES
             for dt in (torch.bfloat16, torch.float32)]
    cases.append((100003, 512, torch.bfloat16))          # ragged rows
    for M, C, dt in cases:
        x, dy, a, b, coefs = _bn_inputs(gen, M, C, dt)
        tol = TOL_BF16 if dt == torch.bfloat16 else TOL_F32
        tag = ":%dx%d:%s" % (M, C, str(dt).replace("torch.", ""))
        s, q = fbn.stats2(x)
        s_p, q_p = fbn.bn_stats_plain(x)
        errs["bn_stats"] = max(errs["bn_stats"], check("bn_stats" + tag, [
            ("sum", s, s_p, TOL_F32), ("sumsq", q, q_p, TOL_F32)]))
        _check_reduction_repeats("bn_stats" + tag, lambda: fbn.stats2(x))
        errs["bn_scale_shift"] = max(errs["bn_scale_shift"], check(
            "bn_scale_shift" + tag, [("y", fbn.scale_shift2(x, a, b),
                                      fbn.scale_shift_plain(x, a, b), tol)]))
        s1, s2 = fbn.bwd_reduce2(dy, x)
        s1_p, s2_p = fbn.bwd_reduce_plain(dy, x)
        errs["bn_bwd_reduce"] = max(errs["bn_bwd_reduce"], check(
            "bn_bwd_reduce" + tag, [("sum_dy", s1, s1_p, TOL_F32),
                                    ("sum_dy_x", s2, s2_p, TOL_F32)]))
        _check_reduction_repeats("bn_bwd_reduce" + tag,
                                 lambda: fbn.bwd_reduce2(dy, x))
        errs["bn_dx"] = max(errs["bn_dx"], check("bn_dx" + tag, [
            ("dx", fbn.dx2(dy, x, coefs), fbn.dx_plain(dy, x, coefs), tol)]))
        del x, dy, s, q, s1, s2
    # fused_bn_train then fused_scale_shift through autograd, f32, at the
    # widest timed shape: the kernels on the card against the plain
    # versions behind the same autograd functions on the CPU
    M, C = BN_SHAPES[1]
    x, w, _, _, _ = _bn_inputs(gen, M, C, torch.float32)
    x, w = x.view(2, -1, 7, C), w.view(2, -1, 7, C)
    scale = torch.rand(C, generator=gen, device="cuda") + 0.5
    bias = torch.randn(C, generator=gen, device="cuda")
    outs = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).detach().requires_grad_() for t in (x, scale, bias)]
        y, m, v = fbn.fused_bn_train(*leaves)
        z = fbn.fused_scale_shift(y, leaves[1], leaves[2])
        (z * w.to(dev)).sum().backward()
        outs.append([t.detach().cpu() for t in (z, m, v)]
                    + [t.grad.cpu() for t in leaves])
    check("fused_bn_train+fused_scale_shift:autograd", [
        (n, got, want, TOL_F32) for n, got, want in zip(
            ("y", "mean", "var", "dx", "dscale", "dbias"), *outs)])
    torch.cuda.synchronize()
    return errs


def phase_resnet_slice(device_name):
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.parallel import optim
    from paddle_tpu_torch.parallel.train import stack_batches

    cfg = resnet.resnet50_config(dtype="bfloat16", fuse_bn=True, image_size=IMAGE)
    trainer = resnet.build_resnet_trainer(cfg, optimizer=optim.momentum(0.9),
                                          seed=0)
    # images staged in bf16, as bench.py stages them on the chip
    staged = stack_batches(resnet.synthetic_batches(cfg, TIMED_STEPS + 1, B_RN),
                           trainer.device, {"image": torch.bfloat16})
    batches = [{k: v[i] for k, v in staged.items()} for i in range(TIMED_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats()
    dt, losses, counts = timed_steps(trainer, batches, 1e-2, RN_PER_STEP)
    img_s = B_RN * TIMED_STEPS / dt
    peak_flops = card_peaks(device_name)[0]
    emit({"phase": "slice", "config": "resnet50", "batch": B_RN,
          "image": IMAGE, "steps_timed": TIMED_STEPS,
          "ms_per_step": dt / TIMED_STEPS * 1e3, "images_per_sec": img_s,
          "mfu": img_s * RESNET50_FLOPS_PER_IMAGE / peak_flops,
          "peak_bf16_flops": peak_flops,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "losses": losses, "launches": counts})
    del trainer, staged, batches
    torch.cuda.empty_cache()
    return {k: counts[k] for k in RN_PER_STEP}


def phase_resnet_parity():
    from paddle_tpu_torch._tree import tree_leaves, tree_map
    from paddle_tpu_torch.models import resnet

    cfg = resnet.resnet50_config(dtype="float32", fuse_bn=True, image_size=IMAGE)
    params, state = resnet.init_resnet_params(torch.Generator().manual_seed(1),
                                              cfg, "cpu")
    batch = resnet.synthetic_batches(cfg, 1, 2, seed=1)[0]
    loss_fn = resnet.make_loss_fn(cfg)

    def run(device):
        p = tree_map(lambda t: t.to(device).requires_grad_(True), params)
        s = tree_map(lambda t: t.to(device), state)
        loss, new_state = loss_fn({"params": p, "_bn": s},
                                  {k: torch.from_numpy(v).to(device)
                                   for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tree_leaves(p))
        return (float(loss.detach()), [g.detach().cpu() for g in grads],
                [t.cpu() for t in tree_leaves(new_state)])

    loss_k, grads_k, state_k = run("cuda")
    loss_p, grads_p, state_p = run("cpu")
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))
    leaf = [rel(a, b) for a, b in zip(grads_k, grads_p)]
    every = float(math.sqrt(sum(float((a - b).square().sum())
                                for a, b in zip(grads_k, grads_p))
                            / sum(float(b.square().sum()) for b in grads_p)))
    states = [rel(a, b) for a, b in zip(state_k, state_p)]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    ok = (loss_rel <= TOL_RN_LOSS and max(states) <= TOL_RN_STATE
          and every <= TOL_RN_GRAD_ALL and max(leaf) <= TOL_RN_GRAD_LEAF)
    emit({"phase": "parity", "config": "resnet50 f32", "batch": 2,
          "image": IMAGE, "loss_kernels": loss_k, "loss_plain_cpu": loss_p,
          "loss_rel_err": loss_rel, "tol_loss": TOL_RN_LOSS,
          "grad_rel_l2_all_leaves": every, "tol_grad_all": TOL_RN_GRAD_ALL,
          "grad_rel_l2_max": max(leaf),
          "grad_rel_l2_median": sorted(leaf)[len(leaf) // 2],
          "tol_grad_leaf": TOL_RN_GRAD_LEAF, "bn_state_rel_l2_max": max(states),
          "tol_bn_state": TOL_RN_STATE, "leaves": len(leaf),
          "bn_state_leaves": len(states), "ok": ok})
    if not ok:
        raise AssertionError("ResNet whole-step parity failed")


def phase_times_bn(errs, launches, device_name):
    """Each BN kernel at both shapes and ResNet-50's two smallest views
    (bf16): CUDA-event and device (``torch.profiler``) ms a call, with its
    plain version and the PyTorch call that computes the same function (or
    the nearest one), from ``tools/bn_times.py``; the bound from this card's
    peaks."""
    from paddle_tpu_torch.tools import bn_times

    rows = {k: [] for k in RN_PER_STEP}
    for M, C in BN_SHAPES + BN_SMALL_SHAPES:
        for name, row in bn_times.shape_rows(M, C).items():
            t_ops, t_bytes = bound_ms(device_name, row["flops"], row["bytes"],
                                      peak="f32")
            row.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            emit({"phase": "times", "name": name, **row})
            rows[name].append(row)
    out = []
    for name, (first, *others) in rows.items():
        src, rep = SOURCES[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": launches[name],
                    "max_abs_err": errs[name], **first,
                    "other_shapes": others})
    return out


# -- DeepFM and conv2d phases ---------------------------------------------------

def _kernel_record(name, launches, err, **rec):
    src, rep = SOURCES[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": err, **rec}


def _bound(device_name, flops, nbytes, peak):
    t_ops, t_bytes = bound_ms(device_name, flops, nbytes, peak=peak)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _segment_ids(gen, case):
    """The DeepFM step's N = 8192 x 39 ids in one of the compared cases."""
    from paddle_tpu_torch.models import deepfm

    N, V = DFM_B * 39, deepfm.DeepFMConfig().num_features
    if case == "one_id":
        return torch.full((N,), 7, dtype=torch.int32, device="cuda"), V
    if case == "n1":
        return torch.full((1,), 7, dtype=torch.int32, device="cuda"), V
    if case == "ragged":                 # N off the kernel's 256-row tile
        N = 5 * 256 + 77
    if case == "spanning":
        # sorted-unique ids with a run of 3.5 tiles from mid-tile and a run
        # ending at a tile edge, shuffled
        ids = torch.arange(N, device="cuda", dtype=torch.int32) * 3
        ids[100:100 + 3 * 256 + 128] = 300
        ids[4 * 256 - 24:4 * 256] = 3 * (4 * 256 - 24)
        return ids[torch.randperm(N, generator=gen, device="cuda")], V
    hi = 100 if case == "dups" else V
    ids = torch.randint(0, hi, (N,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if case == "out_of_range":
        pos = torch.randperm(N, generator=gen, device="cuda")[:20]
        ids[pos] = V + torch.arange(20, device="cuda", dtype=torch.int32)
    return ids, V


def phase_compare_segment():
    """The segment kernel against its plain version: row ids exactly equal,
    values to TOL_F32 / TOL_BF16 of the largest, and a second call giving
    the same bits.  The DeepFM step's ids in four distributions, then runs
    crossing several tiles from mid-tile, N = 1, and N off the tile."""
    from paddle_tpu_torch.kernels import segment_update as seg

    gen = torch.Generator(device="cuda").manual_seed(6)
    err = 0.0
    cases = [(c, dt, 11) for c in ("bench", "dups", "one_id", "out_of_range",
                                   "spanning", "n1", "ragged")
             for dt in (torch.float32, torch.bfloat16)]
    cases.append(("spanning", torch.float32, 8))
    cases.append(("spanning", torch.float32, 256))     # 8 column chunks
    for case, dt, D in cases:
        ids, V = _segment_ids(gen, case)
        vals = torch.randn(ids.shape[0], D, generator=gen, device="cuda").to(dt)
        rows, out = seg.dedup_segment_sum(ids, vals, V)
        rows2, out2 = seg.dedup_segment_sum(ids, vals, V)
        rows_p, out_p = seg.segsum_plain(ids, vals, V)
        tag = "segment_sum:%s:N%d:D%d:%s" % (case, ids.shape[0], D,
                                             str(dt).replace("torch.", ""))
        same = bool(torch.equal(rows, rows_p))
        twice = bool(torch.equal(out, out2) and torch.equal(rows, rows2))
        emit({"phase": "compare", "kernel": tag, "out_rows_equal": same,
              "bit_identical_twice": twice})
        if not same:
            raise AssertionError("segment_sum: out_rows differ (%s)" % tag)
        if not twice:
            raise AssertionError("segment_sum: two calls differ (%s)" % tag)
        err = max(err, check(tag, [
            ("values", out, out_p,
             TOL_BF16 if dt == torch.bfloat16 else TOL_F32)]))
        del ids, vals, rows, out, rows2, out2, rows_p, out_p
    torch.cuda.synchronize()
    return err


def phase_deepfm_slice(device_name):
    from paddle_tpu_torch.models import deepfm

    cfg = deepfm.DeepFMConfig()
    trainer = deepfm.build_deepfm_trainer(cfg, variant="segment", seed=0)
    batch = {k: torch.from_numpy(v).to(trainer.device)
             for k, v in deepfm.synthetic_batch(cfg, DFM_B).items()}
    torch.cuda.reset_peak_memory_stats()
    # the bench's one batch, taken every step
    dt, losses, counts = timed_steps(trainer, [batch] * (TIMED_STEPS + 1),
                                     DFM_LR, DFM_PER_STEP)
    ex_s = DFM_B * TIMED_STEPS / dt
    peak_flops = card_peaks(device_name)[0]
    emit({"phase": "slice", "config": "deepfm", "batch": DFM_B,
          "variant": "segment", "steps_timed": TIMED_STEPS,
          "ms_per_step": dt / TIMED_STEPS * 1e3, "examples_per_sec": ex_s,
          "mfu": ex_s / DFM_B * deepfm.mlp_train_flops(cfg, DFM_B) / peak_flops,
          "mlp_train_flops_per_step": deepfm.mlp_train_flops(cfg, DFM_B),
          "peak_bf16_flops": peak_flops,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "losses": losses, "launches": counts})
    variants = deepfm.make_step_variants(cfg, DFM_LR)
    winner, _, timings = deepfm.autotune_step(variants, trainer.state["params"],
                                              batch, AUTOTUNE_ITERS)
    emit({"phase": "autotune", "config": "deepfm", "batch": DFM_B,
          "iters": AUTOTUNE_ITERS, "autotune_step_ms": timings,
          "winner": winner})
    del trainer, batch, variants
    torch.cuda.empty_cache()
    return counts["segment_sum"]


def phase_deepfm_parity():
    from paddle_tpu_torch._tree import tree_leaves, tree_map
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.models.parity import deepfm_synthetic_auc

    cfg = deepfm.DeepFMConfig()
    params = deepfm.init_deepfm_params(torch.Generator().manual_seed(1), cfg,
                                       "cpu")
    batch = deepfm.synthetic_batch(cfg, DFM_B, seed=1)
    step = deepfm.make_step_variants(cfg, DFM_PARITY_LR)["segment"]

    def run(device, dtype=torch.float32):
        p = tree_map(lambda t: t.to(device, dtype), params)
        new, loss = step(p, {k: torch.from_numpy(v).to(device)
                             for k, v in batch.items()})
        return float(loss), tree_map(lambda t: t.cpu().double(), new)

    loss_k, new_k = run("cuda")
    loss_p, new_p = run("cpu")
    _, new_64 = run("cpu", torch.float64)
    p0 = tree_map(lambda t: t.double(), params)
    touched = torch.unique(torch.from_numpy(batch["feat_ids"])).long()
    untouched = torch.ones(cfg.num_features, dtype=torch.bool)
    untouched[touched] = False
    f0 = deepfm.fuse_tables(p0)
    fk, fp, f64 = (deepfm.fuse_tables(t) for t in (new_k, new_p, new_64))
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-300))
    upd = lambda f: f[touched] - f0[touched]
    head = lambda t: tree_leaves({"mlp": t["mlp"], "bias": t["bias"]})
    head_upd = lambda t: [a - b for a, b in zip(head(t), head(p0))]
    table_rel, table_floor = rel(upd(fk), upd(fp)), rel(upd(fp), upd(f64))
    head_rel = [rel(a, b) for a, b in zip(head_upd(new_k), head_upd(new_p))]
    head_floor = [rel(a, b) for a, b in zip(head_upd(new_p), head_upd(new_64))]
    untouched_same = bool(torch.equal(fk[untouched], f0[untouched])
                          and torch.equal(fp[untouched], f0[untouched]))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    ok = (loss_rel <= TOL_DFM_LOSS and table_rel <= TOL_DFM_TABLE
          and max(head_rel) <= TOL_DFM_HEAD and untouched_same)
    emit({"phase": "parity", "config": "deepfm f32 segment step",
          "batch": DFM_B, "lr": DFM_PARITY_LR, "loss_kernels": loss_k,
          "loss_plain_cpu": loss_p, "loss_rel_err": loss_rel,
          "tol_loss": TOL_DFM_LOSS, "touched_rows": int(touched.numel()),
          "table_max_abs_err": float((fk[touched] - fp[touched]).abs().max()),
          "table_update_rel_l2": table_rel, "tol_table": TOL_DFM_TABLE,
          "table_update_rel_l2_cpu_f32_vs_f64": table_floor,
          "head_update_rel_l2": head_rel, "tol_head": TOL_DFM_HEAD,
          "head_update_rel_l2_cpu_f32_vs_f64": head_floor,
          "untouched_rows_unchanged": untouched_same, "ok": ok})
    if not ok:
        raise AssertionError("DeepFM whole-step parity failed")
    del new_k, new_p, new_64, fk, fp, f64, f0, p0

    # the four variants on the card against dense, one step from one tree
    variants = deepfm.make_step_variants(cfg, DFM_PARITY_LR)
    pc = tree_map(lambda t: t.cuda(), params)
    bc = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    ref, loss_ref = variants["dense"](pc, bc)
    tc = touched.cuda()
    step_upd = lambda t: [deepfm.fuse_tables(t)[tc] - deepfm.fuse_tables(pc)[tc]
                          ] + [a - b for a, b in zip(head(t), head(pc))]
    ref_upd = step_upd(ref)
    errs, upd_errs = {}, {}
    for name in ("fused", "rows", "segment"):
        out, loss = variants[name](pc, bc)
        errs[name] = max([abs(float(loss) - float(loss_ref))] + [
            float((a - b).abs().max()) for a, b in zip(tree_leaves(out),
                                                      tree_leaves(ref))])
        upd_errs[name] = max(rel(a.double(), b.double()) for a, b in
                             zip(step_upd(out), ref_upd))
        del out
    auc = deepfm_synthetic_auc(device="cuda")
    ok = (max(errs.values()) <= TOL_DFM_VARIANTS
          and max(upd_errs.values()) <= TOL_DFM_VARIANTS_UPD and auc > 0.95)
    emit({"phase": "parity", "config": "deepfm variants vs dense (card)",
          "lr": DFM_PARITY_LR, "max_abs_err": errs, "tol": TOL_DFM_VARIANTS,
          "update_rel_l2": upd_errs, "tol_update": TOL_DFM_VARIANTS_UPD,
          "synthetic_auc": auc, "auc_threshold": 0.95, "ok": ok})
    if not ok:
        raise AssertionError("DeepFM variants or AUC failed")
    del pc, ref
    torch.cuda.empty_cache()


def phase_compare_conv():
    """conv_wgrad against wgrad_plain; the conv2d entry at ResNet-50's
    shapes with the counts set to 0; the autograd round trip vs the CPU.
    Returns (max abs err, conv_wgrad launches of the entry's run)."""
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.kernels import conv as pconv

    gen = torch.Generator(device="cuda").manual_seed(7)
    mk = lambda *shape, dt: torch.randn(*shape, generator=gen,
                                        device="cuda").to(dt)
    err = 0.0
    cases = [(s, torch.bfloat16) for s in CONV_SHAPES] + [
        ((32, 28, 28, 128, 128, 3, 1), torch.float32),
        ((32, 14, 14, 64, 64, 4, 2), torch.bfloat16),
        ((16, 15, 13, 72, 136, 5, 2), torch.bfloat16),   # ragged tiles
        ((16, 14, 14, 36, 64, 3, 1), torch.bfloat16)]    # C % 8: FMA route
    for (B_, H, W, C, K, k, pad), dt in cases:
        x, dy = mk(B_, H, W, C, dt=dt), mk(B_, H, W, K, dt=dt)
        # both sides sum the same (bf16) products in f32, in other orders
        err = max(err, check("conv_wgrad:%dx%dx%dx%d->%d:k%d:%s" % (
            B_, H, W, C, K, k, str(dt).replace("torch.", "")), [
                ("dw", pconv.conv_wgrad(x, dy, k, pad),
                 pconv.wgrad_plain(x, dy, k, pad), TOL_F32)],
            route=pconv._wgrad_route(dt, C, K)))
        del x, dy

    # the entry at full width: forward and backward of each eligible
    # ResNet-50 shape, then a stride-2 3x3 (ineligible: no wgrad launch)
    ins = []
    for B_, H, W, C, K, k, _ in CONV_SHAPES:
        ins.append((mk(B_, H, W, C, dt=torch.bfloat16).requires_grad_(),
                    (mk(k, k, C, K, dt=torch.float32) * 0.05).bfloat16()
                    .requires_grad_(), 1))
    ins.append((ins[0][0], mk(3, 3, 64, 64, dt=torch.bfloat16).requires_grad_(),
                2))
    _common.reset_launches()
    for x, w, stride in ins:
        y = pconv.conv2d(x, w, stride, "SAME")
        gx, gw = torch.autograd.grad(y, (x, w), torch.ones_like(y))
        if not (torch.isfinite(gx).all() and torch.isfinite(gw).all()):
            raise AssertionError("conv2d: non-finite gradients")
    torch.cuda.synchronize()
    counts = dict(_common.launches)
    want = {k: (len(CONV_SHAPES) if k == "conv_wgrad" else 0) for k in counts}
    emit({"phase": "conv2d", "shapes": [list(s) for s in CONV_SHAPES],
          "ineligible": "stride 2", "launches": counts})
    if counts != want:
        raise AssertionError("conv2d launch counts %s, expected %s"
                             % (counts, want))
    del ins, y, gx, gw

    # autograd round trip, f32 (TF32 off): the card against the CPU
    rng = torch.Generator().manual_seed(8)
    for shape, pad in (((4, 16, 16, 64, 48, 3), "SAME"),
                       ((2, 12, 12, 32, 40, 4), ((2, 1), (2, 1)))):
        B_, H, W, C, K, k = shape
        x = torch.randn(B_, H, W, C, generator=rng)
        w = torch.randn(k, k, C, K, generator=rng) * 0.1
        dy = torch.randn(B_, H, W, K, generator=rng)
        outs = []
        for dev in ("cuda", "cpu"):
            xs, ws = (t.to(dev).requires_grad_() for t in (x, w))
            y = pconv.conv2d(xs, ws, 1, pad)
            dx, dw = torch.autograd.grad(y, (xs, ws), dy.to(dev))
            outs.append([t.detach().cpu() for t in (y, dx, dw)])
        check("conv2d:autograd:k%d" % k, [
            (n, a, b, TOL_F32) for n, a, b in zip(("y", "dx", "dw"), *outs)])
    torch.cuda.synchronize()
    return err, counts["conv_wgrad"]


def phase_compare_flash_long():
    """The flash kernels at S = 1024, where the TPU runs its two-sweep
    backward, against their plain versions."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(9)
    Bl, Sl, H, D = FLASH_LONG
    err = 0.0
    for causal in (False, True):
        q, k, v, do = _qkv(gen, (Bl, Sl, H * D))
        sc = D ** -0.5
        tag = ":S%d%s" % (Sl, "_causal" if causal else "")
        o, lse = fa.flash_fwd(q, k, v, H, sc, causal)
        f32 = [t.float() for t in (q, k, v)]
        o_p, lse_p = fa.flash_fwd_plain(*f32, H, sc, causal)
        check("flash_attention_fwd" + tag, [("o", o, o_p, TOL_BF16),
                                            ("lse", lse, lse_p, TOL_F32)],
              route=fa._fwd_route(q.dtype))
        grads = fa.flash_bwd(q, k, v, o, lse, do, H, sc, causal)
        grads_p = fa.flash_bwd_plain(*f32, o.float(), lse, do.float(), H, sc,
                                     causal)
        err = max(err, check("flash_attention_bwd" + tag, [
            (n, g, gp, TOL_BF16) for n, g, gp in zip(("dq", "dk", "dv"),
                                                     grads, grads_p)],
            route=fa._bwd_route(q.dtype)))
        del q, k, v, do, o, lse, f32, o_p, lse_p, grads, grads_p
    torch.cuda.empty_cache()
    return err


def device_ms(fn, calls=10):
    """Device milliseconds per call of ``fn``, all its CUDA kernels summed
    (torch.profiler)."""
    from paddle_tpu_torch.tools.profile_step import cuda_kernels_per_call

    return sum(ms for _, ms in cuda_kernels_per_call(fn, calls).values())


def _device_ms_by_kernel(fn, calls, keys):
    """Device ms per call of each kernel whose name holds one of ``keys``,
    from torch.profiler over ``calls`` calls."""
    from paddle_tpu_torch.tools.profile_step import cuda_kernels_per_call

    per = cuda_kernels_per_call(fn, calls)
    out = {k: sum(ms for name, (_, ms) in per.items() if k in name)
           for k in keys}
    if not all(out.values()):
        raise AssertionError("the profiler recorded no device time for %s"
                             % [k for k, t in out.items() if not t])
    return out


def phase_kernels_per_call():
    """The CUDA kernels one call of each kernel wrapper launches (fills
    included), by name with its device time, at the main paths' shapes:
    LayerNorm at BERT-base's [32768, 768] bf16, flash attention at its
    packed [64, 512, 768] bf16, the BN kernels at [401408, 256] bf16, the
    segment kernel at the DeepFM step's [319488, 11] f32 on pre-sorted ids,
    ``conv_wgrad`` at ResNet-50's 56 x 56 3 x 3 bf16.  Returns ({wrapper:
    kernels a call}, {wrapper: {kernel: (launches a call, device ms)}})."""
    from paddle_tpu_torch.kernels import conv as pconv
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_bn as fbn
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import segment_update as seg
    from paddle_tpu_torch.tools.bn_times import inputs as _bn_inputs
    from paddle_tpu_torch.tools.profile_step import cuda_kernels_per_call

    gen = torch.Generator(device="cuda").manual_seed(11)
    x, scale, bias, dy = _ln_inputs(gen)
    _, mu, rstd = ln.layer_norm_fwd(x, scale, bias, 1e-6)
    q, k, v, do = _qkv(gen, (B, S, 768))
    o, lse = fa.flash_fwd(q, k, v, 12, 0.125, False)
    bx, bdy, ba, bb, coefs = _bn_inputs(gen, *BN_SHAPES[0], torch.bfloat16)
    ids, V = _segment_ids(gen, "bench")
    vals = torch.randn(ids.shape[0], 11, generator=gen, device="cuda")
    keys, order = torch.sort(ids, stable=True)
    B_, H, W, C, K, kk, pad = CONV_SHAPES[0]
    cx = torch.randn(B_, H, W, C, generator=gen, device="cuda").bfloat16()
    cdy = torch.randn(B_, H, W, K, generator=gen, device="cuda").bfloat16()
    out, detail = {}, {}
    for name, fn in (
            ("layer_norm_fwd", lambda: ln.layer_norm_fwd(x, scale, bias, 1e-6)),
            ("layer_norm_bwd", lambda: ln.layer_norm_bwd(x, scale, dy, mu, rstd)),
            ("flash_attention_fwd", lambda: fa.flash_fwd(q, k, v, 12, 0.125, False)),
            ("flash_attention_bwd", lambda: fa.flash_bwd(q, k, v, o, lse, do, 12,
                                                         0.125, False)),
            ("bn_stats", lambda: fbn.stats2(bx)),
            ("bn_scale_shift", lambda: fbn.scale_shift2(bx, ba, bb)),
            ("bn_bwd_reduce", lambda: fbn.bwd_reduce2(bdy, bx)),
            ("bn_dx", lambda: fbn.dx2(bdy, bx, coefs)),
            ("segment_sum", lambda: seg._segsum_sorted(keys, order, vals, V)),
            ("conv_wgrad", lambda: pconv.conv_wgrad(cx, cdy, kk, pad))):
        per = detail[name] = cuda_kernels_per_call(fn)
        out[name] = sum(n for n, _ in per.values())
        emit({"phase": "kernels_per_call", "wrapper": name,
              "cuda_kernels_per_call": out[name],
              "kernels": {k_: {"per_call": n, "device_ms": ms}
                          for k_, (n, ms) in per.items()}})
    del x, dy, q, k, v, do, o, bx, bdy, ids, vals, keys, order, cx, cdy
    torch.cuda.empty_cache()
    return out, detail


def phase_times_new(errs, launches, device_name):
    """Times of the segment kernel (the DeepFM step's shape, f32), the
    wgrad kernel (both ResNet-50 shapes, bf16) and the flash backward's
    two sweeps at S = 1024 (bf16), beside plain versions, library calls and
    bounds (bytes read once and written once)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import conv as pconv
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import segment_update as seg

    gen = torch.Generator(device="cuda").manual_seed(10)
    out = []

    # segment sum: the kernel on pre-sorted ids; the sort on its own
    ids, V = _segment_ids(gen, "bench")
    N, Dv = ids.shape[0], 11
    vals = torch.randn(N, Dv, generator=gen, device="cuda")
    keys, order = torch.sort(ids, stable=True)
    first = torch.ones(N, dtype=torch.bool, device="cuda")
    first[1:] = keys[1:] != keys[:-1]
    pos = torch.arange(N, device="cuda")
    start = torch.where(first, pos, 0).cummax(0).values
    at_first = torch.empty_like(start).scatter_(0, order, start)
    lengths = torch.unique_consecutive(keys, return_counts=True)[1]
    sorted_vals = vals[order]
    one_keys = torch.full_like(keys, 7)
    kernel = lambda: seg._segsum_sorted(keys, order, vals, V)
    # index_add_ of every value into its run's first sorted position: the
    # same output values in one PyTorch call
    library = lambda: torch.zeros_like(vals).index_add_(0, at_first, vals)
    one_id = lambda: seg._segsum_sorted(one_keys, pos, vals, V)
    # ms, library_ms, one_id_ms: CUDA events around 20 calls, as in every
    # row; back to back the wrapper is bound by the host, so the kernels'
    # device time (torch.profiler) stands beside them as *device_ms
    rec = {"shape": [N, Dv],
           "ms": cuda_time(kernel),
           "device_ms": device_ms(kernel),
           "plain_ms": cuda_time(lambda: seg.segsum_plain(ids, vals, V)),
           "library_ms": cuda_time(library),
           "library_device_ms": device_ms(library),
           "sort_ms": cuda_time(lambda: torch.sort(ids, stable=True)),
           # torch.segment_reduce: the compacted layout, a different
           # function, from values already sorted
           "segment_reduce_ms": cuda_time(
               lambda: torch.segment_reduce(sorted_vals, "sum",
                                            lengths=lengths)),
           "one_id_ms": cuda_time(one_id),
           "one_id_device_ms": device_ms(one_id),
           **_bound(device_name, N * Dv, 4 * N + 8 * N + 2 * 4 * N * Dv + 4 * N,
                    "f32")}
    emit({"phase": "times", "name": "segment_sum", **rec})
    out.append(_kernel_record("segment_sum", launches["segment_sum"],
                              errs["segment_sum"], **rec))
    del ids, vals, keys, order, first, pos, start, at_first, sorted_vals

    # conv wgrad, bf16 in, f32 dw; the library call is cuDNN's wgrad alone
    rows = []
    for B_, H, W, C, K, k, pad in CONV_SHAPES:
        x = torch.randn(B_, H, W, C, generator=gen, device="cuda").bfloat16()
        dy = torch.randn(B_, H, W, K, generator=gen, device="cuda").bfloat16()
        wt = torch.zeros(K, C, k, k, device="cuda", dtype=torch.bfloat16
                         ).contiguous(memory_format=torch.channels_last)
        xt, dyt = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        lib = lambda: torch.ops.aten.convolution_backward(
            dyt, xt, wt, None, [1, 1], [pad, pad], [1, 1], False, [0, 0], 1,
            [False, True, False])
        flops = 2 * B_ * H * W * C * K * k * k
        row = {"shape": [B_, H, W, C, K, k],
               "kernel_route": pconv._wgrad_route(x.dtype, C, K),
               "ms": cuda_time(lambda: pconv.conv_wgrad(x, dy, k, pad)),
               "plain_ms": cuda_time(lambda: pconv.wgrad_plain(x, dy, k, pad),
                                     iters=5),
               "library_ms": cuda_time(lib),
               **_bound(device_name, flops,
                        2 * B_ * H * W * (C + K) + 4 * k * k * C * K, "bf16")}
        row["tensor_core_share"] = flops / (row["ms"] * 1e-3) / card_peaks(
            device_name)[0]
        if not rows:
            # the f32 route (FMAs) at the first shape, against its own bound
            x32, dy32 = x.float(), dy.float()
            row["fma_f32"] = {
                "ms": cuda_time(lambda: pconv.conv_wgrad(x32, dy32, k, pad),
                                iters=5),
                **_bound(device_name, flops,
                         4 * B_ * H * W * (C + K) + 4 * k * k * C * K, "f32")}
            del x32, dy32
        emit({"phase": "times", "name": "conv_wgrad", **row})
        rows.append(row)
        del x, dy, wt, xt, dyt
    out.append(_kernel_record("conv_wgrad", launches["conv_wgrad"],
                              errs["conv_wgrad"], **rows[0],
                              other_shapes=rows[1:]))

    # the flash backward at S = 1024: its dk/dv and dq sweeps, split by the
    # profiler; the plain and SDPA times cover the whole backward
    Bl, Sl, H, D = FLASH_LONG
    q, k_, v, do = _qkv(gen, (Bl, Sl, H * D))
    sc = D ** -0.5
    o, lse = fa.flash_fwd(q, k_, v, H, sc, False)
    bwd = lambda: fa.flash_bwd(q, k_, v, o, lse, do, H, sc, False)
    split = _device_ms_by_kernel(bwd, 5, ("flash_bwd_dkv_mma_kernel",
                                          "flash_bwd_dq_mma_kernel",
                                          "flash_delta_kernel"))
    # the f32 route's two FMA kernels at the same shape
    f32 = [t.float() for t in (q, k_, v, o, do)]
    split32 = _device_ms_by_kernel(
        lambda: fa.flash_bwd(*f32[:4], lse, f32[4], H, sc, False), 3,
        ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"))
    del f32
    heads = [t.view(Bl, Sl, H, D).transpose(1, 2) for t in (q, k_, v)]
    lq, lk, lv = (t.detach().requires_grad_() for t in heads)
    lo = F.scaled_dot_product_attention(lq, lk, lv)
    ldo = do.view(Bl, Sl, H, D).transpose(1, 2)
    whole = {"seq": Sl, "batch": Bl, "heads": H, "head_dim": D,
             "bwd_ms": cuda_time(bwd),
             "delta_ms": split["flash_delta_kernel"],
             "plain_ms": cuda_time(lambda: fa.flash_bwd_plain(
                 q, k_, v, o, lse, do, H, sc, False), iters=5),
             "library_ms": cuda_time(lambda: torch.autograd.grad(
                 lo, (lq, lk, lv), ldo, retain_graph=True)),
             "sdpa_fwd_ms": cuda_time(
                 lambda: F.scaled_dot_product_attention(*heads)),
             "note": "plain_ms and library_ms (SDPA's backward) are of the "
                     "whole backward; ms is this kernel's own device time"}
    io, rowsz = Bl * Sl * H * D * 2, Bl * H * Sl * 4
    s2 = Bl * H * Sl * Sl * D
    for name, key, flops, n_io in (
            # dq: recompute s, dp = do v^T, dq = ds k; reads q k v do lse
            # delta, writes dq
            ("flash_attention_bwd_dq", "flash_bwd_dq", 6 * s2, 5),
            # dk/dv: recompute s, dp, dv = p^T do, dk = ds^T q; reads q k v
            # do lse delta, writes dk dv
            ("flash_attention_bwd_dkv", "flash_bwd_dkv", 8 * s2, 6)):
        rec = {**whole, "ms": split[key + "_mma_kernel"],
               **_bound(device_name, flops, n_io * io + 2 * rowsz, "bf16"),
               "fma_f32": {"ms": split32[key + "_kernel"],
                           **_bound(device_name, flops,
                                    2 * n_io * io + 2 * rowsz, "f32")}}
        emit({"phase": "times", "name": name, **rec})
        out.append(_kernel_record(name, launches["flash_attention_bwd"],
                                  errs["flash_attention_bwd_long"], **rec))
    return out


# -- NMT phases -----------------------------------------------------------------

def assert_no_launches(phase):
    from paddle_tpu_torch.kernels import _common

    moved = {k: n for k, n in _common.launches.items() if n}
    if moved:
        raise AssertionError("%s launched port kernels: %s" % (phase, moved))


def phase_nmt_slice(device_name):
    """Returns (cfg, params after the timed steps)."""
    from paddle_tpu_torch._tree import tree_leaves
    from paddle_tpu_torch.datasets.wmt16 import wmt16_batch
    from paddle_tpu_torch.models import transformer_nmt as nmt

    cfg = nmt.NMTConfig(dtype="bfloat16")
    trainer = nmt.build_nmt_trainer(cfg, seed=0)
    batch = nmt.batch_to(wmt16_batch(cfg, NMT_B, NMT_S, NMT_S), trainer.device)
    torch.cuda.reset_peak_memory_stats()
    # the bench's one batch, taken every step; every count must stay 0
    dt, losses, counts = timed_steps(trainer, [batch] * (TIMED_STEPS + 1),
                                     NMT_LR, {})
    tok_s = NMT_B * 2 * NMT_S * TIMED_STEPS / dt
    flops = nmt.nmt_train_flops(cfg, NMT_B, NMT_S, NMT_S)
    peak_flops = card_peaks(device_name)[0]
    n_params = sum(t.numel() for t in tree_leaves(trainer.state["params"]))
    emit({"phase": "slice", "config": "transformer_nmt", "dtype": cfg.dtype,
          "batch": NMT_B, "src_len": NMT_S, "tgt_len": NMT_S,
          "parameters": n_params, "steps_timed": TIMED_STEPS,
          "ms_per_step": dt / TIMED_STEPS * 1e3, "tokens_per_sec": tok_s,
          "train_flops_per_step": flops,
          "mfu": flops * TIMED_STEPS / dt / peak_flops,
          "peak_bf16_flops": peak_flops,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "losses": losses, "launches": counts})
    params = trainer.state["params"]
    del trainer, batch
    torch.cuda.empty_cache()
    return cfg, params


def phase_nmt_serving(cfg, params):
    from paddle_tpu_torch.datasets.wmt16 import wmt16_batch
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.models import transformer_nmt as nmt

    n, K, T = NMT_SERVE["n"], NMT_SERVE["beam_size"], NMT_SERVE["max_len"]
    src = wmt16_batch(cfg, n, NMT_S, NMT_S, split="test")
    src_ids = torch.from_numpy(src["src_ids"]).cuda()
    src_mask = torch.from_numpy(src["src_mask"] > 0).cuda()
    decode = lambda: nmt.beam_search(params, src_ids, src_mask, cfg,
                                     beam_size=K, max_len=T,
                                     alpha=NMT_SERVE["alpha"])
    _common.reset_launches()
    decode()                                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seqs, scores = decode()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert_no_launches("NMT serving")
    ok = (tuple(seqs.shape) == (n, K, T) and tuple(scores.shape) == (n, K)
          and bool(torch.isfinite(scores).all())
          and bool((scores[:, :-1] >= scores[:, 1:]).all())
          and bool(((seqs >= 0) & (seqs < cfg.tgt_vocab)).all()))
    emit({"phase": "serving", "config": "transformer_nmt", "dtype": cfg.dtype,
          "sentences": n, "src_len": NMT_S, **NMT_SERVE,
          "seconds": dt, "sentences_per_sec": n / dt,
          "ms_per_decode_step": dt / T * 1e3,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "best_scores": scores[:, 0].tolist(), "ok": ok})
    if not ok:
        raise AssertionError("NMT serving: malformed beams")


def _first_parting(cfg, params, src_ids, src_mask, K, T):
    """Runs ``beam_search_steps`` on the card and the CPU side by side.
    Where the beams first part: {"step", "margin": the CPU's smallest gap
    between its best K + 1 candidates there, "err": the largest difference
    of the two runs' K best scores there}.  Else {"card", "cpu"}: the final
    states."""
    from paddle_tpu_torch._tree import tree_map
    from paddle_tpu_torch.models import transformer_nmt as nmt
    from paddle_tpu_torch.ops.beam_search_ops import beam_search_step

    runs = [nmt.beam_search_steps(tree_map(lambda t: t.to(dev), params),
                                  src_ids.to(dev), src_mask.to(dev), cfg,
                                  beam_size=K, max_len=T)
            for dev in ("cuda", "cpu")]
    for (t, _, _, card), (_, cur, before, cpu) in zip(*runs):
        if not torch.equal(card[0].cpu(), cpu[0]):
            sel, _, _ = beam_search_step(before[1], cur, K + 1, cfg.eos_id,
                                         before[2])
            # the K best scores themselves agree, whichever beams hold them
            return {"step": t,
                    "margin": float((sel[:, :-1] - sel[:, 1:]).min()),
                    "err": float((card[1].cpu() - cpu[1]).abs().max())}
    return {"card": card, "cpu": cpu}


def phase_nmt_parity():
    from paddle_tpu_torch._tree import tree_leaves, tree_map
    from paddle_tpu_torch.datasets.wmt16 import wmt16_batch
    from paddle_tpu_torch.models import transformer_nmt as nmt
    from paddle_tpu_torch.models.parity import nmt_copy_decode_parity
    from paddle_tpu_torch.parallel.train import grads_of

    cfg = nmt.NMTConfig()                                  # f32, full width
    params = nmt.init_nmt_params(torch.Generator().manual_seed(1), cfg)
    batch = wmt16_batch(cfg, NMT_PARITY_B, NMT_S, NMT_S)

    def step(device, dtype=torch.float32):
        p = tree_map(lambda t: t.to(device, dtype), params)
        loss, grads = grads_of(lambda p_, b: nmt.nmt_loss(p_, b, cfg), p,
                               nmt.batch_to(batch, device))
        return (float(loss.detach()),
                [g.cpu().double() for g in tree_leaves(grads)])

    loss_k, grads_k = step("cuda")
    loss_p, grads_p = step("cpu")
    _, grads_64 = step("cpu", torch.float64)
    rel = lambda ga, gb: max(float((a - b).norm() / b.norm().clamp_min(1e-300))
                             for a, b in zip(ga, gb))
    rel_cpu, rel_64 = rel(grads_k, grads_p), rel(grads_k, grads_64)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    ok = loss_rel <= TOL_NMT_LOSS and max(rel_cpu, rel_64) <= TOL_NMT_GRAD
    emit({"phase": "parity", "config": "transformer_nmt f32 step",
          "batch": NMT_PARITY_B, "src_len": NMT_S, "tgt_len": NMT_S,
          "loss_card": loss_k, "loss_plain_cpu": loss_p,
          "loss_rel_err": loss_rel, "tol_loss": TOL_NMT_LOSS,
          "grad_rel_l2_max": rel_cpu, "grad_rel_l2_max_vs_cpu_f64": rel_64,
          "tol_grad": TOL_NMT_GRAD,
          "grad_rel_l2_max_cpu_f32_vs_f64": rel(grads_p, grads_64),
          "leaves": len(grads_k), "ok": ok})
    if not ok:
        raise AssertionError("NMT whole-step parity failed")

    K, T = NMT_PARITY_DECODE["beam_size"], NMT_PARITY_DECODE["max_len"]
    src_ids = torch.from_numpy(batch["src_ids"])
    src_mask = torch.from_numpy(batch["src_mask"] > 0)
    run = _first_parting(cfg, params, src_ids, src_mask, K, T)
    rec = {"phase": "parity", "config": "transformer_nmt f32 beam_search",
           "batch": NMT_PARITY_B, **NMT_PARITY_DECODE,
           "tol_score": TOL_NMT_SCORE}
    if "step" in run:
        # a random model's beams repeat one token and sit ~1e-4 apart, so
        # the two runs may part at a near tie; up to it they must agree
        ok = run["margin"] <= TOL_NMT_SCORE and run["err"] <= TOL_NMT_SCORE
        emit({**rec, "beams_equal": False, "first_parting_step": run["step"],
              "cpu_smallest_top_k_margin": run["margin"],
              "top_k_scores_max_abs_err": run["err"], "ok": ok})
    else:
        (seq_k, sc_k), (seq_p, sc_p) = (
            nmt.rank_beams(run[d][0].cpu(), run[d][1].cpu(), cfg)
            for d in ("card", "cpu"))
        same = bool(torch.equal(seq_k, seq_p))
        score_err = float((sc_k - sc_p).abs().max())
        # ranked apart only where two final scores lie within the tolerance
        rank_margin = float((sc_p[:, :-1] - sc_p[:, 1:]).min())
        ok = score_err <= TOL_NMT_SCORE and (same or rank_margin <= TOL_NMT_SCORE)
        emit({**rec, "beams_equal": True, "sequences_equal": same,
              "score_max_abs_err": score_err,
              "cpu_smallest_rank_margin": rank_margin,
              "best_scores_cpu": sc_p[:, 0].tolist(), "ok": ok})
    if not ok:
        raise AssertionError("NMT decode parity failed")

    copy = nmt_copy_decode_parity(device="cuda")
    ok = copy > NMT_COPY_THRESHOLD
    emit({"phase": "parity", "config": "nmt_copy_decode_parity (card)",
          "decode_parity": copy, "threshold": NMT_COPY_THRESHOLD, "ok": ok})
    if not ok:
        raise AssertionError("NMT copy-task decode parity failed")
    torch.cuda.empty_cache()


# -- LeNet phases (the Fluid program mode) ----------------------------------

def phase_lenet_slice(device_name, card):
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.datasets import mnist
    from paddle_tpu_torch.tools import profile_step

    from paddle_tpu_torch import convert

    main, startup, v = profile_step.lenet_programs(
        fluid, fluid.optimizer.Adam(1e-3))
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    startup_values = convert.scope_to_numpy(
        scope, [x.name for x in startup.list_vars() if x.persistable])
    feeder = fluid.DataFeeder([v["img"], v["label"]], program=main)
    rows = iter(mnist.train()())
    feeds = [feeder.feed([next(rows) for _ in range(LENET_B)])
             for _ in range(LENET_WARMUP + LENET_TIMED)]
    fetch = [v["loss"], v["acc"]]
    for feed in feeds[:LENET_WARMUP]:
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
           for feed in feeds[LENET_WARMUP:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = [float(lv) for lv, _ in out]
    accs = [float(av) for _, av in out]
    ok = bool(np.isfinite(losses).all()) and all(0 <= a <= 1 for a in accs)
    emit({"phase": "slice", "config": "lenet (Fluid Executor)",
          "device": device_name, "nvidia_smi": card, "dtype": "float32",
          "batch": LENET_B, "optimizer": "adam(1e-3)",
          "steps_timed": LENET_TIMED, "ms_per_step": dt / LENET_TIMED * 1e3,
          "images_per_sec": LENET_B * LENET_TIMED / dt,
          "loss_first": losses[0], "loss_last": losses[-1],
          "acc_last": float(out[-1][1]), "ok": ok})
    if not ok:
        raise AssertionError("LeNet slice: a loss not finite or an accuracy "
                             "outside [0, 1]")
    prof = profile_step.profile_model("lenet", card)
    emit({"phase": "slice_profile", "config": "lenet (Fluid Executor)",
          "device_idle_share": prof["device_idle_share"],
          "device_busy_share": 1 - prof["device_idle_share"],
          "launches_per_step": prof["launches_per_step"],
          "wall_ms_per_step_profiled": prof["wall_ms_per_step"],
          "device_busy_ms_per_step": prof["device_busy_ms_per_step"]})
    return main, scope, v, startup_values


def _lenet_digits(seed, n):
    """The JAX package's convergence batch (tests/test_models.py:25-29)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ys = rng.randint(0, 10, (n, 1)).astype("int64")
    xs = rng.rand(n, 1, 28, 28).astype("f4") * 0.1
    for i, k in enumerate(ys[:, 0]):
        xs[i, 0, :k + 2, :k + 2] += 1.0
    return {"img": xs, "label": ys}


def _lenet_sgd_run(dtype, device, values):
    """LeNet + SGD in ``dtype`` on ``device``, from ``values`` (the CPU's
    f32 startup run, cast to each var's declared dtype): the test clone's
    fetches on a held-out batch, then LENET_PARITY_STEPS steps.  Returns
    {"test": fetches, "steps": [fetches of each step: the loss, the
    accuracy, every gradient, the ReLU inputs], "params": {name: array}}."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.dtypes import numpy_dtype
    from paddle_tpu_torch.tools import profile_step

    main, startup, v = profile_step.lenet_programs(
        fluid, fluid.optimizer.SGD(LENET_SGD_LR), dtype)
    declared = {x.name: numpy_dtype(x.dtype) for x in startup.list_vars()}
    scope = convert.scope_from_numpy(
        {n: a.astype(declared[n]) for n, a in values.items()}, fluid.Scope(),
        device)
    exe = fluid.Executor(fluid.CPUPlace() if device == "cpu"
                         else fluid.CUDAPlace(0))

    def feed_of(seed):
        feed = _lenet_digits(seed, LENET_B)
        feed["img"] = feed["img"].astype(dtype)
        return feed

    params = [p.name for p in main.all_parameters()]
    relu_in = [op.inputs["X"][0] for op in main.global_block().ops
               if op.type == "relu"]
    test = exe.run(main.clone(for_test=True), feed=feed_of(1000), scope=scope,
                   fetch_list=[v["loss"], v["acc"], v["pred"]])
    fetch = ([v["loss"], v["acc"]] + [p + "@GRAD" for p in params]
             + relu_in)
    steps = [exe.run(main, feed=feed_of(step), fetch_list=fetch, scope=scope)
             for step in range(LENET_PARITY_STEPS)]
    return {"test": test, "steps": steps, "n_out": 2 + len(params),
            "params": convert.scope_to_numpy(scope, params)}


def phase_lenet_parity(card):
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.tools import profile_step

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))

    def params_rel(a, b):
        return max(rel(a["params"][n], b["params"][n]) for n in a["params"])

    _, startup, _ = profile_step.lenet_programs(
        fluid, fluid.optimizer.SGD(LENET_SGD_LR))
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    values = convert.scope_to_numpy(
        init, [x.name for x in startup.list_vars() if x.persistable])
    runs = {(dt, dev): _lenet_sgd_run(dt, dev, values)
            for dt in ("float32", "float64") for dev in ("cpu", "cuda")}
    for dtype in ("float32", "float64"):
        cpu, gpu = runs[dtype, "cpu"], runs[dtype, "cuda"]
        n = cpu["n_out"]
        test_err = max(rel(a, b) for a, b in zip(gpu["test"], cpu["test"]))
        names = ["loss", "acc"] + [p + "@GRAD" for p in cpu["params"]]
        step_err = {k: rel(a, b) for k, a, b in zip(
            names, gpu["steps"][0][:n], cpu["steps"][0][:n])}
        grad_err = [max(rel(a, b) for a, b in zip(k[2:n], c[2:n]))
                    for k, c in zip(gpu["steps"], cpu["steps"])]
        # the ReLU inputs the two devices put on either side of 0, by step,
        # and the first few flips' values (CPU, card)
        flips, flip_values = [], []
        for k, c in zip(gpu["steps"], cpu["steps"]):
            count = 0
            for a, b in zip(k[n:], c[n:]):
                where = np.argwhere((a > 0) != (b > 0))
                count += len(where)
                flip_values += [(float(b[tuple(i)]), float(a[tuple(i)]))
                                for i in where[:3 - len(flip_values)]]
            flips.append(count)
        param_err = params_rel(gpu, cpu)
        # f32 rounding may flip a ReLU mask between the devices (LENET_TOL's
        # comment): a step with a flip, and the trajectory after it, are
        # held to LENET_F32_TRAJ_TOL; float64 holds everything to LENET_TOL
        step_tol = LENET_TOL if flips[0] == 0 else LENET_F32_TRAJ_TOL
        traj_tol = LENET_TOL if sum(flips) == 0 else LENET_F32_TRAJ_TOL
        if dtype == "float64":
            step_tol = traj_tol = LENET_TOL
        ok = (test_err <= LENET_TOL and max(step_err.values()) <= step_tol
              and param_err <= traj_tol)
        rec = {"phase": "parity", "config": "lenet %s SGD, card vs CPU" % dtype,
               "batch": LENET_B, "test_clone_max_rel_err": test_err,
               "test_clone_tol": LENET_TOL, "one_step_rel_err": step_err,
               "one_step_tol": step_tol, "grad_max_rel_err_by_step": grad_err,
               "params_after_%d_steps_max_rel_err" % LENET_PARITY_STEPS: param_err,
               "params_tol": traj_tol, "relu_sign_flips_by_step": flips,
               "first_flips_cpu_card": flip_values, "ok": ok}
        if dtype == "float32":
            # both devices' f32 trajectories beside the CPU's float64 one
            f64 = runs["float64", "cpu"]
            rec["params_cpu_f32_vs_cpu_f64"] = params_rel(cpu, f64)
            rec["params_card_f32_vs_cpu_f64"] = params_rel(gpu, f64)
        emit(rec)
        if not ok:
            raise AssertionError("LeNet %s card vs CPU parity failed" % dtype)

    main, startup, v = profile_step.lenet_programs(
        fluid, fluid.optimizer.Adam(1e-3))
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    batch = _lenet_digits(0, LENET_B)
    accs = []
    for _ in range(LENET_MAX_STEPS):
        lv, av = exe.run(main, feed=batch, fetch_list=[v["loss"], v["acc"]],
                         scope=scope)
        if not np.isfinite(lv).all():
            raise AssertionError("LeNet convergence: loss not finite")
        accs.append(float(av))
        if accs[-1] >= LENET_ACC:
            break
    ok = accs[-1] >= LENET_ACC
    emit({"phase": "parity", "config": "lenet converges on the card",
          "nvidia_smi": card, "steps": len(accs), "accuracy": accs[-1],
          "threshold": LENET_ACC, "max_steps": LENET_MAX_STEPS, "ok": ok})
    if not ok:
        raise AssertionError("LeNet did not reach accuracy %g in %d steps"
                             % (LENET_ACC, LENET_MAX_STEPS))


# -- the deploy path and control flow (the Fluid deployment surface) -----------

def _rel(got, want):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError("shapes differ: %s, %s" % (got.shape, want.shape))
    return float(np.abs(got - want).max(initial=0.0)
                 / max(np.abs(want).max(initial=0.0), 1e-30))


def _refused(error, fn):
    """True when ``fn()`` raises ``error`` (a refusal the phase checks)."""
    try:
        fn()
    except error:
        return True
    return False


def _per_request(fn, requests):
    """(ms per request, requests/s) on the host clock: each call returns
    numpy, so it ends synchronised."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(requests):
        fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dt / requests * 1e3, requests / dt


def _device_per_call(fn, calls=5):
    """(CUDA activities a call, device ms a call) by torch.profiler: the
    kernels and copies of one call (profile_step.cuda_kernels_per_call)."""
    from paddle_tpu_torch.tools import profile_step

    per = profile_step.cuda_kernels_per_call(fn, calls=calls)
    return (sum(n for n, _ in per.values()), sum(ms for _, ms in per.values()),
            [k[:80] for k in sorted(per, key=lambda k: -per[k][1])[:5]])


def phase_deploy(card, trained):
    """Phase 22: save, serve through the Predictor and the exported
    predictor's CUDA graphs, swap weights, metrics and a CompiledProgram
    step.  ``trained``: phase 20's (main, scope, vars, startup values)."""
    import tempfile

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert

    t_phase = time.perf_counter()
    main, scope, v, startup_values = trained
    exe = fluid.Executor()
    test = main.clone(for_test=True)
    inf = fluid.inference
    rec = {"phase": "deploy", "config": "lenet (save_inference_model, "
           "Predictor, exported predictor)", "nvidia_smi": card,
           "dtype": "float32"}
    with tempfile.TemporaryDirectory() as d:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, ["img"], [v["pred"]], exe, main)
        pred = inf.create_predictor(inf.AnalysisConfig(d))
        cpu_config = inf.AnalysisConfig(d)
        cpu_config.disable_gpu()
        cpu = inf.create_predictor(cpu_config)
        if pred._exe.device.type != "cuda" or cpu._exe.device.type != "cpu":
            raise AssertionError("predictor devices: %s, %s"
                                 % (pred._exe.device, cpu._exe.device))
        batches = {b: _lenet_digits(3000 + b, b) for b in (1, 5, 64)}
        clone_of = {}
        errs = {}
        for b, batch in batches.items():
            (got,) = pred.run({"img": batch["img"]})
            clone_of[b] = exe.run(test, feed=batch, fetch_list=[v["pred"]],
                                  scope=scope)[0]
            errs[b] = {"vs_cpu_predictor": _rel(got, cpu.run([batch["img"]])[0]),
                       "vs_test_clone": _rel(got, clone_of[b])}
        rec["predictor_rel_err"] = errs
        ok = all(e <= DEPLOY_TOL for r in errs.values() for e in r.values())

        c = pred.clone()
        names = pred._scope.local_var_names()
        rec["clone_shares_weights"] = shares = (
            c._scope is pred._scope and c._exe is pred._exe and all(
                c._scope.find_var(n).data_ptr() == pred._scope.find_var(n).data_ptr()
                for n in names))
        ok &= shares and bool(np.array_equal(c.run([batches[5]["img"]])[0],
                                             pred.run([batches[5]["img"]])[0]))

        t0 = time.perf_counter()
        inf.export_inference_model(d, {"img": (64, 1, 28, 28)}, poly_batch=True)
        rec["export_seconds"] = time.perf_counter() - t0
        ep = inf.load_exported_model(d).declare_batch_buckets(DEPLOY_BUCKETS)
        if ep.device.type != "cuda":
            raise AssertionError("exported predictor on %s" % ep.device)
        for b in DEPLOY_BUCKETS:
            ep.ensure_compiled({"img": ((b, 1, 28, 28), "float32")})
        warm = ep.compiled_signature_count()
        rec["capture_seconds"] = {str(sig[0][1][0]): s for sig, s
                                  in ep.capture_seconds().items()}
        exp_err = {b: _rel(ep.run([batch["img"]])[0], clone_of[b])
                   for b, batch in batches.items()}
        rec["exported_vs_test_clone_rel_err"] = exp_err
        ok &= all(e <= DEPLOY_TOL for e in exp_err.values())
        five = batches[5]["img"]
        padded = np.concatenate([five, np.zeros((3,) + five.shape[1:], "f4")])
        got5 = ep.run([five])[0]
        rec["b5_pads_to_8"] = pad_ok = (
            got5.shape == (5, 10)
            and bool(np.array_equal(got5, ep.run([padded])[0][:5]))
            and _rel(got5, pred.run([five])[0]) <= DEPLOY_TOL)
        ok &= pad_ok
        rng = np.random.RandomState(22)
        sizes = rng.randint(1, 65, DEPLOY_MIXED)
        pool = rng.rand(64, 1, 28, 28).astype("f4")
        for n in sizes:
            if ep.run([pool[:n]])[0].shape != (n, 10):
                raise AssertionError("exported predictor: wrong output rows")
        after = ep.compiled_signature_count()
        rec["signatures"] = {"after_buckets": warm, "after_mixed": after,
                             "mixed_requests": DEPLOY_MIXED}
        ok &= warm == after == len(DEPLOY_BUCKETS)

        # requests: the host clock per request and the device's share
        timing = {}
        for name, fn in (("predictor", lambda x: pred.run([x])),
                         ("exported", lambda x: ep.run([x]))):
            for b in (1, 64):
                x = batches[b]["img"]
                ms, rps = _per_request(lambda: fn(x), DEPLOY_TIMED)
                n_act, dev_ms, top = _device_per_call(lambda: fn(x))
                timing["%s_b%d" % (name, b)] = {
                    "ms_per_request": ms, "requests_per_sec": rps,
                    "images_per_sec": rps * b,
                    "cuda_activities_per_request": n_act,
                    "device_ms_per_request": dev_ms, "top_device": top}
        rec["requests"] = timing

        # swap_state: the startup weights give the fresh program's answers
        x = batches[64]["img"]
        trained_out = ep.run([x])[0]
        ep.swap_state(startup_values)
        fresh = convert.scope_from_numpy(startup_values, fluid.Scope(), "cuda")
        want = exe.run(test, feed=batches[64], fetch_list=[v["pred"]],
                       scope=fresh)[0]
        swapped = ep.run([x])[0]
        w = next(n for n in ep._state if ".w_" in n)
        refused = _refused(ValueError, lambda: ep.swap_state(
            {**startup_values, w: np.zeros((3, 3), "f4")}))
        rec["swap_state"] = {
            "rel_err_vs_fresh_program": _rel(swapped, want),
            "moved_from_trained": float(np.abs(swapped - trained_out).max()),
            "shape_change_refused": refused,
            "signatures_after": ep.compiled_signature_count()}
        ok &= (rec["swap_state"]["rel_err_vs_fresh_program"] <= DEPLOY_TOL
               and rec["swap_state"]["moved_from_trained"] > 1e-3 and refused
               and rec["swap_state"]["signatures_after"] == len(DEPLOY_BUCKETS))

    # metrics: Accuracy over the predictor's outputs, as the test clone's
    held = _lenet_digits(4000, LENET_B)
    probs = pred.run([held["img"]])[0]
    metric = fluid.metrics.Accuracy()
    metric.update(float((probs.argmax(1) == held["label"][:, 0]).mean()),
                  weight=LENET_B)
    clone_acc = float(exe.run(test, feed=held, fetch_list=[v["acc"]],
                              scope=scope)[0])
    rec["accuracy"] = {"metrics_accuracy": metric.eval(), "test_clone": clone_acc}
    ok &= abs(metric.eval() - clone_acc) <= 1e-7

    # compiler: one step through a one-device CompiledProgram and through
    # the plain program, from the same weights
    names = [x.name for x in main.list_vars() if x.persistable]
    values = convert.scope_to_numpy(scope, names)
    params = [p.name for p in main.all_parameters()]
    batch = _lenet_digits(5000, LENET_B)
    runs = []
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v["loss"].name)
    for prog in (main, compiled):
        sc = convert.scope_from_numpy(values, fluid.Scope(), "cuda")
        (loss,) = exe.run(prog, feed=batch, fetch_list=[v["loss"]], scope=sc)
        runs.append((loss, convert.scope_to_numpy(sc, params)))
    step_err = max([_rel(runs[1][0], runs[0][0])]
                   + [_rel(runs[1][1][n], runs[0][1][n]) for n in params])
    rec["compiled_program_step_rel_err"] = step_err
    rec["compiled_program_tol"] = DEPLOY_STEP_TOL
    ok &= step_err <= DEPLOY_STEP_TOL
    rec["seconds"] = time.perf_counter() - t_phase
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("deploy phase failed")


def _decode_state(B, K):
    import numpy as np

    ps0 = (np.where(np.arange(K)[None] == 0, 0.0, -1e9)
           * np.ones((B, 1))).astype("f4")
    return ps0, np.full((B, K), -1, "i4")


def _plain_beam_decode(probs, ps0, pi0, K, end_id=0):
    """The decode as a plain loop over the port's beam_search_step and
    beam_backtrack, on the device ``probs`` lies on."""
    from paddle_tpu_torch.ops import beam_search_ops as bs

    dev = probs.device
    scores, ids = torch.from_numpy(ps0).to(dev), torch.from_numpy(pi0).to(dev)
    toks, pars = [], []
    for t in range(probs.shape[0]):
        scores, ids, parent = bs.beam_search_step(
            scores, torch.log(probs[t].clamp_min(1e-20)), K, end_id,
            ids == end_id)
        toks.append(ids)
        pars.append(parent)
    return bs.beam_backtrack(torch.stack(toks), torch.stack(pars)).cpu().numpy()


def phase_control_flow(card):
    """Phase 23: the While beam decode at NMT width, cond and Switch."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.ops import control_flow_ops
    from paddle_tpu_torch.tools import programs

    t_phase = time.perf_counter()
    rec = {"phase": "control_flow", "nvidia_smi": card}

    def decode(place, T, B, K, V, lp):
        main, startup, v = programs.while_beam_decode(fluid, T, B, K, V)
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        ps0, pi0 = _decode_state(B, K)
        feed = {"lp": lp, "ps": ps0, "pi": pi0}
        return lambda: exe.run(main, feed=feed, fetch_list=[v["sent"]],
                               scope=scope)[0]

    # the small case against the CPU
    T, B, K, V = DECODE_SMALL
    small = np.exp(np.random.RandomState(23).randn(T, B, K, V) * 0.5 - 1.0
                   ).astype("f4")
    cpu_sent = decode(fluid.CPUPlace(), T, B, K, V, small)()
    card_sent = decode(fluid.CUDAPlace(0), T, B, K, V, small)()
    rec["small_equal_cpu"] = small_ok = bool(np.array_equal(card_sent, cpu_sent))

    # NMT decode's width: the probabilities made on the host from the seed
    T, B, K, V = DECODE_T, DECODE_B, DECODE_K, DECODE_V
    gen = torch.Generator().manual_seed(23)
    host = torch.randn((T, B, K, V), generator=gen).mul_(0.5).sub_(1.0).exp_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = host.to("cuda")
    torch.cuda.synchronize()
    rec["feed_gb"] = host.numel() * 4 / 1e9
    rec["feed_copy_ms"] = (time.perf_counter() - t0) * 1e3
    run = decode(fluid.CUDAPlace(0), T, B, K, V, lp)
    run()                                       # warm-up
    control_flow_ops.reset_host_syncs()
    t0 = time.perf_counter()
    sent = run()
    dt = time.perf_counter() - t0
    syncs = control_flow_ops.host_syncs["while"]
    plain = _plain_beam_decode(lp, *_decode_state(B, K), K)
    n_act, dev_ms, top = _device_per_call(run, calls=2)
    with_copy = decode(fluid.CUDAPlace(0), T, B, K, V, host)
    with_copy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with_copy()
    rec["decode_with_host_feed_ms"] = (time.perf_counter() - t0) * 1e3
    del host, lp, with_copy, run
    torch.cuda.empty_cache()
    rec["decode"] = {
        "T": T, "B": B, "K": K, "V": V, "ms": dt * 1e3,
        "ms_per_iteration": dt * 1e3 / T, "host_syncs": syncs,
        "host_syncs_per_iteration": syncs / T,
        "cuda_activities_per_iteration": n_act / T,
        "device_ms_per_iteration": dev_ms / T, "top_device": top,
        "equal_plain_loop": bool(np.array_equal(sent, plain)),
        "sentence_shape": list(sent.shape)}
    ok = small_ok and rec["decode"]["equal_plain_loop"] and syncs == T + 1

    # cond in a trained forward section: the card against the CPU from the
    # same values, each step's loss, branch and gradients
    main, startup, cv = programs.cond_program(fluid)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    values = convert.scope_to_numpy(
        init, [x.name for x in startup.list_vars() if x.persistable])
    params = [p.name for p in main.all_parameters()]
    fetch = [cv["loss"].name, cv["pred"].name] + [p + "@GRAD" for p in params]
    outs = {}
    for dev, place in (("cpu", fluid.CPUPlace()), ("cuda", fluid.CUDAPlace(0))):
        exe = fluid.Executor(place)
        sc = convert.scope_from_numpy(values, fluid.Scope(), dev)
        outs[dev] = [exe.run(main, feed={"x": np.random.RandomState(s).randn(
            16, 8).astype("f4")}, fetch_list=fetch, scope=sc)
            for s in range(COND_STEPS)]
    branches = [bool(o[1][0]) for o in outs["cpu"]]
    cond_err = max(_rel(a, b) for k, c in zip(outs["cuda"], outs["cpu"])
                   for a, b in zip(k, c))
    rec["cond"] = {"branches_taken": branches, "max_rel_err": cond_err,
                   "tol": COND_TOL}
    ok &= cond_err <= COND_TOL and len(set(branches)) == 2

    # Switch: the card's values equal the CPU's
    main, startup, sv = programs.switch_program(fluid)
    lrs = {}
    for dev, place in (("cpu", fluid.CPUPlace()), ("cuda", fluid.CUDAPlace(0))):
        exe, sc = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=sc)
        lrs[dev] = [float(exe.run(main, feed={"step": np.array([s], "f4")},
                                  fetch_list=[sv["lr"]], scope=sc)[0][0])
                    for s in (0, 4, 5, 9, 10, 20)]
    rec["switch"] = {"card": lrs["cuda"], "equal_cpu": lrs["cuda"] == lrs["cpu"]}
    ok &= lrs["cuda"] == lrs["cpu"]
    rec["seconds"] = time.perf_counter() - t_phase
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("control-flow phase failed")

# -- the book suite (the Fluid book models through the executor) -------------

def _book(model, optimizer=None, **sizes):
    """``tools/book_suite.py``'s run of ``model`` on the port."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import datasets
    from paddle_tpu_torch.models import book
    from paddle_tpu_torch.tools import book_suite

    return book_suite.build(fluid, book, datasets, model, optimizer=optimizer,
                            **sizes)


def _executor(device):
    import paddle_tpu_torch as fluid

    return fluid.Executor(fluid.CPUPlace() if device == "cpu"
                          else fluid.CUDAPlace(0))


def _startup_values(run):
    """The port's f32 startup values of ``run``, from a CPU run."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert

    scope = fluid.Scope()
    _executor("cpu").run(run.startup, scope=scope)
    return convert.scope_to_numpy(
        scope, [v.name for v in run.startup.list_vars() if v.persistable])


def _srl_tag_accuracy(exe, run, scope):
    """The semantic-role test's decode check: (valid label ids, tag
    accuracy on the trained batch) from one run of the main program
    fetching the CRF decode, as tests/test_book_models.py does."""
    import numpy as np

    (dec,) = exe.run(run.main, feed=run.feed,
                     fetch_list=[run.extra["decode"]], scope=scope)
    dec, tgt = np.asarray(dec), run.feed["target"]
    mask = np.arange(tgt.shape[1])[None, :] < run.feed["word_seq_len"][:, None]
    valid = bool(dec.min() >= 0 and dec.max() < run.extra["n_labels"])
    return valid, float((dec[:, :tgt.shape[1]] == tgt)[mask].mean())


def phase_book_training(card):
    """Phase 24: each book model trained to its threshold on the card, then
    timed and profiled."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import book_suite, profile_step

    failed = []
    for model in book_suite.MODELS:
        run = _book(model)
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(run.startup, scope=scope)
        values = []
        t0 = time.perf_counter()
        for step in range(run.contract[2]):
            out = exe.run(run.main, feed=run.feed, fetch_list=run.fetch,
                          scope=scope)
            if not np.isfinite(out[0]).all():
                break
            values.append(float(np.asarray(out[-1]).mean()))
            if book_suite.converged(run.contract, values):
                break
        train_s = time.perf_counter() - t0
        ok = book_suite.converged(run.contract, values)
        rec = {"phase": "book", "model": model, "nvidia_smi": card,
               "contract": list(run.contract), "steps": len(values),
               "first": values[0] if values else None,
               "last": values[-1] if values else None,
               "train_seconds": train_s}
        if model == "semantic_roles":
            valid, tag_acc = _srl_tag_accuracy(exe, run, scope)
            rec.update(decode_ids_valid=valid, tag_accuracy=tag_acc)
            ok = ok and valid and tag_acc > 0.5
        for _ in range(BOOK_WARMUP):
            exe.run(run.main, feed=run.feed, fetch_list=run.fetch, scope=scope)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BOOK_TIMED):
            exe.run(run.main, feed=run.feed, fetch_list=run.fetch, scope=scope)
        torch.cuda.synchronize()
        rec["ms_per_step"] = (time.perf_counter() - t0) / BOOK_TIMED * 1e3
        prof = profile_step.profile_model(profile_step.BOOK_PREFIX + model,
                                          card)
        rec.update(launches_per_step=prof["launches_per_step"],
                   device_busy_ms_per_step=prof["device_busy_ms_per_step"],
                   device_idle_share=prof["device_idle_share"],
                   wall_ms_per_step_profiled=prof["wall_ms_per_step"],
                   ok=ok)
        emit(rec)
        if not ok:
            failed.append(model)
        del exe, scope, run
    if failed:
        raise AssertionError("book models that missed their thresholds on "
                             "the card: %s" % failed)


def _book_steps(model, device, values, steps, **sizes):
    """``steps`` steps of ``model`` (its random ops pinned; ``sizes`` as
    ``book_suite.build`` takes them) on ``device`` from ``values``: each
    step's fetches (the loss, every dense gradient, every global-block ReLU
    input), then the parameters."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.tools import book_suite

    run = _book(model, **sizes)
    book_suite.pin_random_ops(run.main)
    scope = convert.scope_from_numpy(values, fluid.Scope(), device)
    exe = _executor(device)
    params = [p.name for p in run.main.all_parameters()]
    sparse = book_suite.sparse_tables(run.main)
    dense = [n for n in params if n not in sparse]
    relu_in = [op.inputs["X"][0] for op in run.main.global_block().ops
               if op.type == "relu"]
    fetch = [run.cost.name] + [n + "@GRAD" for n in dense] + relu_in
    out = [exe.run(run.main, feed=run.feed, fetch_list=fetch, scope=scope)
           for _ in range(steps)]
    counters = [v.name for v in run.main.list_vars()
                if v.persistable and not v.dtype.startswith("float")]
    return {"steps": out, "dense": dense, "sparse": sparse,
            "adam_lr": run.adam_lr, "params": convert.scope_to_numpy(scope, params),
            "counters": convert.scope_to_numpy(scope, counters)}


def _book_parity(model, cpu, gpu, loose):
    """Card against CPU over one pair of ``_book_steps`` runs.  ``loose``
    (an f32 trajectory after a ReLU flip): the losses to BOOK_FLIP_TOL and
    Adam's parameters only to its 2 lr a step; otherwise the module's
    tolerances (BOOK_TOL ...).  Returns the record."""
    import numpy as np

    from paddle_tpu_torch.tools import book_suite

    n = 1 + len(cpu["dense"])
    flips, losses = [], []
    for c, g in zip(cpu["steps"], gpu["steps"]):
        flips.append(sum(int(((a > 0) != (b > 0)).sum())
                         for a, b in zip(g[n:], c[n:])))
        losses.append(_rel(g[0], c[0]))
    loss_tol = BOOK_FLIP_TOL if loose else BOOK_TOL
    g_min = {}
    for c in cpu["steps"]:
        for name, grad in zip(cpu["dense"], c[1:n]):
            g_min[name] = np.minimum(g_min.get(name, np.inf), np.abs(grad))
    lr = cpu["adam_lr"]
    errs = book_suite.param_errors(gpu["params"], cpu["params"],
                                   g_min if lr is not None else {},
                                   BOOK_SMALL_G)
    adam_tol = BOOK_TOL_VGG if model == "image_vgg" else BOOK_TOL
    bad, worst_rel, small_parted = [], 0.0, 0
    for name, (above, small, n_small, scale) in errs.items():
        worst_rel = max(worst_rel, max(above, small) / scale)
        small_parted += n_small
        if lr is None:
            ok = max(above, small) <= loss_tol * scale
        elif name in cpu["sparse"] or loose:
            # no gradient to read, or one a flip changed: Adam moves an
            # element by at most about lr a step
            ok = max(above, small) <= 2 * lr * BOOK_PARITY_STEPS
        else:
            ok = above <= adam_tol and small <= 2 * lr * BOOK_PARITY_STEPS
        if not ok:
            bad.append(name)
    counters_ok = all(np.array_equal(gpu["counters"][k], v)
                      for k, v in cpu["counters"].items())
    return {"steps": BOOK_PARITY_STEPS, "loss_rel_err_by_step": losses,
            "relu_sign_flips_by_step": flips, "loss_tol": loss_tol,
            "optimizer": "adam(%g)" % lr if lr is not None else "sgd",
            "params_max_rel_err": worst_rel,
            "small_gradient_elements_parted": small_parted,
            "params_out_of_tolerance": bad,
            "ok": (max(losses) <= loss_tol and not bad and counters_ok)}


def _dropout_on_the_card():
    """Training-mode dropout on a card tensor: the kept share and the
    scaling of both implementations."""
    from paddle_tpu_torch.registry import OpLoweringContext, get_lowering

    p, n = BOOK_DROPOUT_P, BOOK_DROPOUT_N
    v = torch.rand(n, device="cuda") + 0.5
    ctx = OpLoweringContext(None, torch.Generator("cuda").manual_seed(0))
    rec = {}
    for impl, keep in (("downgrade_in_infer", 1.0),
                       ("upscale_in_train", 1.0 - p)):
        outs = get_lowering("dropout")(
            {"X": [v]}, {"dropout_prob": p, "dropout_implementation": impl,
                         "seed": 3}, ctx)
        y, kept = outs["Out"][0], outs["Mask"][0].bool()
        share = float(kept.float().mean())
        exact = bool(torch.equal(y[kept], v[kept] / keep)
                     and not y[~kept].any())
        rec[impl] = {"kept_share": share, "scaled_exactly": exact,
                     "ok": exact and abs(share - (1 - p))
                     <= 5 * (p * (1 - p) / n) ** 0.5}
    return rec


def phase_book_parity(card):
    """Phase 25: BOOK_PARITY_STEPS f32 steps of each book model on the card
    and on the CPU from the same values; where a ReLU input flips between
    the devices, the f32 trajectory loosely and float64 runs of the same
    program strictly."""
    from paddle_tpu_torch.dtypes import numpy_dtype
    from paddle_tpu_torch.tools import book_suite

    failed = []
    for model in book_suite.MODELS:
        values = _startup_values(_book(model))
        runs = {dev: _book_steps(model, dev, values, BOOK_PARITY_STEPS)
                for dev in ("cpu", "cuda")}
        n = 1 + len(runs["cpu"]["dense"])
        flipped = any(((a > 0) != (b > 0)).any()
                      for c, g in zip(runs["cpu"]["steps"],
                                      runs["cuda"]["steps"])
                      for a, b in zip(g[n:], c[n:]))
        rec = {"phase": "book_parity", "model": model, "nvidia_smi": card,
               "float32": _book_parity(model, runs["cpu"], runs["cuda"],
                                       loose=flipped)}
        ok = rec["float32"]["ok"]
        if flipped:
            # the same program in float64: the flips are f32 rounding only
            # if the float64 runs agree at the strict tolerances
            if not model.startswith("image_"):
                ok = False
                rec["float64"] = "no float64 build of this model"
            else:
                run64 = _book(model, dtype="float64")
                declared = {v.name: numpy_dtype(v.dtype)
                            for v in run64.startup.list_vars()}
                v64 = {k: a.astype(declared[k]) for k, a in values.items()}
                r64 = {dev: _book_steps(model, dev, v64, BOOK_PARITY_STEPS,
                                        dtype="float64")
                       for dev in ("cpu", "cuda")}
                rec["float64"] = _book_parity(model, r64["cpu"],
                                              r64["cuda"], loose=False)
                ok = ok and rec["float64"]["ok"]
        rec["ok"] = ok
        emit(rec)
        if not ok:
            failed.append(model)
    drop = _dropout_on_the_card()
    emit({"phase": "book_parity", "check": "dropout in training mode",
          "p": BOOK_DROPOUT_P, "values": BOOK_DROPOUT_N, **drop})
    if failed or not all(r["ok"] for r in drop.values()):
        raise AssertionError("book parity card vs CPU failed: %s" % failed)


def phase_book_amp(card):
    """Phase 26: AMP_MODELS under amp.decorate(Adam) on the card: the first
    loss against the card's f32 run and the CPU's bf16 run, the f32 state
    after AMP_STEPS steps, and the persistables saved and loaded in the JAX
    package's file format with one bf16 persistable among them."""
    import os
    import shutil

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert

    def amp_adam(fl, lr):
        return fl.amp.decorate(fl.optimizer.Adam(lr))

    failed = []
    for model in AMP_MODELS:
        values = _startup_values(_book(model))
        first = {}
        for key, device, amp in (("card_bf16", "cuda", True),
                                 ("card_f32", "cuda", False),
                                 ("cpu_bf16", "cpu", True)):
            run = _book(model, optimizer=amp_adam if amp else None)
            scope = convert.scope_from_numpy(values, fluid.Scope(), device)
            exe = _executor(device)
            (first[key],) = exe.run(run.main, feed=run.feed,
                                    fetch_list=[run.cost], scope=scope)
            if key == "card_bf16":
                on_card = (run, scope, exe)
        run, scope, exe = on_card
        stats = [v.name for v in run.main.list_vars()
                 if v.persistable and ("mean" in v.name or "variance" in v.name)
                 and v.name.startswith("batch_norm")]
        stats_before = convert.scope_to_numpy(scope, stats)
        params = [p.name for p in run.main.all_parameters()]
        for _ in range(AMP_STEPS - 2):
            exe.run(run.main, feed=run.feed, fetch_list=[run.cost], scope=scope)
        grads = exe.run(run.main, feed=run.feed, return_numpy=False,
                        fetch_list=[p + "@GRAD" for p in params], scope=scope)
        state = [v.name for v in run.main.list_vars() if v.persistable]
        not_f32 = [n for n in state if scope.find_var(n).is_floating_point()
                   and scope.find_var(n).dtype != torch.float32]
        grads_f32 = all(g.dtype == torch.float32 for g in grads)
        stats_moved = all(not np.array_equal(scope.find_tensor_as_numpy(n), a)
                          for n, a in stats_before.items())
        # save in the JAX package's format, with a bf16 persistable
        bits = np.array([0x3FC0, 0xBF80, 0x0001, 0x4049], np.uint16)
        run.main.global_block().create_var(name="amp_bf16_probe", shape=(4,),
                                           dtype="bfloat16", persistable=True)
        scope.var("amp_bf16_probe")
        scope.set("amp_bf16_probe", torch.from_numpy(
            bits.view(np.int16).copy()).view(torch.bfloat16).cuda())
        d = os.path.join("build", "chip_amp", model)
        shutil.rmtree(d, ignore_errors=True)
        with fluid.scope_guard(scope):
            fluid.io.save_persistables(exe, d, run.main)
        on_disk = np.load(os.path.join(d, "amp_bf16_probe.npy"))
        files_ok = (on_disk.dtype == np.dtype("V2")
                    and np.array_equal(on_disk.view(np.uint16), bits)
                    and all(np.load(os.path.join(d, p + ".npy")).dtype
                            == np.float32 for p in params))
        back = fluid.Scope()
        with fluid.scope_guard(back):
            fluid.io.load_persistables(exe, d, run.main)
        probe = back.find_var("amp_bf16_probe")
        round_trip = (probe.dtype == torch.bfloat16 and probe.is_cuda
                      and np.array_equal(probe.view(torch.int16).cpu().numpy()
                                         .view(np.uint16), bits)
                      and all(np.array_equal(back.find_tensor_as_numpy(n),
                                             scope.find_tensor_as_numpy(n))
                              for n in params))
        err_f32 = _rel(first["card_bf16"], first["card_f32"])
        err_cpu = _rel(first["card_bf16"], first["cpu_bf16"])
        ok = (err_f32 <= AMP_LOSS_TOL and err_cpu <= AMP_LOSS_TOL
              and not not_f32 and grads_f32 and stats_moved and files_ok
              and round_trip)
        emit({"phase": "book_amp", "model": model, "nvidia_smi": card,
              "first_loss": {k: float(v) for k, v in first.items()},
              "rel_err_vs_card_f32": err_f32, "rel_err_vs_cpu_bf16": err_cpu,
              "tol": AMP_LOSS_TOL, "steps": AMP_STEPS,
              "state_vars": len(state), "state_not_f32": not_f32,
              "grads_f32": grads_f32, "bn_stats": len(stats),
              "bn_stats_moved": stats_moved, "files_in_jax_format": files_ok,
              "bf16_round_trip": round_trip, "ok": ok})
        if not ok:
            failed.append(model)
        shutil.rmtree(d, ignore_errors=True)
    if failed:
        raise AssertionError("AMP phase failed: %s" % failed)


def phase_book_sparse(card):
    """Phase 27: the is_sparse path's step on both merge routes and
    against the dense gradient.  Returns the segment kernel's launches per
    step on the recommender's kernel route (its main path in this
    slice)."""
    import os

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.tools import book_suite

    def sgd(fl, lr):
        return fl.optimizer.SGD(lr)

    cases = (("recommender", None, {}),
             ("word2vec_softmax", sgd, {"is_sparse": True}))
    failed, per_step = [], None
    saved = os.environ.pop("PADDLE_TPU_SEGMENT_KERNEL", None)
    try:
        for model, opt, sizes in cases:
            values = _startup_values(_book(model, optimizer=opt, **sizes))
            res, later, ms, launches = {}, {}, {}, {}
            for route in ("xla", "kernel", "dense"):
                run = _book(model, optimizer=opt, **sizes)
                if route == "dense":
                    for op in run.main.global_block().ops:
                        if op.type in ("lookup_table", "lookup_table_v2"):
                            op.attrs["is_sparse"] = False
                tables = sorted(book_suite.sparse_tables(run.main))
                os.environ["PADDLE_TPU_SEGMENT_KERNEL"] = (
                    "1" if route == "kernel" else "0")
                scope = convert.scope_from_numpy(values, fluid.Scope(), "cuda")
                exe = fluid.Executor(fluid.CUDAPlace(0))
                state = [v.name for v in run.main.list_vars() if v.persistable]
                torch.cuda.synchronize()
                _common.reset_launches()
                for step in range(SPARSE_STEPS):
                    exe.run(run.main, feed=run.feed, fetch_list=[run.cost],
                            scope=scope)
                    if step == 0:
                        res[route] = convert.scope_to_numpy(scope, state)
                torch.cuda.synchronize()
                launches[route] = dict(_common.launches)
                later[route] = convert.scope_to_numpy(scope, state)
                if route != "dense":
                    sparse_tables = tables
                t0 = time.perf_counter()
                for _ in range(SPARSE_TIMED):
                    exe.run(run.main, feed=run.feed, fetch_list=[run.cost],
                            scope=scope)
                torch.cuda.synchronize()
                ms[route] = (time.perf_counter() - t0) / SPARSE_TIMED * 1e3
            by_var = sorted(((_rel(res["kernel"][n], a), n)
                             for n, a in res["xla"].items()), reverse=True)
            route_err = by_var[0][0]
            route_ok = all(e <= SPARSE_ROUTE_TOL * (2 if "moment2" in n else 1)
                           for e, n in by_var)
            dense_err = max(_rel(res["dense"][n], a)
                            for n, a in res["xla"].items())
            drift = {k: max(_rel(later[k][n], a)
                            for n, a in later["xla"].items())
                     for k in ("kernel", "dense")}
            seg = launches["kernel"].get("segment_sum", 0)
            others = {k: v for route in launches for k, v in
                      launches[route].items() if v and k != "segment_sum"}
            merging = 0 if opt is sgd else len(sparse_tables)
            expect = merging * SPARSE_STEPS
            ok = (route_ok and dense_err <= BOOK_TOL
                  and seg == expect and not others
                  and launches["xla"].get("segment_sum", 0) == 0)
            emit({"phase": "book_sparse", "model": model, "nvidia_smi": card,
                  "optimizer": "sgd" if opt is sgd else "adam",
                  "sparse_tables": len(sparse_tables), "steps": SPARSE_STEPS,
                  "kernel_vs_xla_max_rel_err": route_err,
                  "kernel_vs_xla_worst": [[n, e] for e, n in by_var[:3]],
                  "route_tol": SPARSE_ROUTE_TOL,
                  "sparse_vs_dense_max_rel_err": dense_err,
                  "dense_tol": BOOK_TOL,
                  "after_%d_steps_max_rel_err" % SPARSE_STEPS: drift,
                  "segment_sum_launches": seg,
                  "segment_sum_launches_expected": expect,
                  "ms_per_step": ms, "other_port_launches": others,
                  "note": "sgd's sparse branch adds every slot without "
                          "merging rows, as the reference's does"
                          if opt is sgd else "", "ok": ok})
            if not ok:
                failed.append(model)
            if model == "recommender":
                per_step = seg / SPARSE_STEPS
    finally:
        os.environ.pop("PADDLE_TPU_SEGMENT_KERNEL", None)
        if saved is not None:
            os.environ["PADDLE_TPU_SEGMENT_KERNEL"] = saved
    if failed:
        raise AssertionError("sparse phase failed: %s" % failed)
    return per_step


# -- op rules on the card ----------------------------------------------------

_NAN, _INF = float("nan"), float("inf")
_OOR = [_NAN, _INF, -_INF, 3e9, -1.7, 256.0, 300.0, 0.5]
_ARANGE12 = [[0., 1., 2., 3.], [4., 5., 6., 7.], [8., 9., 10., 11.]]
_CRF_EM = [[[1.764, 0.4, 0.979], [2.241, 1.868, -0.977], [0.95, -0.151, -0.103], [0.411, 0.144, 1.454]], [[0.761, 0.122, 0.444], [0.334, 1.494, -0.205], [0.313, -0.854, -2.553], [0.654, 0.864, -0.742]], [[2.27, -1.454, 0.046], [-0.187, 1.533, 1.469], [0.155, 0.378, -0.888], [-1.981, -0.348, 0.156]]]
_CRF_TR = [[1.624, -0.612, -0.528], [-1.073, 0.865, -2.302], [1.745, -0.761, 0.319], [-0.249, 1.462, -2.06], [-0.322, -0.384, 1.134]]
_HS_X = [[1.764, 0.4, 0.979, 2.241], [1.868, -0.977, 0.95, -0.151], [-0.103, 0.411, 0.144, 1.454]]
_P = [[1.7641, 0.4002, 0.9787], [2.2409, 1.8676, -0.9773]]
_G = [[0.095, -0.0151, -0.0103], [0.0411, 0.0144, 0.1454]]
# (label, op, {slot: [(values, dtype)]}, attrs, {out slot: the JAX rule's
# values on the CPU, or None where only the CPU's are compared}):
# tests/test_torch_fluid_ops.py holds the port's CPU values to the JAX
# package's rules on these inputs
OP_RULE_CASES = (
    ("cast f32->uint8", "cast", {"X": [([[1., 0.], [2., -3.]], "float32")]},
     {"out_dtype": "uint8"}, {"Out": [[1, 0], [2, 0]]}),
    ("cast f32->uint8 high", "cast", {"X": [([-1.7, 256., 300.], "float32")]},
     {"out_dtype": "uint8"}, {"Out": [0, 255, 255]}),
    ("cast f32->int32", "cast", {"X": [([_NAN, _INF, -_INF, 3e9], "float32")]},
     {"out_dtype": "int32"},
     {"Out": [0, 2147483647, -2147483648, 2147483647]}),
    ("cast f32->int8", "cast", {"X": [(_OOR, "float32")]},
     {"out_dtype": "int8"}, {"Out": [0, 127, -128, 127, -1, 127, 127, 0]}),
    ("cast f32->uint8 all", "cast", {"X": [(_OOR, "float32")]},
     {"out_dtype": "uint8"}, {"Out": [0, 255, 0, 255, 0, 255, 255, 0]}),
    ("cast f32->bool", "cast", {"X": [(_OOR + [0.0], "float32")]},
     {"out_dtype": "bool"}, {"Out": [True] * 8 + [False]}),
    ("cast f32->float16", "cast", {"X": [(_OOR, "float32")]},
     {"out_dtype": "float16"}, {"Out": None}),
    ("cast f32->bfloat16", "cast", {"X": [(_OOR, "float32")]},
     {"out_dtype": "bfloat16"}, {"Out": None}),
    ("fill_constant int32 1e10", "fill_constant", {},
     {"shape": [2], "dtype": "int32", "value": 1e10},
     {"Out": [2147483647, 2147483647]}),
    ("fill_constant int32 nan", "fill_constant", {},
     {"shape": [2], "dtype": "int32", "value": _NAN}, {"Out": [0, 0]}),
    ("fill_constant uint8 -3.7", "fill_constant", {},
     {"shape": [2], "dtype": "uint8", "value": -3.7}, {"Out": [0, 0]}),
    ("fill_constant uint8 300", "fill_constant", {},
     {"shape": [2], "dtype": "uint8", "value": 300.0}, {"Out": [255, 255]}),
    ("fill_constant float16 1e10", "fill_constant", {},
     {"shape": [2], "dtype": "float16", "value": 1e10}, {"Out": [_INF, _INF]}),
    ("sequence_reverse f32", "sequence_reverse",
     {"X": [(_ARANGE12, "float32")], "SeqLen": [([0, 1, 6], "int64")]}, {},
     {"Y": [[0, 1, 2, 3], [4, 5, 6, 7], [_NAN, _NAN, 11, 10]]}),
    ("sequence_reverse int32", "sequence_reverse",
     {"X": [(_ARANGE12, "int32")], "SeqLen": [([0, 1, 6], "int64")]}, {},
     {"Y": [[0, 1, 2, 3], [4, 5, 6, 7], [-2147483648, -2147483648, 11, 10]]}),
    ("sequence_reverse bool", "sequence_reverse",
     {"X": [(_ARANGE12, "bool")], "SeqLen": [([0, 1, 6], "int64")]}, {},
     {"Y": [[False, True, True, True], [True] * 4, [True, True, True, True]]}),
    ("reduce_sum dim=[]", "reduce_sum", {"X": [([[1., 0.], [2., -3.]], "float32")]},
     {"dim": [], "keep_dim": False}, {"Out": [[1, 0], [2, -3]]}),
    ("reduce_all dim=[]", "reduce_all", {"X": [([[1., 0.], [2., -3.]], "float32")]},
     {"dim": [], "keep_dim": True}, {"Out": [[True, False], [True, True]]}),
    ("mean int32", "mean", {"X": [([[1, 2], [3, 4]], "int32")]}, {},
     {"Out": 2.5}),
    ("reduce_mean bool", "reduce_mean", {"X": [([[1, 0], [1, 1]], "bool")]},
     {"dim": [0]}, {"Out": [1.0, 0.5]}),
    ("softmax int32", "softmax", {"X": [([[1, 2, 3]], "int32")]}, {},
     {"Out": [[0.09003057, 0.24472847, 0.66524096]]}),
    ("where int32 condition", "where",
     {"Condition": [([1, 0], "int32")], "X": [([1., 2.], "float32")],
      "Y": [([3., 4.], "float32")]}, {}, {"Out": [1., 4.]}),
    # ROADMAP Queue 3's four logged faults: labels and lengths out of range
    # read as JAX's gathers read them, an int32 batch_norm in f32; then one
    # case for each of the 18 rules of Queue 1 item 3-A but the truncated
    # normal (phase_op_classes holds its support and moments)
    ('linear_chain_crf length past T', 'linear_chain_crf',
     {"Emission": [(_CRF_EM, 'float32')], "Transition": [(_CRF_TR, 'float32')], "Label": [([[0, 1, 2, 0], [0, 1, 2, 0], [0, 1, 2, 0]], 'int64')], "Length": [([2, 4, 6], 'int64')]},
     {},
     {"LogLikelihood": [[1.3678775], [11.106925], [11.013948]]}),
    ('linear_chain_crf label out of range', 'linear_chain_crf',
     {"Emission": [(_CRF_EM, 'float32')], "Transition": [(_CRF_TR, 'float32')], "Label": [([[0, 5, -1, 0], [1, 2, 0, 1], [2, 2, 7, 0]], 'int64')], "Length": [([2, 4, 2], 'int64')]},
     {},
     {"LogLikelihood": [[_NAN], [10.666924], [6.1030145]]}),
    ('hierarchical_sigmoid label out of range', 'hierarchical_sigmoid',
     {"X": [(_HS_X, 'float32')], "W": [([[1.624, -0.612, -0.528, -1.073], [0.865, -2.302, 1.745, -0.761], [0.319, -0.249, 1.462, -2.06], [-0.322, -0.384, 1.134, -1.1]], 'float32')], "Bias": [([0.0, 0.0, 0.0, 0.0], 'float32')], "Label": [([1, 7, -1], 'int64')]},
     {'num_classes': 5},
     {"Out": [[1.6120735], [3.9773767], [0.95431507]], "PreOut": [[-2.722046, -0.30156884, 0.0], [1.017072, 2.539125, 3.291979], [-1.890431, -2.054978, 0.0]]}),
    ('nce label out of range', 'nce',
     {"Input": [(_HS_X, 'float32')], "Label": [([[1], [7], [-1]], 'int64')], "Weight": [([[-0.417, -0.056, -2.136, 1.64], [-1.793, -0.842, 0.503, -1.245], [-1.058, -0.909, 0.551, 2.292], [0.042, -1.118, 0.539, -0.596], [-0.019, 1.175, -0.748, 0.009]], 'float32')], "Bias": [([1.789, 0.437, 0.096, -1.863, -0.277], 'float32')]},
     {'num_total_classes': 5, 'custom_neg_classes': [0, 3]},
     {"Cost": [[5.770802], [2.83041], [1.9028805]]}),
    ('batch_norm int32 training', 'batch_norm',
     {"X": [([[[[1, 0], [0, 2]], [[1, 0], [0, 0]], [[0, 0], [0, 1]]], [[[0, 0], [0, 0]], [[1, 0], [0, 0]], [[-2, 0], [0, 0]]]], 'int32')], "Scale": [([1.0, 1.0, 1.0], 'float32')], "Bias": [([0.0, 0.0, 0.0], 'float32')], "Mean": [([0.0, 0.0, 0.0], 'float32')], "Variance": [([1.0, 1.0, 1.0], 'float32')]},
     {},
     {"Y": [[[[0, 0], [0, 2]], [[1, 0], [0, 0]], [[0, 0], [0, 1]]], [[[0, 0], [0, 0]], [[1, 0], [0, 0]], [[-2, 0], [0, 0]]]], "MeanOut": [0.0375, 0.025, -0.0125], "VarianceOut": [0.94843745, 0.91875, 0.9609375], "SavedMean": [0.375, 0.25, -0.125], "SavedVariance": [0.484375, 0.1875, 0.609375]}),
    ('clip', 'clip',
     {"X": [(_P, 'float32')]},
     {'min': -0.5, 'max': 0.5},
     {"Out": [[0.5, 0.4002, 0.5], [0.5, 0.5, -0.5]]}),
    ('clip_by_norm', 'clip_by_norm',
     {"X": [(_P, 'float32')]},
     {'max_norm': 1.0},
     {"Out": [[0.47670126, 0.10814345, 0.26446775], [0.60554385, 0.50466937, -0.26408944]]}),
    ('squared_l2_norm', 'squared_l2_norm',
     {"X": [(_P, 'float32')]},
     {},
     {"Out": 13.69474}),
    ('sqrt', 'sqrt',
     {"X": [([0.0, 0.25, 2.0, 9.0], 'float32')]},
     {},
     {"Out": [0.0, 0.5, 1.4142135, 3.0]}),
    ('sign of 0 and nan', 'sign',
     {"X": [([-2.0, -0.0, 0.0, 3.5, _NAN, -_INF], 'float32')]},
     {},
     {"Out": [-1.0, -0.0, 0.0, 1.0, _NAN, -1.0]}),
    ('elementwise_max', 'elementwise_max',
     {"X": [(_P, 'float32')], "Y": [([0.1, -0.2, 0.3], 'float32')]},
     {},
     {"Out": [[1.7641, 0.4002, 0.9787], [2.2409, 1.8676, 0.3]]}),
    ('elementwise_mod negative', 'elementwise_mod',
     {"X": [([7.0, -7.0, 7.0, -7.0, 5.5], 'float32')], "Y": [([3.0, 3.0, -3.0, -3.0, 2.0], 'float32')]},
     {},
     {"Out": [1.0, 2.0, -2.0, -1.0, 1.5]}),
    ('elementwise_mod int32', 'elementwise_mod',
     {"X": [([7, -7, 7, -7, 0], 'int32')], "Y": [([3, 3, -3, -3, 4], 'int32')]},
     {},
     {"Out": [1, 2, -2, -1, 0]}),
    ('weight_norm dim 1', 'weight_norm',
     {"V": [(_P, 'float32')], "G": [([0.5, 1.5, 2.0], 'float32')]},
     {'dim': 1},
     {"Out": [[0.3092784, 0.31429362, 1.4152254], [0.39287, 1.4667035, -1.413201]]}),
    ('lars_momentum', 'lars_momentum',
     {"Param": [(_P, 'float32')], "Grad": [(_G, 'float32')], "LearningRate": [([0.05], 'float32')], "Velocity": [([[0.0076, 0.0012, 0.0044], [0.0033, 0.0149, -0.0021]], 'float32')]},
     {'mu': 0.9, 'lars_coeff': 0.001, 'lars_weight_decay': 0.0005},
     {"ParamOut": [[1.7571623, 0.39913517, 0.97475], [2.2378871, 1.8541744, -0.97555745]], "VelocityOut": [[0.0069375644, 0.0010648387, 0.003950017], [0.003012961, 0.013425602, -0.001742546]]}),
    ('adamax', 'adamax',
     {"Param": [(_P, 'float32')], "Grad": [(_G, 'float32')], "LearningRate": [([0.05], 'float32')], "Moment": [([[0.0031, -0.0085, -0.0255], [0.0065, 0.0086, -0.0074]], 'float32')], "InfNorm": [([[0.0727, 0.0645, 0.0505], [0.0519, 0.0653, 0.0647]], 'float32')], "Beta1Pow": [([0.729], 'float32')]},
     {},
     {"ParamOut": [[1.7402313, 0.42642835, 1.0663986], [2.2054572, 1.8416364, -0.98729914]], "MomentOut": [[0.01229, -0.00916, -0.02398], [0.0099599995, 0.00918, 0.00788]], "InfNormOut": [[0.095, 0.0644355, 0.0504495], [0.0518481, 0.065234706, 0.1454]]}),
    ('decayed_adagrad', 'decayed_adagrad',
     {"Param": [(_P, 'float32')], "Grad": [(_G, 'float32')], "LearningRate": [([0.05], 'float32')], "Moment": [([[0.0515, 0.0538, 0.0589], [0.0698, 0.0535, 0.0516]], 'float32')]},
     {},
     {"ParamOut": [[1.7427237, 0.4035392, 0.98087704], [2.2329247, 1.8644066, -1.0097872]], "MomentOut": [[0.04937625, 0.0511214, 0.0559603], [0.066394456, 0.050835367, 0.05007706]]}),
    ('adadelta', 'adadelta',
     {"Param": [(_P, 'float32')], "Grad": [(_G, 'float32')], "LearningRate": [([0.05], 'float32')], "AvgSquaredGrad": [([[0.0623, 0.062, 0.0539], [0.053, 0.0605, 0.0642]], 'float32')], "AvgSquaredUpdate": [([[0.0671, 0.0695, 0.0551], [0.0544, 0.0625, 0.0578]], 'float32')]},
     {},
     {"ParamOut": [[1.6633304, 0.41660097, 0.989384], [2.1982148, 1.8525851, -1.1176356]], "AvgSquaredGradOut": [[0.05963625, 0.058911398, 0.051210303], [0.05043446, 0.057485368, 0.062047057]], "AvgSquaredUpdateOut": [[0.06425273, 0.066038445, 0.052350707], [0.0517711, 0.059386272, 0.055894703]]}),
    ('rmsprop centered', 'rmsprop',
     {"Param": [(_P, 'float32')], "Grad": [(_G, 'float32')], "LearningRate": [([0.05], 'float32')], "MeanSquare": [([[0.0661, 0.0521, 0.059], [0.0539, 0.0551, 0.0618]], 'float32')], "Moment": [([[-0.0003, 0.0043, 0.0007], [0.003, -0.0063, -0.0036]], 'float32')], "MeanGrad": [([[-0.0067, -0.0036, -0.0081], [-0.0173, 0.0018, -0.004]], 'float32')]},
     {'decay': 0.9, 'momentum': 0.5, 'centered': True, 'epsilon': 0.0001},
     {"ParamOut": [[1.7449354, 0.40153292, 0.980584], [2.230083, 1.8675203, -1.0057616]], "MeanSquareOut": [[0.0603925, 0.0469128, 0.053110607], [0.04867892, 0.049610734, 0.057734117]], "MomentOut": [[0.019164614, -0.0013329173, -0.0018840394], [0.01081711, 7.959688e-05, 0.028461622]], "MeanGradOut": [[0.0034699999, -0.00475, -0.00832], [-0.01146, 0.00306, 0.01094]]}),
    ('ftrl', 'ftrl',
     {"Param": [(_P, 'float32')], "Grad": [(_G, 'float32')], "LearningRate": [([0.05], 'float32')], "SquaredAccumulator": [([[0.0663, 0.0546, 0.0591], [0.0505, 0.0573, 0.0513]], 'float32')], "LinearAccumulator": [([[0.0114, -0.0123, 0.004], [-0.0068, -0.0087, -0.0058]], 'float32')]},
     {'l1': 0.01, 'l2': 0.01},
     {"ParamOut": [[0.08752807, 0.0045291735, 0.00011649584], [0.026751028, 9.620155e-05, -0.17829302]], "SquaredAccumOut": [[0.075325, 0.05482801, 0.059206087], [0.052189212, 0.057507362, 0.07244116]], "LinearAccumOut": [[-0.49219912, -0.031301048, -0.010569252], [-0.13276024, -0.01046332, 0.97331345]]}),
    ('lamb', 'lamb',
     {"Param": [(_P, 'float32')], "Grad": [(_G, 'float32')], "LearningRate": [([0.05], 'float32')], "Moment1": [([[-0.0031, 0.0006, -0.0117], [0.009, 0.0047, -0.0154]], 'float32')], "Moment2": [([[0.0649, 0.069, 0.0618], [0.0518, 0.0607, 0.0605]], 'float32')], "Beta1Pow": [([0.729], 'float32')], "Beta2Pow": [([0.997], 'float32')]},
     {},
     {"ParamOut": [[1.6749736, 0.38756734, 0.97721034], [2.1118402, 1.7770652, -0.9415433]], "Moment1Out": [[0.0067099994, -0.00097000005, -0.01156], [0.012209999, 0.00567, 0.00068000145]], "Moment2Out": [[0.064844124, 0.06893123, 0.061738305], [0.05174989, 0.060639508, 0.060460642]]}),
    ('dpsgd sigma 0', 'dpsgd',
     {"Param": [(_P, 'float32')], "Grad": [(_G, 'float32')], "LearningRate": [([0.05], 'float32')]},
     {'clip': 0.2, 'batch_size': 8.0, 'sigma': 0.0},
     {"ParamOut": [[1.75935, 0.40095502, 0.97921497], [2.238845, 1.8668799, -0.98456997]]}),
    ('dgc_momentum before rampup', 'dgc_momentum',
     {"Param": [(_P, 'float32')], "Grad": [(_G, 'float32')], "LearningRate": [([0.05], 'float32')], "Velocity": [([[-0.004, 0.0122, 0.0021], [0.0098, 0.0036, 0.0071]], 'float32')], "ErrorAccum": [([[0.0001, 0.0179, 0.0013], [0.004, 0.0188, -0.0135]], 'float32')], "Step": [([1.0], 'float32')]},
     {'rampup_begin_step': 3, 'sparsity': [0.5]},
     {"ParamOut": [[1.75953, 0.400406, 0.9791205], [2.238404, 1.8667179, -0.9848895]], "VelocityOut": [[0.0914, -0.0041200006, -0.00841], [0.04992, 0.01764, 0.15179001]], "ErrorAccumOut": [[1e-04, 0.0179, 0.0013], [0.004, 0.0188, -0.0135]], "StepOut": [2.0]}),
    ('dgc_momentum after rampup', 'dgc_momentum',
     {"Param": [(_P, 'float32')], "Grad": [(_G, 'float32')], "LearningRate": [([0.05], 'float32')], "Velocity": [([[-0.0127, 0.0097, -0.0117], [0.0194, -0.0041, -0.0075]], 'float32')], "ErrorAccum": [([[0.0192, 0.0148, 0.0187], [0.0091, -0.0086, 0.0191]], 'float32')], "Step": [([5.0], 'float32')]},
     {'rampup_begin_step': 3, 'sparsity': [0.5]},
     {"ParamOut": [[1.7589614, 0.4002, 0.9787], [2.237517, 1.8676, -0.9851875]], "VelocityOut": [[0.0, -0.0063700005, -0.02083], [0.0, 0.01071, 0.0]], "ErrorAccumOut": [[0.0, 0.008429999, -0.00213], [0.0, 0.0021099998, 0.0]], "StepOut": [6.0]}),
)


def _same_values(got, want, tol):
    """Equal shapes and values: NaN where NaN, the same infinities, finite
    floats to ``tol`` of the largest finite magnitude, the rest exactly."""
    got, want = got.double(), want.double()
    if got.shape != want.shape or not torch.equal(got.isnan(), want.isnan()):
        return False
    g, w = got[~got.isnan()], want[~want.isnan()]
    if not torch.equal(g.isinf(), w.isinf()) or not torch.equal(
            g[g.isinf()], w[w.isinf()]):
        return False
    g, w = g[~g.isinf()], w[~w.isinf()]
    if not g.numel():
        return True
    return float((g - w).abs().max()) <= tol * max(float(w.abs().max()), 1e-30)


def phase_op_rules():
    """Each OP_RULE_CASES rule on CUDA tensors against its JAX values and
    against the same rule on the CPU: no device assert (the sync after
    each case would raise it), the same values."""
    import paddle_tpu_torch.ops  # noqa: F401  (registers the rules)
    from paddle_tpu_torch.dtypes import convert_dtype
    from paddle_tpu_torch.registry import OpLoweringContext, get_lowering

    bad = []
    for label, op, ins, attrs, want in OP_RULE_CASES:
        outs = {}
        for dev in ("cuda", "cpu"):
            ctx = OpLoweringContext(None, torch.Generator(dev).manual_seed(0))
            t_ins = {k: [torch.tensor(v).to(convert_dtype(dt)).to(dev)
                         for v, dt in vals] for k, vals in ins.items()}
            outs[dev] = get_lowering(op)(t_ins, dict(attrs), ctx)
            torch.cuda.synchronize()
        rec = {"phase": "op_rules", "case": label}
        for slot, ref in want.items():
            card, cpu = outs["cuda"][slot][0], outs["cpu"][slot][0]
            rec["dtype"] = str(card.dtype).replace("torch.", "")
            rec["card"] = (card.cpu().float() if card.is_floating_point()
                           else card.cpu()).tolist()
            # floats to 1e-6 of the largest (the card's exp differs from
            # the CPU's in the last place), everything else exactly
            tol = 1e-6 if card.is_floating_point() else 0.0
            rec["card_equals_cpu"] = (card.dtype == cpu.dtype
                                      and _same_values(card.cpu(), cpu, tol))
            ok = rec["card_equals_cpu"]
            if ref is not None:
                rec["card_equals_jax"] = _same_values(
                    card.cpu(), torch.tensor(ref, dtype=torch.float64), tol)
                ok = ok and rec["card_equals_jax"]
            if not ok:
                bad.append(label)
        emit(rec)
    if bad:
        raise AssertionError("op rules on the card differ: %s" % bad)


# -- item 3-A's classes and the monitor stack on the card (phases 29-34) ------

PROFILED_STEPS = 2
# the port kernels phase 34's profiler table must list, each with the
# wrapper that launches it (a pattern, since the table holds demangled names)
PROFILED_KERNELS = (("ln_fwd_kernel", "layer_norm_fwd"),
                    ("ln_bwd_\\w*_kernel", "layer_norm_bwd"),
                    ("flash_fwd_mma_kernel", "flash_attention_fwd"),
                    ("flash_delta_kernel", "flash_attention_bwd"),
                    ("flash_bwd_dkv_mma_kernel", "flash_attention_bwd"),
                    ("flash_bwd_dq_mma_kernel", "flash_attention_bwd"))
MON_SAMPLE_EVERY = 8
# phase 30's runs, each mode twice over, first and last in turn
MON_ORDER = ("off", "monitor", "sentinel", "skip_batch", "skip_batch",
             "sentinel", "monitor", "off")
MON_DIR = "build/monitor"
MON_BOOK = (("sentiment_conv", "dense", False), ("recommender", "sparse", False),
            ("image_resnet", "amp", True))
CLASS_STEPS, CLASS_TOL = 3, 1e-5
# RMSProp and Adadelta divide each element's step by its own running
# gradient size, so a bias gradient that nearly cancels over the batch
# carries its rounding into a relative error (tests/test_torch_optimizers.py)
CLASS_TOL_PER_ELEMENT = {"Adadelta": 1e-4, "RMSProp": 1e-4,
                         "RMSPropCentered": 2e-4}
TRUNC_N, TRUNC_VAR = 100000, 0.7737413       # a unit normal cut to [-2, 2]


def _profiled_kernel_calls(rows):
    """{pattern: calls} of PROFILED_KERNELS among the table's device rows."""
    return {pat: sum(r["calls"] for r in rows if r["device"] == "device"
                     and re.search(r"\b" + pat + r"\b", r["name"]))
            for pat, _ in PROFILED_KERNELS}


def phase_profiler(kernels_per_call):
    """Phase 34 (run last): PROFILED_STEPS BERT-base steps of phase 4's
    trainer, after a warm-up step, under ``profiler.profiler()`` with the
    counts set to 0: each kernel count must rise by its per-step count x
    PROFILED_STEPS, and the aggregate table must list the LN and flash
    kernels with phase 15's kernels a call x their launches a step x
    PROFILED_STEPS (``check_profiled_calls``).  The profiler now and then
    loses a kernel's record (``cuda_kernels_per_call``), so a capture whose
    table misses a launch is taken once more; both are printed.  It runs
    last: after this capture (host and card activity, ~10^5 events), the
    card-only captures of later ``torch.profiler`` sessions in the same
    process lost most kernel records (H100 80GB HBM3, torch 2.11)."""
    import os

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.kernels import _common

    lr = 1e-4
    _, trainer, batches = _bert_slice()
    trainer.step(batches[0], lr)                   # warm-up
    torch.cuda.synchronize()

    os.environ["PADDLE_TPU_TRACE_DIR"] = _fresh_dir("profiler_bert")
    want = {k: v * PROFILED_STEPS for k, v in PER_STEP.items()}
    attempts = []
    for _ in range(2):
        _common.reset_launches()
        t0 = time.perf_counter()
        with profiler.profiler("All", sorted_key="calls"):
            for b in batches[1:1 + PROFILED_STEPS]:
                trainer.step(b, lr)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in _common.launches.items() if v}
        if counts != want:
            raise AssertionError("launch counts under the profiler %s, "
                                 "expected %s" % (counts, want))
        rows = profiler.aggregate_profile(None, "calls")
        calls = _profiled_kernel_calls(rows)
        attempts.append(calls)
        emit({"phase": "profiler", "config": "bert_base", "steps":
              PROFILED_STEPS, "wall_seconds": wall, "launches": counts,
              "table_rows": len(rows), "kernel_calls": calls,
              "kernels": [{k: r[k] for k in ("name", "calls", "total_ms",
                                              "avg_ms")}
                          for r in rows if r["device"] == "device"
                          and any(re.search(r"\b" + p + r"\b", r["name"])
                                  for p, _ in PROFILED_KERNELS)]})
        if all(calls[p] == PER_STEP[w] * PROFILED_STEPS
               for p, w in PROFILED_KERNELS):
            break
    del trainer, batches
    torch.cuda.empty_cache()
    check_profiled_calls(attempts[-1], kernels_per_call)


def check_profiled_calls(calls, kernels_per_call):
    """Phase 34's table against phase 15: each kernel's calls equal its
    launches a wrapper call x the wrapper's launches a step x
    PROFILED_STEPS."""
    want = {}
    for pat, wrapper in PROFILED_KERNELS:
        per = [n for name, (n, _) in kernels_per_call[wrapper].items()
               if re.search(r"\b" + pat + r"\b", name)]
        want[pat] = sum(per) * PER_STEP[wrapper] * PROFILED_STEPS
    emit({"phase": "profiler_check", "table_calls": calls, "expected": want,
          "ok": calls == want})
    if calls != want:
        raise AssertionError("profiler table calls %s, expected %s (phase "
                             "15's launches a step x %d)"
                             % (calls, want, PROFILED_STEPS))


def _lenet_setup(n_feeds):
    """LeNet + Adam(1e-3) on the card (phase 20's program): its startup
    values and ``n_feeds`` MNIST batches of LENET_B."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.datasets import mnist
    from paddle_tpu_torch.tools import profile_step

    main, startup, v = profile_step.lenet_programs(
        fluid, fluid.optimizer.Adam(1e-3))
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    values = convert.scope_to_numpy(
        scope, [x.name for x in startup.list_vars() if x.persistable])
    feeder = fluid.DataFeeder([v["img"], v["label"]], program=main)
    rows = iter(mnist.train()())
    feeds = [feeder.feed([next(rows) for _ in range(LENET_B)])
             for _ in range(n_feeds)]
    return main, v, values, feeds


def _fresh_dir(name):
    import os

    path = os.path.join(MON_DIR, name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def _lenet_run(main, v, values, feeds, mode):
    """LENET_WARMUP + LENET_TIMED steps from ``values`` with the monitor
    off, on (``monitor``) or on with the sentinel (``sentinel``: halt,
    sampled 1 in MON_SAMPLE_EVERY; ``skip_batch``: the guard every step):
    (ms a timed step, the losses, the monitor dir)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, monitor

    out_dir = None
    if mode != "off":
        out_dir = _fresh_dir("lenet_" + mode)
        monitor.enable(out_dir)
        if mode != "monitor":
            monitor.sentinel.enable(
                policy="halt" if mode == "sentinel" else mode,
                sample_every=MON_SAMPLE_EVERY)
    try:
        exe = fluid.Executor()
        scope = convert.scope_from_numpy(values, fluid.Scope(), "cuda")
        fetch = [v["loss"], v["acc"]]
        losses = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)[0]
                  for f in feeds[:LENET_WARMUP]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [exe.run(main, feed=f, fetch_list=fetch, scope=scope)[0]
                   for f in feeds[LENET_WARMUP:]]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        monitor.disable()
    return dt / LENET_TIMED * 1e3, losses, out_dir


def _trace_summary(out_dir):
    """``scripts/trace_summary.py --timeline out_dir --json`` (a JAX-free
    CLI of the repo, reading the files): its summary."""
    r = subprocess.run([sys.executable, "scripts/trace_summary.py",
                        "--timeline", out_dir, "--json"],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError("trace_summary.py failed on %s: %s"
                             % (out_dir, r.stderr[-2000:]))
    return json.loads(r.stdout.strip().splitlines()[-1])


def _deterministic_cudnn():
    """cuDNN's deterministic algorithms: the bit-for-bit checks compare
    two runs of the same step."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return saved


def phase_lenet_monitored(card):
    """Phase 30: phase 20's LeNet, LENET_TIMED steps after LENET_WARMUP,
    with the monitor off, on, on with the sentinel (halt, sampled 1 in
    MON_SAMPLE_EVERY) and on with ``skip_batch``, four runs each in
    MON_ORDER twice over: ms a step of each run and the overheads of the
    medians; the losses of every run equal the first run's with the
    monitor off, bit for bit; ``trace_summary.py`` reads each monitored
    directory."""
    import numpy as np

    from paddle_tpu_torch.kernels import _common

    saved = _deterministic_cudnn()
    try:
        main, v, values, feeds = _lenet_setup(LENET_WARMUP + LENET_TIMED)
        ms, losses, dirs = {}, {}, {}
        _common.reset_launches()
        for mode in MON_ORDER * 2:
            t, ls, d = _lenet_run(main, v, values, feeds, mode)
            ms.setdefault(mode, []).append(t)
            losses.setdefault(mode, []).append(
                np.concatenate([np.asarray(x).reshape(-1) for x in ls]))
            dirs[mode] = d
        counts = {k: n for k, n in _common.launches.items() if n}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    ref = losses["off"][0]
    same = {m: all(np.array_equal(ref, x) for x in runs)
            for m, runs in losses.items()}
    summaries = {m: _trace_summary(dirs[m])
                 for m in ("monitor", "sentinel", "skip_batch")}
    median = {m: float(np.median(t)) for m, t in ms.items()}
    rec = {"phase": "lenet_monitored", "nvidia_smi": card,
           "steps_timed": LENET_TIMED, "warmup": LENET_WARMUP,
           "sample_every": MON_SAMPLE_EVERY, "ms_per_step": ms,
           "median_ms_per_step": median,
           "overhead_of_median": {m: median[m] / median["off"] - 1
                                  for m in median if m != "off"},
           "losses_equal_to_monitor_off": same,
           "trace_summary_steps": {m: s["steps"] for m, s in summaries.items()},
           "health_samples": summaries["sentinel"].get("health_samples"),
           "port_launches": counts}
    ok = (all(same.values()) and not counts
          and all(s["steps"] == LENET_WARMUP + LENET_TIMED
                  for s in summaries.values())
          and summaries["sentinel"].get("health_samples", 0) > 0
          and summaries["skip_batch"].get("health_samples", 0) > 0)
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise AssertionError("LeNet under the monitor: %s" % rec)


def phase_sentinel_drills(card):
    """Phase 31: the sentinel's drills on phase 20's LeNet on the card:
    ``nan_batch`` at the third step under ``halt`` (sampled every step)
    raises naming a tensor and writes a postmortem; under ``skip_batch``
    the parameters equal a clean run's that never saw the batch, bit for
    bit, with one skip counted; ``FLAGS_check_nan_inf`` names the tensor."""
    import json as _json

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, monitor
    from paddle_tpu_torch.ft import chaos
    from paddle_tpu_torch.monitor.sentinel import NonFiniteError

    saved = _deterministic_cudnn()
    try:
        main, v, values, feeds = _lenet_setup(6)
        persist = sorted(x.name for x in main.list_vars() if x.persistable)
        names = set(persist) | {v["loss"].name, v["acc"].name}

        def train(batches, policy=None, nan_at=None):
            if policy is not None:
                monitor.enable(_fresh_dir("drill_" + policy))
                monitor.sentinel.enable(policy=policy, sample_every=1)
            if nan_at is not None:
                chaos.arm("nan_batch", at=nan_at)
            try:
                exe = fluid.Executor()
                scope = convert.scope_from_numpy(values, fluid.Scope(), "cuda")
                for f in batches:
                    exe.run(main, feed=f, fetch_list=[v["loss"]], scope=scope)
                skips = (monitor.active().registry.counter(
                    "monitor.health.skipped_batches").value
                    if policy else None)
                return {n: scope.find_var(n) for n in persist}, skips
            finally:
                chaos.disarm()
                monitor.disable()

        rec = {"phase": "sentinel_drills", "nvidia_smi": card}
        try:
            train(feeds[:5], "halt", nan_at=3)
            raise AssertionError("halt: the poisoned batch did not raise")
        except NonFiniteError as e:
            with open(e.postmortem) as f:
                post = _json.load(f)
            rec["halt"] = {"step": e.step, "first": e.first,
                           "postmortem_reason": post["reason"]}
            halt_ok = (e.step == 2 and e.first in names
                       and post["health"]["first_bad"] == e.first)
        skipped, skips = train(feeds, "skip_batch", nan_at=3)
        clean, _ = train(feeds[:2] + feeds[3:])
        bits = all(torch.equal(skipped[n], clean[n]) for n in persist)
        rec["skip_batch"] = {"skips": skips, "equal_to_clean_bit_for_bit": bits}
        bad = dict(feeds[0])
        bad["img"] = np.array(bad["img"], copy=True)
        bad["img"].reshape(-1)[7] = np.nan
        fluid.set_flags({"FLAGS_check_nan_inf": True})
        try:
            exe = fluid.Executor()
            scope = convert.scope_from_numpy(values, fluid.Scope(), "cuda")
            exe.run(main, feed=bad, fetch_list=[v["loss"]], scope=scope)
            flag_msg = None
        except RuntimeError as e:
            flag_msg = str(e)
        finally:
            fluid.set_flags({"FLAGS_check_nan_inf": False})
        flag_ok = bool(flag_msg) and "FLAGS_check_nan_inf" in flag_msg and any(
            "%r" % n in flag_msg for n in names)
        rec["check_nan_inf"] = flag_msg
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    rec["ok"] = ok = halt_ok and skips == 1 and bits and flag_ok
    emit(rec)
    if not ok:
        raise AssertionError("sentinel drills on the card: %s" % rec)


def phase_memscope(card):
    """Phase 32: MemScope on the card with phase 20's LeNet: the plan's
    ledger (measured on its first run, temp bytes from the allocator's
    peak); the snapshot's ``bytes_in_use`` above 0 and within
    ``bytes_limit``; the scope's owner bytes; the ``oom_step`` drill's
    postmortem with its memory section; refuse mode with a configured limit
    of 1 MB raising before the dispatch, the state unchanged."""
    import json as _json
    import os

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, monitor
    from paddle_tpu_torch.ft import chaos
    from paddle_tpu_torch.monitor import memscope

    main, v, values, feeds = _lenet_setup(3)
    out_dir = _fresh_dir("memscope")
    memscope.reset()
    mon = monitor.enable(out_dir)
    rec = {"phase": "memscope", "nvidia_smi": card}
    try:
        exe = fluid.Executor()
        scope = convert.scope_from_numpy(values, fluid.Scope(), "cuda")
        exe.run(main, feed=feeds[0], fetch_list=[v["loss"]], scope=scope)
        (ident, ledger), = memscope.ledgers()
        snap = mon.maybe_sample_memory(force=True)
        dev = snap["devices"]["cuda:0"]
        rec.update(ledger=ledger, device=dev, owners=snap.get("owners"),
                   hbm_frac=snap.get("hbm_frac"))
        ok = (ledger.get("temp_bytes") is not None
              and ledger["argument_bytes"] > 0 and ledger["output_bytes"] > 0
              and 0 < dev["bytes_in_use"] <= dev["bytes_limit"]
              and snap["owners"].get("scope", 0) > 0)
        chaos.arm("oom_step", at=1)
        try:
            exe.run(main, feed=feeds[1], fetch_list=[v["loss"]], scope=scope)
            oom = None
        except memscope.InjectedOOMError as e:
            oom = str(e)
        finally:
            chaos.disarm()
        # refuse mode: a new executor's plan is measured on its first run
        # and refused before its second dispatch
        exe = fluid.Executor()
        exe.run(main, feed=feeds[1], fetch_list=[v["loss"]], scope=scope)
        before = {p.name: scope.find_var(p.name).clone()
                  for p in main.all_parameters()}
        memscope.configure(bytes_limit=1 << 20, refuse=True)
        try:
            exe.run(main, feed=feeds[2], fetch_list=[v["loss"]], scope=scope)
            refused = None
        except memscope.MemoryBudgetError as e:
            refused = str(e)
        unchanged = bool(before) and all(
            torch.equal(t, scope.find_var(n)) for n, t in before.items())
        rec.update(refused=refused, state_unchanged=unchanged)
        post_path = os.path.join(out_dir, "postmortem.json")
        with open(post_path) as f:
            post = _json.load(f)
        rec["oom_postmortem"] = {"reason": post["reason"],
                                 "ledger": post["mem_oom"]["ledger"],
                                 "owners_top": post["mem_oom"]["owners_top"]}
        ok = (ok and refused is not None and unchanged and oom is not None
              and post["reason"] == "resource_exhausted")
    finally:
        monitor.disable()
        memscope.reset()
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise AssertionError("MemScope on the card: %s" % rec)


def phase_book_monitored(card):
    """Phase 33: one book model each of the dense, sparse and AMP paths,
    BOOK_WARMUP + BOOK_TIMED steps from the same values with the monitor
    off and on, four runs each (off, on, on, off, twice): ms a step of each
    run and the overhead of the medians."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert, monitor

    def amp_adam(fl, lr):
        return fl.amp.decorate(fl.optimizer.Adam(lr))

    bad = []
    for model, path, amp in MON_BOOK:
        opt = amp_adam if amp else None
        values = _startup_values(_book(model, optimizer=opt))
        ms = {}
        for mode in ("off", "on", "on", "off") * 2:
            run = _book(model, optimizer=opt)
            if mode == "on":
                monitor.enable(_fresh_dir("book_" + model))
            try:
                exe = fluid.Executor(fluid.CUDAPlace(0))
                scope = convert.scope_from_numpy(values, fluid.Scope(), "cuda")
                for _ in range(BOOK_WARMUP):
                    exe.run(run.main, feed=run.feed, fetch_list=run.fetch,
                            scope=scope)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = [exe.run(run.main, feed=run.feed, fetch_list=run.fetch,
                                scope=scope) for _ in range(BOOK_TIMED)]
                torch.cuda.synchronize()
                ms.setdefault(mode, []).append(
                    (time.perf_counter() - t0) / BOOK_TIMED * 1e3)
            finally:
                monitor.disable()
            if not all(np.isfinite(o[0]).all() for o in outs):
                bad.append(model)
        emit({"phase": "book_monitored", "model": model, "path": path,
              "nvidia_smi": card, "steps_timed": BOOK_TIMED, "ms_per_step": ms,
              "overhead_of_median": float(np.median(ms["on"])
                                          / np.median(ms["off"]) - 1)})
    if bad:
        raise AssertionError("book models under the monitor gave non-finite "
                             "losses: %s" % bad)


def _class_optimizers():
    return {
        "DGCMomentum": lambda f: f.optimizer.DGCMomentumOptimizer(
            0.1, 0.9, rampup_begin_step=1, rampup_step=2, sparsity=[0.5, 0.75]),
        "LarsMomentum": lambda f: f.optimizer.LarsMomentum(0.5, 0.9),
        "Adamax": lambda f: f.optimizer.Adamax(0.05),
        "Dpsgd": lambda f: f.optimizer.Dpsgd(0.1, clip=0.5, batch_size=16.0,
                                             sigma=0.0),
        "DecayedAdagrad": lambda f: f.optimizer.DecayedAdagrad(0.05),
        "Adadelta": lambda f: f.optimizer.Adadelta(1.0),
        "RMSProp": lambda f: f.optimizer.RMSProp(0.01, momentum=0.5),
        "RMSPropCentered": lambda f: f.optimizer.RMSProp(0.01, centered=True),
        "Ftrl": lambda f: f.optimizer.Ftrl(0.1, l1=0.01, l2=0.01),
        "Lamb": lambda f: f.optimizer.Lamb(0.05),
        "ClipByValue": lambda f: f.optimizer.SGD(
            0.5, grad_clip=f.clip.GradientClipByValue(0.05)),
        "ClipByNorm": lambda f: f.optimizer.SGD(
            0.5, grad_clip=f.clip.GradientClipByNorm(0.1)),
        "ClipByGlobalNorm": lambda f: f.optimizer.Momentum(
            0.5, 0.9, grad_clip=f.clip.GradientClipByGlobalNorm(0.1)),
        "L1Decay": lambda f: f.optimizer.Adam(
            0.05, regularization=f.regularizer.L1Decay(1e-2)),
        "Lookahead": lambda f: f.optimizer.LookaheadOptimizer(
            f.optimizer.Adam(0.05), alpha=0.5, k=2),
        "WeightNorm": lambda f: f.optimizer.SGD(0.2),
        "TruncatedNormal": lambda f: f.optimizer.SGD(0.2),
    }


def _class_steps(name, make_opt, device):
    """tests/test_torch_optimizers.py's MLP with ``name``'s class, built
    on the port, its startup run on the CPU, then CLASS_STEPS steps on
    ``device`` from those values: the losses and every persistable."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert

    attr = {"WeightNorm": lambda f: f.WeightNormParamAttr(dim=1),
            "TruncatedNormal": lambda f: f.ParamAttr(
                initializer=f.initializer.TruncatedNormal(0.2, 0.5))}.get(name)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[6], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 8, act="tanh",
                            param_attr=None if attr is None else attr(fluid))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(h, 1), y))
        make_opt(fluid).minimize(loss)
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
    persist = sorted(v.name for v in startup.list_vars() if v.persistable)
    scope = convert.scope_from_numpy(convert.scope_to_numpy(cpu_scope, persist),
                                     fluid.Scope(), device)
    exe = _executor(device)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(CLASS_STEPS):
        xs = rng.randn(16, 6).astype(np.float32)
        feed = {"x": xs, "y": (xs[:, :1] * 0.7 - xs[:, 1:2] * 0.3)}
        losses.append(exe.run(main, feed=feed, fetch_list=[loss],
                              scope=scope)[0])
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    return losses, convert.scope_to_numpy(scope, names)


def phase_op_classes(card):
    """Phase 29: every optimizer, clip, decay, initializer and weight-norm
    class of ROADMAP Queue 1 item 3-A trains CLASS_STEPS steps of a small
    MLP on the card and on the CPU from the same values: the losses and
    every persistable to CLASS_TOL of the largest magnitude (the CPU's are
    held to the JAX package by tests/test_torch_optimizers.py); then
    ``truncated_gaussian_random`` on the card: its support and first two
    moments at TRUNC_N.  No port kernel launched."""
    import paddle_tpu_torch.ops  # noqa: F401  (registers the rules)
    from paddle_tpu_torch.registry import OpLoweringContext, get_lowering

    worst, bad = {}, []
    for name, make_opt in _class_optimizers().items():
        tol = CLASS_TOL_PER_ELEMENT.get(name, CLASS_TOL)
        card_l, card_p = _class_steps(name, make_opt, "cuda")
        cpu_l, cpu_p = _class_steps(name, make_opt, "cpu")
        errs = [_rel(a, b) for a, b in zip(card_l, cpu_l)]
        errs += [_rel(card_p[n], cpu_p[n]) for n in cpu_p]
        worst[name] = max(errs)
        if not worst[name] <= tol:
            bad.append(name)
    ctx = OpLoweringContext(None, torch.Generator("cuda").manual_seed(0))
    mean, std = 0.2, 0.5
    t = get_lowering("truncated_gaussian_random")(
        {}, {"shape": [TRUNC_N], "mean": mean, "std": std, "seed": 3,
             "dtype": "float32"}, ctx)["Out"][0]
    torch.cuda.synchronize()
    t = t.double().cpu().numpy()
    trunc = {"min": float(t.min()), "max": float(t.max()),
             "mean": float(t.mean()), "var": float(t.var())}
    trunc_ok = bool(t.min() >= mean - 2 * std - 1e-6
                    and t.max() <= mean + 2 * std + 1e-6
                    and abs(t.mean() - mean) <= 0.02 * std
                    and abs(t.var() / (std * std * TRUNC_VAR) - 1) <= 0.02)
    rec = {"phase": "op_classes", "nvidia_smi": card, "steps": CLASS_STEPS,
           "max_rel_err_card_vs_cpu": worst, "tol": CLASS_TOL,
           "tol_per_element": CLASS_TOL_PER_ELEMENT,
           "truncated_normal": trunc, "ok": not bad and trunc_ok}
    emit(rec)
    if bad or not trunc_ok:
        raise AssertionError("op classes on the card: %s" % rec)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: the port package is missing (%s); run from the "
              "repository's root" % e, file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, card = phase_device()
    phase_build()
    errs = phase_compare()
    launches = phase_slice(name)
    phase_parity()
    kernels = phase_times(errs, launches, name)
    bn_errs = phase_compare_bn()
    bn_launches = phase_resnet_slice(name)
    phase_resnet_parity()
    kernels += phase_times_bn(bn_errs, bn_launches, name)
    new_errs = {"segment_sum": phase_compare_segment()}
    new_launches = {"segment_sum": phase_deepfm_slice(name),
                    "flash_attention_bwd": launches["flash_attention_bwd"]}
    phase_deepfm_parity()
    new_errs["conv_wgrad"], new_launches["conv_wgrad"] = phase_compare_conv()
    new_errs["flash_attention_bwd_long"] = phase_compare_flash_long()
    per_call, per_kernel = phase_kernels_per_call()
    one_launch = ("layer_norm_bwd", "segment_sum", "bn_stats", "bn_bwd_reduce")
    if any(per_call[k] != 1 for k in one_launch):
        raise AssertionError("CUDA kernels a call, by torch.profiler: %s "
                             "(expected 1 for %s)" % (per_call, one_launch))
    kernels += phase_times_new(new_errs, new_launches, name)
    nmt_cfg, nmt_params = phase_nmt_slice(name)
    phase_nmt_serving(nmt_cfg, nmt_params)
    del nmt_params
    phase_nmt_parity()
    assert_no_launches("NMT serving and parity")
    from paddle_tpu_torch.kernels import _common
    _common.reset_launches()
    trained = phase_lenet_slice(name, card)
    phase_lenet_parity(card)
    assert_no_launches("LeNet slice and parity")
    phase_deploy(card, trained)
    del trained
    assert_no_launches("the deploy path")
    phase_control_flow(card)
    assert_no_launches("control flow")
    phase_op_rules()
    phase_op_classes(card)
    assert_no_launches("op rules and classes")
    phase_lenet_monitored(card)
    phase_sentinel_drills(card)
    phase_memscope(card)
    assert_no_launches("the monitored LeNet, the sentinel drills, MemScope")
    phase_book_training(card)
    phase_book_parity(card)
    phase_book_amp(card)
    phase_book_monitored(card)
    assert_no_launches("the book suite (training, parity, AMP, monitored)")
    seg_per_step = phase_book_sparse(card)
    for rec in kernels:
        if rec["name"] == "segment_sum":
            rec["sparse_executor_launches_per_step"] = seg_per_step
    phase_profiler(per_kernel)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
