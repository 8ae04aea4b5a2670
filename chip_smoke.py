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
    recommender, 0 under SGD, whose sparse branch does not merge); each
    route's first-step update of every sparse table held to the bounds
    derived from its arithmetic (``tools/fp_bounds.py``: the merge against
    the exact sum of the same contributions, Adam's outputs against a
    float64 recomputation and bit for bit against their f32 replay, SGD's
    table against its float64 recomputation), with ``max_err_over_bound``
    printed; the routes' distance from each other printed, the sparse path
    against the dense gradient; ms per step of each; its launches per step
    go into the segment kernel's record as
    ``sparse_executor_launches_per_step``;
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
34. the profiler on the kernel path: phase 4's trainer, a warm-up
    step, then two steps under ``fluid.profiler.profiler()`` with the
    counts set to 0 (48 / 48 / 24 / 24 launches): the aggregate table must
    list ``ln_fwd_kernel``, ``ln_bwd_*_kernel``, ``flash_fwd_mma_kernel``
    and the three flash backward kernels, each with phase 15's CUDA kernels
    a call x its wrapper's launches a step x 2 calls (taken after the
    other card captures: later card-only captures in the same process lost
    kernel records);
35. the native datafeed: the port's own build of
    ``runtime/datafeed.cc`` (asserted, with its build or load seconds);
    four seeded MultiSlot files of 3000 lines, every 7th malformed, parsed
    by ``QueueDataset`` on one thread in the same order as the Python
    parser, by ``InMemoryDataset`` in the same order, on four threads into
    the same multiset, the malformed lines dropped;
36. ``ctr_dataset``: the CTR program (``tools/ctr_program.py``) at
    ``DeepFMConfig()``'s widths (1M features, 39 fields, embed 10 and a
    first-order table, MLP 400-400-400, f32, B = 8192, Adam 1e-3, ids from
    a Zipf(0.99) law) trained two passes by ``train_from_dataset`` on
    ``InMemoryDataset`` and ``QueueDataset`` (1 and 4 threads), the pipe on
    and off, on the segment kernel's route: 2 ``segment_sum`` launches a
    step and no other kernel; every run on one thread bit for bit the
    first, a second and a monitored run too; the last pass's mean loss
    below the first's; first, one step on each merge route and on the CPU
    with each table's update held to its derived bounds (as in 27), the
    routes' and the CPU's distances printed; ms a step and examples/s of
    each run, the pipe's ``feed_stall_ms`` and ``overlap_ms``, and the
    segment kernel's times at the two tables' shapes with their bounds;
37. ``deepfm_hostfed``: ``bench.py``'s host-fed DeepFM line,
    ``build_deepfm_trainer(DeepFMConfig(), variant="segment")``, a fresh
    numpy batch each of 100 steps through ``DeviceFeedPipe`` (pinned
    buffers, a side stream) and ``InFlightWindow(2)``, or inline with the
    loss read each step, interleaved: the losses bit for bit, one
    ``segment_sum`` a step, ms a step and examples/s;
38. ``dataloader``: LeNet at B = 64 for 20 steps through
    ``DataLoader.from_generator`` and a ``py_reader`` program: the staged
    batches on the card equal the host's, the losses equal the ``feed=``
    path's bit for bit (cuDNN deterministic), ``EOFException`` after the
    last batch;
39. ``rules_3b``: every row of ``tools/rule_cases.py`` (ROADMAP Queue 1
    item 3-B's tranches 1-4 with ``ctc_align`` and ``edit_distance``: the
    rules that compute, with their traps and edges, and the inputs of
    Queue 3's faults 1-7) on CUDA tensors, forward and the gradients of a
    seeded cotangent, with no device assert, held to the same rule in
    float64 on the CPU within the bound ``tools/fp_bounds.py``'s
    ``BoundMode`` derives from the rule's own ATen operations (bit for bit
    with the CPU's f32 rule where no operation rounds; integer and bool
    outputs exactly), cuDNN off; then Queue 3's fault 8, every row with its
    float slots cast to int32 and to bool (``cast_rows``), forward, held
    alike, and refused on the card where the CPU refuses; the largest
    error over bound of every case and rule; the four refusals raise;
    ``randint``, ``sample_logits``' negatives and ``sampling_id`` keep their
    range and repeat themselves from a seed; what ``linalg.svdvals`` gives
    on the card for a matrix holding a NaN (``tests/test_torch_op_rules_3b.py``,
    ``test_torch_op_rules_4.py`` and ``test_torch_queue3_faults.py`` hold
    the CPU to the JAX rules on the same rows);
40. ``encoder_parity``: the Fluid-layers encoder of ``tools/programs.py``
    at 2 layers, hidden 64, 4 heads, S = 32, B = 4, dropout 0, three SGD
    and three Adam steps on the card and on the CPU from one
    initialisation: losses (and under SGD every parameter) to 1e-5 of the
    largest, the tolerance of ``tests/test_torch_optimizers.py``, which the
    card's first runs met at under a tenth of it;
41. ``encoder``: that program at BERT-base widths (vocab 30528, 12 x 768,
    12 heads, FFN 3072), S = 512, B = 16, f32, dropout 0.1, Adam 1e-4,
    through ``Executor(CUDAPlace(0))``: a warm-up and 5 timed steps (ms a
    step, tokens/s, MFU of the bf16 peak, share of the f32 CUDA-core
    peak, peak memory), launches, busy and idle a step from
    ``tools/profile_step.py``'s ``fluid_encoder``, a second run from the
    same startup bit for bit the first, 10 steps on one batch with dropout
    0 with the loss falling;
42. ``crnn_parity``: the CRNN-CTC recognizer of ``tools/programs.py``
    (PaddleCV ocr_recognition's ``crnn_ctc_model.py`` at its published
    widths: 48 x 512 images, conv groups of 16 / 32 / 64 / 128, GRUs of
    200 both ways, 96 logits over 64 steps, ``warpctc``), B = 32, f32, two
    Momentum steps on the card and on the CPU from one initialisation: the
    losses, and the parameters, momentum velocities and BN running
    statistics each as one vector, to 1e-5 of its largest (phase 40's
    tolerance); the evaluation program's edit distances equal the CPU's
    on every row decoded alike;
43. ``crnn``: that program through ``Executor(CUDAPlace(0))``: a warm-up
    and 5 timed steps (ms a step, images/s, shares of the f32 and bf16
    peaks, peak memory), launches, busy and idle a step from
    ``tools/profile_step.py``'s ``crnn_ctc``, 10 steps on one batch with
    the loss falling, the evaluation's mean edit distance, and the warpctc
    rule against ``F.ctc_loss`` at [32, 64, 96] as a yardstick;
44. ``rules_5``: every row of ``tools/rule_cases_5.py`` (item 3-B's
    tranche 5: the 59 rules of ``misc_ops``-``misc_ops4`` with their kinks
    and attribute edges) held as phase 39 holds its rows, their int32 and
    bool casts, the refusals, the random rules, ``py_func`` and
    SelectedRows by contract, and ``install_check.run_check()`` on the
    card (``tests/test_torch_op_rules_5.py`` holds the CPU to the JAX
    rules on the same rows);
45. ``lac_parity``: the LAC tagger of ``tools/programs.py`` (PaddleNLP
    lexical_analysis's ``lex_net``) at a narrow width, two Adam steps on
    the card and on the CPU from one initialisation: the losses, and the
    parameters and Adam moments each as one vector, to 1e-5 of its
    largest; every decoded tag and ``chunk_eval`` count exactly;
46. ``lac``: that program at its published widths (vocabulary 20,940,
    128 / 128, 2 bidirectional GRU layers, 57 tags), B = 300, T = 64,
    through ``Executor(CUDAPlace(0))``: a warm-up and 5 timed steps (ms a
    step, tokens/s, the f32 CUDA-core share, peak memory), launches, busy
    and idle a step from ``tools/profile_step.py``'s ``lac``, 30 steps on
    one batch with the loss falling, the evaluation's precision, recall
    and F1 before and after them (F1 must rise); no port kernel launched
    in 39-46;
47. ``dygraph_parity``: the dygraph mode on the card against the CPU:
    ``tools/programs.py``'s ``dygraph_resnet`` at a narrow width ([1, 1,
    1, 1], widths 8-64, 32 x 32, B = 4) from one set of weights, two
    Momentum steps: in float64 the losses, parameters, velocities and BN
    statistics as vectors to 1e-5 of the largest, in f32 the first loss;
    a Linear / LayerNorm / GRUUnit / Embedding / BilinearTensorProduct set
    with one Adam step in f32 likewise; each gradient clipper within
    ``BoundMode``'s bound of its float64 CPU run;
48. ``dygraph_resnet``: the dygraph ResNet-50 (PaddlePaddle models v1.6
    dygraph/resnet, 102 classes, B = 32, 224 x 224, f32, Momentum over
    ``PiecewiseDecay``) under ``dygraph.guard()``: a warm-up and 5 timed
    steps (ms a step, images/s, the f32 CUDA-core share, peak memory, the
    first loss), launches, busy and idle a step from
    ``tools/profile_step.py``'s ``dygraph_resnet``, 20 steps on one batch
    with the loss falling and its accuracy rising;
49. ``dygraph_serving``: that net's checkpoint (``save_dygraph`` /
    ``load_dygraph``) bit for bit, ``TracedLayer`` in eval mode against
    the eager forward and its saved program bit for bit, ms a request
    eager / traced / loaded, one recompile for a new batch size, and
    ``DataParallel`` at one rank bit for bit; no port kernel launched in
    47-49;
50. ``dp_nccl``: ``fleet.init()`` from a one-rank PADDLE_* env joins a
    world of one over NCCL; ``build_bert_trainer(bert_base_config(),
    MeshSpec(dp=1))`` (bf16, B = 64, S = 512, LAMB, 3 steps) bit for bit
    against the default one-device trainer, ms a step both ways; every
    backend function under the collective wrappers on the NCCL group at
    BERT-base's gradient size, each bit for bit its identity, timed;
51. ``dp_two_ranks``: two spawned ranks share the card over gloo (CUDA
    tensors; NCCL refuses two ranks on one device): every backend
    function checked on the card's tensors; ResNet-50 (224, bf16,
    ``fuse_bn``, ``sync_bn``, momentum, global B = 128) and BERT-base (bf16,
    LAMB, ``zero=True``, global B = 64), 3 steps each: replicas bit for
    bit, every reduced statistic and gradient the card's sum of the ranks'
    local values bit for bit, the loss within the derived bound of the
    mean of the same terms (BERT's terms bit for bit the one-rank step's),
    the update against the one-rank optimizer's on the reduced gradient,
    ms a step, collective ms, peak memory, launches a rank a step (53 of
    each BN kernel; 24 / 24 / 12 / 12 LN and flash), then 3 more steps of
    each untapped and timed; ResNet-50 in f32, two steps at dp = 2 with
    sync-BN, its per-image loss terms and reduced gradient held to the
    one-rank step's within DP_F32_LIMIT times the distance a row
    permutation of the global batch makes, and a control without sync-BN
    that must exceed that limit;
52. ``program_dp_nccl`` / ``program_dp_two_ranks``: the Fluid-layers
    BERT-base encoder under ``fleet`` at one NCCL rank (bit for bit the
    untagged program) and over two gloo ranks (masks, loss bound,
    gradient yardsticks, kReduce with Adam), ResNet-CIFAR's global batch
    norms, GeoSGD;
53. ``program_dp_more_nccl`` / ``program_dp_more_two_ranks``: under
    ``fleet``, DeepFM's CTR program at ``DeepFMConfig()``'s widths through
    ``train_from_dataset`` with the feed pipe (a rank's host-to-device
    bytes half the one-rank run's, the AUC's counts its), a py_reader
    program, the CRNN-CTC (B = 32), LAC (B = 300) and the LAMB encoder
    (kReduce against AllReduce within the bound of the trust ratio's
    reassociated norms): bit for bit the untagged programs at one NCCL
    rank; at two gloo ranks the replicas bit for bit, the first losses in
    their derived bounds, the edit-distance and chunk counts equal to one
    rank's, the gradients against their yardsticks, the segment kernel's
    launches on the sparse merges.
54. ``model_parallel_one_rank`` / ``model_parallel_two_ranks``: BERT-base
    (bf16, S = 512, global B = 16, LAMB) with ``use_flash=False``
    (``ring_attention(axis=None)``) against the flash step, both
    attentions at every layer within a derived bound of the float64 one,
    and a ``PipelineOptimizer`` MLP (4 microbatches, 3 sections) against
    the unpipelined program within ``BoundMode``'s bound; then two gloo
    ranks: BERT-base at tp = 2 heads (Megatron-SP), tp = 2 ring and pp = 2
    (4 microbatches), each with the replicated leaves and every reduced
    value bit for bit, LAMB bit for bit its replay, the loss and the
    gathered gradient over 2 within 4 yardsticks of the one-rank step's; MoE at ep = 2 (8 experts,
    8192 tokens a rank) against one rank holding all 8 within a derived
    bound; the LN / flash launches a rank a step and the shift's route.
55. ``tp_tables_two_ranks``: two gloo ranks: the Fluid-layers BERT-base
    encoder with the Megatron marks at tp = 2 (f32, dropout 0.1, global
    B = 8) with no fallback gather, its dropout masks bit for bit the
    one-rank run's and, at dropout 0, its loss and gathered gradient within
    4 yardsticks of the one-rank step's; DeepFM at config 5 with its tables
    row-sharded (2 segment-sum launches a rank a step, each call within its
    derived bound of the plain version; losses and table updates in
    yardsticks of the one-rank segment trainer's); Local SGD on BERT-base
    (LAMB, k = 2: replicas apart after steps 1 and 3, bit for bit after 2
    and 4; k = 1 SGD in yardsticks of the sync dp step); then the dryrun at
    N = 2 on the card and the embedding router's capacity guard.

Phases 30-33 and 36 write their monitor directories under
``build/monitor``, phases 35-36 and 53 their data files under
``build/data_path``, phase 49 its checkpoint and traced program under
``build/dygraph``.
TF32 is switched off for matrix products and convolutions, so the f32
phases compare f32 with f32.  The last two lines are the kernels' JSON
record and ``{"ok": true, "device": {...}}``; any failure exits non-zero
without them.  Nothing here imports JAX or the JAX package.
"""

import contextlib
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
# and with is_sparse=False.  In the first step (the sparse step) each
# route's update of every sparse table is captured and held to bounds
# derived from its arithmetic (tools/fp_bounds.py): the merge of duplicate
# ids to the exact float64 sum of the same contributions within
# gamma(n - 1) sum |x| (runs of one or two terms bit for bit), Adam's
# moments and table (or SGD's table) to a float64 recomputation from the
# route's own merged gradient and the old state, the bound propagated
# through each f32 operation with 2^-149 of underflow per operation.  The
# kernel sums a run of equal ids in another order than index_add_'s
# atomics, so the routes' distance is printed, not held.  The sparse path
# against the dense gradient to BOOK_TOL; the launches counted over
# SPARSE_STEPS steps, and the distance after them printed, not held: it
# grows through the dense layers' Adam updates; SPARSE_TIMED steps of each
# route timed.
SPARSE_STEPS, SPARSE_TIMED = 5, 20


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
    # and phase 54's tp = 2 heads mode: 6 heads a rank, packed width 384
    for label, shape, H, causal in (("packed", (B, S, 768), 12, False),
                                    ("packed_causal", (8, S, 768), 12, True),
                                    ("packed_tp2", (MP_BATCH, S, 384), 6,
                                     False)):
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
    staged = stack_batches(trainer.mesh, bert.batch_specs(),
                           bert.synthetic_batches(cfg, TIMED_STEPS + 1, B, S),
                           bert.batch_dtypes())
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
    from paddle_tpu_torch.parallel.rules import P
    from paddle_tpu_torch.parallel.train import stack_batches

    cfg = resnet.resnet50_config(dtype="bfloat16", fuse_bn=True, image_size=IMAGE)
    trainer = resnet.build_resnet_trainer(cfg, optimizer=optim.momentum(0.9),
                                          seed=0)
    # images staged in bf16, as bench.py stages them on the chip
    staged = stack_batches(trainer.mesh, {"image": P("dp"), "label": P("dp")},
                           resnet.synthetic_batches(cfg, TIMED_STEPS + 1, B_RN),
                           {"image": torch.bfloat16})
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
    params = nmt.init_nmt_params(torch.Generator().manual_seed(1), cfg, "cpu")
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
    from paddle_tpu_torch.tools import book_suite, fp_bounds

    def sgd(fl, lr):
        return fl.optimizer.SGD(lr)

    cases = (("recommender", None, {}),
             ("word2vec_softmax", sgd, {"is_sparse": True}))
    failed, per_step = [], None
    saved = os.environ.pop("PADDLE_TPU_SEGMENT_KERNEL", None)
    try:
        for model, opt, sizes in cases:
            values = _startup_values(_book(model, optimizer=opt, **sizes))
            res, later, ms, launches, bounds = {}, {}, {}, {}, {}
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
                state = [v.name for v in run.main.list_vars() if v.persistable]
                torch.cuda.synchronize()
                _common.reset_launches()
                # the first (sparse) step with each table's update captured
                # and held to its derived bounds (tools/fp_bounds.py)
                with fp_bounds.capture_sparse_updates() as recs:
                    exe = fluid.Executor(fluid.CUDAPlace(0))
                    exe.run(run.main, feed=run.feed, fetch_list=[run.cost],
                            scope=scope)
                res[route] = convert.scope_to_numpy(scope, state)
                if route != "dense":
                    names = [op.inputs["Param"][0]
                             for op in run.main.global_block().ops
                             if op.type in ("adam", "sgd")
                             and op.inputs["Param"][0] in tables]
                    bounds[route] = (len(recs) == len(names), {
                        n: fp_bounds.check_sparse_update(r, replay=True)
                        for n, r in zip(names, recs)})
                for step in range(1, SPARSE_STEPS):
                    exe.run(run.main, feed=run.feed, fetch_list=[run.cost],
                            scope=scope)
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
            # each route's merge, moments and tables held to its own
            # derived bounds; the routes' distance printed, not held
            by_var = sorted(((_rel(res["kernel"][n], a), n)
                             for n, a in res["xla"].items()), reverse=True)
            route_err = by_var[0][0]
            route_ok = all(complete and all(c["ok"] for c in checks.values())
                           for complete, checks in bounds.values())
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
                  "bounds": {r: checks for r, (_, checks) in bounds.items()},
                  "max_err_over_bound": {r: _worst_ratio(checks) for r, (
                      _, checks) in bounds.items()},
                  "bounds_ok": route_ok,
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


# -- the data path (phases 35-38) ----------------------------------------------

# Phase 35 (datafeed): DF_FILES MultiSlot files of DF_LINES lines, every
# DF_MALFORMED-th line malformed (dropped by both parsers).
DF_FILES, DF_LINES, DF_MALFORMED = 4, 3000, 7
# Phase 36 (ctr_dataset): the CTR program at DeepFMConfig()'s widths, f32,
# B = CTR_B, Adam(CTR_LR), CTR_FILES files of CTR_LINES lines (3 batches a
# file, 12 steps a pass) with ids from a Zipf(CTR_ZIPF) law; every run
# trains CTR_PASSES passes from the same startup values.
CTR_B, CTR_FILES, CTR_LINES, CTR_PASSES = 8192, 4, 3 * 8192, 2
CTR_LR, CTR_ZIPF, CTR_SEED = 1e-3, 0.99, 14
CTR_PER_STEP = {"segment_sum": 2}           # one merge per is_sparse table
# Phase 37 (deepfm_hostfed): bench.py:817-946's host-fed DeepFM line.
HOSTFED_STEPS, HOSTFED_ORDER = 100, ("on", "off", "on", "off")
# Phase 38 (dataloader): LeNet through DataLoader.from_generator and a
# py_reader program.
LOADER_B, LOADER_STEPS = 64, 20
DATA_DIR = "build/data_path"


def _own_datafeed():
    """The native datafeed, which must be the port's own build of
    ``paddle_tpu_torch/runtime/datafeed.cc``: (library info, seconds to
    build or load).  Raises when it is not."""
    from pathlib import Path

    from paddle_tpu_torch import runtime

    t0 = time.perf_counter()
    lib = runtime.load("datafeed")
    secs = time.perf_counter() - t0
    info = dict(runtime.build_info.get("datafeed", {}))
    here = Path(__file__).resolve().parent
    path = Path(info.get("path", "")).resolve()
    if (lib is None or path != runtime.library_path("datafeed").resolve()
            or here / "paddle_tpu_torch" != Path(
                runtime.__file__).resolve().parent.parent):
        raise AssertionError("the native datafeed is not the port's own "
                             "build: %s" % info)
    return info, secs


def _host_rows(batches):
    import numpy as np

    return np.concatenate([np.concatenate(
        [b["feat_ids"], b["label"].astype(np.int64)], 1) for b in batches])


def phase_datafeed(card):
    """Phase 35: the native MultiSlot parser against the Python one on the
    same files: order on one thread and in memory, the multiset on four
    threads, the row count."""
    import os

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import ctr_program as cp

    info, secs = _own_datafeed()
    files = cp.write_ctr_files(os.path.join(DATA_DIR, "datafeed"),
                               n_files=DF_FILES, rows_per_file=DF_LINES,
                               n_fields=39, vocab=1000000, seed=CTR_SEED,
                               malformed_every=DF_MALFORMED)
    prog = cp.build_ctr_program(fluid, n_fields=39, vocab=1000000, embed=10,
                                mlp=(400, 400, 400), lr=CTR_LR)

    def rows(kind, thread):
        ds = cp.make_dataset(fluid, kind, files, prog, 1000, thread)
        if kind == "InMemoryDataset":
            ds.load_into_memory()
        return _host_rows(list(ds._iter_batches()))

    os.environ["PADDLE_TPU_NO_NATIVE"] = "1"
    try:
        python = rows("QueueDataset", 1)
    finally:
        os.environ.pop("PADDLE_TPU_NO_NATIVE")
    queue1, inmem, queue4 = (rows("QueueDataset", 1),
                             rows("InMemoryDataset", 4),
                             rows("QueueDataset", 4))
    expected = DF_FILES * (DF_LINES - DF_LINES // DF_MALFORMED)
    sort = lambda a: a[np.lexsort(a.T)]
    checks = {"queue_1_thread_same_order": bool(np.array_equal(queue1, python)),
              "inmemory_same_order": bool(np.array_equal(inmem, python)),
              "queue_4_threads_same_multiset": bool(np.array_equal(
                  sort(queue4), sort(python))),
              "rows": len(python) == expected}
    ok = all(checks.values())
    emit({"phase": "datafeed", "nvidia_smi": card, "library": info["path"],
          "built_here": info.get("built"), "build_or_load_s": secs,
          "files": DF_FILES, "lines_per_file": DF_LINES,
          "malformed_every": DF_MALFORMED, "rows": len(python),
          "rows_expected": expected, "checks": checks, "ok": ok})
    if not ok:
        raise AssertionError("datafeed: %s" % checks)


def _ctr_values(prog):
    """The CTR program's startup values, from a CPU run of the port."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.tools import ctr_program as cp

    scope = fluid.Scope()
    _executor("cpu").run(prog.startup, scope=scope)
    return convert.scope_to_numpy(scope, cp.persistable_names(prog.main))


def _set_env(**kv):
    import os

    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _ctr_run(prog, values, ds, thread, pipe, route="kernel", passes=CTR_PASSES):
    """One training run of the CTR program on the card from ``values``:
    ``passes`` passes of ``train_from_dataset`` with the pipe on or off and
    the merge on ``route``.  Returns the losses (a tensor on the card), the
    final state (tensors on the card), the seconds of the timed passes and
    the launch counts."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.kernels import _common

    _set_env(PADDLE_TPU_SEGMENT_KERNEL="1" if route == "kernel" else "0",
             PADDLE_TPU_FEED_PIPE="1" if pipe == "on" else "0")
    scope = convert.scope_from_numpy(values, fluid.Scope(), "cuda")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    losses = []
    run = exe.run

    def recorded(*a, **kw):
        res = run(*a, **kw)
        losses.append(res[0].reshape(()))
        return res

    exe.run = recorded
    torch.cuda.synchronize()
    _common.reset_launches()
    t0 = time.perf_counter()
    for _ in range(passes):
        exe.train_from_dataset(prog.main, ds, scope=scope, thread=thread,
                               fetch_list=[prog.loss])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_common.launches)
    state = {n: scope.find_var(n) for n in values}
    return {"losses": torch.stack(losses), "state": state, "seconds": dt,
            "steps": len(losses), "counts": counts}


def _same_bits(a, b):
    """The losses and every persistable of two runs equal, bit for bit."""
    return (torch.equal(a["losses"], b["losses"])
            and all(torch.equal(a["state"][n], b["state"][n])
                    for n in a["state"]))


def _one_step_checks(prog, values, feed, device, route):
    """One step from ``values`` on ``device`` with the merge on ``route``,
    each sparse table's Adam update captured and held to its derived
    bounds (``tools/fp_bounds.py``).  Returns (checks by table, new state
    as numpy)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.tools import ctr_program as cp
    from paddle_tpu_torch.tools import fp_bounds

    _set_env(PADDLE_TPU_SEGMENT_KERNEL="1" if route == "kernel" else "0")
    scope = convert.scope_from_numpy(values, fluid.Scope(), device)
    with fp_bounds.capture_sparse_updates() as recs:
        _executor(device).run(prog.main, feed=feed, fetch_list=[prog.loss],
                              scope=scope)
    tables = [op.inputs["Param"][0] for op in prog.main.global_block().ops
              if op.type == "adam" and op.inputs["Param"][0] in prog.tables]
    if len(recs) != len(tables):
        raise AssertionError("captured %d sparse updates for tables %s"
                             % (len(recs), tables))
    checks = {}
    for name, rec in zip(tables, recs):
        checks[name] = fp_bounds.check_sparse_update(rec,
                                                     replay=device == "cuda")
    return checks, convert.scope_to_numpy(scope, cp.persistable_names(prog.main))


def _max_abs_diffs(a, b):
    import numpy as np

    return sorted(([n, float(np.abs(a[n].astype(np.float64)
                                     - b[n].astype(np.float64)).max())]
                   for n in a), key=lambda r: -r[1])


def _worst_ratio(checks):
    worst = {}
    for table, rec in checks.items():
        for key in ("merge", "ParamOut", "Moment1Out", "Moment2Out"):
            if key in rec:
                worst[key] = max(worst.get(key, 0.0),
                                 rec[key].get("max_err_over_bound", 0.0))
    return worst


def _segment_times_at(device_name, ids, d):
    """The segment kernel at one of the CTR program's tables' shapes: the
    wrapper's kernel on pre-sorted ids, its plain version and index_add_
    into each run's first position (the same values in one PyTorch call),
    with the bound of bytes read and written once."""
    from paddle_tpu_torch.kernels import segment_update as seg

    gen = torch.Generator(device="cuda").manual_seed(36)
    n, height = ids.shape[0], 1000000
    vals = torch.randn(n, d, generator=gen, device="cuda")
    keys, order = torch.sort(ids, stable=True)
    first = torch.ones(n, dtype=torch.bool, device="cuda")
    first[1:] = keys[1:] != keys[:-1]
    pos = torch.arange(n, device="cuda")
    start = torch.where(first, pos, 0).cummax(0).values
    at_first = torch.empty_like(start).scatter_(0, order, start)
    kernel = lambda: seg._segsum_sorted(keys, order, vals, height)
    library = lambda: torch.zeros_like(vals).index_add_(0, at_first, vals)
    ib = keys.element_size()
    nbytes = ib * n + 8 * n + 2 * 4 * n * d + ib * n
    return {"shape": [n, d], "ms": cuda_time(kernel),
            "plain_ms": cuda_time(lambda: seg.segsum_plain(ids, vals, height)),
            "library_ms": cuda_time(library),
            **_bound(device_name, n * d, nbytes, "f32")}


def phase_ctr_dataset(card, device_name):
    """Phase 36: the Fluid CTR program at DeepFMConfig()'s widths trained
    through ``train_from_dataset`` on the card.  Returns the segment
    kernel's launches a step and its times at the two tables' shapes."""
    import os

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.tools import ctr_program as cp

    cfg = deepfm.DeepFMConfig()
    t0 = time.perf_counter()
    files = cp.write_ctr_files(os.path.join(DATA_DIR, "ctr"),
                               n_files=CTR_FILES, rows_per_file=CTR_LINES,
                               n_fields=cfg.num_fields, vocab=cfg.num_features,
                               seed=CTR_SEED, zipf=CTR_ZIPF)
    write_s = time.perf_counter() - t0
    prog = cp.build_ctr_program(fluid, n_fields=cfg.num_fields,
                                vocab=cfg.num_features, embed=cfg.embed_dim,
                                mlp=cfg.mlp_dims, lr=CTR_LR)
    values = _ctr_values(prog)
    inmem = cp.make_dataset(fluid, "InMemoryDataset", files, prog, CTR_B, 1)
    t0 = time.perf_counter()
    inmem.load_into_memory()
    load_s = time.perf_counter() - t0
    first = next(inmem._iter_batches())
    steps_per_pass = CTR_FILES * CTR_LINES // CTR_B
    saved = {k: os.environ.get(k) for k in ("PADDLE_TPU_SEGMENT_KERNEL",
                                            "PADDLE_TPU_FEED_PIPE")}
    fails = []
    try:
        # the derived bounds of one step on each route, and on the CPU
        checks, after = {}, {}
        for where, device, route in (("kernel", "cuda", "kernel"),
                                     ("index_add", "cuda", "xla"),
                                     ("cpu", "cpu", "xla")):
            checks[where], after[where] = _one_step_checks(
                prog, values, first, device, route)
        for where in ("kernel", "index_add"):
            bad = [t for t, rec in checks[where].items() if not rec["ok"]]
            if bad:
                fails.append("%s route: %s outside their derived bounds"
                             % (where, bad))
        emit({"phase": "ctr_dataset", "part": "one_step_bounds",
              "nvidia_smi": card, "batch": CTR_B,
              "first_batch_ids": int(first["feat_ids"].size),
              "first_batch_unique_ids": int(np.unique(first["feat_ids"]).size),
              "checks": checks,
              "max_err_over_bound": {w: _worst_ratio(c)
                                     for w, c in checks.items()},
              # reported, not gated: each route is held to its own bound
              "kernel_vs_index_add": _max_abs_diffs(after["kernel"],
                                                    after["index_add"])[:6],
              "kernel_vs_cpu": _max_abs_diffs(after["kernel"],
                                              after["cpu"])[:6]})
        del after

        # warm-up (plans, cuBLAS handles), then the timed runs
        _ctr_run(prog, values, inmem, 1, "on", passes=1)
        queue1 = cp.make_dataset(fluid, "QueueDataset", files, prog, CTR_B, 1)
        queue4 = cp.make_dataset(fluid, "QueueDataset", files, prog, CTR_B, 4)
        plan = (("inmemory_1_on", inmem, 1, "on"),
                ("inmemory_1_off", inmem, 1, "off"),
                ("queue_1_on", queue1, 1, "on"),
                ("queue_1_off", queue1, 1, "off"),
                ("queue_4_on", queue4, 4, "on"),
                ("queue_4_off", queue4, 4, "off"),
                ("inmemory_1_on_again", inmem, 1, "on"))
        runs = {}
        for name, ds, thread, pipe in plan:
            runs[name] = _ctr_run(prog, values, ds, thread, pipe)
        # the pipe's stats: a monitored run (bit for bit the same)
        from paddle_tpu_torch import monitor

        mon = monitor.enable(_fresh_dir("ctr_dataset"))
        try:
            runs["inmemory_1_on_monitored"] = _ctr_run(prog, values, inmem, 1,
                                                       "on")
            reg = mon.registry
            pipe_stats = {}
            for stat in ("feed_stall_ms", "overlap_ms", "convert_ms",
                         "put_wait_ms", "fetch_wait_ms"):
                h = reg.get_stat("monitor.pipe." + stat)
                if h is not None:
                    pipe_stats[stat] = {"calls": h.calls,
                                        "mean": h.total / max(h.calls, 1),
                                        "max": h.max,
                                        "p50": h.quantiles((0.5,))}
        finally:
            monitor.disable()
        ref = runs["inmemory_1_on"]
        bit_equal = {name: _same_bits(ref, runs[name]) for name in
                     ("inmemory_1_off", "queue_1_on", "queue_1_off",
                      "inmemory_1_on_again", "inmemory_1_on_monitored")}
        if not all(bit_equal.values()):
            fails.append("kernel route not bit for bit: %s" % bit_equal)
        want = {k: CTR_PER_STEP.get(k, 0) * CTR_PASSES * steps_per_pass
                for k in _common.launches}
        bad_counts = {n: r["counts"] for n, r in runs.items()
                      if r["counts"] != want}
        if bad_counts:
            fails.append("launch counts %s, expected %s" % (bad_counts, want))
        losses = ref["losses"].cpu().numpy()
        first_pass = float(losses[:steps_per_pass].mean())
        last_pass = float(losses[-steps_per_pass:].mean())
        finite = all(bool(torch.isfinite(r["losses"]).all())
                     for r in runs.values())
        if not (finite and last_pass < first_pass):
            fails.append("no progress: first pass %.6f, last %.6f, finite %s"
                         % (first_pass, last_pass, finite))
        times = {n: {"ms_per_step": r["seconds"] / r["steps"] * 1e3,
                     "examples_per_sec": CTR_B * r["steps"] / r["seconds"],
                     "steps": r["steps"]} for n, r in runs.items()}
        ids = torch.from_numpy(first["feat_ids"].reshape(-1)).cuda()
        seg_times = [_segment_times_at(device_name, ids, d)
                     for d in (cfg.embed_dim, 1)]
        emit({"phase": "ctr_dataset", "nvidia_smi": card, "batch": CTR_B,
              "steps_per_pass": steps_per_pass, "passes": CTR_PASSES,
              "files": CTR_FILES, "lines_per_file": CTR_LINES,
              "write_files_s": write_s, "load_into_memory_s": load_s,
              "zipf": CTR_ZIPF, "lr": CTR_LR,
              "widths": {"features": cfg.num_features,
                         "fields": cfg.num_fields, "embed": cfg.embed_dim,
                         "mlp": list(cfg.mlp_dims)},
              "runs": times, "bit_equal_to_inmemory_1_on": bit_equal,
              "segment_sum_launches_per_step":
                  ref["counts"]["segment_sum"] / ref["steps"],
              "other_port_launches": {k: v for k, v in ref["counts"].items()
                                      if v and k != "segment_sum"},
              "pipe_stats": pipe_stats,
              "first_pass_mean_loss": first_pass,
              "last_pass_mean_loss": last_pass,
              "segment_sum_at_ctr_shapes": seg_times,
              "fails": fails, "ok": not fails})
    finally:
        _set_env(**saved)
    if fails:
        raise AssertionError("ctr_dataset: %s" % fails)
    return ref["counts"]["segment_sum"] / ref["steps"], seg_times


def phase_deepfm_hostfed(card):
    """Phase 37: the host-fed DeepFM line (bench.py:817-946) on the card: a
    fresh numpy batch every step through ``DeviceFeedPipe`` and an
    ``InFlightWindow(2)``, or inline (pipe off, the loss read each step),
    runs interleaved from the same weights and batch stream.  Returns the
    segment kernel's launches a step."""
    import numpy as np

    from paddle_tpu_torch._tree import tree_map
    from paddle_tpu_torch.feed_pipe import (DeviceFeedPipe, InFlightWindow,
                                            make_placer)
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.models import deepfm

    cfg = deepfm.DeepFMConfig()
    trainer = deepfm.build_deepfm_trainer(cfg, variant="segment", seed=0,
                                          device="cuda")
    params0 = tree_map(lambda t: t.clone(), trainer.state["params"])

    def source():
        rng = np.random.RandomState(1)
        for _ in range(HOSTFED_STEPS):
            yield {"feat_ids": rng.randint(0, cfg.num_features,
                                           (DFM_B, cfg.num_fields)
                                           ).astype(np.int32),
                   "label": rng.randint(0, 2, (DFM_B,)).astype(np.float32)}

    def run(pipe):
        trainer.state["params"] = tree_map(lambda t: t.clone(), params0)
        losses = []
        torch.cuda.synchronize()
        _common.reset_launches()
        t0 = time.perf_counter()
        if pipe == "on":
            feed = DeviceFeedPipe(source(), convert=make_placer("cuda"),
                                  name="hostfed_pipe")
            window = InFlightWindow(2)
            for b in feed:
                loss = trainer.step(b, DFM_LR)
                window.admit(loss)
                losses.append(loss)
            window.drain()
        else:
            for b in source():
                b = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
                loss = trainer.step(b, DFM_LR)
                float(loss)                          # the inline fetch sync
                losses.append(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return {"ms_per_step": dt / HOSTFED_STEPS * 1e3,
                "examples_per_sec": DFM_B * HOSTFED_STEPS / dt,
                "losses": torch.stack(losses).cpu(),
                "counts": dict(_common.launches)}

    run("on")                                          # warm-up
    runs = [(pipe, run(pipe)) for pipe in HOSTFED_ORDER]
    ref = runs[0][1]
    bit_equal = all(torch.equal(r["losses"], ref["losses"]) for _, r in runs)
    want = {k: (HOSTFED_STEPS if k == "segment_sum" else 0)
            for k in _common.launches}
    counts_ok = all(r["counts"] == want for _, r in runs)
    finite = bool(torch.isfinite(ref["losses"]).all())
    ok = bit_equal and counts_ok and finite
    emit({"phase": "deepfm_hostfed", "nvidia_smi": card, "batch": DFM_B,
          "steps": HOSTFED_STEPS, "lr": DFM_LR, "variant": "segment",
          "runs": [{"pipe": p, "ms_per_step": r["ms_per_step"],
                    "examples_per_sec": r["examples_per_sec"]}
                   for p, r in runs],
          "losses_bit_equal": bit_equal,
          "segment_sum_launches_per_step":
              ref["counts"]["segment_sum"] / HOSTFED_STEPS,
          "counts_ok": counts_ok,
          "first_last_loss": [float(ref["losses"][0]),
                              float(ref["losses"][-1])], "ok": ok})
    del trainer, params0
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("deepfm_hostfed: bit_equal %s, counts %s, "
                             "finite %s" % (bit_equal, [r["counts"] for _, r
                                                         in runs], finite))
    return ref["counts"]["segment_sum"] / HOSTFED_STEPS


def _lenet_program(fluid, feed):
    """LeNet + SGD, fed by data vars ("feed", "loader") or a py_reader."""
    from paddle_tpu_torch.models import lenet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if feed == "py_reader":
            src = fluid.layers.py_reader(
                capacity=4, shapes=[(-1, 1, 28, 28), (-1, 1)],
                dtypes=["float32", "int64"])
            img, label = fluid.layers.read_file(src)
        else:
            img = fluid.layers.data("img", shape=[1, 28, 28], dtype="float32")
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            src = (fluid.DataLoader.from_generator(feed_list=[img, label],
                                                   capacity=4)
                   if feed == "loader" else None)
        _, loss, _ = lenet.build_lenet(img, label)
        fluid.optimizer.SGD(LENET_SGD_LR).minimize(loss)
    return main, startup, loss, src


def phase_dataloader(card):
    """Phase 38: LeNet trained LOADER_STEPS steps on the card through
    ``DataLoader.from_generator`` and through a py_reader program, against
    the ``feed=`` path from the same values and batches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert

    batches = [_lenet_digits(k, LOADER_B) for k in range(LOADER_STEPS)]
    host = [(b["img"], b["label"]) for b in batches]
    saved = _deterministic_cudnn()
    try:
        progs = {k: _lenet_program(fluid, k)
                 for k in ("feed", "loader", "py_reader")}
        scope0 = fluid.Scope()
        _executor("cpu").run(progs["feed"][1], scope=scope0)
        names = [v.name for v in progs["feed"][1].list_vars() if v.persistable]
        values = convert.scope_to_numpy(scope0, names)

        def fresh():
            return (fluid.Executor(fluid.CUDAPlace(0)),
                    convert.scope_from_numpy(values, fluid.Scope(), "cuda"))

        exe, scope = fresh()
        main, _, loss, _ = progs["feed"]
        fed = [exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0]
               for b in batches]

        exe, scope = fresh()
        main, _, loss, loader = progs["loader"]
        loader.set_batch_generator(lambda: iter(host),
                                   places=fluid.CUDAPlace(0))
        staged_equal, on_card, via_loader = True, True, []
        for b, (x, y) in zip(loader, host):
            on_card &= b["img"].is_cuda and b["label"].is_cuda
            staged_equal &= (torch.equal(b["img"].cpu(), torch.from_numpy(x))
                             and torch.equal(b["label"].cpu(),
                                             torch.from_numpy(y)))
            via_loader.append(exe.run(main, feed=b, fetch_list=[loss],
                                      scope=scope)[0])

        exe, scope = fresh()
        main, _, loss, reader = progs["py_reader"]
        reader.decorate_batch_generator(lambda: iter(host),
                                        places=fluid.CUDAPlace(0))
        reader.start()
        via_reader, eof = [], False
        for _ in range(LOADER_STEPS + 1):
            try:
                via_reader.append(exe.run(main, fetch_list=[loss],
                                          scope=scope)[0])
            except fluid.EOFException:
                eof = True
                break
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    same = lambda a, b: len(a) == len(b) and all(
        (x == y).all() for x, y in zip(a, b))
    rec = {"staged_on_card": bool(on_card), "staged_equal_host": bool(staged_equal),
           "loader_losses_equal": same(via_loader, fed),
           "py_reader_losses_equal": same(via_reader, fed),
           "py_reader_eof_after": len(via_reader), "eof_raised": eof}
    ok = (all(rec[k] for k in ("staged_on_card", "staged_equal_host",
                               "loader_losses_equal", "py_reader_losses_equal",
                               "eof_raised"))
          and len(via_reader) == LOADER_STEPS)
    emit({"phase": "dataloader", "nvidia_smi": card, "batch": LOADER_B,
          "steps": LOADER_STEPS, **rec,
          "first_losses": [float(v) for v in fed[:3]], "ok": ok})
    if not ok:
        raise AssertionError("dataloader: %s" % rec)


# -- item 3-B's op rules and the Fluid-layers encoder (phases 39-41) --------------

# the encoder parity cell: tools/programs.py's program at 2 layers, hidden 64
ENC_PARITY = dict(vocab=512, hidden=64, layers=2, heads=4, ffn=256, seq=32,
                  batch=4, dropout=0.0)
ENC_PARITY_STEPS = 3
ENC_PARITY_TOL = 1e-5        # tests/test_torch_optimizers.py's, for 3 steps
ENC_SGD_LR, ENC_ADAM_LR = 0.05, 1e-3
ENC_WARMUP, ENC_TIMED, ENC_FALL_STEPS = 1, 5, 10
ENC_FEED_SEED = 100
# phase 39's rules: tranches 1-3 (101), tranche 4 with ctc_align and
# edit_distance (27)
RULES_ON_THE_CARD = 128


def _rule_on(device, op, ins, attrs, grad_slots, grad_out, ct):
    """The port's rule on ``device`` from numpy inputs: (outputs, grads);
    the sync raises a device assert, if one fired."""
    from paddle_tpu_torch.registry import OpLoweringContext, get_lowering

    ctx = OpLoweringContext(None, torch.Generator(device).manual_seed(0))
    t = {k: [torch.from_numpy(a.copy()).to(device) for a in v]
         for k, v in ins.items()}
    leaves = [t[s][0].requires_grad_(True) for s in grad_slots]
    outs = get_lowering(op)(t, dict(attrs), ctx)
    grads = {}
    if grad_slots:
        got = torch.autograd.grad(outs[grad_out][0], leaves, ct.to(device),
                                  allow_unused=True)
        grads = dict(zip(grad_slots, got))
    if device == "cuda":
        torch.cuda.synchronize()
    return outs, grads


def _hold_row(op, ins, attrs, grad_slots, grad_out):
    """One row on the card against its float64 CPU run within
    ``BoundMode``'s bound (bit for bit with the CPU's f32 rule where the
    bound is 0; integer and bool outputs exactly; the same dtypes).
    Returns (per-output records, ok, undecided comparisons)."""
    import numpy as np

    from paddle_tpu_torch.registry import get_lowering
    from paddle_tpu_torch.tools import fp_bounds

    ct = None
    if grad_slots:
        y, _ = _rule_on("cpu", op, ins, attrs, (), None, None)
        ct = torch.from_numpy(np.random.RandomState(1).standard_normal(
            tuple(y[grad_out][0].shape)).astype(np.float32))
    dev, dev_g = _rule_on("cuda", op, ins, attrs, grad_slots, grad_out, ct)
    cpu, cpu_g = _rule_on("cpu", op, ins, attrs, grad_slots, grad_out, ct)
    res, gres, ambiguous = fp_bounds.rule_bounds(
        get_lowering(op), {k: [torch.from_numpy(a.copy()) for a in v]
                           for k, v in ins.items()},
        attrs, grad_slots, grad_out, ct)
    checks = [(slot, dev[slot][i], cpu[slot][i], rb)
              for slot, vals in res.items() for i, rb in enumerate(vals)]
    checks += [("d" + s, dev_g[s], cpu_g[s], gres[s])
               for s in grad_slots if gres[s] is not None]
    rows, ok = {}, True
    for slot, got, exact, (ref, bound) in checks:
        rec = fp_bounds.hold_to_bound(got, ref, bound, exact=exact)
        rec["ok"] = rec["ok"] and got.dtype == exact.dtype and got.is_cuda
        rec["card_minus_cpu_f32"] = float(
            (got.detach().cpu().double() - exact.detach().double())
            .abs().nan_to_num().max()) if got.numel() else 0.0
        rows[slot] = rec
        ok = ok and rec["ok"]
    return rows, ok, ambiguous


def _raises(device, op, ins, attrs):
    """Whether the rule refuses these inputs on ``device`` (its error's
    kind may differ between the devices' kernels)."""
    try:
        _rule_on(device, op, ins, attrs, (), None, None)
    except Exception:
        return True
    return False


# cast rows whose rule computes an integer or bool input in f32 and
# converts the result back (as astype): held where the conversion is
# decided by the float result's bound
_CONVERTED = ("interpolate", "bilinear_interp")


def _hold_converted(op, ins, attrs, rows):
    """For a ``_CONVERTED`` row whose integer or bool output differs from
    the CPU's: the same rule on the input as f32 gives the float value and
    its bound (``BoundMode``); an element whose interval holds a
    conversion threshold (an integer for a truncation, 0 for bool) is
    undecided, every other one must equal the CPU's."""
    import numpy as np

    from paddle_tpu_torch.registry import get_lowering
    from paddle_tpu_torch.tools import fp_bounds

    f_ins = {k: [torch.from_numpy(a.astype(np.float32)) for a in v]
             for k, v in ins.items()}
    dev, _ = _rule_on("cuda", op, ins, attrs, (), None, None)
    cpu, _ = _rule_on("cpu", op, ins, attrs, (), None, None)
    (ref, bound), = fp_bounds.rule_bounds(get_lowering(op), f_ins, attrs)[0]["Out"]
    got, want = dev["Out"][0].cpu(), cpu["Out"][0]
    lo, hi = ref - bound, ref + bound
    if want.dtype == torch.bool:
        decided = (lo > 0) | (hi < 0) | ((ref == 0) & (bound == 0))
    else:
        decided = torch.trunc(lo) == torch.trunc(hi)
    ok = bool((got[decided] == want[decided]).all()) and got.dtype == want.dtype
    rows["Out"].update(ok=ok, undecided_elements=int((~decided).sum()))
    return ok


def _draws_on_the_card():
    """sample_logits' negatives and sampling_id's draws on CUDA tensors:
    in range, on the card, repeating themselves from a seed and not from
    another (the tests hold their distributions on the CPU)."""
    from paddle_tpu_torch.registry import OpLoweringContext, get_lowering

    def run(op, ins, attrs, seed):
        return get_lowering(op)(ins, dict(attrs), OpLoweringContext(
            None, torch.Generator("cuda").manual_seed(seed)))

    g = torch.Generator().manual_seed(5)
    logits = torch.randn(16, 1000, generator=g).cuda()
    labels = torch.randint(0, 1000, (16, 2), generator=g).cuda()
    attrs = {"num_samples": 64, "seed": 3}
    a, b, c = (run("sample_logits", {"Logits": [logits], "Labels": [labels]},
                   attrs, s)["Samples"][0] for s in (0, 0, 1))
    neg = a[:, 2:]
    logits_ok = (a.is_cuda and torch.equal(a, b) and not torch.equal(a, c)
                 and bool((neg == neg[:1]).all())
                 and len(set(neg[0].tolist())) == 64
                 and 0 <= int(neg.min()) and int(neg.max()) < 1000
                 and torch.equal(a[:, :2], labels))
    probs = torch.softmax(torch.randn(4096, 7, generator=g), 1).cuda()
    x, y, z = (run("sampling_id", {"X": [probs]}, {"seed": 1}, s)["Out"][0]
               for s in (0, 0, 1))
    id_ok = (x.is_cuda and torch.equal(x, y) and not torch.equal(x, z)
             and 0 <= float(x.min()) and float(x.max()) <= 6)
    return {"sample_logits": logits_ok, "sampling_id": id_ok}


def phase_rules_3b(card):
    """Phase 39: every row of ``tools/rule_cases.py`` (the rules of item
    3-B's tranches 1-4 that compute, with ``ctc_align`` and
    ``edit_distance``, their traps and edges, and Queue 3's faults) on
    CUDA tensors, forward and the gradients of a seeded cotangent, held to
    the same rule run in float64 on the CPU within the bound
    ``tools/fp_bounds.py``'s ``BoundMode`` derives from the rule's
    operations (bit for bit where no operation rounds, and to the CPU's f32
    rule there; integer and bool outputs exactly); then Queue 3 entry 8,
    every row with its float slots cast to int32 and to bool, forward, held
    alike (a row the CPU refuses must be refused on the card too; the
    resizes' integer outputs, conversions of an f32 interpolation, where
    the float result's bound decides the conversion); the
    four refusals raise on the card; ``randint``, ``sample_logits``' draws
    and ``sampling_id`` keep their range and repeat themselves from a
    seed; what ``linalg.svdvals`` gives on the card for a matrix holding a
    NaN (the ``p_norm`` rule guards it).  cuDNN is off, so the
    convolutions run PyTorch's im2col products, whose sums the bound
    covers (cuDNN may choose Winograd or FFT algorithms, whose errors it
    does not).  Prints each case's largest error over bound and each
    rule's."""
    from paddle_tpu_torch.registry import OpLoweringContext, get_lowering
    from paddle_tpu_torch.tools.rule_cases import (QUEUE3_ROWS, REFUSALS,
                                                   RULE_CASES, cast_rows)

    worst, bad, n_checked, refused_alike = {}, [], 0, {}
    with torch.backends.cudnn.flags(enabled=False):
        for cid, op, ins, attrs, grad_slots, grad_out in RULE_CASES:
            rows, ok, ambiguous = _hold_row(op, ins, attrs, grad_slots, grad_out)
            n_checked += len(rows)
            ratio = max(r["ratio"] for r in rows.values())
            worst[op] = max(worst.get(op, 0.0), ratio)
            emit({"phase": "rules_3b", "case": cid, "op": op,
                  "max_err_over_bound": ratio, "outputs": rows,
                  "undecided_comparisons": ambiguous, "ok": ok})
            if not ok:
                bad.append(cid)
        cast_worst, n_cast = 0.0, 0
        for cid, op, ins, attrs in cast_rows():
            if _raises("cpu", op, ins, attrs):
                refused_alike[cid] = _raises("cuda", op, ins, attrs)
                continue
            rows, ok, _ = _hold_row(op, ins, attrs, (), None)
            if not ok and op in _CONVERTED:
                ok = _hold_converted(op, ins, attrs, rows)
            n_cast += 1
            n_checked += len(rows)
            cast_worst = max([cast_worst] + [r["ratio"] for r in rows.values()])
            if not ok:
                bad.append(cid)
                emit({"phase": "rules_3b_cast", "case": cid, "op": op,
                      "outputs": rows, "ok": ok})
        refused = {}
        for cid, op, ins, attrs in REFUSALS:
            try:
                _rule_on("cuda", op, ins, attrs, (), None, None)
                refused[cid] = False
            except NotImplementedError:
                refused[cid] = True
        attrs = {"shape": [1000, 4], "low": -3, "high": 5, "seed": 7}
        draws = [get_lowering("randint")({}, attrs, OpLoweringContext(
            None, torch.Generator("cuda").manual_seed(seed)))["Out"][0]
                 for seed in (0, 0, 1)]
        randint_ok = (draws[0].dtype == torch.int64 and draws[0].is_cuda
                      and tuple(draws[0].shape) == (1000, 4)
                      and set(draws[0].unique().tolist()) == set(range(-3, 5))
                      and torch.equal(draws[0], draws[1])
                      and not torch.equal(draws[0], draws[2]))
        sampled = _draws_on_the_card()
        nan_matrix = torch.tensor([[1.0, float("nan"), 2.0], [3.0, 4.0, 5.0]],
                                  device="cuda")
        try:
            svdvals_of_nan = torch.linalg.svdvals(nan_matrix).tolist()
        except RuntimeError as e:
            svdvals_of_nan = "raises %s" % type(e).__name__
    rules = sorted(set(worst) | {c[1] for c in REFUSALS} | {"randint"}
                   | set(sampled))
    emit({"phase": "rules_3b_summary", "nvidia_smi": card,
          "cases": len(RULE_CASES), "queue3_fault_rows": QUEUE3_ROWS,
          "cast_rows_held": n_cast, "cast_rows_refused_alike": refused_alike,
          "cast_max_err_over_bound": cast_worst,
          "outputs_checked": n_checked, "rules": len(rules),
          "max_err_over_bound_by_rule": worst, "refusals_raise": refused,
          "randint_range_and_seed": randint_ok, "draws_range_and_seed": sampled,
          "svdvals_of_a_nan_matrix_on_the_card": svdvals_of_nan,
          "failed": bad})
    if (bad or not all(refused.values()) or not randint_ok
            or not all(sampled.values()) or not all(refused_alike.values())
            or len(rules) != RULES_ON_THE_CARD):
        raise AssertionError(
            "item 3-B rules on the card: failed %s, refusals %s, randint %s, "
            "draws %s, refused alike %s, %d rules" % (
                bad, refused, randint_ok, sampled,
                [k for k, v in refused_alike.items() if not v], len(rules)))


def _encoder(cfg_kw, **over):
    from paddle_tpu_torch.tools.programs import EncoderConfig

    return EncoderConfig(**dict(cfg_kw, **over))


def _encoder_steps(cfg, device, values, steps, names):
    """``steps`` runs of the encoder program on ``device`` from the startup
    ``values``: (losses, {name: final numpy value})."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.tools.programs import (bert_encoder_program,
                                                 encoder_feed)

    main, _, v = bert_encoder_program(fluid, cfg)
    scope = convert.scope_from_numpy(values, fluid.Scope(), device)
    exe = _executor(device)
    losses = [float(exe.run(main, feed=encoder_feed(cfg, k),
                            fetch_list=[v["loss"]], scope=scope)[0])
              for k in range(steps)]
    return losses, convert.scope_to_numpy(scope, names)


def phase_encoder_parity(card):
    """Phase 40: the Fluid-layers encoder at 2 layers, hidden 64, 4 heads,
    S = 32, B = 4, dropout 0, three steps on the card and on the CPU from
    one initialisation (the CPU startup's values): with SGD the losses and
    every parameter to ENC_PARITY_TOL of the largest (the key projection's
    bias, whose gradient is exactly 0, to 1e-5 lr a step absolute, as in
    ``tests/test_torch_fluid_encoder.py``); with Adam the losses only (its
    m / sqrt(v) turns a gradient that nearly cancels into a full step)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.tools.programs import bert_encoder_program

    out = {}
    for opt, lr in (("sgd", ENC_SGD_LR), ("adam", ENC_ADAM_LR)):
        cfg = _encoder(ENC_PARITY, lr=lr, optimizer=opt)
        main, startup, _ = bert_encoder_program(fluid, cfg)
        scope0 = fluid.Scope()
        _executor("cpu").run(startup, scope=scope0)
        names = sorted(x.name for x in startup.list_vars() if x.persistable)
        values = convert.scope_to_numpy(scope0, names)
        params = [p.name for p in main.global_block().all_parameters()]
        card_l, card_p = _encoder_steps(cfg, "cuda", values, ENC_PARITY_STEPS,
                                        params)
        cpu_l, cpu_p = _encoder_steps(cfg, "cpu", values, ENC_PARITY_STEPS,
                                      params)
        loss_err = max(_rel([a], [b]) for a, b in zip(card_l, cpu_l))
        rec = {"phase": "encoder_parity", "nvidia_smi": card,
               "optimizer": opt, "lr": lr,
               "steps": ENC_PARITY_STEPS, "card_losses": card_l,
               "cpu_losses": cpu_l, "loss_max_rel_err": loss_err,
               "tol": ENC_PARITY_TOL}
        ok = loss_err <= ENC_PARITY_TOL
        if opt == "sgd":
            key_bias = [n for n in params if n.endswith("_key_fc.b_0")]
            errs = {n: _rel(card_p[n], cpu_p[n]) for n in params
                    if n not in key_bias}
            noise = max(float(abs(p[n]).max()) for p in (card_p, cpu_p)
                        for n in key_bias)
            rec.update(param_max_rel_err=max(errs.values()),
                       worst_param=max(errs, key=errs.get),
                       key_bias_max_abs=noise,
                       key_bias_bound=1e-5 * lr * ENC_PARITY_STEPS)
            ok = (ok and rec["param_max_rel_err"] <= ENC_PARITY_TOL
                  and noise <= rec["key_bias_bound"])
        rec["ok"] = ok
        emit(rec)
        out[opt] = rec
        if not ok:
            raise AssertionError("encoder parity (%s) outside %g: %s"
                                 % (opt, ENC_PARITY_TOL, rec))
    return out


def _encoder_run(cfg, feeds, fetch_params=False):
    """A fresh Executor on the card: the startup, then one run a feed.
    Returns (losses, ms of each run, params or None, (exe, main, scope))."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.programs import bert_encoder_program

    main, startup, v = bert_encoder_program(fluid, cfg)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    losses, ms = [], []
    for feed in feeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[v["loss"]], scope=scope)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(lv))
    params = None
    if fetch_params:
        from paddle_tpu_torch import convert

        params = convert.scope_to_numpy(
            scope, [p.name for p in main.global_block().all_parameters()])
    return losses, ms, params


def phase_encoder(device_name, card):
    """Phase 41: the Fluid-layers BERT-base encoder (``tools/programs.py``
    ``BERT_BASE_ENCODER``: vocab 30528, 12 x 768, 12 heads, FFN 3072,
    S = 512, B = 16, f32, dropout 0.1, Adam 1e-4) through
    ``Executor(CUDAPlace(0))``: a warm-up step and ENC_TIMED timed steps
    (host clock, each ending in a sync), a fresh seeded batch each; ms a
    step, tokens/s, MFU against the bf16 peak and the share of the f32
    CUDA-core peak; launches, busy and idle a step from ``torch.profiler``
    (``profile_step``'s ``fluid_encoder``); a second run from a fresh
    Executor (the same startup seeds) bit for bit the first; ENC_FALL_STEPS
    steps on one batch with dropout 0, the loss falling; no port kernel
    launched."""
    import numpy as np

    from paddle_tpu_torch.tools import profile_step
    from paddle_tpu_torch.tools.programs import (BERT_BASE_ENCODER,
                                                 encoder_feed,
                                                 encoder_train_flops)

    cfg = BERT_BASE_ENCODER
    feeds = [encoder_feed(cfg, ENC_FEED_SEED + k)
             for k in range(ENC_WARMUP + ENC_TIMED)]
    torch.cuda.reset_peak_memory_stats()
    losses, ms, params = _encoder_run(cfg, feeds, fetch_params=True)
    peak = torch.cuda.max_memory_allocated()
    again, _, params2 = _encoder_run(cfg, feeds, fetch_params=True)
    same = again == losses and all(np.array_equal(params[n], params2[n])
                                   for n in params)
    del params, params2
    step_s = sum(ms[ENC_WARMUP:]) / ENC_TIMED / 1e3
    flops = encoder_train_flops(cfg)
    bf16, _, f32 = card_peaks(device_name)
    fall, _, _ = _encoder_run(cfg._replace(dropout=0.0),
                              [encoder_feed(cfg, ENC_FEED_SEED)] * ENC_FALL_STEPS)
    torch.cuda.empty_cache()
    prof = profile_step.profile_model("fluid_encoder", card)
    ok = (bool(np.isfinite(losses).all()) and same
          and fall[-1] < fall[0] and bool(np.isfinite(fall).all()))
    emit({"phase": "encoder", "config": "Fluid-layers BERT-base encoder "
          "(Executor)", "device": device_name, "nvidia_smi": card,
          "dtype": "float32", "batch": cfg.batch, "seq": cfg.seq,
          "layers": cfg.layers, "hidden": cfg.hidden, "vocab": cfg.vocab,
          "optimizer": "adam(1e-4)", "dropout": cfg.dropout,
          "steps_timed": ENC_TIMED, "ms_per_step": step_s * 1e3,
          "ms_each_step": ms, "tokens_per_sec": cfg.batch * cfg.seq / step_s,
          "train_flops_per_step": flops, "mfu_bf16_peak": flops / step_s / bf16,
          "f32_cuda_core_share": flops / step_s / f32,
          "peak_memory_gb": peak / 1e9, "losses": losses,
          "rerun_bit_for_bit": same, "fixed_batch_losses_dropout0": fall,
          "launches_per_step": prof["launches_per_step"],
          "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
          "device_busy_share": 1 - prof["device_idle_share"],
          "device_idle_share": prof["device_idle_share"],
          "wall_ms_per_step_profiled": prof["wall_ms_per_step"], "ok": ok})
    if not ok:
        raise AssertionError("encoder: losses finite %s, rerun bit for bit %s, "
                             "loss falling %s -> %s" % (
                                 bool(np.isfinite(losses).all()), same,
                                 fall[0], fall[-1]))


# -- item 3-B tranche 4: the CRNN-CTC recognizer (phases 42-43) ---------------

CRNN_STEPS = 2               # phase 42: card against the CPU's f32 run
CRNN_TOL = ENC_PARITY_TOL    # as phase 40
CRNN_WARMUP, CRNN_TIMED, CRNN_FALL_STEPS = 1, 5, 10
CRNN_FEED_SEED = 300


def _crnn_run(cfg, device, values, feeds, names):
    """``feeds`` runs of the CRNN program on ``device`` from the startup
    ``values``, then its evaluation program on the last feed: (losses,
    {name: numpy}, (decoded, decoded lengths, distances))."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.tools.programs import crnn_ctc_program

    main, _, test, v = crnn_ctc_program(fluid, cfg)
    scope = convert.scope_from_numpy(values, fluid.Scope(), device)
    exe = _executor(device)
    losses = [float(exe.run(main, feed=f, fetch_list=[v["loss"]],
                            scope=scope)[0]) for f in feeds]
    ev = exe.run(test, feed=feeds[-1], scope=scope,
                 fetch_list=[v["decoded"], v["decoded_length"], v["distance"]])
    return losses, convert.scope_to_numpy(scope, names), ev


def _max_norm_rel(got, want, names):
    """The state ``names`` as one vector: its largest distance over its
    largest magnitude (each name's own, largest first, beside it)."""
    import numpy as np

    err = {n: float(np.abs(got[n].astype(np.float64) - want[n]).max())
           for n in names}
    scale = max(float(np.abs(want[n]).max()) for n in names)
    worst = sorted(err, key=err.get, reverse=True)[:3]
    return max(err.values()) / scale, {n: err[n] for n in worst}


def phase_crnn_parity(card):
    """Phase 42: the CRNN-CTC recognizer (``tools/programs.py``
    ``CRNN_CTC``: 48 x 512 gray images, conv groups of 16 / 32 / 64 / 128
    with BN and ceil-mode pools, ``im2sequence`` to 64 steps of 768, GRUs
    of 200 both ways, 96 logits a step, ``warpctc`` with
    ``norm_by_times``, Momentum(1e-3, 0.9) with L2Decay(4e-4)), B = 32,
    f32, two steps on the card and on the CPU from one initialisation (the
    CPU startup's values), held as phase 40 holds the encoder to the CPU's
    f32 run: the losses, and the model's state as three vectors (the
    parameters, the momentum velocities, the BN running statistics), each
    to CRNN_TOL of its largest magnitude.  Not each parameter on its own:
    the published initialisation (BN scales N(0, 0.01), zero biases) leaves
    whole parameters at rounding noise after two steps (a convolution bias
    before a BN has a gradient of exactly 0; the first BN's offset moves
    by ~1e-11, a cancellation of far larger terms), where a relative
    comparison compares the noise.  ``BoundMode`` cannot hold a whole step:
    through eight BNs, ReLU flips and 64-step recurrences its worst-case
    bounds pass 1e300.  Then the evaluation program (``ctc_greedy_decoder``,
    ``edit_distance``) on the last batch: where the card decodes a row as
    the CPU does, its edit distance equals the CPU's; the rows decoded
    otherwise (a logit that ties within rounding) are counted."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.tools.programs import (CRNN_CTC, crnn_ctc_program,
                                                 crnn_feed)

    cfg = CRNN_CTC
    main, startup, _, _ = crnn_ctc_program(fluid, cfg)
    scope0 = fluid.Scope()
    _executor("cpu").run(startup, scope=scope0)
    names = sorted(x.name for x in startup.list_vars() if x.persistable)
    values = convert.scope_to_numpy(scope0, names)
    params = sorted(p.name for p in main.global_block().all_parameters())
    velocity = [n for n in names if "velocity" in n]
    running = [n for n in names if n.endswith((".mean_0", ".var_0"))]
    feeds = [crnn_feed(cfg, CRNN_FEED_SEED + k) for k in range(CRNN_STEPS)]
    t0 = time.perf_counter()
    card_l, card_p, card_ev = _crnn_run(cfg, "cuda", values, feeds, names)
    cpu_l, cpu_p, cpu_ev = _crnn_run(cfg, "cpu", values, feeds, names)
    loss_err = max(_rel([a], [b]) for a, b in zip(card_l, cpu_l))
    groups = {g: _max_norm_rel(card_p, cpu_p, ns) for g, ns in (
        ("parameters", params), ("velocities", velocity),
        ("bn_running_stats", running))}
    each = {n: _rel(card_p[n], cpu_p[n]) for n in params}
    same_rows = [b for b in range(cfg.batch)
                 if np.array_equal(card_ev[0][b], cpu_ev[0][b])
                 and card_ev[1][b] == cpu_ev[1][b]]
    dist_equal = all(float(card_ev[2][b, 0]) == float(cpu_ev[2][b, 0])
                     for b in same_rows)
    ok = (loss_err <= CRNN_TOL and all(e <= CRNN_TOL for e, _ in groups.values())
          and dist_equal and bool(np.isfinite(card_ev[2]).all())
          and len(params) == 8 * 4 + 15 and len(velocity) == len(params))
    rec = {"phase": "crnn_parity", "nvidia_smi": card, "batch": cfg.batch,
           "image": [cfg.height, cfg.width], "steps": CRNN_STEPS,
           "card_losses": card_l, "cpu_losses": cpu_l,
           "loss_max_rel_err": loss_err,
           "state_max_rel_err": {g: e for g, (e, _) in groups.items()},
           "state_largest_distances": {g: w for g, (_, w) in groups.items()},
           "param_rel_err_each_largest": sorted(each.values())[-3:],
           "tol": CRNN_TOL, "eval_rows_decoded_as_cpu": len(same_rows),
           "eval_distances_equal_there": dist_equal,
           "card_mean_edit_distance": float(np.mean(card_ev[2])),
           "cpu_mean_edit_distance": float(np.mean(cpu_ev[2])),
           "seconds": time.perf_counter() - t0, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError("CRNN parity outside %g: %s" % (CRNN_TOL, rec))
    return rec


def _ctc_yardstick(device_name):
    """The warpctc rule (forward and backward, its own log-space loop over
    T) against ``F.ctc_loss`` (cuDNN's or PyTorch's CTC kernels) at the
    CRNN's CTC shape, [32, 64, 96] logits, labels of 4-24: CUDA-event
    times of each, and their largest difference per row (a yardstick; the
    port never calls F.ctc_loss)."""
    import numpy as np
    import torch.nn.functional as F

    from paddle_tpu_torch.registry import OpLoweringContext, get_lowering
    from paddle_tpu_torch.tools.programs import CRNN_CTC, crnn_feed

    cfg = CRNN_CTC
    T = cfg.width // 8
    feed = crnn_feed(cfg, CRNN_FEED_SEED)
    g = torch.Generator().manual_seed(6)
    logits = torch.randn(cfg.batch, T, cfg.classes + 1, generator=g).cuda()
    logits.requires_grad_(True)
    labels = torch.from_numpy(feed["label"]).cuda()
    lens = torch.from_numpy(feed["label_length"]).cuda()
    rule = get_lowering("warpctc")
    ctx = OpLoweringContext(None, torch.Generator("cuda"))

    def ours():
        loss = rule({"Logits": [logits], "Label": [labels],
                     "LabelLength": [lens]}, {"blank": cfg.classes}, ctx)["Loss"][0]
        torch.autograd.grad(loss.sum(), [logits])
        return loss

    def library():
        lp = torch.log_softmax(logits, -1).transpose(0, 1)
        loss = F.ctc_loss(lp, labels.long(), torch.full((cfg.batch,), T,
                                                        device="cuda"),
                          lens, blank=cfg.classes, reduction="none")
        torch.autograd.grad(loss.sum(), [logits])
        return loss

    diff = float((ours().detach()[:, 0] - library().detach()).abs().max())
    rec = {"phase": "ctc_yardstick", "shape": [cfg.batch, T, cfg.classes + 1],
           "label_lengths": [int(lens.min()), int(lens.max())],
           "warpctc_rule_fwd_bwd_ms": cuda_time(ours, iters=10),
           "f_ctc_loss_fwd_bwd_ms": cuda_time(library, iters=10),
           "max_abs_loss_difference": diff,
           "losses_finite": bool(np.isfinite(diff))}
    emit(rec)
    return rec


def phase_crnn(device_name, card):
    """Phase 43: the CRNN-CTC recognizer at its published widths, B = 32,
    f32, through ``Executor(CUDAPlace(0))`` from the card's own seeded
    startup: a warm-up step and CRNN_TIMED timed steps, a fresh seeded
    batch each (ms a step, images/s, the share of the f32 CUDA-core and
    bf16 peaks, peak memory); launches, busy and idle a step from
    ``tools/profile_step.py``'s ``crnn_ctc``; CRNN_FALL_STEPS steps on one
    batch with the loss falling, then the evaluation program on that batch
    (the mean edit distance); the warpctc rule against ``F.ctc_loss`` as a
    yardstick."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import profile_step
    from paddle_tpu_torch.tools.programs import (CRNN_CTC, crnn_ctc_program,
                                                 crnn_feed, crnn_train_flops)

    cfg = CRNN_CTC
    torch.cuda.reset_peak_memory_stats()
    main, startup, test, v = crnn_ctc_program(fluid, cfg)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    losses, ms = [], []
    for k in range(CRNN_WARMUP + CRNN_TIMED):
        feed = crnn_feed(cfg, CRNN_FEED_SEED + k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[v["loss"]], scope=scope)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(lv))
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(ms[CRNN_WARMUP:]) / CRNN_TIMED / 1e3
    one = crnn_feed(cfg, CRNN_FEED_SEED)
    fall = [float(exe.run(main, feed=one, fetch_list=[v["loss"]],
                          scope=scope)[0]) for _ in range(CRNN_FALL_STEPS)]
    dist, dec_len = exe.run(test, feed=one, scope=scope,
                            fetch_list=[v["distance"], v["decoded_length"]])
    del exe, scope
    torch.cuda.empty_cache()
    prof = profile_step.profile_model("crnn_ctc", card)
    ctc = _ctc_yardstick(device_name)
    flops = crnn_train_flops(cfg)
    bf16, _, f32 = card_peaks(device_name)
    ok = (bool(np.isfinite(losses).all()) and bool(np.isfinite(fall).all())
          and fall[-1] < fall[0] and bool(np.isfinite(dist).all())
          and ctc["losses_finite"])
    emit({"phase": "crnn", "config": "CRNN-CTC (PaddleCV ocr_recognition, "
          "crnn_ctc_model.py) through the Executor", "device": device_name,
          "nvidia_smi": card, "dtype": "float32", "batch": cfg.batch,
          "image": [1, cfg.height, cfg.width], "classes": cfg.classes + 1,
          "optimizer": "momentum(1e-3, 0.9) + L2Decay(4e-4)",
          "steps_timed": CRNN_TIMED, "ms_per_step": step_s * 1e3,
          "ms_each_step": ms, "images_per_sec": cfg.batch / step_s,
          "train_flops_per_step": flops,
          "f32_cuda_core_share": flops / step_s / f32,
          "mfu_bf16_peak": flops / step_s / bf16,
          "peak_memory_gb": peak / 1e9, "losses": losses,
          "fixed_batch_losses": fall,
          "eval_mean_edit_distance": float(np.mean(dist)),
          "eval_mean_decoded_length": float(np.mean(dec_len)),
          "launches_per_step": prof["launches_per_step"],
          "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
          "device_busy_share": 1 - prof["device_idle_share"],
          "device_idle_share": prof["device_idle_share"],
          "wall_ms_per_step_profiled": prof["wall_ms_per_step"], "ok": ok})
    if not ok:
        raise AssertionError("crnn: losses finite %s, loss falling %s -> %s, "
                             "distances finite %s" % (
                                 bool(np.isfinite(losses).all()), fall[0],
                                 fall[-1], bool(np.isfinite(dist).all())))



# -- item 3-B tranche 5 and the LAC tagger (phases 44-46) -----------------------

# phase 44's rules: tranche 5 (59)
RULES_5_ON_THE_CARD = 59
LAC_STEPS = 2                # phase 45: card against the CPU's f32 run
LAC_TOL = ENC_PARITY_TOL     # as phases 40 and 42
LAC_WARMUP, LAC_TIMED, LAC_FALL_STEPS = 1, 5, 30
LAC_FEED_SEED = 400


def _contract_draws_on_the_card():
    """The random rules of tranche 5 and ``py_func`` on CUDA tensors:
    ``*_batch_size_like`` shapes, dtypes, ranges, a seed repeating itself
    and another not; ``random_crop`` windows at starts in range with
    SeedOut the seed; ``py_func`` calling a numpy function on the card's
    tensors; ``merge_selected_rows`` of integer-valued rows bit for bit
    the CPU's."""
    import numpy as np

    from paddle_tpu_torch.ops.misc_ops4 import register_py_func
    from paddle_tpu_torch.registry import OpLoweringContext, get_lowering
    from paddle_tpu_torch.sparse import SelectedRows

    def run(op, ins, attrs, seed=0, device="cuda"):
        return get_lowering(op)(ins, dict(attrs), OpLoweringContext(
            None, torch.Generator(device).manual_seed(seed)))

    like = torch.zeros(6, 1000, device="cuda")
    ok = {}
    attrs = {"shape": [-1, 300], "input_dim_idx": 1, "output_dim_idx": 0,
             "min": -2.0, "max": 3.0, "seed": 4}
    u = [run("uniform_random_batch_size_like", {"Input": [like]}, attrs, s)
         ["Out"][0] for s in (0, 0, 1)]
    ok["uniform_random_batch_size_like"] = (
        u[0].is_cuda and tuple(u[0].shape) == (1000, 300)
        and float(u[0].min()) >= -2.0 and float(u[0].max()) < 3.0
        and torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2]))
    attrs = {"shape": [4, -1], "input_dim_idx": 0, "output_dim_idx": 1,
             "mean": 1.0, "std": 0.5, "seed": 4, "dtype": "float64"}
    gs = [run("gaussian_random_batch_size_like", {"Input": [like]}, attrs, s)
          ["Out"][0] for s in (0, 0, 1)]
    ok["gaussian_random_batch_size_like"] = (
        gs[0].is_cuda and gs[0].dtype == torch.float64
        and tuple(gs[0].shape) == (4, 6) and torch.equal(gs[0], gs[1])
        and not torch.equal(gs[0], gs[2]))
    x = torch.arange(2 * 5 * 6, dtype=torch.float32, device="cuda").reshape(2, 5, 6)
    crops = []
    for s in range(12):
        r = run("random_crop", {"X": [x]}, {"shape": [3, 4], "seed": 9}, s)
        o = r["Out"][0]
        i, j = divmod(int(o[0, 0, 0]), 6)
        crops.append(o.is_cuda and int(r["SeedOut"][0]) == 9 and 0 <= i <= 2
                     and 0 <= j <= 2 and torch.equal(o, x[:, i:i + 3, j:j + 4]))
    ok["random_crop"] = all(crops)
    seen = []

    def host(a, b):
        seen.append((type(a), type(b)))
        return a * 2 + b, b.max()

    fid = register_py_func(host)
    a = torch.arange(6, dtype=torch.float32, device="cuda").reshape(2, 3)
    b = torch.tensor([[1, 5, -2], [0, 3, 7]], dtype=torch.int32, device="cuda")
    got = run("py_func", {"X": [a, b]},
              {"forward_callable_id": fid, "out_shapes": [[2, 3], []],
               "out_dtypes": ["float32", "int64"]})["Out"]
    ok["py_func"] = (all(t.is_cuda for t in got) and seen == [(np.ndarray,) * 2]
                     and torch.equal(got[0], a * 2 + b)
                     and got[1].dtype == torch.int64 and int(got[1]) == 7)
    rows = torch.tensor([4, 1, 4, 0, 1, 4, 9, 0])
    vals = torch.randint(-50, 50, (8, 16), generator=torch.Generator()
                         .manual_seed(3)).float()
    merged = [run("merge_selected_rows", {"X": [SelectedRows(
        rows.to(dev), vals.to(dev), 12)]}, {}, device=dev)["Out"][0]
        for dev in ("cuda", "cpu")]
    ok["merge_selected_rows"] = (
        merged[0].values.is_cuda
        and torch.equal(merged[0].rows.cpu(), merged[1].rows)
        and torch.equal(merged[0].values.cpu(), merged[1].values)
        and merged[1].rows.tolist()[:4] == [0, 1, 4, 9])
    return ok


def phase_rules_5(card):
    """Phase 44: every row of ``tools/rule_cases_5.py`` (item 3-B's
    tranche 5, the 59 rules of ``misc_ops``-``misc_ops4`` with their kinks
    and attribute edges) on CUDA tensors, forward and the gradients of a
    seeded cotangent, held as phase 39 holds tranches 1-4: to the same rule
    in float64 on the CPU within ``BoundMode``'s derived bound (bit for bit
    with the CPU's f32 rule where no operation rounds; integer and bool
    outputs, as ``hash``, ``unique``'s Index, ``chunk_eval``'s and
    ``mean_iou``'s counts, exactly), cuDNN off; every row's int32 and bool
    casts alike, or refused on the card where the CPU refuses; the four
    refusals raise; the random rules, ``py_func`` and SelectedRows by
    contract (``_contract_draws_on_the_card``); ``install_check.run_check()``
    on the card."""
    import io as _io
    import contextlib

    from paddle_tpu_torch import install_check
    from paddle_tpu_torch.tools.rule_cases import cast_rows
    from paddle_tpu_torch.tools.rule_cases_5 import REFUSALS_5, RULE_CASES_5

    worst, bad, n_checked, refused_alike = {}, [], 0, {}
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=False):
        for cid, op, ins, attrs, grad_slots, grad_out in RULE_CASES_5:
            rows, ok, ambiguous = _hold_row(op, ins, attrs, grad_slots, grad_out)
            n_checked += len(rows)
            ratio = max(r["ratio"] for r in rows.values())
            worst[op] = max(worst.get(op, 0.0), ratio)
            emit({"phase": "rules_5", "case": cid, "op": op,
                  "max_err_over_bound": ratio, "outputs": rows,
                  "undecided_comparisons": ambiguous, "ok": ok})
            if not ok:
                bad.append(cid)
        cast_worst, n_cast = 0.0, 0
        for cid, op, ins, attrs in cast_rows(RULE_CASES_5):
            if _raises("cpu", op, ins, attrs):
                refused_alike[cid] = _raises("cuda", op, ins, attrs)
                continue
            rows, ok, _ = _hold_row(op, ins, attrs, (), None)
            n_cast += 1
            n_checked += len(rows)
            cast_worst = max([cast_worst] + [r["ratio"] for r in rows.values()])
            if not ok:
                bad.append(cid)
                emit({"phase": "rules_5_cast", "case": cid, "op": op,
                      "outputs": rows, "ok": ok})
        refused = {cid: _raises("cuda", op, ins, attrs)
                   for cid, op, ins, attrs in REFUSALS_5}
        drawn = _contract_draws_on_the_card()
    said = _io.StringIO()
    with contextlib.redirect_stdout(said):
        check_loss = install_check.run_check()
    rules = sorted(set(worst) | set(drawn))
    emit({"phase": "rules_5_summary", "nvidia_smi": card,
          "cases": len(RULE_CASES_5), "cast_rows_held": n_cast,
          "cast_rows_refused_alike": refused_alike,
          "cast_max_err_over_bound": cast_worst,
          "outputs_checked": n_checked, "rules": len(rules),
          "max_err_over_bound_by_rule": worst, "refusals_raise": refused,
          "contracts": drawn, "install_check": said.getvalue().strip(),
          "seconds": time.perf_counter() - t0, "failed": bad})
    name = torch.cuda.get_device_name(0)
    if (bad or not all(refused.values()) or not all(drawn.values())
            or not all(refused_alike.values())
            or len(rules) != RULES_5_ON_THE_CARD
            or not (name in said.getvalue() and "TPU" not in said.getvalue()
                    and check_loss == check_loss)):
        raise AssertionError(
            "tranche 5 on the card: failed %s, refusals %s, contracts %s, "
            "refused alike %s, %d rules, install_check %r" % (
                bad, refused, drawn,
                [k for k, v in refused_alike.items() if not v], len(rules),
                said.getvalue()))


def _lac_run(cfg, device, values, feeds, names):
    """``feeds`` runs of the LAC program on ``device`` from the startup
    ``values``, fetching the loss and the decoded tags with chunk_eval's
    counts and scores, then its test program on the last feed: (losses,
    evaluations a step, {name: numpy}, the test evaluation)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.tools.programs import lac_program

    main, _, test, v = lac_program(fluid, cfg)
    scope = convert.scope_from_numpy(values, fluid.Scope(), device)
    exe = _executor(device)
    fetch = [v[k] for k in ("loss", "decoded", "num_infer", "num_label",
                            "num_correct", "precision", "recall", "f1")]
    runs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope) for f in feeds]
    ev = exe.run(test, feed=feeds[-1], scope=scope, fetch_list=fetch[1:])
    return ([float(r[0]) for r in runs], [r[1:] for r in runs],
            convert.scope_to_numpy(scope, names), ev)


def _same_eval(a, b):
    """Decoded tags and chunk counts equal; precision, recall, F1 within 2
    roundings of the CPU's f32 (each is a count ratio: one division, F1 two
    more operations)."""
    import numpy as np

    exact = all(np.array_equal(np.asarray(x), np.asarray(y))
                for x, y in zip(a[:4], b[:4]))
    scores = all(abs(float(x) - float(y)) <= 4 * 2.0 ** -24 * max(abs(float(y)), 1e-30)
                 for x, y in zip(a[4:], b[4:]))
    return exact and scores


def phase_lac_parity(card):
    """Phase 45: the LAC tagger (``tools/programs.py`` ``lac_program``) at
    a narrow width (2 bidirectional GRU layers of 8, embedding 8,
    vocabulary 50, 7 tags, B = 3, T = 6), f32, two Adam steps on the card
    and on the CPU from one initialisation (the CPU startup's values): the
    losses, and the parameters and the two Adam moments each as one
    vector, to LAC_TOL of its largest (phases 40 and 42's tolerance; one
    by one, an element whose gradient is rounding noise moves by Adam's
    lr g / (|g| + eps)); every ``crf_decoding`` tag and every
    ``chunk_eval`` count exactly, precision / recall / F1 to the CPU's
    f32 within their few roundings, in both training steps and the test
    program."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.tools.programs import (LACConfig, lac_feed,
                                                 lac_program)

    cfg = LACConfig(batch=3, seq_len=6, vocab=50, emb=8, hidden=8, tags=7,
                    len_min=2, len_max=6, lr=1e-3)
    main, startup, _, _ = lac_program(fluid, cfg)
    scope0 = fluid.Scope()
    _executor("cpu").run(startup, scope=scope0)
    names = sorted(x.name for x in startup.list_vars() if x.persistable)
    values = convert.scope_to_numpy(scope0, names)
    params = sorted(p.name for p in main.global_block().all_parameters())
    groups = {"parameters": params,
              "moment1": [n for n in names if "_moment1" in n],
              "moment2": [n for n in names if "_moment2" in n]}
    feeds = [lac_feed(cfg, LAC_FEED_SEED + k) for k in range(LAC_STEPS)]
    t0 = time.perf_counter()
    card_l, card_e, card_p, card_t = _lac_run(cfg, "cuda", values, feeds, names)
    cpu_l, cpu_e, cpu_p, cpu_t = _lac_run(cfg, "cpu", values, feeds, names)
    loss_err = max(_rel([a], [b]) for a, b in zip(card_l, cpu_l))
    state = {g: _max_norm_rel(card_p, cpu_p, ns) for g, ns in groups.items()}
    evals = [_same_eval(a, b) for a, b in zip(card_e + [card_t], cpu_e + [cpu_t])]
    ok = (loss_err <= LAC_TOL and all(e <= LAC_TOL for e, _ in state.values())
          and all(evals) and len(params) == 28
          and len(groups["moment1"]) == len(params))
    rec = {"phase": "lac_parity", "nvidia_smi": card, "batch": cfg.batch,
           "seq_len": cfg.seq_len, "steps": LAC_STEPS, "card_losses": card_l,
           "cpu_losses": cpu_l, "loss_max_rel_err": loss_err,
           "state_max_rel_err": {g: e for g, (e, _) in state.items()},
           "state_largest_distances": {g: w for g, (_, w) in state.items()},
           "tol": LAC_TOL, "evaluations_equal": evals,
           "card_counts": [[int(x) for x in e[1:4]] for e in card_e + [card_t]],
           "seconds": time.perf_counter() - t0, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError("LAC parity outside %g: %s" % (LAC_TOL, rec))
    return rec


def phase_lac(device_name, card):
    """Phase 46: the LAC tagger at its published widths (vocabulary 20,940,
    embedding 128, 2 bidirectional GRU layers of 128, 57 tags), B = 300,
    T = 64, f32, Adam(1e-3) with the learning-rate factors 5 (embedding)
    and 0.2 (``crfw``), through ``Executor(CUDAPlace(0))`` from the card's
    own seeded startup: a warm-up step and LAC_TIMED timed steps, a fresh
    seeded batch each (ms a step, tokens/s at B T, the share of the f32
    CUDA-core peak from ``lac_train_flops``, peak memory); launches, busy
    and idle a step from ``tools/profile_step.py``'s ``lac``;
    the test program's chunk precision, recall and F1 on one batch before
    and after LAC_FALL_STEPS steps on it: the loss falls, and as the
    feed's tags follow from its words, chunks are inferred and matched and
    F1 rises."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import profile_step
    from paddle_tpu_torch.tools.programs import (LAC, lac_feed, lac_program,
                                                 lac_train_flops)

    cfg = LAC
    torch.cuda.reset_peak_memory_stats()
    main, startup, test, v = lac_program(fluid, cfg)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    losses, ms = [], []
    for k in range(LAC_WARMUP + LAC_TIMED):
        feed = lac_feed(cfg, LAC_FEED_SEED + k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[v["loss"]], scope=scope)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(lv))
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(ms[LAC_WARMUP:]) / LAC_TIMED / 1e3
    one = lac_feed(cfg, LAC_FEED_SEED)
    evaluated = [v[k] for k in ("precision", "recall", "f1", "num_infer",
                                "num_label", "num_correct")]
    before = exe.run(test, feed=one, scope=scope, fetch_list=evaluated)
    fall = [float(exe.run(main, feed=one, fetch_list=[v["loss"]],
                          scope=scope)[0]) for _ in range(LAC_FALL_STEPS)]
    p, r, f1, ni, nl, nc = exe.run(test, feed=one, scope=scope,
                                   fetch_list=evaluated)
    del exe, scope
    torch.cuda.empty_cache()
    prof = profile_step.profile_model("lac", card)
    flops = lac_train_flops(cfg)
    _, _, f32 = card_peaks(device_name)
    tokens = cfg.batch * cfg.seq_len
    ok = (bool(np.isfinite(losses).all()) and bool(np.isfinite(fall).all())
          and fall[-1] < fall[0] and int(nl) > 0 and int(ni) > 0
          and int(nc) > 0 and float(before[2]) < float(f1) <= 1.0)
    emit({"phase": "lac", "config": "LAC lexical analysis (PaddleNLP "
          "lexical_analysis, nets.py lex_net) through the Executor",
          "device": device_name, "nvidia_smi": card, "dtype": "float32",
          "batch": cfg.batch, "seq_len": cfg.seq_len, "vocab": cfg.vocab,
          "tags": cfg.tags, "optimizer": "adam(1e-3), lr factors emb 5, "
          "crfw 0.2, L2Decay(1e-4)", "steps_timed": LAC_TIMED,
          "ms_per_step": step_s * 1e3, "ms_each_step": ms,
          "tokens_per_sec": tokens / step_s, "train_flops_per_step": flops,
          "f32_cuda_core_share": flops / step_s / f32,
          "peak_memory_gb": peak / 1e9, "losses": losses,
          "fixed_batch_losses": fall, "eval_precision": float(p),
          "eval_recall": float(r), "eval_f1": float(f1),
          "eval_chunks_infer_label_correct": [int(ni), int(nl), int(nc)],
          "eval_before_fixed_batch_steps": {
              "precision": float(before[0]), "recall": float(before[1]),
              "f1": float(before[2]),
              "chunks_infer_label_correct": [int(x) for x in before[3:]]},
          "launches_per_step": prof["launches_per_step"],
          "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
          "device_busy_share": 1 - prof["device_idle_share"],
          "device_idle_share": prof["device_idle_share"],
          "wall_ms_per_step_profiled": prof["wall_ms_per_step"], "ok": ok})
    if not ok:
        raise AssertionError("lac: losses finite %s, loss falling %s -> %s, "
                             "chunks inferred / label / correct %d / %d / "
                             "%d, F1 %r -> %r" % (
                                 bool(np.isfinite(losses).all()), fall[0],
                                 fall[-1], int(ni), int(nl), int(nc),
                                 float(before[2]), float(f1)))


# -- item 3-C, the dygraph mode (phases 47-49) ----------------------------------

DY_PARITY_STEPS = 2          # phase 47: card against the CPU
DY_TOL = ENC_PARITY_TOL      # as phases 40, 42 and 45
DY_FEED_SEED = 500
DY_WARMUP, DY_TIMED, DY_FALL_STEPS = 1, 5, 20
DY_REQUESTS = 20             # phase 49: ms a request, each way
DY_NEW_BATCH = 8             # phase 49: a second signature
DY_DIR = "build/dygraph"


def _dy_narrow():
    """Phase 47's ResNet: the [1, 1, 1, 1] layout, widths 8-64, 32 x 32,
    B = 4."""
    from paddle_tpu_torch.tools.programs import DygraphResNetConfig

    return DygraphResNetConfig(depth=(1, 1, 1, 1), base_width=8, classes=102,
                               batch=4, image=32)


def _dy_place(device):
    import paddle_tpu_torch as fluid

    return fluid.CPUPlace() if device == "cpu" else fluid.CUDAPlace(0)


def _dy_resnet_run(cfg, device, state, feeds, dtype):
    """Momentum steps of ``dygraph_resnet`` on ``device`` from ``state``,
    its parameters and statistics in ``dtype``: (losses, {name: float64
    numpy} of the state, of the velocities)."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.programs import (dygraph_resnet,
                                                 dygraph_resnet_optimizer,
                                                 dygraph_resnet_step)

    dy = fluid.dygraph
    with dy.guard(_dy_place(device)):
        net = dygraph_resnet(fluid, cfg)
        net.set_dict(state)
        for p in net.parameters():
            p._value = p._value.to(dtype)
        opt = dygraph_resnet_optimizer(fluid)
        losses = [float(dygraph_resnet_step(
            fluid, net, opt, dy.to_variable(torch.from_numpy(img).to(dtype)),
            dy.to_variable(lab))[0].numpy()) for img, lab in feeds]
        vel = {n: opt._dy_acc[("velocity", id(p))].double().cpu().numpy()
               for n, p in net.named_parameters() if p.trainable}
        return (losses, {n: v.astype(np.float64)
                         for n, v in net.state_dict().items()}, vel)


def _dy_layer_set(fluid):
    """A Linear, a LayerNorm, a GRUUnit over 6 steps, an Embedding and a
    ``_lowering_apply`` layer (BilinearTensorProduct) in one Layer."""
    dy = fluid.dygraph

    class LayerSet(dy.Layer):
        def __init__(self):
            super().__init__("layer_set")
            self.emb = dy.Embedding(size=[50, 16])
            self.fc = dy.Linear(16, 24, act="tanh")
            self.ln = dy.LayerNorm(normalized_shape=[24], begin_norm_axis=2)
            self.gru = dy.GRUUnit(size=24)
            self.btp = dy.nn.BilinearTensorProduct(size=3, act="sigmoid")

        def forward(self, ids, h):
            x = self.ln(self.fc(self.emb(ids)))
            for t in range(x.shape[1]):
                h, _, _ = self.gru(x[:, t, :], h)
            return self.btp(h, h)

    return LayerSet()


def _dy_layer_set_run(device, state, feed):
    """The layer set on ``device`` from ``state`` (its lazy layer built by
    a first call): the loss, one Adam step, the loss again; (losses,
    {name: numpy} of the state and the two moments, {name: gradient})."""
    import numpy as np

    import paddle_tpu_torch as fluid

    dy = fluid.dygraph
    ids, h0, w = feed
    with dy.guard(_dy_place(device)):
        net = _dy_layer_set(fluid)
        net(dy.to_variable(ids), dy.to_variable(h0))
        if state is not None:
            net.set_dict(state)
        opt = fluid.optimizer.Adam(1e-3)

        def loss():
            out = net(dy.to_variable(ids), dy.to_variable(h0))
            return dy.nn._lowering_apply("mean", ("X",), {}, "Out",
                                         out * dy.to_variable(w))

        first = loss()
        first.backward()
        grads = {n: p._grad for n, p in net.named_parameters()}
        opt.minimize(first, parameter_list=net.parameters())
        net.clear_gradients()
        after = loss()
        got = {n: v.astype(np.float64) for n, v in net.state_dict().items()}
        for n, p in net.named_parameters():
            for m in ("moment1", "moment2"):
                got["%s@%s" % (n, m)] = (opt._dy_acc[(m, id(p))]
                                         .double().cpu().numpy())
        return [float(first.numpy()), float(after.numpy())], got, grads


def _dy_clippers(grads):
    """Each clipper on the card's gradients against its float64 CPU run
    within ``BoundMode``'s bound: the largest ratio of each."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import fp_bounds

    gs = [g for _, g in sorted(grads.items()) if g is not None]
    top = max(float(g.abs().max()) for g in gs)
    norms = [float(g.double().norm()) for g in gs]
    glob = sum(n * n for n in norms) ** 0.5
    clip = fluid.dygraph_grad_clip
    rec = {}
    for name, c in (("value", clip.GradClipByValue(0.5 * top)),
                    ("norm", clip.GradClipByNorm(0.5 * min(norms))),
                    ("global_norm", clip.GradClipByGlobalNorm(0.5 * glob))):
        def rule(ins, attrs, ctx, c=c):
            return {"Out": [g for _, g in c._clip(list(enumerate(ins["G"])))]}

        res, _, ambiguous = fp_bounds.rule_bounds(rule, {"G": [g.cpu() for g in gs]}, {})
        got = rule({"G": gs}, {}, None)["Out"]
        held = [fp_bounds.hold_to_bound(g, r, b)
                for g, (r, b) in zip(got, res["Out"])]
        rec[name] = {"ratio": max(h["ratio"] for h in held),
                     "on_the_card": all(g.is_cuda for g in got),
                     "ok": (all(h["ok"] for h in held) and not ambiguous
                            and all(g.is_cuda for g in got))}
    return rec


def phase_dygraph_parity(card):
    """Phase 47: the dygraph mode on the card against the CPU.  The narrow
    ResNet of ``tools/programs.py`` (``dygraph_resnet`` at the [1, 1, 1, 1]
    layout, widths 8-64, 32 x 32, B = 4), from one set of weights
    (``set_dict``), DY_PARITY_STEPS Momentum steps on each: in float64 the
    losses, and the parameters, velocities and BN statistics each as one
    vector, to DY_TOL of its largest; in f32 the first loss to DY_TOL and
    the state's distances recorded (a ReLU input that cancels to ~0 takes
    either sign in f32, and its flip moves every gradient below it: the
    f32 trajectory is not held).  A Linear + LayerNorm + GRUUnit +
    Embedding + BilinearTensorProduct set in f32, one Adam step: the two
    losses, the parameters and both moments as vectors to DY_TOL.  Each
    gradient clipper on the card's gradients to its float64 CPU run
    within ``BoundMode``'s bound."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.programs import (dygraph_resnet,
                                                 dygraph_resnet_feed)

    t0 = time.perf_counter()
    cfg = _dy_narrow()
    with fluid.dygraph.guard(fluid.CPUPlace()):
        state = dygraph_resnet(fluid, cfg).state_dict()
    feeds = [dygraph_resnet_feed(cfg, DY_FEED_SEED + k)
             for k in range(DY_PARITY_STEPS)]
    rec = {"phase": "dygraph_parity", "nvidia_smi": card, "batch": cfg.batch,
           "image": cfg.image, "steps": DY_PARITY_STEPS, "tol": DY_TOL}
    ok = True
    for dtype in (torch.float64, torch.float32):
        card_l, card_s, card_v = _dy_resnet_run(cfg, "cuda", state, feeds, dtype)
        cpu_l, cpu_s, cpu_v = _dy_resnet_run(cfg, "cpu", state, feeds, dtype)
        trainable = list(cpu_v)
        stats = [n for n in cpu_s if n not in cpu_v]
        errs = {"parameters": _max_norm_rel(card_s, cpu_s, trainable),
                "velocities": _max_norm_rel(card_v, cpu_v, trainable),
                "bn_statistics": _max_norm_rel(card_s, cpu_s, stats)}
        loss_errs = [_rel([a], [b]) for a, b in zip(card_l, cpu_l)]
        key = str(dtype).replace("torch.", "")
        rec[key] = {"card_losses": card_l, "cpu_losses": cpu_l,
                    "loss_rel_err": loss_errs,
                    "state_max_rel_err": {g: e for g, (e, _) in errs.items()},
                    "state_largest_distances": {g: w for g, (_, w) in errs.items()}}
        if dtype == torch.float64:
            ok &= (max(loss_errs) <= DY_TOL
                   and all(e <= DY_TOL for e, _ in errs.values())
                   and len(trainable) == 53 and len(stats) == 34)
        else:
            ok &= loss_errs[0] <= DY_TOL and bool(np.isfinite(card_l).all())
    rng = np.random.RandomState(DY_FEED_SEED)
    feed = (rng.randint(0, 50, (4, 6)).astype(np.int64),
            (rng.randn(4, 8) * 0.5).astype(np.float32),
            np.cos(np.arange(12)).reshape(4, 3).astype(np.float32))
    with fluid.dygraph.guard(fluid.CPUPlace()):
        net = _dy_layer_set(fluid)
        net(fluid.dygraph.to_variable(feed[0]), fluid.dygraph.to_variable(feed[1]))
        state = net.state_dict()
    card_l, card_s, card_g = _dy_layer_set_run("cuda", state, feed)
    cpu_l, cpu_s, _ = _dy_layer_set_run("cpu", state, feed)
    groups = {"parameters": [n for n in cpu_s if "@" not in n],
              "moment1": [n for n in cpu_s if n.endswith("@moment1")],
              "moment2": [n for n in cpu_s if n.endswith("@moment2")]}
    errs = {g: _max_norm_rel(card_s, cpu_s, ns) for g, ns in groups.items()}
    loss_err = max(_rel([a], [b]) for a, b in zip(card_l, cpu_l))
    rec["layer_set"] = {"layers": "Embedding, Linear(tanh), LayerNorm, "
                        "GRUUnit x 6, BilinearTensorProduct(sigmoid)",
                        "optimizer": "adam(1e-3), one step",
                        "card_losses": card_l, "cpu_losses": cpu_l,
                        "loss_rel_err": loss_err,
                        "state_max_rel_err": {g: e for g, (e, _) in errs.items()}}
    ok &= loss_err <= DY_TOL and all(e <= DY_TOL for e, _ in errs.values())
    rec["clippers"] = _dy_clippers(card_g)
    ok &= all(r["ok"] for r in rec["clippers"].values())
    rec["seconds"] = time.perf_counter() - t0
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("dygraph parity: %s" % rec)


def _dy_accuracy(prob, label):
    return float((prob.numpy().argmax(1) == label.reshape(-1)).mean())


def phase_dygraph_resnet(device_name, card):
    """Phase 48: the dygraph ResNet-50 of ``tools/programs.py``
    (``DYGRAPH_RESNET50``: PaddlePaddle models v1.6 dygraph/resnet at its
    published widths, 102 classes, B = 32, 224 x 224, f32, Momentum 0.9
    over ``PiecewiseDecay`` from 0.1) under ``dygraph.guard()`` on the
    card: a warm-up and DY_TIMED timed steps on fresh seeded batches
    staged on the card (ms a step, images/s, the f32 CUDA-core share from
    ``dygraph_resnet_train_flops``, peak memory, the first loss);
    launches, busy and idle a step from ``tools/profile_step.py``'s
    ``dygraph_resnet``; DY_FALL_STEPS steps on one batch: the loss falls
    and that batch's accuracy rises.  Returns the trained net and a batch
    for phase 49."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import profile_step
    from paddle_tpu_torch.tools.programs import (
        DYGRAPH_RESNET50, dygraph_resnet, dygraph_resnet_feed,
        dygraph_resnet_optimizer, dygraph_resnet_step,
        dygraph_resnet_train_flops)

    cfg = DYGRAPH_RESNET50
    dy = fluid.dygraph
    torch.cuda.reset_peak_memory_stats()
    with dy.guard():
        net = dygraph_resnet(fluid, cfg)
        opt = dygraph_resnet_optimizer(fluid)
        batches = []
        for k in range(DY_WARMUP + DY_TIMED):
            img, lab = dygraph_resnet_feed(cfg, DY_FEED_SEED + k)
            batches.append((dy.to_variable(img), dy.to_variable(lab)))
        losses, ms = [], []
        for img, lab in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = dygraph_resnet_step(fluid, net, opt, img, lab)
            lv = float(loss.numpy())
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(lv)
        peak = torch.cuda.max_memory_allocated()
        step_s = sum(ms[DY_WARMUP:]) / DY_TIMED / 1e3
        img, lab = batches[0]
        fall, acc = [], []
        for _ in range(DY_FALL_STEPS):
            loss, prob = dygraph_resnet_step(fluid, net, opt, img, lab)
            fall.append(float(loss.numpy()))
            acc.append(_dy_accuracy(prob, lab.numpy()))
        del batches
    torch.cuda.empty_cache()
    prof = profile_step.profile_model("dygraph_resnet", card)
    flops = dygraph_resnet_train_flops(cfg)
    _, _, f32 = card_peaks(device_name)
    ok = (bool(np.isfinite(losses).all()) and bool(np.isfinite(fall).all())
          and fall[-1] < fall[0] and acc[-1] > acc[0])
    emit({"phase": "dygraph_resnet", "config": "ResNet-50 in dygraph "
          "(PaddlePaddle models v1.6 dygraph/resnet/train.py)",
          "device": device_name, "nvidia_smi": card, "dtype": "float32",
          "batch": cfg.batch, "image": cfg.image, "classes": cfg.classes,
          "optimizer": "momentum(0.9) over piecewise_decay from 0.1",
          "steps_timed": DY_TIMED, "ms_per_step": step_s * 1e3,
          "ms_each_step": ms, "images_per_sec": cfg.batch / step_s,
          "train_flops_per_step": flops,
          "f32_cuda_core_share": flops / step_s / f32,
          "peak_memory_gb": peak / 1e9, "first_loss": losses[0],
          "losses": losses, "fixed_batch_losses": fall,
          "fixed_batch_accuracy_first_last": [acc[0], acc[-1]],
          "launches_per_step": prof["launches_per_step"],
          "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
          "device_busy_share": 1 - prof["device_idle_share"],
          "device_idle_share": prof["device_idle_share"],
          "wall_ms_per_step_profiled": prof["wall_ms_per_step"], "ok": ok})
    if not ok:
        raise AssertionError("dygraph ResNet-50: losses finite %s, loss %r -> "
                             "%r, accuracy %r -> %r" % (
                                 bool(np.isfinite(losses).all()), fall[0],
                                 fall[-1], acc[0], acc[-1]))
    return net, dygraph_resnet_feed(cfg, DY_FEED_SEED + DY_WARMUP + DY_TIMED)


def _dy_same_state(a, b):
    import numpy as np

    return list(a) == list(b) and all(
        a[n].dtype == b[n].dtype and np.array_equal(a[n], b[n]) for n in a)


def phase_dygraph_serving(card, net, feed):
    """Phase 49: phase 48's trained ResNet-50.  ``save_dygraph`` ->
    ``load_dygraph`` -> ``set_dict`` into a fresh net restores every
    parameter and BN statistic bit for bit.  ``TracedLayer.trace`` in eval
    mode at B = 32: the traced call against the eager eval forward to
    DEPLOY_TOL (as phase 22 holds the exported predictor), the layer's
    state unchanged by it; ``save_inference_model`` -> ``TracedLayer.load``
    equals the traced call bit for bit; ms a request eager (under
    ``no_grad``), traced and loaded; a call at B = DY_NEW_BATCH records one
    recompile with the monitor enabled.  ``DataParallel`` at one rank
    trains one step of phase 47's narrow net bit for bit as the bare net."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.tools.programs import (
        DYGRAPH_RESNET50, dygraph_resnet, dygraph_resnet_feed,
        dygraph_resnet_optimizer, dygraph_resnet_step)

    dy = fluid.dygraph
    t0 = time.perf_counter()
    rec = {"phase": "dygraph_serving", "nvidia_smi": card,
           "batch": DYGRAPH_RESNET50.batch, "tol": DEPLOY_TOL}
    saved = _deterministic_cudnn()
    try:
        with dy.guard():
            trained = net.state_dict()
            shutil.rmtree(DY_DIR, ignore_errors=True)
            path = DY_DIR + "/resnet50"
            dy.save_dygraph(trained, path)
            loaded, _ = dy.load_dygraph(path)
            fresh = dygraph_resnet(fluid, DYGRAPH_RESNET50)
            fresh.set_dict(loaded)
            rec["checkpoint_bit_for_bit"] = _dy_same_state(fresh.state_dict(),
                                                           trained)
            del fresh
            net.eval()
            img = dy.to_variable(feed[0])
            with dy.no_grad():
                eager = net(img).numpy()
            t1 = time.perf_counter()
            _, traced = dy.TracedLayer.trace(net, [img])
            got = traced(img).numpy()
            rec["trace_and_capture_seconds"] = time.perf_counter() - t1
            rec["traced_rel_err_vs_eager"] = _rel(got, eager)
            rec["layer_state_unchanged"] = _dy_same_state(net.state_dict(),
                                                          trained)
            t1 = time.perf_counter()
            traced.save_inference_model(DY_DIR + "/traced")
            served = dy.TracedLayer.load(DY_DIR + "/traced")
            from_disk = served(feed[0]).numpy()
            rec["save_load_seconds"] = time.perf_counter() - t1
            rec["loaded_bit_for_bit"] = bool(np.array_equal(from_disk, got))

            def eager_call():
                with dy.no_grad():
                    return net(dy.to_variable(feed[0])).numpy()

            rec["ms_per_request"] = {
                "eager": _per_request(eager_call, DY_REQUESTS)[0],
                "traced": _per_request(lambda: traced(feed[0]).numpy(),
                                       DY_REQUESTS)[0],
                "loaded": _per_request(lambda: served(feed[0]).numpy(),
                                       DY_REQUESTS)[0]}
            mon = monitor.enable(_fresh_dir("dygraph_monitor"))
            try:
                before = len(mon.recompiles.events)
                traced(feed[0][:DY_NEW_BATCH])
                traced(feed[0][:DY_NEW_BATCH])
                events = list(mon.recompiles.events)[before:]
            finally:
                monitor.disable()
            rec["new_signature_recompiles"] = len(events)
            rec["recompile_ident"] = events[0]["ident"] if events else None
            net.train()
        cfg = _dy_narrow()
        small = dygraph_resnet_feed(cfg, DY_FEED_SEED)
        with dy.guard(fluid.CPUPlace()):
            start = dygraph_resnet(fluid, cfg).state_dict()
        after = []
        for wrap in (False, True):
            with dy.guard():
                bare = dygraph_resnet(fluid, cfg)
                bare.set_dict(start)
                model = dy.DataParallel(bare) if wrap else bare
                if wrap:
                    dy.prepare_context()
                opt = dygraph_resnet_optimizer(fluid)
                img, lab = map(dy.to_variable, small)
                loss = fluid.dygraph.nn._lowering_apply(
                    "mean", ("X",), {}, "Out", fluid.dygraph.nn._lowering_apply(
                        "cross_entropy", ("X", "Label"), {}, "Y", model(img), lab))
                if wrap:
                    loss = model.scale_loss(loss)
                loss.backward()
                if wrap:
                    model.apply_collective_grads()
                opt.minimize(loss, parameter_list=model.parameters())
                after.append(model.state_dict())
        rec["data_parallel_bit_for_bit"] = _dy_same_state(after[1], after[0])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    rec["seconds"] = time.perf_counter() - t0
    ok = (rec["checkpoint_bit_for_bit"] and rec["layer_state_unchanged"]
          and rec["traced_rel_err_vs_eager"] <= DEPLOY_TOL
          and rec["loaded_bit_for_bit"] and rec["new_signature_recompiles"] == 1
          and "TracedLayer" in (rec["recompile_ident"] or "")
          and rec["data_parallel_bit_for_bit"])
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("dygraph serving: %s" % rec)


# -- item 5-A: data parallelism (phases 50-51) ----------------------------------

DP_STEPS = 3
DP_WORLD = 2                  # phase 51: two gloo ranks sharing the one card
DP_LR_BERT, DP_LR_RN = 1e-4, 1e-2     # the slices' learning rates (4, 7)
DP_TIMEOUT_S = 600
DP_F32_STEPS = 2              # phase 51's f32 ResNet-50 steps at dp = 2
# ... held within this many yardsticks: sound runs on the H100 read 0.90-1.36,
# the control without sync-BN 41-3,161 (PERF.md, section 6)
DP_F32_LIMIT = 4.0
U_BF16 = 2.0 ** -8            # bf16's unit roundoff (8 significant bits)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _same_tensor_bits(a, b):
    """Equal shapes, dtypes and bits (-0.0 is not 0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32, torch.float64: torch.int64}
    if a.dtype in ints:
        a, b = (t.contiguous().view(ints[t.dtype]) for t in (a, b))
    return bool(torch.equal(a, b))


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clone(tree):
    from paddle_tpu_torch._tree import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def _like(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) put back in ``tree``'s shape."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(tree)


def phase_dp_nccl(device_name, card, device=None, bert_kw=None, batch=B, seq=S):
    """Phase 50: the NCCL route at world size 1.  ``fleet.init()`` from a
    one-rank PADDLE_* env joins a world of one over NCCL (the backend the
    card picks); ``build_bert_trainer(bert_base_config(), MeshSpec(dp=1))``
    (bf16, B = 64, S = 512, LAMB) trains DP_STEPS steps, held bit for bit
    (losses, parameters, moments) to the default one-device trainer at the
    same seed and batches, with ms a step both ways and the flash / LN
    launches per step; then every backend function under the collective
    wrappers, called directly on the one-rank NCCL group on a bf16 buffer
    of BERT-base's gradient size (every parameter), each held bit for bit
    to its identity (the sum of one, the concatenation of one, the
    permutation of one) and timed."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch._tree import tree_leaves
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import MeshSpec, optim
    from paddle_tpu_torch.parallel import collectives as col

    endpoint = "127.0.0.1:%d" % _free_port()
    env = {"PADDLE_TRAINER_ID": "0", "PADDLE_TRAINERS_NUM": "1",
           "PADDLE_TRAINER_ENDPOINTS": endpoint,
           "PADDLE_CURRENT_ENDPOINT": endpoint}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    rec = {"phase": "dp_nccl", "nvidia_smi": card}
    try:
        f = fleet.init(device=device)
        dev = f.device
        rec.update(backend=dist.get_backend(), world=dist.get_world_size(),
                   device=str(dev))
        cfg = bert.bert_base_config(**(bert_kw or {}))
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                   for b in bert.synthetic_batches(cfg, DP_STEPS, batch, seq)]

        def run(mesh_spec):
            kw = {} if mesh_spec is None else {"mesh_spec": mesh_spec}
            tr = bert.build_bert_trainer(cfg, optimizer=optim.lamb(), seed=0,
                                         device=dev, **kw)
            _common.reset_launches()
            losses, ms = [], []
            for b in batches:
                _sync(dev)
                t0 = time.perf_counter()
                losses.append(tr.step(b, DP_LR_BERT))
                _sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
            counts = dict(_common.launches)
            state = [t.detach().cpu() for t in tree_leaves(tr.state)]
            rec["backend_elements"] = sum(t.numel() for t in
                                          tree_leaves(tr.state["params"]))
            del tr
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            return [float(l) for l in losses], ms, counts, state

        one_loss, one_ms, one_counts, one_state = run(None)
        dp_loss, dp_ms, dp_counts, dp_state = run(MeshSpec(dp=1))
        rec.update(losses=dp_loss, ms_per_step_mesh=dp_ms,
                   ms_per_step_one_device=one_ms, launches=dp_counts,
                   bit_for_bit=bool(one_loss == dp_loss and all(
                       _same_tensor_bits(a, b) for a, b in zip(one_state, dp_state))))
        n = rec["backend_elements"]
        del one_state, dp_state
        group = dist.group.WORLD
        gen = torch.Generator(device=dev).manual_seed(50)
        buf = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
        calls = {
            "all_reduce_sum": lambda: col.backend_all_reduce(buf, group, "sum"),
            "all_reduce_max": lambda: col.backend_all_reduce(buf, group, "max"),
            "all_reduce_min": lambda: col.backend_all_reduce(buf, group, "min"),
            "all_gather": lambda: col.backend_all_gather(buf, group, 0),
            "reduce_scatter": lambda: col.backend_reduce_scatter(buf, group, 0),
            "permute": lambda: col.backend_permute(buf, group, 1),
            "all_to_all": lambda: col.backend_all_to_all(buf, group, 0, 0),
            "broadcast": lambda: col.backend_broadcast(buf, group, 0)}
        rows = {}
        for name, fn in calls.items():
            got = fn()
            _sync(dev)
            same = _same_tensor_bits(got, buf)
            del got
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            _sync(dev)
            rows[name] = {"bit_for_bit": same,
                          "ms": (time.perf_counter() - t0) / 5 * 1e3}
        rec["backend_calls"] = rows
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    want = {k: PER_STEP.get(k, 0) * DP_STEPS for k in rec["launches"]}
    ok = (rec["backend"] == ("nccl" if torch.device(rec["device"]).type == "cuda"
                            else "gloo")
          and rec["world"] == 1 and rec["bit_for_bit"]
          and all(r["bit_for_bit"] for r in rows.values())
          and (rec["launches"] == want or dev.type != "cuda"))
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("phase 50 (NCCL at world 1): %s" % rec)
    return rec["launches"]


class _DpWatch:
    """Inside the block: every sum the backend layer runs (psum's all-reduce
    and ZeRO's reduce-scatter) recorded as (kind, the local value, the
    reduced one, dim), and every torch.distributed collective timed on the
    host clock between two syncs of the card, with the bytes of its
    input."""

    _TIMED = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
              "broadcast", "all_to_all_single")

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        import torch.distributed as dist

        from paddle_tpu_torch.parallel import collectives as col

        self.taps, self.seconds, self.calls, self._saved = [], 0.0, 0, []
        self.bytes = 0
        ar, rs = col.backend_all_reduce, col.backend_reduce_scatter

        def tap_ar(x, group, op="sum"):
            y = ar(x, group, op)
            if op == "sum":
                self.taps.append(("sum", x.detach().clone(), y.detach(), None))
            return y

        def tap_rs(x, group, dim=0):
            y = rs(x, group, dim)
            self.taps.append(("scatter", x.detach().clone(), y.detach(), dim))
            return y

        def timed(fn):
            # the input: the second argument of the (output, input) forms
            src = 1 if fn.__name__.endswith(("_tensor", "_single")) else 0

            def call(*a, **k):
                _sync(self.device)
                t0 = time.perf_counter()
                out = fn(*a, **k)
                _sync(self.device)
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                self.bytes += a[src].numel() * a[src].element_size()
                return out
            return call

        patches = [(col, "backend_all_reduce", tap_ar),
                   (col, "backend_reduce_scatter", tap_rs)]
        patches += [(dist, n, timed(getattr(dist, n))) for n in self._TIMED]
        for mod, name, fn in patches:
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def _check_taps(taps, rank, world):
    """Each reduced value against the sum of the ranks' local values on the
    card (gathered from every rank), bit for bit: (values checked, bad)."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import collectives as col

    group, bad = dist.group.WORLD, 0
    for kind, local, reduced, dim in taps:
        both = col.backend_all_gather(local.unsqueeze(0), group, 0)
        want = both[0]
        for r in range(1, world):
            want = want + both[r]
        if kind == "scatter":
            want = want.chunk(world, dim)[rank]
        bad += not _same_tensor_bits(reduced, want)
    return {"reduced_values": len(taps), "differ": bad}


def _replicas_differ(trees, world):
    """Leaves of ``trees`` whose bits differ between the ranks."""
    import torch.distributed as dist

    from paddle_tpu_torch._tree import tree_leaves
    from paddle_tpu_torch.parallel import collectives as col

    bad = 0
    for t in (leaf for tree in trees for leaf in tree_leaves(tree)):
        both = col.backend_all_gather(t.reshape(1, -1), dist.group.WORLD, 0)
        bad += not all(_same_tensor_bits(both[0], both[r]) for r in range(1, world))
    return bad


def _dp_backend_check(rank, world, device):
    """Every backend function on the gloo group over the card's tensors
    (f32 and bf16), each against the value it must give, computed from the
    ranks' gathered inputs: gloo takes CUDA tensors, nothing stages."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import collectives as col

    group, out = dist.group.WORLD, {}
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.arange(world * 4 * 3, dtype=torch.float32, device=device)
             .reshape(world * 4, 3) * (rank + 1) / 7).to(dt)
        allx = col.backend_all_gather(x.unsqueeze(0), group, 0)
        total = allx[0]
        for r in range(1, world):
            total = total + allx[r]
        checks = {
            "all_reduce_sum": (col.backend_all_reduce(x, group, "sum"), total),
            "all_reduce_max": (col.backend_all_reduce(x, group, "max"),
                               allx.amax(0)),
            "all_reduce_min": (col.backend_all_reduce(x, group, "min"),
                               allx.amin(0)),
            "all_gather": (col.backend_all_gather(x, group, 1),
                           torch.cat(list(allx), 1)),
            "reduce_scatter": (col.backend_reduce_scatter(x, group, 0),
                               total.chunk(world, 0)[rank]),
            "permute": (col.backend_permute(x, group, 1),
                        allx[(rank - 1) % world]),
            "all_to_all": (col.backend_all_to_all(x, group, 0, 1),
                           torch.cat([a.chunk(world, 0)[rank] for a in allx], 1)),
            "broadcast": (col.backend_broadcast(x, group, 1), allx[1])}
        for name, (got, want) in checks.items():
            out["%s %s" % (name, str(dt)[6:])] = bool(
                got.device == x.device and _same_tensor_bits(got, want))
    return out


def _split_sum_bound(terms, count, l_one, l_dp):
    """The bound ``tools/fp_bounds.py`` derives for a mean of the same n
    f32 ``terms`` that the one-rank step adds in one order and the dp = 2
    step as two sums of n/2 added together: gamma(n - 1) sum |t| for the
    first, gamma(n/2) sum |t| for the second (its halves and their sum),
    over the count, and one division's rounding each."""
    from paddle_tpu_torch.tools import fp_bounds

    t = terms.double().flatten()
    n = t.numel()
    abs_sum = float(t.abs().sum())
    bound = ((float(fp_bounds.gamma(n - 1)) + float(fp_bounds.gamma(n // 2)))
             * abs_sum / count + 2 * fp_bounds.U32 * (abs(l_one) + abs(l_dp)))
    return {"terms": n, "loss_one_order": l_one, "loss_dp": l_dp,
            "err": abs(l_one - l_dp), "bound": bound,
            "err_over_bound": abs(l_one - l_dp) / bound}


def _terms_gap(t_x, t_one):
    """Relative L2 distance of two runs' per-example loss terms."""
    t_x, t_one = t_x.double().flatten(), t_one.double().flatten()
    return float((t_x - t_one).norm() / t_one.norm())


def _grad_gap(g_dp, g_one, world, names):
    """The reduced dp gradient over the world size (an exact scaling)
    against the one-rank gradient of the global batch, by leaf: the largest
    relative L2 distance (and its leaf), the median one, and the median
    ratio of the norms before the scaling (the dp gradient scale, ROADMAP
    Queue 3).  Reported in bf16; phase 51 holds it in f32
    (``_dp_resnet_f32``)."""
    gaps, ratios = [], []
    for name, a, b in zip(names, g_dp, g_one):
        a, b = a.double(), b.double()
        nb = float(b.norm())
        if nb > 0:
            gaps.append((float((a / world - b).norm()) / nb, name))
            ratios.append(float(a.norm()) / nb)
    gaps.sort()
    return {"grad_rel_l2_max": gaps[-1][0], "grad_rel_l2_max_leaf": gaps[-1][1],
            "grad_rel_l2_median": gaps[len(gaps) // 2][0],
            "grad_norm_ratio_median": sorted(ratios)[len(ratios) // 2]}


def _untapped_steps(tr, batches, lr, device):
    """One more step a batch with no watch (no card syncs around the
    collectives, no copies of their inputs): each one's ms, loss and kernel
    launches."""
    from paddle_tpu_torch.kernels import _common

    out = []
    for b in batches:
        _common.reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        loss = tr.step(b, lr)
        _sync(device)
        out.append({"ms": (time.perf_counter() - t0) * 1e3,
                    "loss": float(loss), "launches": dict(_common.launches)})
    return out


def _resnet_terms(params, bn, batch, mesh, cfg):
    """The per-image NLL terms of the ResNet loss, forward only."""
    import torch.nn.functional as F

    from paddle_tpu_torch.models import resnet

    with torch.no_grad(), mesh:
        logits, _ = resnet.resnet_forward(params, bn, batch["image"], cfg,
                                          train=True)
        logp = F.log_softmax(logits, dim=-1)
        return -logp.gather(1, batch["label"].long()[:, None])[:, 0]


def _dp_resnet(rank, world, device, args):
    """ResNet-50 at dp = world, sync-BN through the fused kernels."""
    import torch.distributed as dist

    from paddle_tpu_torch._tree import tree_leaves
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.parallel import MeshSpec, optim
    from paddle_tpu_torch.parallel import collectives as col
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel.rules import P, leaf_paths
    from paddle_tpu_torch.parallel.train import grads_of, shard_batch

    cfg = resnet.resnet50_config(dtype="bfloat16", fuse_bn=True, sync_bn=True,
                                 image_size=args["image"], **args["rn_kw"])
    init, update = optim.momentum(0.9)
    seen = []

    def recording(grads, state, params, lr):     # the reduced gradients
        if seen is not None:
            seen.append(_clone(grads))
        return update(grads, state, params, lr)

    tr = resnet.build_resnet_trainer(cfg, MeshSpec(dp=world),
                                     optimizer=(init, recording), seed=0,
                                     device=device)
    batches = [{"image": torch.from_numpy(b["image"]).to(device, torch.bfloat16),
                "label": torch.from_numpy(b["label"]).to(device)}
               for b in resnet.synthetic_batches(cfg, DP_STEPS,
                                                 args["rn_batch"])]
    steps, peak = [], 0
    for i, b in enumerate(batches):
        p0, v0 = _clone(tr.state["params"]), _clone(tr.state["opt"]["velocity"])
        bn0 = _clone(tr.bn_state)
        seen.clear()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _common.reset_launches()
        with _DpWatch(device) as w:
            _sync(device)
            t0 = time.perf_counter()
            loss = tr.step(b, DP_LR_RN)
            _sync(device)
            dt = time.perf_counter() - t0
        rec = {"step": i, "loss": float(loss), "ms": dt * 1e3,
               "collective_ms": w.seconds * 1e3,
               "collective_calls": w.calls, "launches": dict(_common.launches)}
        if device.type == "cuda":
            peak = max(peak, torch.cuda.max_memory_allocated())
        rec["taps"] = _check_taps(w.taps, rank, world)
        del w
        rec["replicas_differ"] = _replicas_differ(
            [tr.state["params"], tr.state["opt"]["velocity"], tr.bn_state], world)
        local = shard_batch(tr.mesh, {"image": P("dp"), "label": P("dp")}, b)
        t_dp = col.backend_all_gather(_resnet_terms(p0, bn0, local, tr.mesh, cfg),
                                      dist.group.WORLD, 0)
        if rank == 0:
            # the loss: the mean of the dp forward's own terms (their
            # distance from the one-rank terms is held in f32, in
            # _dp_resnet_f32); the bf16 distance reported
            rec["loss_bound"] = _split_sum_bound(
                t_dp, t_dp.numel(), float(t_dp.sum() / t_dp.numel()),
                float(loss))
            rec["terms_rel_l2"] = _terms_gap(
                t_dp, _resnet_terms(p0, bn0, b, make_mesh(device=device), cfg))
            # the update: the one-rank momentum step on the reduced gradient
            pr, st = _clone(p0), {"velocity": _clone(v0)}
            update(seen[0], st, pr, DP_LR_RN)
            rec["update_bit_for_bit"] = all(
                _same_tensor_bits(a, c) for a, c in zip(
                    tree_leaves(pr) + tree_leaves(st["velocity"]),
                    tree_leaves(tr.state["params"])
                    + tree_leaves(tr.state["opt"]["velocity"])))
            loss_fn = resnet.make_loss_fn(cfg)
            _, g1 = grads_of(lambda p, bb: loss_fn({"params": p, "_bn": bn0}, bb),
                             _clone(p0), b)
            rec.update(_grad_gap(tree_leaves(seen[0]), tree_leaves(g1), world,
                                 leaf_paths(g1)[0]))
            del g1, pr, st
        del p0, v0, bn0
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        steps.append(rec)
    seen = None
    untapped = _untapped_steps(tr, batches, DP_LR_RN, device)
    del tr
    return {"steps": steps, "peak_memory_allocated": peak, "untapped": untapped}


def _dp_resnet_f32(rank, world, device, args):
    """ResNet-50 in f32 (``fuse_bn``, the bf16 run's images and global
    batch), DP_F32_STEPS steps at dp = world with sync-BN, and the same
    steps of a control with each rank's own BN statistics (sync_bn off).
    Rank 0 takes, from each step's starting state, the one-rank loss terms
    and gradient of the global batch, and the yardstick: the same of the
    batch with its rows permuted, which reassociates the batch sums (the BN
    statistics, their backward sums and the gradients' batch reductions)
    and changes nothing else.  Returns, per step and run, the distances of
    the terms and of the reduced gradient over the world size from the
    one-rank step's (``_terms_gap``, ``_grad_gap``) and the permutation's."""
    import torch.distributed as dist

    from paddle_tpu_torch._tree import tree_leaves
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.parallel import MeshSpec, optim
    from paddle_tpu_torch.parallel import collectives as col
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel.rules import P, leaf_paths
    from paddle_tpu_torch.parallel.train import grads_of, shard_batch

    host = resnet.synthetic_batches(
        resnet.resnet50_config(image_size=args["image"], **args["rn_kw"]),
        DP_F32_STEPS, args["rn_batch"])
    batches = [{"image": torch.from_numpy(b["image"]).to(device),
                "label": torch.from_numpy(b["label"]).to(device)}
               for b in host]
    perm = torch.randperm(args["rn_batch"],
                          generator=torch.Generator().manual_seed(1)).to(device)
    one = make_mesh(device=device)
    out = {}
    for run, sync in (("sync_bn", True), ("control_local_bn", False)):
        cfg = resnet.resnet50_config(dtype="float32", fuse_bn=True,
                                     sync_bn=sync, image_size=args["image"],
                                     **args["rn_kw"])
        init, update = optim.momentum(0.9)
        seen = []

        def recording(grads, state, params, lr, seen=seen, update=update):
            seen.append(_clone(grads))
            return update(grads, state, params, lr)

        tr = resnet.build_resnet_trainer(cfg, MeshSpec(dp=world),
                                         optimizer=(init, recording), seed=0,
                                         device=device)
        loss_fn = resnet.make_loss_fn(cfg)
        recs = []
        for i, b in enumerate(batches):
            p0, bn0 = _clone(tr.state["params"]), _clone(tr.bn_state)
            seen.clear()
            loss = float(tr.step(b, DP_LR_RN))
            local = shard_batch(tr.mesh, {"image": P("dp"), "label": P("dp")}, b)
            t_dp = col.backend_all_gather(
                _resnet_terms(p0, bn0, local, tr.mesh, cfg), dist.group.WORLD, 0)
            rec = {"step": i, "loss": loss}
            if rank == 0:
                names = leaf_paths(p0)[0]

                def one_rank(bb):
                    _, g = grads_of(
                        lambda p, x: loss_fn({"params": p, "_bn": bn0}, x),
                        _clone(p0), bb)
                    return _resnet_terms(p0, bn0, bb, one, cfg), tree_leaves(g)

                t1, g1 = one_rank(b)
                rec["loss_bound"] = _split_sum_bound(
                    t_dp, t_dp.numel(), float(t_dp.sum() / t_dp.numel()), loss)
                rec["terms_rel_l2"] = _terms_gap(t_dp, t1)
                rec["grad"] = _grad_gap(tree_leaves(seen[0]), g1, world, names)
                if sync:
                    tp, gp = one_rank({k: v[perm] for k, v in b.items()})
                    rec["yardstick_terms_rel_l2"] = _terms_gap(
                        tp[torch.argsort(perm)], t1)
                    rec["yardstick_grad"] = _grad_gap(gp, g1, 1, names)
                    del tp, gp
                del t1, g1
            del p0, bn0
            if device.type == "cuda":
                torch.cuda.empty_cache()
            dist.barrier()
            recs.append(rec)
        out[run] = recs
        del tr
    return out


def _f32_verdict(f32):
    """Phase 51's f32 hold: at every step, the sync-BN run's terms and
    reduced gradient (by leaf, median and largest) within DP_F32_LIMIT
    times the permutation's distance, and the control past that limit in
    its terms and its gradient median.  Returns the problems found."""
    bad = []
    for st, ctl in zip(f32["sync_bn"], f32["control_local_bn"]):
        g, y = st["grad"], st["yardstick_grad"]
        pairs = {"terms": (st["terms_rel_l2"], st["yardstick_terms_rel_l2"]),
                 "grad median": (g["grad_rel_l2_median"],
                                 y["grad_rel_l2_median"]),
                 "grad largest": (g["grad_rel_l2_max"], y["grad_rel_l2_max"])}
        for what, (got, yard) in pairs.items():
            if not got <= DP_F32_LIMIT * yard:
                bad.append("f32 step %d %s %s over %s x %s"
                           % (st["step"], what, got, DP_F32_LIMIT, yard))
        ctl_pairs = {"terms": (ctl["terms_rel_l2"], pairs["terms"][1]),
                     "grad median": (ctl["grad"]["grad_rel_l2_median"],
                                     pairs["grad median"][1])}
        for what, (got, yard) in ctl_pairs.items():
            if not got > DP_F32_LIMIT * yard:
                bad.append("f32 step %d: the control's (no sync-BN) %s %s is "
                           "within %s x %s" % (st["step"], what, got,
                                               DP_F32_LIMIT, yard))
        for r in (st, ctl):
            if r["loss_bound"]["err_over_bound"] > 1 or not math.isfinite(
                    r["loss"]):
                bad.append("f32 step %d loss %s" % (st["step"], r["loss_bound"]))
    return bad


def _bert_terms(params, batch, cfg):
    """The per-token terms of the MLM loss (nll * mask), forward only."""
    from paddle_tpu_torch.parallel import transformer as T

    with torch.no_grad():
        x = T.embed(params, batch["ids"], cfg)
        x = T.run_layers(params["params_layers"], x, cfg)
        x = T.layer_norm(x, params["lnf_scale"], params["lnf_bias"], fused=False)
        nll = T._ChunkedVocabNLL.apply(x, params["tok_emb"], batch["labels"], 4)
        return (nll * batch["mask"].float()).flatten()


def _lamb_replay_bound(p0, p_ref, p_dp, m_ref, v_ref, step, lr):
    """Per leaf, the largest |p_dp - p_ref| over the bound derived for
    LAMB's update when its two trust-ratio norms are sums of squares
    reassociated (ZeRO's psum of two halves against one sum over the
    leaf): each norm within gamma(n - 1) / 2 + u, the ratio within
    delta = 2 (gamma(n - 1) + 3u), the f32 update lr * trust * r within
    delta + 4u of |u|, then its bf16 cast and the bf16 subtraction, half
    a bf16 ulp each of |u| (twice) and of the two results."""
    from paddle_tpu_torch.tools import fp_bounds

    b1, b2, eps, wd = 0.9, 0.999, 1e-6, 0.01       # optim.lamb's defaults
    worst = 0.0
    for p, pr, pd, m, v in zip(p0, p_ref, p_dp, m_ref, v_ref):
        n = p.numel()
        b1t, b2t = b1 ** float(step), b2 ** float(step)
        r = (m.double() / (1 - b1t)) / ((v.double() / (1 - b2t)).sqrt() + eps) \
            + wd * p.double()
        w_norm, r_norm = float(p.double().norm()), float(r.norm())
        trust = w_norm / r_norm if w_norm > 0 and r_norm > 0 else 1.0
        u = (lr * trust * r).abs()
        delta = 2 * (float(fp_bounds.gamma(n - 1)) + 3 * fp_bounds.U32)
        bound = (u * (delta + 4 * fp_bounds.U32) + U_BF16 * 2 * u * (1 + delta)
                 + U_BF16 * (pr.double().abs() + pd.double().abs()) + 1e-30)
        worst = max(worst, float(((pd.double() - pr.double()).abs() / bound).max()))
    return worst


def _dp_bert(rank, world, device, args):
    """BERT-base at dp = world with ZeRO (LAMB moments sharded over dp)."""
    import torch.distributed as dist

    from paddle_tpu_torch._tree import tree_leaves
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import MeshSpec, optim
    from paddle_tpu_torch.parallel import collectives as col
    from paddle_tpu_torch.parallel.rules import leaf_paths
    from paddle_tpu_torch.parallel.train import grads_of, shard_batch

    cfg = bert.bert_base_config(**args["bert_kw"])
    init, update = optim.lamb()
    seen = []

    def recording(grads, state, params, lr):     # the reduced shards
        if seen is not None:
            seen.append([g.detach().clone() for g in tree_leaves(grads)])
        return update(grads, state, params, lr)

    tr = bert.build_bert_trainer(cfg, MeshSpec(dp=world, zero=True),
                                 optimizer=(init, recording), seed=0,
                                 device=device)
    group = dist.group.WORLD
    params = tr.state["params"]
    sharded = [m.shape != p.shape for m, p in zip(
        tree_leaves(tr.state["opt"]["m"]), tree_leaves(params))]
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in bert.synthetic_batches(cfg, DP_STEPS, args["bert_batch"],
                                               args["seq"])]

    def gathered(key):
        return [col.backend_all_gather(t, group, 0) if s else t.detach().clone()
                for t, s in zip(tree_leaves(tr.state["opt"][key]), sharded)]

    steps, peak = [], 0
    for i, b in enumerate(batches):
        p0 = [t.detach().clone() for t in tree_leaves(params)]
        m0, v0 = gathered("m"), gathered("v")
        step0 = int(tr.state["opt"]["step"])
        seen.clear()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _common.reset_launches()
        with _DpWatch(device) as w:
            _sync(device)
            t0 = time.perf_counter()
            loss = tr.step(b, DP_LR_BERT)
            _sync(device)
            dt = time.perf_counter() - t0
        rec = {"step": i, "loss": float(loss), "ms": dt * 1e3,
               "collective_ms": w.seconds * 1e3,
               "collective_calls": w.calls, "launches": dict(_common.launches),
               "sharded_leaves": sum(sharded), "leaves": len(sharded)}
        if device.type == "cuda":
            peak = max(peak, torch.cuda.max_memory_allocated())
        rec["taps"] = _check_taps(w.taps, rank, world)
        del w
        m1, v1 = gathered("m"), gathered("v")
        rec["replicas_differ"] = _replicas_differ([params, m1, v1], world)
        # ZeRO's update runs on the sharded leaves' reduced shards, then on
        # the replicated leaves' reduced gradients
        calls = iter(seen)
        sh = iter(next(calls) if any(sharded) else [])
        rep = iter(next(calls) if not all(sharded) else [])
        g_full = [col.backend_all_gather(next(sh), group, 0) if s else next(rep)
                  for s in sharded]
        p0_tree = _like(params, p0)
        t_dp = col.backend_all_gather(_bert_terms(
            p0_tree, shard_batch(tr.mesh, bert.batch_specs(), b), cfg), group, 0)
        if rank == 0:
            t1 = _bert_terms(p0_tree, b, cfg)
            count = float(b["mask"].float().sum())
            l1 = float(t1.sum() / max(count, 1.0))
            # per-sequence terms: the dp forward's are the one-rank's bits
            rec["terms_bit_for_bit"] = _same_tensor_bits(t1, t_dp)
            rec["loss_bound"] = _split_sum_bound(t1, count, l1, float(loss))
            # the update: the replicated LAMB step on the reduced gradient
            pr = [t.clone() for t in p0]
            st = {"m": [t.clone() for t in m0], "v": [t.clone() for t in v0],
                  "step": torch.tensor(step0, dtype=torch.int32, device=device)}
            update(g_full, st, pr, DP_LR_BERT)
            rec["moments_bit_for_bit"] = all(
                _same_tensor_bits(a, c) for a, c in zip(st["m"] + st["v"], m1 + v1))
            rec["params_err_over_bound"] = _lamb_replay_bound(
                p0, pr, tree_leaves(params), st["m"], st["v"], step0 + 1,
                DP_LR_BERT)
            _, g1 = grads_of(bert.make_loss_fn(cfg), _clone(p0_tree), b)
            rec.update(_grad_gap(g_full, tree_leaves(g1), world,
                                 leaf_paths(g1)[0]))
            del g1, pr, st
        del p0, p0_tree, m0, v0, m1, v1, g_full
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        steps.append(rec)
    seen = None
    untapped = _untapped_steps(tr, batches, DP_LR_BERT, device)
    del tr
    return {"steps": steps, "peak_memory_allocated": peak, "untapped": untapped}


def _dp_rank(rank, world, endpoint, results, args):
    """One rank of phase 51, in a spawned process: ``fleet.init()`` from
    the PADDLE_* env a launcher gives a worker, with
    ``PADDLE_DISTRI_BACKEND=gloo`` (both ranks on card 0), then the backend
    check, ResNet-50 and BERT-base; its records go on ``results``.  An
    exception fails the process, whose exit code the parent reads."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TRAINER_ENDPOINTS": endpoint,
        "PADDLE_CURRENT_ENDPOINT": endpoint, "PADDLE_DISTRI_BACKEND": "gloo",
        "FLAGS_selected_gpus": "0"})
    device = fleet.init(
        device=None if args["device"] == "cuda" else args["device"]).device
    try:
        res = {"rank": rank, "backend": dist.get_backend(),
               "backend_cuda": _dp_backend_check(rank, world, device),
               "resnet": _dp_resnet(rank, world, device, args)}
        if device.type == "cuda":
            torch.cuda.empty_cache()
        res["bert"] = _dp_bert(rank, world, device, args)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        res["resnet_f32"] = _dp_resnet_f32(rank, world, device, args)
        results.put(res)
    finally:
        dist.destroy_process_group()


def phase_dp_two_ranks(device_name, card, device="cuda", rn_kw=None,
                       bert_kw=None, rn_batch=B_RN, bert_batch=B, seq=S,
                       image=IMAGE):
    """Phase 51: two ranks on the one card, gloo over CUDA tensors (NCCL
    refuses two ranks on one device), each a spawned process that joins
    through ``fleet.init()`` (a launcher's PADDLE_* env with
    ``PADDLE_DISTRI_BACKEND=gloo``).  Every
    backend function on the card's tensors; then ResNet-50 (224, bf16,
    fuse_bn, sync_bn, momentum, global B = 128) and BERT-base (S = 512,
    bf16, LAMB with zero=True, global B = 64), DP_STEPS steps each.  After
    every step: both ranks' parameters, BN state, velocities and gathered
    moments bit for bit alike; every reduced statistic and gradient (each
    psum and reduce-scatter the backend ran) equal to the card's sum of the
    ranks' local values, bit for bit; the step's loss within the derived
    bound of the one-rank step's on the same global batch from the same
    state (``_split_sum_bound``; ResNet's of its own terms, BERT's of the
    one-rank terms, which its dp terms equal bit for bit); the update
    against the one-rank optimizer on the reduced gradient (momentum bit
    for bit; LAMB's moments bit for bit and its parameters within
    ``_lamb_replay_bound``); the bf16 reduced gradient over 2 against the
    one-rank gradient, reported.  Each rank's ms a step, collective ms,
    peak memory and kernel launches a step (53 of each BN kernel for
    ResNet; 24 / 24 / 12 / 12 LN and flash for BERT), all under the
    watch's syncs and copies; then 3 more steps of each, untapped and
    timed.  Last, ResNet-50 in f32 (``_dp_resnet_f32``), held by
    ``_f32_verdict``.
    Returns the launches a rank a step, by model."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    endpoint = "127.0.0.1:%d" % _free_port()
    args = {"device": device, "rn_kw": rn_kw or {}, "bert_kw": bert_kw or {},
            "rn_batch": rn_batch, "bert_batch": bert_batch, "seq": seq,
            "image": image}
    procs = [ctx.Process(target=_dp_rank, args=(r, DP_WORLD, endpoint, results,
                                                args))
             for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + DP_TIMEOUT_S
        while len(got) < DP_WORLD:
            try:
                res = results.get(timeout=5)
                got[res["rank"]] = res
            except queue.Empty:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    raise AssertionError("phase 51: a rank failed, exit codes "
                                         "%s" % codes)
                if time.monotonic() > deadline:
                    raise AssertionError("phase 51: no result in %d s"
                                         % DP_TIMEOUT_S)
        for p in procs:
            p.join(120)
        codes = [p.exitcode for p in procs]
        if codes != [0] * DP_WORLD:
            raise AssertionError("phase 51: exit codes %s" % codes)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    on_card = torch.device(device).type == "cuda"
    want = {"resnet": RN_PER_STEP, "bert": PER_STEP}
    ok, bad = True, []
    for rank in range(DP_WORLD):
        res = got[rank]
        if res["backend"] != "gloo" or not all(res["backend_cuda"].values()):
            bad.append("rank %d backend %s" % (rank, res["backend_cuda"]))
        for model in ("resnet", "bert"):
            for st in res[model]["steps"]:
                where = "rank %d %s step %d" % (rank, model, st["step"])
                if st["taps"]["differ"] or st["replicas_differ"]:
                    bad.append("%s: taps %s, replicas %s"
                               % (where, st["taps"], st["replicas_differ"]))
                if on_card and st["launches"] != {
                        k: want[model].get(k, 0) for k in st["launches"]}:
                    bad.append("%s launches %s" % (where, st["launches"]))
                if not math.isfinite(st["loss"]):
                    bad.append("%s loss %s" % (where, st["loss"]))
                if rank == 0:
                    if st["loss_bound"]["err_over_bound"] > 1 or not st.get(
                            "terms_bit_for_bit", True):
                        bad.append("%s loss %s, terms bit for bit %s" % (
                            where, st["loss_bound"],
                            st.get("terms_bit_for_bit")))
                    if not st.get("update_bit_for_bit",
                                  st.get("moments_bit_for_bit")):
                        bad.append("%s update replay" % where)
                    if st.get("params_err_over_bound", 0) > 1:
                        bad.append("%s LAMB params %s"
                                   % (where, st["params_err_over_bound"]))
            for un in res[model]["untapped"]:
                if (on_card and un["launches"] != {
                        k: want[model].get(k, 0) for k in un["launches"]}) \
                        or not math.isfinite(un["loss"]):
                    bad.append("rank %d %s untapped step %s" % (rank, model, un))
            emit({"phase": "dp_two_ranks", "model": model, "rank": rank,
                  "world": DP_WORLD, "backend": res["backend"],
                  "peak_memory_allocated": res[model]["peak_memory_allocated"],
                  "steps": res[model]["steps"],
                  "untapped_steps": res[model]["untapped"]})
        if rank == 0:
            bad += _f32_verdict(res["resnet_f32"])
            emit({"phase": "dp_two_ranks", "model": "resnet_f32",
                  "limit_in_yardsticks": DP_F32_LIMIT,
                  "runs": res["resnet_f32"]})
            emit({"phase": "dp_two_ranks", "backend_calls_on_cuda_tensors":
                  res["backend_cuda"]})
    ok = not bad
    emit({"phase": "dp_two_ranks", "nvidia_smi": card, "ok": ok, "seconds":
          time.perf_counter() - t0, "problems": bad[:20]})
    if not ok:
        raise AssertionError("phase 51: %s" % bad[:20])
    return {m: got[0][m]["steps"][-1]["launches"] for m in ("resnet", "bert")}


# -- item 5-B: program-mode data parallelism (phase 52) -------------------------

PDP_STEPS = 3                 # the encoder: a checked, a watched, an untapped step
PDP_FEED_SEED = 700
PDP_RN_BATCH = 64             # ResNet-CIFAR's global batch: 32 a rank
PDP_RN_STEPS = 2              # checked steps (then one untapped)
PDP_GEO_K, PDP_GEO_STEPS = 2, 4
PDP_GRAD_LIMIT = DP_F32_LIMIT  # yardsticks, as phase 51's f32 hold
PDP_TIMEOUT_S = 600


def _pdp_place(device):
    import paddle_tpu_torch as fluid

    return (fluid.CUDAPlace(0) if torch.device(device).type == "cuda"
            else fluid.CPUPlace())


def phase_program_dp_nccl(device_name, card, device=None, cfg=None):
    """Phase 52, first part: the Fluid-layers BERT-base encoder (phase 41's
    program: 12 x 768, S = 512, f32, Adam, B = 16, dropout 0.1) under
    ``fleet.distributed_optimizer`` in a one-rank NCCL world (``fleet.init()``
    from a one-rank PADDLE_* env), PDP_STEPS steps from the state and on the
    batches the untagged program runs: the losses and every persistable bit
    for bit the untagged program's."""
    import os

    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.tools.programs import (BERT_BASE_ENCODER,
                                                 bert_encoder_program,
                                                 encoder_feed)

    cfg = cfg or BERT_BASE_ENCODER
    endpoint = "127.0.0.1:%d" % _free_port()
    env = {"PADDLE_TRAINER_ID": "0", "PADDLE_TRAINERS_NUM": "1",
           "PADDLE_TRAINER_ENDPOINTS": endpoint,
           "PADDLE_CURRENT_ENDPOINT": endpoint}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    rec = {"phase": "program_dp_nccl", "nvidia_smi": card, "batch": cfg.batch,
           "seq": cfg.seq, "layers": cfg.layers, "hidden": cfg.hidden}
    t0 = time.perf_counter()
    try:
        dev = fleet.init(device=device).device
        rec.update(backend=dist.get_backend(), world=dist.get_world_size())
        place = _pdp_place(dev)
        feeds = [encoder_feed(cfg, PDP_FEED_SEED + k) for k in range(PDP_STEPS)]
        init, runs = None, {}
        for tagged in (False, True):
            main, startup, v = bert_encoder_program(
                fluid, cfg, wrap_optimizer=fleet.distributed_optimizer
                if tagged else None)
            exe, scope = fluid.Executor(place), fluid.Scope()
            exe.run(startup, scope=scope)
            names = sorted(x.name for x in startup.list_vars() if x.persistable)
            if init is None:
                init = {n: scope.find_var(n).clone() for n in names}
            else:
                for n in names:
                    scope.set(n, init[n].clone())
            losses, ms = [], []
            for f in feeds:
                _sync(dev)
                t1 = time.perf_counter()
                (lv,) = exe.run(main, feed=f, fetch_list=[v["loss"]],
                                scope=scope)
                _sync(dev)
                ms.append((time.perf_counter() - t1) * 1e3)
                losses.append(float(lv))
            runs[tagged] = (losses, ms, {n: scope.find_var(n) for n in names})
            del exe, scope
        del init
        (l0, ms0, s0), (l1, ms1, s1) = runs[False], runs[True]
        rec.update(losses=l1, ms_each_step_fleet=ms1, ms_each_step_plain=ms0,
                   fleet_tagged=True,
                   bit_for_bit=bool(l0 == l1 and all(
                       _same_tensor_bits(s0[n], s1[n]) for n in s0)))
        del runs, s0, s1
        if dev.type == "cuda":
            torch.cuda.empty_cache()     # the ranks of the second part share the card
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    rec["seconds"] = time.perf_counter() - t0
    rec["ok"] = bool(rec["bit_for_bit"] and rec["world"] == 1 and
                     all(math.isfinite(x) for x in rec["losses"]))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("phase 52 (one-rank NCCL world): %s" % rec)


def _pdp_replicas_differ(scope, names):
    """The names whose value differs from rank 0's (a broadcast each), the
    same list on every rank."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import collectives as col

    bad = []
    for n in names:
        t = scope.find_var(n)
        if not isinstance(t, torch.Tensor):
            continue
        ref = col.backend_broadcast(t, dist.group.WORLD, 0)
        if not _same_tensor_bits(t.contiguous(), ref):
            bad.append(n)
    flag = torch.tensor([len(bad)], device=scope.find_var(names[0]).device)
    dist.all_reduce(flag)
    return bad if int(flag) == len(bad) else bad + ["(another rank's)"]


def _pdp_state(scope, names):
    return {n: scope.find_var(n).clone() for n in names}


def _pdp_one_rank(place, main, state, step, feed, fetch):
    """The untagged ``main`` on one rank from ``state`` (copied), its
    executor at the data-parallel run's step (so its random ops draw the
    same numbers): the fetches, on the device."""
    import paddle_tpu_torch as fluid

    exe, scope = fluid.Executor(place), fluid.Scope()
    for n, t in state.items():
        scope.var(n)
        scope.set(n, t.clone())
    exe._step = step
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   return_numpy=False)


def _pdp_loss_bound(t_dp, t_one, l_dp, l_one, world):
    """|l_dp - l_one| against the bound the arithmetic gives: each loss is
    an f32 mean of its own terms (the data-parallel one a sum of each
    rank's n/world, then of the ranks; one rank's in one order), each within
    gamma(k) of the terms' absolute sum over n and a rounding of its
    division; the two runs' exact means differ by what float64 measures."""
    from paddle_tpu_torch.tools import fp_bounds

    a, b = t_dp.double().flatten(), t_one.double().flatten()
    n = a.numel()
    g = fp_bounds.gamma
    bound = (g(n // world + world) * float(a.abs().sum()) / n
             + g(n) * float(b.abs().sum()) / n
             + 2 * fp_bounds.U32 * (abs(l_dp) + abs(l_one))
             + abs(float(a.mean()) - float(b.mean()))
             + 2 * n * 2.0 ** -53 * float(a.abs().mean() + b.abs().mean()))
    err = abs(l_dp - l_one)
    return {"terms": n, "loss_dp": l_dp, "loss_one_rank": l_one, "err": err,
            "bound": bound, "err_over_bound": err / bound,
            "terms_bit_for_bit": _same_tensor_bits(t_dp, t_one)}


def _pdp_encoder(rank, world, device, args):
    """BERT-base encoder under fleet, AllReduce: a checked step (rank 0
    holds the gathered dropout masks and loss terms to the one-rank run's
    from the same state), a watched one (collectives), an untapped one;
    replicas; the gradient at dropout 0 against the one-rank gradient in
    yardsticks (the larger of a row permutation's distance and that of the
    one-rank program run on the ranks' row blocks in turn), with a rank's
    own rows and n times the gradient as controls;
    then kReduce from the same state: losses and parameters bit for bit,
    Adam's moments half their bytes a rank."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.tools.programs import (bert_encoder_program,
                                                 encoder_feed)

    cfg = args["enc_cfg"]
    place = _pdp_place(device)
    feeds = [encoder_feed(cfg, PDP_FEED_SEED + k) for k in range(PDP_STEPS)]
    on_card = torch.device(device).type == "cuda"

    def build(c, strategy=None, tagged=True):
        wrap = ((lambda opt: fleet.distributed_optimizer(opt, strategy))
                if tagged else None)
        return bert_encoder_program(fluid, c, wrap_optimizer=wrap)

    out = {}
    main, startup, v = build(cfg)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    names = sorted(x.name for x in startup.list_vars() if x.persistable)
    params = [p.name for p in main.global_block().all_parameters()]
    init = _pdp_state(scope, names)
    ops = main.global_block().ops
    masks = [op.outputs["Mask"][0] for op in ops if op.type == "dropout"]
    terms = next(op.outputs["Loss"][0] for op in ops
                 if op.type == "softmax_with_cross_entropy")
    losses, steps = [], []
    for k, feed in enumerate(feeds):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        step, rec = exe._step, {"step": k}
        fetch = [v["loss"]] + ([terms] + masks if k == 0 else [])
        clock = _DpWatch(device)
        with clock if k == 1 else contextlib.nullcontext():
            _sync(device)
            t0 = time.perf_counter()
            got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                          return_numpy=False)
            _sync(device)
            rec["ms"] = (time.perf_counter() - t0) * 1e3
        if k == 1:
            rec.update(collective_ms=clock.seconds * 1e3,
                       collective_calls=clock.calls,
                       collective_bytes=clock.bytes)
        rec["kind"] = ("checked", "watched", "untapped")[min(k, 2)]
        losses.append(float(got[0]))
        rec["loss"] = losses[-1]
        if on_card:
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if k == 0 and rank == 0:
            rmain, _, rv = build(cfg, tagged=False)
            ref = _pdp_one_rank(place, rmain, init, step, feed,
                                [rv["loss"], terms] + masks)
            rec["loss_bound"] = _pdp_loss_bound(got[1], ref[1], losses[-1],
                                                float(ref[0]), world)
            rec["masks"] = len(masks)
            rec["masks_bit_for_bit"] = all(
                _same_tensor_bits(a, b) for a, b in zip(got[2:], ref[2:]))
            rec["mask_keep_share"] = float(got[2].float().mean())
            rec["masks_global_shape"] = list(got[2].shape)
            del ref
        del got
        steps.append(rec)
    out["steps"] = steps
    out["replicas_differ"] = _pdp_replicas_differ(scope, names)
    final = _pdp_state(scope, params)
    del exe, scope
    if on_card:
        torch.cuda.empty_cache()

    # the gradient, at dropout 0 (a row permutation moves no dropout mask)
    c0 = cfg._replace(dropout=0.0)
    main0, startup0, v0 = build(c0)
    exe0, scope0 = fluid.Executor(place), fluid.Scope()
    exe0.run(startup0, scope=scope0)
    for n in names:
        scope0.set(n, init[n].clone())
    gnames = [p + "@GRAD" for p in params]
    step = exe0._step
    g_dp = exe0.run(main0, feed=feeds[0], fetch_list=gnames, scope=scope0,
                    return_numpy=False)
    del exe0, scope0
    if rank == 0:
        rmain, _, _ = build(c0, tagged=False)
        perm = np.random.RandomState(1).permutation(cfg.batch)
        half = cfg.batch // world
        g1 = _pdp_one_rank(place, rmain, init, step, feeds[0], gnames)
        gp = _pdp_one_rank(place, rmain, init, step,
                           {k: a[perm] for k, a in feeds[0].items()}, gnames)
        # key biases: softmax ignores a shift along its axis, so their
        # gradient is 0 up to rounding noise; compared, not held
        held = [i for i, p in enumerate(params) if not p.endswith("_key_fc.b_0")]
        pick = lambda gs: [gs[i] for i in held]
        hn = [params[i] for i in held]
        out["grad"] = _grad_gap(pick(g_dp), pick(g1), 1, hn)
        out["yardstick_grad"] = _grad_gap(pick(gp), pick(g1), 1, hn)
        del gp
        # the ranks' row blocks run one after another on one rank, their
        # gradients averaged: f32 products round differently at the ranks'
        # shapes than at the global batch's, which no row permutation moves
        parts = [_pdp_one_rank(place, rmain, init, step,
                               {k: a[r * half:(r + 1) * half]
                                for k, a in feeds[0].items()}, gnames)
                 for r in range(world)]
        g_split = [sum(gs) / world for gs in zip(*parts)]
        out["split_yardstick_grad"] = _grad_gap(pick(g_split), pick(g1), 1,
                                                hn)
        out["dp_equals_split_bit_for_bit"] = all(
            _same_tensor_bits(a, b) for a, b in zip(g_dp, g_split))
        out["control_own_rows_grad"] = _grad_gap(pick(parts[0]), pick(g1), 1,
                                                 hn)
        out["control_n_times_grad"] = _grad_gap(
            [g * world for g in pick(g_dp)], pick(g1), 1, hn)
        del g1, parts, g_split
    del g_dp
    if on_card:
        torch.cuda.empty_cache()

    # kReduce from the same state, on the same batches
    strategy = fleet.DistributedStrategy()
    strategy.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    main2, startup2, v2 = build(cfg, strategy)
    exe2, scope2 = fluid.Executor(place), fluid.Scope()
    exe2.run(startup2, scope=scope2)
    for n in names:
        scope2.set(n, init[n].clone())
    del init
    red = [float(exe2.run(main2, feed=f, fetch_list=[v2["loss"]],
                          scope=scope2)[0]) for f in feeds]
    moments = [x.name for x in main2.list_vars()
               if getattr(x, "_is_optimizer_accumulator", False)
               and "moment" in x.name]
    held = sum(scope2.find_var(n).numel() * 4 for n in moments)
    whole = sum(math.prod(main2.global_block().var(n).shape) * 4
                for n in moments)
    out["reduce"] = {
        "losses": red, "losses_bit_for_bit": red == losses,
        "params_bit_for_bit": all(_same_tensor_bits(scope2.find_var(p),
                                                    final[p]) for p in params),
        "moments": len(moments), "moment_bytes_a_rank": held,
        "moment_bytes_whole": whole,
        "row_shards": sorted({scope2.row_shards(n) for n in moments}),
        "replicas_differ": _pdp_replicas_differ(
            scope2, [n for n in names if scope2.row_shards(n) == 1])}
    del exe2, scope2, final
    out["losses"] = losses
    return out


def _pdp_bn_bound(x, mean, var, sync):
    """Per channel, the distance of a batch norm's f32 mean and variance
    from the float64 ones of its input ``x`` (NCHW), and the bound the
    arithmetic gives: a mean of n values within gamma(n + 3) of their
    absolute mean; the variance, as the data-parallel rule forms it
    (``sync``: the mean of squares less the squared mean) or as one rank's
    (the mean of the squared deviations), within gamma(n + 4) of its sums,
    the mean's error carried through the square, and a rounding."""
    from paddle_tpu_torch.tools import fp_bounds

    xd = x.double().transpose(0, 1).reshape(x.shape[1], -1)
    n = xd.shape[1]
    g, u = fp_bounds.gamma, fp_bounds.U32
    mu = xd.mean(1)
    ex2 = (xd * xd).mean(1)
    var64 = ex2 - mu * mu
    e_m = g(n + 3) * xd.abs().mean(1) + n * 2.0 ** -52 * xd.abs().mean(1)
    if sync:
        e_v = (g(n + 4) * ex2 + e_m * (2 * mu.abs() + e_m)
               + u * (mu * mu + var64.abs()))
    else:
        e_v = g(n + 4) * (var64 + e_m * e_m) + e_m * e_m
    e_v = e_v + n * 2.0 ** -52 * ex2
    return mu, var64, e_m, e_v


def _pdp_resnet(rank, world, device, args):
    """The book's ResNet-CIFAR (``tools/book_suite.py`` ``image_resnet``:
    batch norms, ``accuracy``, Adam) under ``with_data_parallel``, PDP_RN_STEPS
    checked steps and one untapped: every batch norm's global statistics
    and the accuracy against the one-rank run's from the same state (rank
    0), replicas after each step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import datasets
    from paddle_tpu_torch.models import book
    from paddle_tpu_torch.tools import book_suite

    place = _pdp_place(device)
    on_card = torch.device(device).type == "cuda"
    run = book_suite.build(fluid, book, datasets, "image_resnet",
                           n=args["rn_batch"])
    main = run.main
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=run.cost.name)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(run.startup, scope=scope)
    names = sorted(x.name for x in run.startup.list_vars() if x.persistable)
    ops = main.global_block().ops
    bns = [(op.inputs["X"][0], op.outputs["SavedMean"][0],
            op.outputs["SavedVariance"][0]) for op in ops
           if op.type == "batch_norm"]
    pred = next(op.inputs["X"][0] for op in ops if op.type == "top_k")
    acc = run.fetch[1]
    fetch = [run.cost, acc, pred] + [n for b in bns for n in b]
    label = torch.from_numpy(run.feed["label"]).to(device).reshape(-1)
    steps = []
    for k in range(PDP_RN_STEPS + 1):
        checked = k < PDP_RN_STEPS
        state = _pdp_state(scope, names) if checked and rank == 0 else None
        step = exe._step
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _sync(device)
        t0 = time.perf_counter()
        got = exe.run(compiled, feed=run.feed,
                      fetch_list=fetch if checked else [run.cost, acc],
                      scope=scope, return_numpy=False)
        _sync(device)
        rec = {"step": k, "ms": (time.perf_counter() - t0) * 1e3,
               "loss": float(got[0]), "accuracy": float(got[1]),
               "kind": "checked" if checked else "untapped"}
        if on_card:
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if checked and rank == 0:
            ref = _pdp_one_rank(place, main, state, step, run.feed, fetch)
            del state
            # accuracy: the data-parallel count is its own gathered
            # predictions' count; it may differ from the one-rank one only
            # on rows whose top-1 margin is within the two runs' distance
            p_dp, p_one = got[2].double(), ref[2].double()
            n_rows = p_dp.shape[0]
            own = float((p_dp.argmax(1) == label).sum()) / n_rows
            top2 = p_one.topk(2, dim=1).values
            dist_row = (p_dp - p_one).abs().amax(1)
            flips = int((top2[:, 0] - top2[:, 1] <= 2 * dist_row).sum())
            rec.update(accuracy_one_rank=float(ref[1]), accuracy_own_count=own,
                       accuracy_rows=n_rows, accuracy_rows_may_flip=flips,
                       accuracy_ok=bool(float(got[1]) == own and abs(
                           float(got[1]) - float(ref[1])) * n_rows <= flips))
            worst = {"mean": 0.0, "var": 0.0}
            for i in range(len(bns)):
                x_dp, m_dp, v_dp = got[3 + 3 * i: 6 + 3 * i]
                x_one, m_one, v_one = ref[3 + 3 * i: 6 + 3 * i]
                mu_a, var_a, em_a, ev_a = _pdp_bn_bound(x_dp, m_dp, v_dp, True)
                mu_b, var_b, em_b, ev_b = _pdp_bn_bound(x_one, m_one, v_one,
                                                        False)
                for what, got_v, one_v, bound in (
                        ("mean", m_dp, m_one,
                         em_a + em_b + (mu_a - mu_b).abs()),
                        ("var", v_dp, v_one,
                         ev_a + ev_b + (var_a - var_b).abs())):
                    r = float(((got_v.double() - one_v.double()).abs()
                               / bound).max())
                    worst[what] = max(worst[what], r)
                # the statistics are the global batch's: the local rows'
                # mean lies outside the bound (the control)
            rec["bn_layers"] = len(bns)
            rec["bn_err_over_bound"] = worst
            half = x_dp.shape[0] // world
            mu_local = x_dp[:half].double().transpose(0, 1).reshape(
                x_dp.shape[1], -1).mean(1)
            rec["control_local_mean_err_over_bound"] = float(
                ((mu_local - m_one.double()).abs()
                 / (em_a + em_b + (mu_a - mu_b).abs())).max())
            del ref
        del got
        rec["replicas_differ"] = _pdp_replicas_differ(scope, names)
        steps.append(rec)
    del exe, scope
    return {"steps": steps, "batch": args["rn_batch"], "world": world}


def _pdp_geo(rank, world, device, args):
    """ResNet-CIFAR transpiled with ``geo_sgd_mode``, K = PDP_GEO_K: each
    rank its own half of the batch, PDP_GEO_STEPS local steps; at every
    reconcile the replicas differ before and agree bit for bit after."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import datasets
    from paddle_tpu_torch.distributed import Communicator, DistributeTranspiler
    from paddle_tpu_torch.distributed.transpiler import (
        DistributeTranspilerConfig)
    from paddle_tpu_torch.models import book
    from paddle_tpu_torch.tools import book_suite

    place = _pdp_place(device)
    run = book_suite.build(fluid, book, datasets, "image_resnet",
                           n=args["rn_batch"])
    cfg = DistributeTranspilerConfig()
    cfg.geo_sgd_mode = True
    cfg.geo_sgd_need_push_nums = PDP_GEO_K
    DistributeTranspiler(cfg).transpile(rank, program=run.main, pservers="",
                                        trainers=world)
    comm = Communicator(run.main, geo_sgd_need_push_nums=PDP_GEO_K)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(run.startup, scope=scope)
    names = sorted(x.name for x in run.startup.list_vars() if x.persistable
                   and scope.find_var(x.name).is_floating_point())
    average = comm._average_params
    syncs = []

    def checked(scope_=None):
        before = _pdp_replicas_differ(scope, names)
        average(scope_)
        syncs.append({"differed_before": len(before),
                      "differ_after": _pdp_replicas_differ(scope, names)})

    comm._average_params = checked
    comm.start()
    half = args["rn_batch"] // world
    feed = {k: a[rank * half:(rank + 1) * half] for k, a in run.feed.items()}
    losses = []
    for _ in range(PDP_GEO_STEPS):
        losses.append(float(exe.run(run.main, feed=feed,
                                    fetch_list=[run.cost], scope=scope)[0]))
    with fluid.scope_guard(scope):
        comm.stop()
    return {"sync_count": comm.sync_count, "syncs": syncs, "losses": losses,
            "vars": len(names)}


def _pdp_rank(rank, world, endpoint, results, args):
    """One rank of phase 52, in a spawned process: ``fleet.init()`` from a
    launcher's PADDLE_* env with gloo (both ranks on card 0), then the
    encoder, ResNet-CIFAR and GeoSGD; its records go on ``results``."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.kernels import _common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TRAINER_ENDPOINTS": endpoint,
        "PADDLE_CURRENT_ENDPOINT": endpoint, "PADDLE_DISTRI_BACKEND": "gloo",
        "FLAGS_selected_gpus": "0",
        # two ranks' caching allocators share the card
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    device = fleet.init(
        device=None if args["device"] == "cuda" else args["device"]).device
    try:
        _common.reset_launches()
        res = {"rank": rank, "backend": dist.get_backend(),
               "encoder": _pdp_encoder(rank, world, device, args)}
        if device.type == "cuda":
            torch.cuda.empty_cache()
        res["resnet"] = _pdp_resnet(rank, world, device, args)
        res["geo"] = _pdp_geo(rank, world, device, args)
        res["launches"] = {k: n for k, n in _common.launches.items() if n}
        results.put(res)
    finally:
        dist.destroy_process_group()


def _pdp_verdict(got, world):
    """The problems in the ranks' records."""
    bad = []
    for rank in range(world):
        res = got[rank]
        enc, rn, geo = res["encoder"], res["resnet"], res["geo"]
        if res["launches"]:
            bad.append("rank %d launched port kernels %s" % (rank,
                                                             res["launches"]))
        if enc["replicas_differ"] or enc["reduce"]["replicas_differ"]:
            bad.append("rank %d encoder replicas %s / %s" % (
                rank, enc["replicas_differ"][:3],
                enc["reduce"]["replicas_differ"][:3]))
        red = enc["reduce"]
        if not (red["losses_bit_for_bit"] and red["params_bit_for_bit"]
                and red["row_shards"] == [world]
                and red["moment_bytes_a_rank"] * world
                == red["moment_bytes_whole"]):
            bad.append("rank %d kReduce %s" % (rank, red))
        if not all(math.isfinite(x) for x in enc["losses"]):
            bad.append("rank %d encoder losses %s" % (rank, enc["losses"]))
        for st in rn["steps"]:
            if st["replicas_differ"] or not math.isfinite(st["loss"]):
                bad.append("rank %d resnet step %d %s" % (
                    rank, st["step"], st["replicas_differ"][:3]))
        if geo["sync_count"] != PDP_GEO_STEPS // PDP_GEO_K + 1 or any(
                s["differ_after"] for s in geo["syncs"]) or not \
                geo["syncs"][0]["differed_before"]:
            bad.append("rank %d geo %s" % (rank, geo["syncs"]))
    enc, rn = got[0]["encoder"], got[0]["resnet"]
    st = enc["steps"][0]
    if not st["masks_bit_for_bit"] or st["loss_bound"]["err_over_bound"] > 1:
        bad.append("encoder masks %s, loss %s" % (st["masks_bit_for_bit"],
                                                  st["loss_bound"]))
    g, c = enc["grad"], enc["control_own_rows_grad"]
    for what in ("grad_rel_l2_median", "grad_rel_l2_max"):
        yard = max(enc["yardstick_grad"][what],
                   enc["split_yardstick_grad"][what])
        if not g[what] <= PDP_GRAD_LIMIT * yard:
            bad.append("encoder gradient %s %s over %s x %s" % (
                what, g[what], PDP_GRAD_LIMIT, yard))
        for name, ctl in (("a rank's own rows", c),
                          ("n times", enc["control_n_times_grad"])):
            if not ctl["grad_rel_l2_median"] > PDP_GRAD_LIMIT * yard:
                bad.append("encoder control (%s) %s within %s x %s" % (
                    name, ctl["grad_rel_l2_median"], PDP_GRAD_LIMIT, yard))
    for st in rn["steps"][:PDP_RN_STEPS]:
        w = st["bn_err_over_bound"]
        if not st["accuracy_ok"] or w["mean"] > 1 or w["var"] > 1 or not \
                st["control_local_mean_err_over_bound"] > 1:
            bad.append("resnet step %d: accuracy %s, BN %s, control %s" % (
                st["step"], st["accuracy_ok"], w,
                st["control_local_mean_err_over_bound"]))
    return bad


def phase_program_dp_two_ranks(device_name, card, device="cuda", enc_cfg=None,
                               rn_batch=PDP_RN_BATCH):
    """Phase 52, second part: two ranks on the one card over gloo, each a
    spawned process joining through ``fleet.init()``.  The Fluid-layers
    BERT-base encoder under ``fleet.distributed_optimizer`` (global B = 16,
    8 sequences a rank, dropout 0.1, Adam): the replicas bit for bit, the
    gathered dropout masks bit for bit the one-rank run's, the loss within
    the derived bound of the one-rank step's (``_pdp_loss_bound``), the
    gradient (at dropout 0) within PDP_GRAD_LIMIT yardsticks of the
    one-rank gradient (the larger of a row permutation's distance and the
    distance of the one-rank program run on the ranks' row blocks in turn,
    since f32 products round differently at the ranks' shapes) while a
    rank's own rows' gradient and n times the gradient land outside; then
    kReduce, whose losses and parameters equal
    AllReduce's bit for bit with Adam's moments at half their bytes a rank.
    The book's ResNet-CIFAR under ``with_data_parallel``, 32 a rank: every
    batch norm's global statistics within the derived bound of the one-rank
    run's (the local rows' mean outside it), the accuracy its own gathered
    count and within the rows a rounding may flip of the one-rank one; then
    GeoSGD at K = 2, the replicas differing before each reconcile and equal
    after.  ms a step a rank, collective ms, calls and bytes of a watched
    step, peak GB a rank; no port kernel launched."""
    import multiprocessing as mp
    import queue

    from paddle_tpu_torch.tools.programs import BERT_BASE_ENCODER

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    endpoint = "127.0.0.1:%d" % _free_port()
    enc_cfg = enc_cfg or BERT_BASE_ENCODER
    args = {"device": device, "enc_cfg": enc_cfg, "rn_batch": rn_batch}
    procs = [ctx.Process(target=_pdp_rank, args=(r, DP_WORLD, endpoint,
                                                 results, args))
             for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + PDP_TIMEOUT_S
        while len(got) < DP_WORLD:
            try:
                res = results.get(timeout=5)
                got[res["rank"]] = res
            except queue.Empty:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    raise AssertionError("phase 52: a rank failed, exit codes "
                                         "%s" % codes)
                if time.monotonic() > deadline:
                    raise AssertionError("phase 52: no result in %d s"
                                         % PDP_TIMEOUT_S)
        for p in procs:
            p.join(120)
        codes = [p.exitcode for p in procs]
        if codes != [0] * DP_WORLD:
            raise AssertionError("phase 52: exit codes %s" % codes)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    bad = _pdp_verdict(got, DP_WORLD)
    for rank in range(DP_WORLD):
        emit({"phase": "program_dp_two_ranks", "rank": rank,
              "world": DP_WORLD, "backend": got[rank]["backend"],
              "model": "Fluid-layers BERT-base encoder (fleet)",
              "batch_global": enc_cfg.batch, "seq": enc_cfg.seq,
              **got[rank]["encoder"]})
        emit({"phase": "program_dp_two_ranks", "rank": rank,
              "model": "ResNet-CIFAR (book, with_data_parallel)",
              **got[rank]["resnet"]})
        emit({"phase": "program_dp_two_ranks", "rank": rank,
              "model": "ResNet-CIFAR GeoSGD K=%d" % PDP_GEO_K,
              **got[rank]["geo"]})
    ok = not bad
    emit({"phase": "program_dp_two_ranks", "nvidia_smi": card, "ok": ok,
          "seconds": time.perf_counter() - t0, "problems": bad[:20]})
    if not ok:
        raise AssertionError("phase 52: %s" % bad[:20])
    return {rank: got[rank]["launches"] for rank in got}


# Phase 53 (program_dp_more): item 5-B' at full width under fleet: the data
# path (DeepFM's CTR program through train_from_dataset with the feed pipe,
# and a py_reader), the LoD / CRF / CTC ops and scan bodies (the CRNN-CTC and
# LAC), and LAMB under kReduce (the Fluid-layers BERT-base encoder).
PDM_STEPS = 2
PDM_FEED_SEED = 800
PDM_READER_B, PDM_READER_W = 1024, 64    # the py_reader program's batch, width
PDM_TIMEOUT_S = 600
PDM_MODELS = ("ctr", "crnn", "lac", "enc")


def _pdm_args(small=False):
    """Phase 53's configurations: the CTR program at DeepFMConfig()'s widths
    (B = CTR_B), CRNN_CTC (B = 32), LAC (B = 300) and BERT_BASE_ENCODER with
    LAMB at B = 16; ``small`` gives tiny ones for a rehearsal on the CPU."""
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.tools import programs as P

    d = deepfm.DeepFMConfig()
    ctr = dict(n_fields=d.num_fields, vocab=d.num_features, embed=d.embed_dim,
               mlp=tuple(d.mlp_dims), batch=CTR_B)
    crnn, lac = P.CRNN_CTC, P.LAC
    enc = P.BERT_BASE_ENCODER._replace(optimizer="lamb", dropout=0.0)
    if small:
        ctr = dict(n_fields=4, vocab=64, embed=4, mlp=(8,), batch=16)
        crnn = crnn._replace(batch=4, height=16, width=32, channels=(2, 2, 2, 4),
                             hidden=4, classes=9, label_min=1, label_max=3)
        lac = lac._replace(batch=4, seq_len=6, vocab=50, emb=4, hidden=4,
                           tags=7, len_min=2, len_max=6)
        enc = enc._replace(vocab=64, hidden=16, layers=1, heads=2, ffn=32,
                           seq=8, batch=4)
    return {"ctr": ctr, "crnn": crnn, "lac": lac, "enc": enc,
            "reader_b": 8 if small else PDM_READER_B,
            "reader_w": 4 if small else PDM_READER_W}


class _PdmModel:
    """One of phase 53's programs, untagged or under fleet: its programs,
    loss, per-example loss terms, metric vars, feeds and parameters."""

    def __init__(self, kind, args, tagged, strategy=None):
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.tools import ctr_program as cp
        from paddle_tpu_torch.tools import programs as P

        wrap = ((lambda opt: fleet.distributed_optimizer(opt, strategy))
                if tagged else None)
        self.kind, self.args, self.metrics = kind, args, []
        if kind == "ctr":
            c = args["ctr"]
            prog = cp.build_ctr_program(
                fluid, n_fields=c["n_fields"], vocab=c["vocab"],
                embed=c["embed"], mlp=c["mlp"], lr=CTR_LR,
                wrap_optimizer=wrap, auc=True)
            self.main, self.startup, self.loss = (prog.main, prog.startup,
                                                  prog.loss)
            self.prog, self.terms = prog, prog.auc["terms"]
            self.metrics = [prog.auc[k] for k in ("stat_pos", "stat_neg",
                                                  "prob")]
            self.feeds = None               # read from the dataset
        elif kind in ("crnn", "lac"):
            cfg = args[kind]
            build = P.crnn_ctc_program if kind == "crnn" else P.lac_program
            feed = P.crnn_feed if kind == "crnn" else P.lac_feed
            self.main, self.startup, _, v = build(fluid, cfg, wrap)
            self.loss = v["loss"]
            ops = self.main.global_block().ops
            if kind == "crnn":
                self.terms = next(op.outputs["Loss"][0] for op in ops
                                  if op.type == "warpctc")
                self.metrics = [v["distance"], next(
                    op.outputs["SequenceNum"][0] for op in ops
                    if op.type == "edit_distance")]
            else:
                self.terms = next(op.outputs["LogLikelihood"][0] for op in ops
                                  if op.type == "linear_chain_crf")
                self.metrics = [v["num_infer"], v["num_label"],
                                v["num_correct"]]
            self.feeds = [feed(cfg, PDM_FEED_SEED + k)
                          for k in range(PDM_STEPS)]
        else:
            cfg = args["enc"]
            self.main, self.startup, v = P.bert_encoder_program(fluid, cfg,
                                                                wrap)
            self.loss = v["loss"]
            self.terms = next(op.outputs["Loss"][0] for op in
                              self.main.global_block().ops
                              if op.type == "softmax_with_cross_entropy")
            self.feeds = [P.encoder_feed(cfg, PDM_FEED_SEED + k)
                          for k in range(PDM_STEPS)]
        self.names = sorted(x.name for x in self.startup.list_vars()
                            if x.persistable)
        # dense parameters (an is_sparse table's gradient is not fetched)
        sparse = {op.inputs["W"][0] for op in self.main.global_block().ops
                  if op.type in ("lookup_table", "lookup_table_v2")
                  and op.attrs.get("is_sparse")}
        self.params = [p.name for p in self.main.global_block().all_parameters()
                       if p.name not in sparse]

    def dataset(self, files, batch):
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.tools import ctr_program as cp

        ds = cp.make_dataset(fluid, "InMemoryDataset", files, self.prog,
                             batch, 1)
        ds.load_into_memory()
        return ds


def _pdm_deterministic():
    """Phase 53's bit-for-bit checks compare two runs of one step (and the
    replicas of two ranks): cuDNN's deterministic algorithms, and PyTorch's
    deterministic scatter-adds (the gathers' backward, the sparse rows'
    plain merge).  Returns cuDNN's settings before."""
    saved = _deterministic_cudnn()
    torch.use_deterministic_algorithms(True, warn_only=True)
    return saved


def _pdm_float64(model):
    """``model``'s untagged program again, every f32 var declared float64
    (its rules compute in their inputs' dtype)."""
    m = _PdmModel(model.kind, model.args, tagged=False)
    for block in m.main.blocks:
        for var in block.vars.values():
            if str(var.dtype) == "float32":
                var.dtype = "float64"
    return m.main


def _pdm_files(args):
    """The CTR program's MultiSlot file: PDM_STEPS global batches."""
    import os

    from paddle_tpu_torch.tools import ctr_program as cp

    c = args["ctr"]
    return cp.write_ctr_files(os.path.join(DATA_DIR, "program_dp"), n_files=1,
                              rows_per_file=PDM_STEPS * c["batch"],
                              n_fields=c["n_fields"], vocab=c["vocab"],
                              seed=CTR_SEED, zipf=CTR_ZIPF)


def _pdm_train(m, exe, scope, args, device, files, fetch):
    """PDM_STEPS steps of ``m`` from the state in ``scope``: the CTR
    program through ``train_from_dataset`` over an InMemoryDataset (the
    feed pipe on, its staged bytes counted), the others through
    ``Executor.run``.  Returns (each step's fetches on the device, ms a
    step, host-to-device bytes a step, the global batches)."""
    if m.kind != "ctr":
        out, ms = [], []
        for f in m.feeds:
            _sync(device)
            t0 = time.perf_counter()
            out.append(exe.run(m.main, feed=f, fetch_list=fetch, scope=scope,
                               return_numpy=False))
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms, None, m.feeds
    ds = m.dataset(files, args["ctr"]["batch"])
    batches = list(ds._iter_batches())
    out, staged = [], []
    run, convert = exe.run, exe.feed_converter

    def recorded(*a, **kw):
        res = run(*a, **kw)
        out.append(res)
        return res

    def converter(program=None):
        conv = convert(program)

        def counted(feed):
            got = conv(feed)
            vals = getattr(got, "feed", got).values()
            staged.append(sum(v.numel() * v.element_size() for v in vals))
            return got

        return counted

    exe.run, exe.feed_converter = recorded, converter
    _set_env(PADDLE_TPU_FEED_PIPE="1")
    try:
        _sync(device)
        t0 = time.perf_counter()
        exe.train_from_dataset(m.main, ds, scope=scope, fetch_list=fetch)
        _sync(device)
        dt = time.perf_counter() - t0
    finally:
        exe.run, exe.feed_converter = run, convert
        _set_env(PADDLE_TPU_FEED_PIPE=None)
    return out, [dt * 1e3 / len(out)] * len(out), staged, batches


def phase_program_dp_more_nccl(device_name, card, device=None, args=None):
    """Phase 53, first part: a one-rank NCCL world (``fleet.init()``), each
    of the CTR program (train_from_dataset, the feed pipe on), the
    CRNN-CTC, LAC and the LAMB encoder under ``fleet.distributed_optimizer``
    for PDM_STEPS steps from the state and on the batches the untagged
    program runs: losses and every persistable bit for bit the untagged
    program's.  Returns the port kernels' launches a step, by program."""
    import os

    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.kernels import _common

    args = args or _pdm_args()
    endpoint = "127.0.0.1:%d" % _free_port()
    env = {"PADDLE_TRAINER_ID": "0", "PADDLE_TRAINERS_NUM": "1",
           "PADDLE_TRAINER_ENDPOINTS": endpoint,
           "PADDLE_CURRENT_ENDPOINT": endpoint}
    env["PADDLE_TPU_SEGMENT_KERNEL"] = "1"
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    recs, launches = [], {}
    t0 = time.perf_counter()
    saved_cudnn = _pdm_deterministic()
    try:
        dev = fleet.init(device=device).device
        backend, world = dist.get_backend(), dist.get_world_size()
        place = _pdp_place(dev)
        files = _pdm_files(args)
        for kind in PDM_MODELS:
            runs, init = {}, None
            for tagged in (False, True):
                m = _PdmModel(kind, args, tagged)
                exe, scope = fluid.Executor(place), fluid.Scope()
                exe.run(m.startup, scope=scope)
                if init is None:
                    init = _pdp_state(scope, m.names)
                else:
                    for n in m.names:
                        scope.set(n, init[n].clone())
                _common.reset_launches()
                out, ms, staged, _ = _pdm_train(m, exe, scope, args, dev,
                                                files, [m.loss])
                counts = {k: c / len(out) for k, c in _common.launches.items()
                          if c}
                runs[tagged] = ([float(o[0]) for o in out], ms, staged,
                                {n: scope.find_var(n) for n in m.names}, counts)
                del exe, scope, out
            (l0, ms0, st0, s0, c0), (l1, ms1, st1, s1, c1) = runs[False], runs[True]
            differ = [n for n in s0 if not _same_tensor_bits(s0[n], s1[n])]
            same = bool(l0 == l1 and not differ)
            launches[kind] = c1
            recs.append({"model": kind, "losses": l1, "ms_each_step_fleet": ms1,
                         "ms_each_step_plain": ms0, "bit_for_bit": same,
                         "persistables_differ": differ[:5],
                         "h2d_bytes_each_step": st1,
                         "launches_per_step": c1,
                         "launches_per_step_plain": c0})
            del runs, init, s0, s1
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            saved_cudnn
    ok = world == 1 and all(r["bit_for_bit"] and all(
        math.isfinite(x) for x in r["losses"]) for r in recs)
    for r in recs:
        emit({"phase": "program_dp_more_nccl", "backend": backend,
              "world": world, **r})
    emit({"phase": "program_dp_more_nccl", "nvidia_smi": card, "ok": ok,
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError("phase 53 (one-rank NCCL world): %s" % recs)
    ctr_bytes = next(r["h2d_bytes_each_step"][0] for r in recs
                     if r["model"] == "ctr")
    return launches, ctr_bytes


def _pdm_sum_bound(t_dp, t_one, l_dp, l_one, world, mean):
    """|l_dp - l_one| against the bound the arithmetic gives for a sum (or,
    ``mean``, a mean) of each run's own f32 terms: the data-parallel one a
    sum of each rank's n/world terms, then of the ranks, the one-rank one
    in one order, each within gamma(k) of its terms' absolute sum (and a
    division's rounding for a mean), plus the distance of the two runs'
    exact sums (float64)."""
    if mean:
        return _pdp_loss_bound(t_dp, t_one, l_dp, l_one, world)
    from paddle_tpu_torch.tools import fp_bounds

    a, b = t_dp.double().flatten(), t_one.double().flatten()
    n, g = a.numel(), fp_bounds.gamma
    bound = (g(n // world + world) * float(a.abs().sum())
             + g(n) * float(b.abs().sum())
             + abs(float(a.sum()) - float(b.sum()))
             + 2 * n * 2.0 ** -53 * float(a.abs().sum() + b.abs().sum()))
    err = abs(l_dp - l_one)
    return {"terms": n, "loss_dp": l_dp, "loss_one_rank": l_one, "err": err,
            "bound": bound, "err_over_bound": err / bound,
            "terms_bit_for_bit": _same_tensor_bits(t_dp, t_one)}


def _pdm_model(kind, rank, world, device, args, files):
    """One program of phase 53 on this rank under fleet, PDM_STEPS steps:
    the losses, ms a step, host-to-device bytes a step (the CTR program),
    kernel launches a step, the replicas; rank 0 holds the first step to
    the untagged program's on one rank from the same state: the loss
    within its derived bound, the metrics' counts equal as integers, and
    (the CRNN and LAC) the gradient against its yardsticks."""
    import numpy as np

    from paddle_tpu_torch.kernels import _common

    import paddle_tpu_torch as fluid

    place = _pdp_place(device)
    m = _PdmModel(kind, args, tagged=True)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(m.startup, scope=scope)
    init = _pdp_state(scope, m.names)
    grads = ([p + "@GRAD" for p in m.params] if kind in ("crnn", "lac")
             else [])
    fetch = [m.loss, m.terms] + m.metrics
    step0 = exe._step
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _common.reset_launches()
    clock = _DpWatch(device)
    if kind == "ctr":
        # both steps watched (train_from_dataset runs them together)
        with clock:
            out, ms, staged, feeds = _pdm_train(m, exe, scope, args, device,
                                                files, fetch)
        watched = len(out)
    else:
        # the first step fetches the gradient (the one-device one); the
        # second is watched
        out, ms = [], []
        for k, f in enumerate(m.feeds):
            with clock if k == 1 else contextlib.nullcontext():
                _sync(device)
                t0 = time.perf_counter()
                out.append(exe.run(m.main, feed=f, scope=scope,
                                   fetch_list=fetch + (grads if k == 0
                                                       else []),
                                   return_numpy=False))
                _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        staged, feeds, watched = None, m.feeds, 1
    rec = {"model": kind, "losses": [float(o[0]) for o in out], "ms": ms,
           "collective_ms_a_step": clock.seconds * 1e3 / watched,
           "collective_calls_a_step": clock.calls / watched,
           "collective_bytes_a_step": clock.bytes / watched,
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9 if on_card
                       else None),
           "h2d_bytes_each_step": staged,
           "launches_per_step": {k: c / len(out) for k, c in
                                 _common.launches.items() if c},
           "replicas_differ": _pdp_replicas_differ(scope, m.names)}
    del exe, scope
    if rank != 0:
        return rec
    plain = _PdmModel(kind, args, tagged=False)
    ref = _pdp_one_rank(place, plain.main, init, step0, feeds[0],
                        [plain.loss, plain.terms] + plain.metrics
                        + grads)
    got = out[0]
    rec["loss_bound"] = _pdm_sum_bound(got[1], ref[1], rec["losses"][0],
                                       float(ref[0]), world, kind != "crnn")
    if kind == "ctr":
        rec["auc_stats_equal"] = all(torch.equal(a, b) for a, b in
                                     zip(got[2:4], ref[2:4]))
        rec["auc_positives"] = int(got[2].sum())
        rec["auc_negatives"] = int(got[3].sum())
        rec["prob_max_abs_diff"] = float((got[4] - ref[4]).abs().max())
    elif kind == "crnn":
        n = np.maximum(feeds[0]["label_length"], 1).reshape(-1, 1)
        e_dp = np.rint(got[2].cpu().double().numpy() * n).astype(np.int64)
        e_one = np.rint(ref[2].cpu().double().numpy() * n).astype(np.int64)
        rec["edit_counts_equal"] = bool(np.array_equal(e_dp, e_one))
        rec["edit_count_sum"] = int(e_dp.sum())
        rec["sequence_num"] = [int(got[3]), int(ref[3])]
    else:
        rec["chunk_counts"] = [[int(x) for x in got[2:5]],
                               [int(x) for x in ref[2:5]]]
    if grads:
        # a convolution's bias before a batch norm: its gradient is 0 up to
        # rounding noise (the norm takes the mean out); compared, not held
        held = [i for i, p in enumerate(m.params)
                if not (kind == "crnn" and p.startswith("conv2d_")
                        and ".b_" in p)]
        hn = [m.params[i] for i in held]
        pick = lambda gs: [gs[i] for i in held]
        k0 = 2 + len(m.metrics)
        g_dp, g1 = pick(got[k0:]), pick(ref[k0:])
        rec["grad"] = _grad_gap(g_dp, g1, 1, hn)
        rec["grad_leaves_held"] = len(hn)
        perm = np.random.RandomState(1).permutation(len(feeds[0][next(iter(
            feeds[0]))]))
        gp = pick(_pdp_one_rank(place, plain.main, init, step0,
                                {k: a[perm] for k, a in feeds[0].items()},
                                grads))
        rec["yardstick_grad"] = _grad_gap(gp, g1, 1, hn)
        half = len(perm) // world

        def at_batch(b):
            # the CRNN's program spells its batch in a reshape
            if kind != "crnn":
                return plain.main
            return _PdmModel(kind, dict(args, crnn=args["crnn"]._replace(
                batch=b)), tagged=False).main

        own = pick(_pdp_one_rank(place, at_batch(half), init, step0,
                                 {k: a[:half] for k, a in feeds[0].items()},
                                 grads))
        # a control: rank 0's rows alone (times world for the CRNN's sum)
        scale = world if kind == "crnn" else 1
        rec["control_own_rows_grad"] = _grad_gap([g * scale for g in own],
                                                 g1, 1, hn)
        del own
        if kind == "crnn":
            # two more evaluations of the same function in f32: the batch
            # norms' variance as the data-parallel rule forms it (the mean
            # square less the squared mean; no mesh, so no collective), and
            # the global batch twice over (the same statistics, every sum
            # of the CTC loss doubled exactly), its gradient halved: f32
            # products at another batch size, which a permutation keeps
            sync = _PdmModel(kind, args, tagged=False)
            for op in sync.main.global_block().ops:
                if op.type == "batch_norm":
                    op.attrs["_sync_axis"] = "dp"
            gs = pick(_pdp_one_rank(place, sync.main, init, step0, feeds[0],
                                    grads))
            rec["formula_yardstick_grad"] = _grad_gap(gs, g1, 1, hn)
            twice = {k: np.concatenate([a, a]) for k, a in feeds[0].items()}
            gt = pick(_pdp_one_rank(place, at_batch(2 * len(perm)), init,
                                    step0, twice, grads))
            rec["batch_yardstick_grad"] = _grad_gap([g / 2 for g in gt], g1,
                                                    1, hn)
            # the same step in float64: the conv-BN stack is ill-conditioned
            # at f32 (the first convolution's gradient is a small residue of
            # large sums), so the largest leaf is held to what f32 costs the
            # one-rank run against float64, not to a permutation
            g64 = pick(_pdp_one_rank(place, _pdm_float64(plain),
                                     {n: t.double() if t.is_floating_point()
                                      else t for n, t in init.items()},
                                     step0, feeds[0], grads))
            rec["f64_grad"] = _grad_gap(g_dp, g64, 1, hn)
            rec["f64_yardstick_grad"] = _grad_gap(g1, g64, 1, hn)
            del gs, gt, g64
        if kind == "lac":
            # the ranks' row blocks in turn, their gradients averaged (the
            # loss is a mean; the CRNN's batch norms would see other
            # statistics on a block, so it takes the yardsticks above)
            parts = [_pdp_one_rank(place, plain.main, init, step0,
                                   {k: a[r * half:(r + 1) * half]
                                    for k, a in feeds[0].items()}, grads)
                     for r in range(world)]
            rec["split_yardstick_grad"] = _grad_gap(
                pick([sum(gs) / world for gs in zip(*parts)]), g1, 1, hn)
            del parts
        del gp
    del ref, out
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _pdm_reader(rank, world, device, args):
    """A fleet-tagged MLP fed by a started ``py_reader`` (two global
    batches, then its end) against the same program fed each batch by a
    dict from the same state: losses and parameters bit for bit."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import fleet

    B, w = args["reader_b"], args["reader_w"]
    rng = np.random.RandomState(PDM_FEED_SEED)
    batches = [(rng.randn(B, w).astype("f4"), rng.randn(B, 1).astype("f4"))
               for _ in range(PDM_STEPS)]
    place = _pdp_place(device)
    runs, init = [], None
    for with_reader in (True, False):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            L = fluid.layers
            x = L.data("x", shape=[w], dtype="float32")
            y = L.data("y", shape=[1], dtype="float32")
            reader = (L.create_py_reader_by_data(capacity=2, feed_list=[x, y])
                      if with_reader else None)
            loss = L.mean(L.square_error_cost(L.fc(L.fc(x, w, act="relu"), 1),
                                              y))
            fleet.distributed_optimizer(
                fluid.optimizer.Momentum(0.01, 0.9)).minimize(loss)
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in startup.list_vars() if v.persistable)
        if init is None:
            init = _pdp_state(scope, names)
        else:
            for n in names:
                scope.set(n, init[n].clone())
        losses = []
        if with_reader:
            reader.decorate_batch_generator(lambda: iter(batches),
                                            places=place)
            reader.start()
            try:
                while True:
                    losses.append(float(exe.run(main, fetch_list=[loss],
                                                scope=scope)[0]))
            except fluid.EOFException:
                pass
        else:
            for bx, by in batches:
                losses.append(float(exe.run(main, feed={"x": bx, "y": by},
                                            fetch_list=[loss],
                                            scope=scope)[0]))
        runs.append((losses, scope))
    (l_r, s_r), (l_f, s_f) = runs
    return {"losses": l_r, "steps": len(l_r),
            "bit_for_bit": bool(l_r == l_f and all(
                _same_tensor_bits(s_r.find_var(n), s_f.find_var(n))
                for n in names)),
            "replicas_differ": _pdp_replicas_differ(s_r, names)}


def _pdm_lamb_bound(p0, p_ar, p_kr, m, v, b1p, b2p, lr, wd=0.01, eps=1e-6):
    """Per leaf, the largest |p_kr - p_ar| over the bound derived for the
    Fluid ``lamb`` update when its two trust-ratio norms are sums of squares
    reassociated (kReduce: each rank's rows summed, then the ranks; AllReduce:
    one sum over the leaf), from the same moments: each norm within
    gamma(n) / 2 + u, the ratio of each run within gamma(n) + 3u of the
    exact one, so the two within delta = 2 (gamma(n) + 3u); the update
    lr * trust * r (two roundings a run) within delta + 4u of |lr trust r|;
    then each run's subtraction, half an ulp of its result."""
    from paddle_tpu_torch.tools import fp_bounds

    u, worst = fp_bounds.U32, 0.0
    for p, pa, pk, mm, vv, b1, b2 in zip(p0, p_ar, p_kr, m, v, b1p, b2p):
        n = p.numel()
        r = ((mm.double() / (1 - float(b1))) /
             ((vv.double() / (1 - float(b2))).sqrt() + eps) + wd * p.double())
        pn, rn = float(p.double().norm()), float(r.norm())
        trust = pn / rn if pn > 0 and rn > 0 else 1.0
        upd = (lr * trust * r).abs()
        delta = 2 * (float(fp_bounds.gamma(n)) + 3 * u)
        bound = (upd * (delta + 4 * u) * (1 + delta)
                 + u * (pa.double().abs() + pk.double().abs()) + 1e-30)
        worst = max(worst, float(((pk.double() - pa.double()).abs()
                                  / bound).max()))
    return worst


def _pdm_lamb(rank, world, device, args):
    """The encoder with LAMB under fleet, AllReduce against kReduce from one
    state on one batch: the parameters within ``_pdm_lamb_bound`` (the
    trust ratio's norms reassociated, nothing else differs), the kReduce
    moments at 1/world of their bytes a rank; then kReduce's second step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import fleet

    place = _pdp_place(device)
    init, runs = None, {}
    for red in (False, True):
        strategy = fleet.DistributedStrategy()
        if red:
            strategy.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
        m = _PdmModel("enc", args, True, strategy)
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(m.startup, scope=scope)
        if init is None:
            init = _pdp_state(scope, m.names)
        else:
            for n in m.names:
                scope.set(n, init[n].clone())
        params = [p.name for p in m.main.global_block().all_parameters()]
        acc = lambda kind: ["%s_%s_0" % (p, kind) for p in params]
        moments = acc("moment1") + acc("moment2")
        ms, outs = [], []
        clock = _DpWatch(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for k, f in enumerate(m.feeds if red else m.feeds[:1]):
            with clock if k == 1 else contextlib.nullcontext():
                _sync(device)
                t0 = time.perf_counter()
                outs.append(exe.run(m.main, feed=f, scope=scope,
                                    fetch_list=[m.loss] + (moments if k == 0
                                                           else []),
                                    return_numpy=False))
                _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            if k == 0:
                after = {p: scope.find_var(p).clone() for p in params}
        watch = {"collective_ms": getattr(clock, "seconds", 0.0) * 1e3,
                 "collective_calls": getattr(clock, "calls", 0),
                 "collective_bytes": getattr(clock, "bytes", 0),
                 "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                             if torch.device(device).type == "cuda" else None)}
        held = sum(scope.find_var(n).numel() * 4 for n in moments)
        runs[red] = {"after": after, "moments": outs[0][1:], "held": held,
                     "watch": watch,
                     "ms": ms, "losses": [float(o[0]) for o in outs],
                     "shards": sorted({scope.row_shards(n) for n in moments}),
                     "replicas_differ": _pdp_replicas_differ(
                         scope, [n for n in m.names
                                 if scope.row_shards(n) == 1])}
        del exe, scope, outs
    ar, kr = runs[False], runs[True]
    n_p = len(params)
    whole = sum(t.numel() * 4 for t in ar["moments"])
    ratio = _pdm_lamb_bound(
        [init[p] for p in params], [ar["after"][p] for p in params],
        [kr["after"][p] for p in params], ar["moments"][:n_p],
        ar["moments"][n_p:], [init[p + "_beta1_pow_acc_0"] for p in params],
        [init[p + "_beta2_pow_acc_0"] for p in params], args["enc"].lr)
    bits = sum(not _same_tensor_bits(ar["after"][p], kr["after"][p])
               for p in params)
    return {"model": "enc_lamb", "losses_allreduce": ar["losses"],
            "losses_kreduce": kr["losses"], "ms_allreduce": ar["ms"],
            "ms_kreduce": kr["ms"], "kreduce_second_step_watched":
                kr["watch"], "peak_gb_allreduce": ar["watch"]["peak_gb"],
            "params_max_err_over_bound": ratio,
            "params_not_bit_for_bit": bits, "params": len(params),
            "moment_bytes_a_rank_kreduce": kr["held"],
            "moment_bytes_a_rank_allreduce": ar["held"],
            "moment_bytes_whole": whole, "row_shards": kr["shards"],
            "replicas_differ": ar["replicas_differ"] + kr["replicas_differ"]}


def _pdm_rank(rank, world, endpoint, results, args):
    """One rank of phase 53, in a spawned process: ``fleet.init()`` with
    gloo (both ranks on card 0), then the CTR program, the CRNN-CTC, LAC,
    the py_reader program and the LAMB encoder."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TRAINER_ENDPOINTS": endpoint,
        "PADDLE_CURRENT_ENDPOINT": endpoint, "PADDLE_DISTRI_BACKEND": "gloo",
        "FLAGS_selected_gpus": "0", "PADDLE_TPU_SEGMENT_KERNEL": "1",
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    _pdm_deterministic()
    device = fleet.init(
        device=None if args["device"] == "cuda" else args["device"]).device
    try:
        res = {"rank": rank, "backend": dist.get_backend(), "models": []}
        for kind in ("ctr", "crnn", "lac"):
            res["models"].append(_pdm_model(kind, rank, world, device, args,
                                            args["files"]))
        res["reader"] = _pdm_reader(rank, world, device, args)
        res["lamb"] = _pdm_lamb(rank, world, device, args)
        results.put(res)
    finally:
        dist.destroy_process_group()


def _pdm_verdict(got, world, one_rank_bytes, on_card):
    """The problems in the ranks' records (the segment kernel launches only
    on the card)."""
    bad = []
    for rank in range(world):
        res = got[rank]
        for rec in res["models"]:
            if rec["replicas_differ"]:
                bad.append("rank %d %s replicas %s" % (
                    rank, rec["model"], rec["replicas_differ"][:3]))
            if not all(math.isfinite(x) for x in rec["losses"]):
                bad.append("rank %d %s losses %s" % (rank, rec["model"],
                                                     rec["losses"]))
            # the CTR program and LAC merge their is_sparse tables' rows
            # through the segment kernel; nothing else launches a port kernel
            sparse = rec["model"] in ("ctr", "lac")
            moved = {k: c for k, c in rec["launches_per_step"].items()
                     if not (sparse and k == "segment_sum")}
            if moved or (on_card and sparse and rec["launches_per_step"].get(
                    "segment_sum", 0) < 1):
                bad.append("rank %d %s launches %s" % (
                    rank, rec["model"], rec["launches_per_step"]))
            if rec["model"] == "ctr" and any(
                    b * world != one_rank_bytes
                    for b in rec["h2d_bytes_each_step"]):
                bad.append("rank %d staged %s bytes a step, one rank %s"
                           % (rank, rec["h2d_bytes_each_step"],
                              one_rank_bytes))
        rd, lb = res["reader"], res["lamb"]
        if not rd["bit_for_bit"] or rd["steps"] != PDM_STEPS or \
                rd["replicas_differ"]:
            bad.append("rank %d py_reader %s" % (rank, rd))
        if not (lb["params_max_err_over_bound"] <= 1
                and lb["moment_bytes_a_rank_kreduce"] * world
                == lb["moment_bytes_whole"] == lb["moment_bytes_a_rank_allreduce"]
                and lb["row_shards"] == [world] and not lb["replicas_differ"]):
            bad.append("rank %d LAMB kReduce %s" % (rank, lb))
    for rec in got[0]["models"]:
        kind = rec["model"]
        if rec["loss_bound"]["err_over_bound"] > 1:
            bad.append("%s loss %s" % (kind, rec["loss_bound"]))
        if kind == "ctr" and not rec["auc_stats_equal"]:
            bad.append("ctr AUC counts differ from one rank's")
        if kind == "crnn" and not (rec["edit_counts_equal"] and
                                   rec["sequence_num"][0]
                                   == rec["sequence_num"][1]):
            bad.append("crnn edit counts %s %s" % (rec["edit_counts_equal"],
                                                   rec["sequence_num"]))
        if kind == "lac" and rec["chunk_counts"][0] != rec["chunk_counts"][1]:
            bad.append("lac chunk counts %s" % rec["chunk_counts"])
        if "grad" in rec:
            sticks = [rec[k] for k in ("yardstick_grad", "split_yardstick_grad",
                                       "formula_yardstick_grad",
                                       "batch_yardstick_grad") if k in rec]
            yard = {w: max(y[w] for y in sticks)
                    for w in ("grad_rel_l2_median", "grad_rel_l2_max")}
            held = [("grad", w, yard[w]) for w in yard]
            if "f64_grad" in rec:
                # the CRNN's largest leaf against float64 (see _pdm_model)
                held = [("grad", "grad_rel_l2_median",
                         yard["grad_rel_l2_median"])] + [
                    ("f64_grad", w, rec["f64_yardstick_grad"][w])
                    for w in ("grad_rel_l2_median", "grad_rel_l2_max")]
            for key, w, y in held:
                if not rec[key][w] <= PDP_GRAD_LIMIT * y:
                    bad.append("%s %s %s %s over %s x %s" % (
                        kind, key, w, rec[key][w], PDP_GRAD_LIMIT, y))
            ctl = rec["control_own_rows_grad"]["grad_rel_l2_median"]
            if not ctl > PDP_GRAD_LIMIT * yard["grad_rel_l2_median"]:
                bad.append("%s control (a rank's own rows) %s within %s x %s"
                           % (kind, ctl, PDP_GRAD_LIMIT,
                              yard["grad_rel_l2_median"]))
    return bad


def phase_program_dp_more_two_ranks(device_name, card, one_rank_bytes,
                                    device="cuda", args=None):
    """Phase 53, second part: two ranks on the one card over gloo, each a
    spawned process joining through ``fleet.init()``, every program under
    ``fleet.distributed_optimizer`` for PDM_STEPS steps:

    - the CTR program through ``train_from_dataset`` (the feed pipe on):
      each rank stages half the batch's bytes (``one_rank_bytes`` a step at
      one rank); the first step's loss within the derived bound of the
      one-rank step's, the AUC's counts equal to the one-rank run's; the
      segment kernel launched on the sparse merge;
    - the CRNN-CTC (16 a rank) and LAC (150 a rank): the first loss within
      its derived bound, the edit distances' integer counts and
      ``SequenceNum`` / ``chunk_eval``'s three counts equal to the one-rank
      run's, the gradient within PDP_GRAD_LIMIT of the largest yardstick (a
      row permutation; for LAC the ranks' row blocks run in turn; for the
      CRNN, whose batch norms a block would change, the data-parallel
      variance formula and the batch twice over) while rank 0's own rows'
      gradient lands outside;
    - a py_reader-fed MLP bit for bit the same program fed by dicts;
    - the LAMB encoder (8 a rank): kReduce's parameters after one step
      within the bound of the trust ratio's reassociated norms of
      AllReduce's, its moments at half their bytes a rank;

    every replica bit for bit, no port kernel launched but the segment
    kernel (the CTR program's and LAC's sparse merges).  Returns each
    rank's launches a step, by program."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    endpoint = "127.0.0.1:%d" % _free_port()
    args = dict(args or _pdm_args(), device=device)
    args["files"] = _pdm_files(args)
    procs = [ctx.Process(target=_pdm_rank, args=(r, DP_WORLD, endpoint,
                                                 results, args))
             for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + PDM_TIMEOUT_S
        while len(got) < DP_WORLD:
            try:
                res = results.get(timeout=5)
                got[res["rank"]] = res
            except queue.Empty:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    raise AssertionError("phase 53: a rank failed, exit codes "
                                         "%s" % codes)
                if time.monotonic() > deadline:
                    raise AssertionError("phase 53: no result in %d s"
                                         % PDM_TIMEOUT_S)
        for p in procs:
            p.join(120)
        codes = [p.exitcode for p in procs]
        if codes != [0] * DP_WORLD:
            raise AssertionError("phase 53: exit codes %s" % codes)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    bad = _pdm_verdict(got, DP_WORLD, one_rank_bytes, device == "cuda")
    for rank in range(DP_WORLD):
        for rec in got[rank]["models"]:
            emit({"phase": "program_dp_more_two_ranks", "rank": rank,
                  "world": DP_WORLD, "backend": got[rank]["backend"], **rec})
        emit({"phase": "program_dp_more_two_ranks", "rank": rank,
              "model": "py_reader MLP", **got[rank]["reader"]})
        emit({"phase": "program_dp_more_two_ranks", "rank": rank,
              **got[rank]["lamb"]})
    ok = not bad
    emit({"phase": "program_dp_more_two_ranks", "nvidia_smi": card, "ok": ok,
          "seconds": time.perf_counter() - t0, "problems": bad[:20]})
    if not ok:
        raise AssertionError("phase 53: %s" % bad[:20])
    return {rank: {r["model"]: r["launches_per_step"]
                   for r in got[rank]["models"]} for rank in got}


# -- item 5-C part 1: tensor, ring and pipeline parallelism, MoE (phase 54) ---

MP_WORLD = 2                  # two gloo ranks sharing the one card
MP_BATCH = 16                 # BERT-base's global batch (bench.py's 64, cut)
MP_STEPS = 2
MP_LR = 1e-4
MP_MICROBATCHES = 4
MP_TIMEOUT_S = 900
MP_GRAD_LIMIT = DP_F32_LIMIT  # yardsticks, as phases 51-52
# each mode's config and the LN / flash launches a rank a step (rows 1-6):
# at pp every stage runs its 6 layers at each of T = M + S - 1 = 5 ticks,
# the bubble ticks included, forward and backward
MP_MODES = {
    "tp_heads": (dict(tp=2), PER_STEP),
    "tp_ring": (dict(tp=2, attn_mode="ring"),
                {"layer_norm_fwd": 24, "layer_norm_bwd": 24}),
    "pp": (dict(pp=2), {"layer_norm_fwd": 60, "layer_norm_bwd": 60,
                        "flash_attention_fwd": 30, "flash_attention_bwd": 30}),
}
# phase 54's MoE: E, F, experts, tokens a rank (bf16), capacity factor 1.25
MOE = dict(hidden=768, ffn=3072, experts=8, tokens=8192)
# the program pipelined at one rank: an MLP (784 -> 512 -> 512 -> 1) of B
# rows, cut after each hidden layer
PIPE = dict(width=784, hidden=512, batch=256, microbatches=4, steps=2)
GELU_D1, GELU_D2 = 1.13, 0.80     # max |gelu'| and |gelu''| (tanh form)


def _mesh_specs_replicated(specs, axis):
    """Per leaf, whether its spec leaves ``axis`` unsplit."""
    from paddle_tpu_torch._tree import tree_leaves
    from paddle_tpu_torch.parallel.train import _spec_axes

    return [axis not in {a for _, a in _spec_axes(s)}
            for s in tree_leaves(specs)]


def _attention_bound(q, k, v, n_heads):
    """The float64 attention of packed q, k, v ([B, S, H*D], bf16) and a
    bound on the distance from it of any computation that takes the scores
    in f32 from the bf16 operands (an f32 sum of D products), the
    probabilities exp(s - m) in f32 (a subtraction and an exp of 2 ulps, a
    rescale of 4 roundings for each of the S/64 key blocks of an online
    softmax), rounds them to bf16 for the product with v (f32 sums of S
    terms), divides by the f32 sum of the unrounded ones and rounds the
    result to bf16: the flash kernels' and ``ring_attention``'s
    arithmetic.  Returns (the float64 output, the bound), [B, S, H*D]."""
    from paddle_tpu_torch.tools import fp_bounds

    B, S, HD = q.shape
    D = HD // n_heads
    u32, ub = fp_bounds.U32, U_BF16

    def heads(t):
        return t.double().reshape(B, S, n_heads, D).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    scale = 1.0 / math.sqrt(D)
    s = qh @ kh.transpose(-1, -2) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    del s
    delta = (float(fp_bounds.gamma(D)) * scale) * (
        qh.abs() @ kh.abs().transpose(-1, -2))
    eps = (torch.expm1(delta) + 3 * u32 * (1 + torch.log(
        p.clamp_min(1e-300)).abs()) + (S / 64) * 4 * u32)
    del delta
    l = p.sum(-1, keepdim=True)
    o = (p @ vh) / l
    pv = (p @ vh.abs()) / l
    pev = ((p * eps) @ vh.abs()) / l
    pe = (p * eps).sum(-1, keepdim=True) / l
    del p, eps
    gs = float(fp_bounds.gamma(S))
    num = (ub * pv + (1 + ub) * pev + gs * (1 + ub) * (pv + pev)
           + o.abs() * (pe + gs * (1 + pe)))
    bound = num / (1 - pe - gs) + (ub + 2 * u32) * (o.abs() + num)

    def packed(t):
        return t.transpose(1, 2).reshape(B, S, HD)

    return packed(o), packed(bound)


class _FlashCapture:
    """Records the packed q, k, v, head count and output of every
    ``flash_attention_packed`` call the transformer makes in the block."""

    def __enter__(self):
        from paddle_tpu_torch.parallel import transformer as T

        self.calls, self._flash = [], T.flash_attention_packed

        def site(q, k, v, n_heads, causal=False, scale=None):
            o = self._flash(q, k, v, n_heads, causal=causal, scale=scale)
            self.calls.append((q.detach(), k.detach(), v.detach(), n_heads,
                               o.detach()))
            return o

        T.flash_attention_packed = site
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.parallel import transformer as T

        T.flash_attention_packed = self._flash
        return False


def _loss_yardstick(loss, loss_perm, loss_f32):
    """The loss's yardstick, as the gradients': the larger of how far the
    same step moves on the batch's rows permuted and in f32."""
    return max(abs(loss_perm - loss), abs(loss_f32 - loss))


def _mp_bert_one_rank(params, batch, cfg1):
    """The one-rank step's loss and gradients (bf16, tp = pp = 1) from the
    global params, and the yardsticks of both: the same step on the batch's
    rows reversed (a row permutation) and in f32 from the same values (the
    arithmetic's precision)."""
    import dataclasses

    from paddle_tpu_torch._tree import tree_leaves, tree_map
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.train import grads_of

    loss_fn = bert.make_loss_fn(cfg1)
    loss, g1 = grads_of(loss_fn, _clone(params), batch)
    out = {"loss": float(loss.detach()), "grads": tree_leaves(g1)}
    perm = {k: v.flip(0) for k, v in batch.items()}
    lp, gp = grads_of(loss_fn, _clone(params), perm)
    out["perm"], out["loss_perm"] = tree_leaves(gp), float(lp.detach())
    del gp
    cfg32 = dataclasses.replace(cfg1, dtype="float32")
    l32, g32 = grads_of(bert.make_loss_fn(cfg32),
                        tree_map(lambda t: t.detach().float(), params), batch)
    out["f32"], out["loss_f32"] = tree_leaves(g32), float(l32.detach())
    return out


def _mp_bert(rank, world, device, args, mode):
    """BERT-base at one of ``MP_MODES`` over the two ranks: MP_STEPS checked
    steps and one untapped."""
    import torch.distributed as dist

    from paddle_tpu_torch._tree import tree_leaves
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import MeshSpec, optim
    from paddle_tpu_torch.parallel import collectives as col
    from paddle_tpu_torch.parallel.rules import leaf_paths
    from paddle_tpu_torch.parallel.train import gather_pytree
    from paddle_tpu_torch.parallel.transformer import transformer_param_specs

    kw, _ = MP_MODES[mode]
    cfg = bert.bert_base_config(**{**args["bert_kw"], **kw})
    mb = MP_MICROBATCHES if cfg.pp > 1 else 1
    init, update = optim.lamb()
    seen = []

    def recording(grads, state, params, lr):       # the reduced gradients
        seen.append([g.detach().clone() for g in tree_leaves(grads)])
        return update(grads, state, params, lr)

    tr = bert.build_bert_trainer(cfg, MeshSpec(tp=cfg.tp, pp=cfg.pp),
                                 optimizer=(init, recording),
                                 n_microbatches=mb, seed=0, device=device)
    axis = "tp" if cfg.tp > 1 else "pp"
    group = tr.mesh.groups[axis]
    pspecs = transformer_param_specs(cfg)
    replicated = _mesh_specs_replicated(pspecs, axis)
    params = tr.state["params"]
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in bert.synthetic_batches(cfg, MP_STEPS + 1,
                                               args["batch"], args["seq"])]
    probe = tree_leaves(params)[0]
    steps, peak = [], 0
    for i, b in enumerate(batches[:MP_STEPS]):
        p0 = [t.detach().clone() for t in tree_leaves(params)]
        m0 = [t.detach().clone() for t in tree_leaves(tr.state["opt"]["m"])]
        v0 = [t.detach().clone() for t in tree_leaves(tr.state["opt"]["v"])]
        step0 = int(tr.state["opt"]["step"])
        seen.clear()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _common.reset_launches()
        with _DpWatch(device) as w:
            _sync(device)
            t0 = time.perf_counter()
            loss = tr.step(b, MP_LR)
            _sync(device)
            dt = time.perf_counter() - t0
        rec = {"step": i, "loss": float(loss), "ms": dt * 1e3,
               "collective_ms": w.seconds * 1e3, "collective_calls": w.calls,
               "collective_bytes": w.bytes, "launches": dict(_common.launches)}
        if device.type == "cuda":
            peak = max(peak, torch.cuda.max_memory_allocated())
        rec["taps"] = _check_taps(w.taps, rank, world)
        del w
        # the leaves the axis replicates, and their moments, alike bit for bit
        trees = (params, tr.state["opt"]["m"], tr.state["opt"]["v"])
        leaves = [t for tree in trees
                  for t, r in zip(tree_leaves(tree), replicated) if r]
        rec["replicas_differ"] = sum(
            not _same_tensor_bits(*col.backend_all_gather(
                t.reshape(1, -1), group, 0).unbind(0)) for t in leaves)
        # LAMB replayed on the reduced gradient: the moments and parameters
        pr = [t.clone() for t in p0]
        st = {"m": [t.clone() for t in m0], "v": [t.clone() for t in v0],
              "step": torch.tensor(step0, dtype=torch.int32, device=device)}
        update(seen[0], st, pr, MP_LR)
        rec["moments_bit_for_bit"] = all(
            _same_tensor_bits(a, c) for a, c in zip(
                st["m"] + st["v"], tree_leaves(tr.state["opt"]["m"])
                + tree_leaves(tr.state["opt"]["v"])))
        rec["params_bit_for_bit"] = all(
            _same_tensor_bits(a, c) for a, c in zip(pr, tree_leaves(params)))
        del pr, st, m0, v0
        if i == 0:
            g_glob = tree_leaves(gather_pytree(_like(params, seen[0]), pspecs,
                                               tr.mesh))
            p_glob = gather_pytree(_like(params, p0), pspecs, tr.mesh)
            if rank == 0:
                cfg1 = bert.bert_base_config(**args["bert_kw"])
                p1 = dict(p_glob)
                p1["params_layers"] = {     # [pp, L/pp, ...] -> [L, ...]
                    k: v.reshape((cfg1.n_layers,) + tuple(
                        v.shape[2:] if cfg.pp > 1 else v.shape[1:]))
                    for k, v in p_glob["params_layers"].items()}
                one = _mp_bert_one_rank(p1, b, cfg1)
                names = leaf_paths(p1)[0]
                g_glob = [g.reshape(o.shape)
                          for g, o in zip(g_glob, one["grads"])]
                rec["loss_one_rank"] = one["loss"]
                rec["loss_err"] = abs(float(loss) - one["loss"])
                rec["loss_yardstick"] = _loss_yardstick(
                    one["loss"], one["loss_perm"], one["loss_f32"])
                rec["loss_yardstick_perm"] = abs(one["loss_perm"]
                                                 - one["loss"])
                rec["loss_yardstick_f32"] = abs(one["loss_f32"] - one["loss"])
                rec["grad"] = _grad_gap(g_glob, one["grads"], world, names)
                for k in ("perm", "f32"):
                    rec["yardstick_" + k] = _grad_gap(one[k], one["grads"], 1,
                                                      names)
                del one, p1
            del g_glob, p_glob
        del p0
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        steps.append(rec)
    seen.clear()
    untapped = _untapped_steps(tr, batches[MP_STEPS:], MP_LR, device)
    route = col.permute_route(probe, group)
    del tr
    return {"steps": steps, "peak_memory_allocated": peak,
            "untapped": untapped, "permute_route": route}


def _moe_routing(x, router, n_experts, cf=1.25):
    """moe_ffn's routing of ``x``: each token's expert, gate and whether it
    is kept (the capacity's queue), as ``parallel/moe.py`` computes them."""
    import torch.nn.functional as F

    T = x.shape[0]
    probs = torch.softmax(x.float() @ router, dim=-1)
    gate, expert = probs.amax(-1), probs.argmax(-1)
    cap = int(max(1, round(T * cf / n_experts)))
    onehot = F.one_hot(expert, n_experts)
    pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    return expert, gate, probs, (pos >= 0) & (pos < cap)


def _moe_bounds(x, params, cot, ref):
    """Per element, bounds on the distance between two computations of
    ``moe_ffn`` of the same tokens and experts whose bf16 matrix products
    (f32 sums) split their sums another way: each product within u |C| +
    gamma(k) |A| |B| of the exact one, GELU within u |g| + 16 u32 (|g| +
    |h|) after a Lipschitz step of max |gelu'| (1.13; its gradient's
    max |gelu''| 0.80), the gate's f32 product exact-shaped (the router's
    product has the same shape both ways).  ``ref``: the reference run's
    outputs and gradients, where the bound is applied.  Returns bounds on
    y, dx, dw1, dw2 and drouter, shaped like them."""
    import torch.nn.functional as F

    from paddle_tpu_torch.tools import fp_bounds

    ub, u32 = U_BF16, fp_bounds.U32
    g_ = lambda k: float(fp_bounds.gamma(k))          # noqa: E731
    w1, w2, router = params["w1"], params["w2"], params["router"]
    nE, E, Fh = w1.shape
    T = x.shape[0]
    expert, gate, probs, keep = _moe_routing(x, router, nE)
    by = torch.zeros(T, E, device=x.device)
    bdx = torch.zeros(T, E, device=x.device)
    bw1 = torch.zeros(nE, E, Fh, device=x.device)
    bw2 = torch.zeros(nE, Fh, E, device=x.device)
    bgate = torch.zeros(T, device=x.device)
    gmag = torch.zeros(T, device=x.device)
    rows_max = 2 * int(max(1, round(T * 1.25 / nE)))
    for e in range(nE):
        idx = torch.nonzero((expert == e) & keep)[:, 0]
        if not idx.numel():
            continue
        xe = x[idx].float()
        h = torch.bmm(x[idx][None], w1[e][None])[0].float()
        g = F.gelu(h, approximate="tanh").to(torch.bfloat16).float()
        y = (torch.bmm(g.to(torch.bfloat16)[None], w2[e][None])[0]).float()
        a1 = xe.abs() @ w1[e].float().abs()
        eh = (2 * g_(E) * a1 + 2 * ub * h.abs()) / (1 - ub)
        eg = GELU_D1 * eh + (2 * ub * g.abs()
                             + 16 * u32 * (g.abs() + h.abs())) / (1 - ub)
        a2 = (g.abs() + eg) @ w2[e].float().abs()
        ey = eg @ w2[e].float().abs() + (
            2 * g_(Fh) * a2 + 2 * ub * y.abs()) / (1 - ub)
        ge = gate[idx][:, None]
        out = (y * ge).to(torch.bfloat16).float()
        by[idx] = ge * ey + (2 * ub * out.abs()) / (1 - ub)
        c = cot[idx].float()
        bgate[idx] = (c.abs() * ey).sum(-1)
        gmag[idx] = (c.abs() * y.abs()).sum(-1)
        dy = (c * ge).to(torch.bfloat16).float()        # the same both ways
        dg = (dy @ w2[e].float().t()).to(torch.bfloat16).float()
        edg = (2 * g_(E) * (dy.abs() @ w2[e].float().abs().t())
               + 2 * ub * dg.abs()) / (1 - ub)
        d1 = torch.autograd.functional.vjp(
            lambda t: F.gelu(t, approximate="tanh"), h, dg)[1]
        edh = GELU_D2 * eh * (dg.abs() + edg) + GELU_D1 * edg + (
            2 * ub * d1.abs() + 16 * u32 * (d1.abs() + dg.abs())) / (1 - ub)
        dh = d1
        dxe = dh @ w1[e].float().t()
        bdx[idx] = edh @ w1[e].float().abs().t() + (
            2 * g_(Fh) * ((dh.abs() + edh) @ w1[e].float().abs().t())
            + 2 * ub * dxe.abs()) / (1 - ub)
        xt = xe.abs().t()
        bw1[e] = xt @ edh + (2 * g_(rows_max) * (xt @ (dh.abs() + edh))
                             + 3 * ub * (xt @ dh.abs())) / (1 - ub)
        bw2[e] = eg.t() @ dy.abs() + (
            2 * g_(rows_max) * ((g.abs() + eg).t() @ dy.abs())
            + 3 * ub * (g.abs().t() @ dy.abs())) / (1 - ub)
    # the router: the gate's gradient through amax and softmax (d_logits =
    # p (onehot - p_e) dgate, within p (onehot + p_e) of it per unit of
    # dgate), then an f32 product over the tokens, the ranks' added
    spread = probs * (F.one_hot(expert, nE) + probs.gather(1, expert[:, None]))
    blog, mlog = spread * bgate[:, None], spread * gmag[:, None]
    xa = x.float().abs().t()
    brouter = xa @ blog + 2 * g_(T) * (xa @ (mlog + blog)) \
        + 2 * u32 * ref["drouter"].abs()
    return {"y": by, "dx": bdx, "dw1": bw1, "dw2": bw2, "drouter": brouter}


def _mp_moe(rank, world, device, args):
    """``moe_ffn`` with its 8 experts over dp = 2 (4 a rank), 8192 bf16
    tokens a rank, forward and backward of a seeded cotangent, the
    router's gradient psum'd over the ranks; against the same tokens
    through one rank holding all 8 experts (each rank's tokens in a call of
    their own, which routes them as the rank did), bit for bit where the
    products split their sums alike and otherwise within ``_moe_bounds``."""
    import torch.distributed as dist

    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.parallel import collectives as col
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel.moe import init_moe_params, moe_ffn

    m = args["moe"]
    nE, E, Fh, T = m["experts"], m["hidden"], m["ffn"], m["tokens"]
    full = init_moe_params(torch.Generator().manual_seed(0), nE, E, Fh,
                           dtype=torch.bfloat16, device=device)
    gen = torch.Generator().manual_seed(1)
    xs = torch.randn(world, T, E, generator=gen).to(torch.bfloat16).to(device)
    cots = torch.randn(world, T, E, generator=gen).to(torch.bfloat16).to(
        device)
    nl = nE // world
    local = {"router": full["router"].clone(),
             "w1": full["w1"][rank * nl:(rank + 1) * nl].clone(),
             "w2": full["w2"][rank * nl:(rank + 1) * nl].clone()}
    x = xs[rank].clone()
    leaves = [x] + [local[k] for k in ("router", "w1", "w2")]
    for t in leaves:
        t.requires_grad_(True)
    _common.reset_launches()
    with make_mesh(dp=world, device=device) as mesh, _DpWatch(device) as w:
        _sync(device)
        t0 = time.perf_counter()
        y = moe_ffn(local, x)
        grads = torch.autograd.grad((y.float() * cots[rank].float()).sum(),
                                    leaves)
        drouter = col.psum(grads[1], "dp")
        _sync(device)
        dt = time.perf_counter() - t0
    rec = {"ms_fwd_bwd": dt * 1e3, "collective_ms": w.seconds * 1e3,
           "collective_calls": w.calls, "collective_bytes": w.bytes,
           "launches": {k: n for k, n in _common.launches.items() if n},
           "dropped_tokens": int((~y.detach().any(-1)).sum())}
    del w
    group = mesh.groups["dp"]
    got = {"y": col.backend_all_gather(y.detach()[None], group, 0),
           "dx": col.backend_all_gather(grads[0][None], group, 0),
           "dw1": col.backend_all_gather(grads[2], group, 0),
           "dw2": col.backend_all_gather(grads[3], group, 0),
           "drouter": drouter}
    if rank == 0:
        ref_leaves = [full[k].detach().clone().requires_grad_(True)
                      for k in ("router", "w1", "w2")]
        ref_p = dict(zip(("router", "w1", "w2"), ref_leaves))
        ys, dxs, acc = [], [], None
        for r in range(world):
            xr = xs[r].clone().requires_grad_(True)
            yr = moe_ffn(ref_p, xr)
            gr = torch.autograd.grad((yr.float() * cots[r].float()).sum(),
                                     [xr] + ref_leaves)
            ys.append(yr.detach())
            dxs.append(gr[0])
            acc = (list(gr[1:]) if acc is None
                   else [a + b for a, b in zip(acc, gr[1:])])
        want = {"y": torch.stack(ys), "dx": torch.stack(dxs),
                "drouter": acc[0], "dw1": acc[1], "dw2": acc[2]}
        rec["bit_for_bit"] = {k: _same_tensor_bits(got[k], want[k])
                              for k in want}
        bounds = {}
        for r in range(world):
            bd = _moe_bounds(xs[r], full, cots[r],
                             {"drouter": want["drouter"]})
            for k, v in bd.items():
                if k in ("y", "dx"):
                    bounds.setdefault(k, []).append(v)
                else:
                    bounds[k] = v if k not in bounds else bounds[k] + v
        for k in ("y", "dx"):
            bounds[k] = torch.stack(bounds[k])
        rec["err_over_bound"] = {}
        for k in want:
            err = (got[k].double() - want[k].double()).abs()
            b_ = bounds[k].double()
            zero = b_ == 0
            bad_exact = int((zero & (err > 0)).sum())
            ratio = float(torch.where(zero, torch.zeros_like(err),
                                      err / b_).max())
            rec["err_over_bound"][k] = ratio if not bad_exact else float("inf")
            rec.setdefault("max_abs_err", {})[k] = float(err.max())
        del bounds, want
    del got, grads, y, xs, cots, full, local
    if device.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    return rec


def _mp_rank(rank, world, endpoint, results, args):
    """One rank of phase 54, in a spawned process: ``fleet.init()`` from a
    launcher's PADDLE_* env with ``PADDLE_DISTRI_BACKEND=gloo`` (both ranks
    on card 0), then BERT-base at each of ``MP_MODES`` and the MoE; its
    records go on ``results``.  An exception fails the process, whose exit
    code the parent reads."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TRAINER_ENDPOINTS": endpoint,
        "PADDLE_CURRENT_ENDPOINT": endpoint, "PADDLE_DISTRI_BACKEND": "gloo",
        "FLAGS_selected_gpus": "0"})
    device = fleet.init(
        device=None if args["device"] == "cuda" else args["device"]).device
    try:
        res = {"rank": rank, "backend": dist.get_backend()}
        for mode in MP_MODES:
            res[mode] = _mp_bert(rank, world, device, args, mode)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        res["moe"] = _mp_moe(rank, world, device, args)
        results.put(res)
    finally:
        dist.destroy_process_group()


def _mp_verdict(got, world, on_card):
    """The problems in the ranks' records."""
    bad = []
    for rank in range(world):
        res = got[rank]
        for mode, (_, want) in MP_MODES.items():
            for st in res[mode]["steps"]:
                where = "rank %d %s step %d" % (rank, mode, st["step"])
                if st["taps"]["differ"] or st["replicas_differ"]:
                    bad.append("%s: taps %s, replicas %s" % (
                        where, st["taps"], st["replicas_differ"]))
                if not (st["moments_bit_for_bit"]
                        and st["params_bit_for_bit"]):
                    bad.append("%s: LAMB replay" % where)
                if on_card and st["launches"] != {
                        k: want.get(k, 0) for k in st["launches"]}:
                    bad.append("%s launches %s" % (where, st["launches"]))
                if not math.isfinite(st["loss"]):
                    bad.append("%s loss %s" % (where, st["loss"]))
                if "loss_yardstick" in st:
                    if not st["loss_err"] <= MP_GRAD_LIMIT * st[
                            "loss_yardstick"]:
                        bad.append("%s loss %s over %s x %s against one "
                                   "rank's" % (where, st["loss_err"],
                                               MP_GRAD_LIMIT,
                                               st["loss_yardstick"]))
                    for what in ("grad_rel_l2_median", "grad_rel_l2_max"):
                        yard = max(st["yardstick_perm"][what],
                                   st["yardstick_f32"][what])
                        if not st["grad"][what] <= MP_GRAD_LIMIT * yard:
                            bad.append("%s gradient %s %s over %s x %s" % (
                                where, what, st["grad"][what], MP_GRAD_LIMIT,
                                yard))
                    scale = st["grad"]["grad_norm_ratio_median"]
                    if abs(scale - world) > 0.05 * world:
                        bad.append("%s gradient scale %s, not %d" % (
                            where, scale, world))
            for un in res[mode]["untapped"]:
                if (on_card and un["launches"] != {
                        k: want.get(k, 0) for k in un["launches"]}) \
                        or not math.isfinite(un["loss"]):
                    bad.append("rank %d %s untapped step %s"
                               % (rank, mode, un))
        moe = res["moe"]
        if on_card and moe["launches"]:
            bad.append("rank %d MoE launched %s" % (rank, moe["launches"]))
        if rank == 0:
            for k, r in moe["err_over_bound"].items():
                if not (moe["bit_for_bit"][k] or r <= 1):
                    bad.append("MoE %s: err/bound %s" % (k, r))
    return bad


def phase_model_parallel_two_ranks(device_name, card, device="cuda",
                                   args=None):
    """Phase 54: tensor, ring and pipeline parallelism and expert-parallel
    MoE over two ranks on the one card, gloo over CUDA tensors (NCCL
    refuses two ranks on one device), each a spawned process that joins
    through ``fleet.init()``.  BERT-base (bf16, 12 x 768, S = 512, LAMB,
    global B = 16) MP_STEPS steps at each of ``MP_MODES``: tp = 2 heads
    (Megatron-SP: 6 heads and S/2 = 256 a rank, vocab 15264 a rank), tp = 2
    ring (K/V shifted around the two ranks, attention on eager ops) and
    pp = 2 (6 layers a stage, 4 microbatches, 5 ticks).  After every step:
    the leaves the axis replicates (and their moments) bit for bit alike on
    both ranks; every reduced value (each psum and reduce-scatter the
    backend ran) the card's sum of the ranks' values, bit for bit; LAMB's
    moments and parameters bit for bit a replay of the optimizer on the
    reduced gradient.  After the first: the loss within MP_GRAD_LIMIT
    yardsticks (``_loss_yardstick``) of the one-rank step's loss on the
    same batch and state, and the gathered gradient over 2 (the reference's factor:
    psum's transpose is psum) within MP_GRAD_LIMIT yardsticks of the
    one-rank gradient (the larger of a row permutation's distance and of
    the f32 step's), its scale 2.  Then one untapped step.  Then MoE
    (``_mp_moe``).  Reports ms a step, collective ms, calls and bytes, peak
    memory and LN / flash launches a rank a step (``MP_MODES``' counts on
    the card), and the shift's route.  Returns the launches a rank a step,
    by mode."""
    import multiprocessing as mp
    import queue

    args = args or _mp_args()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    endpoint = "127.0.0.1:%d" % _free_port()
    args = dict(args, device=device)
    procs = [ctx.Process(target=_mp_rank,
                         args=(r, MP_WORLD, endpoint, results, args))
             for r in range(MP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + MP_TIMEOUT_S
        while len(got) < MP_WORLD:
            try:
                res = results.get(timeout=5)
                got[res["rank"]] = res
            except queue.Empty:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    raise AssertionError("phase 54: a rank failed, exit codes "
                                         "%s" % codes)
                if time.monotonic() > deadline:
                    raise AssertionError("phase 54: no result in %d s"
                                         % MP_TIMEOUT_S)
        for p in procs:
            p.join(120)
        codes = [p.exitcode for p in procs]
        if codes != [0] * MP_WORLD:
            raise AssertionError("phase 54: exit codes %s" % codes)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    on_card = torch.device(device).type == "cuda"
    bad = _mp_verdict(got, MP_WORLD, on_card)
    for rank in range(MP_WORLD):
        for mode in MP_MODES:
            r = got[rank][mode]
            emit({"phase": "model_parallel_two_ranks", "mode": mode,
                  "rank": rank, "world": MP_WORLD,
                  "backend": got[rank]["backend"],
                  "permute_route": r["permute_route"],
                  "peak_memory_allocated": r["peak_memory_allocated"],
                  "steps": r["steps"], "untapped_steps": r["untapped"]})
        emit({"phase": "model_parallel_two_ranks", "mode": "moe_ep2",
              "rank": rank, **got[rank]["moe"]})
    ok = not bad
    emit({"phase": "model_parallel_two_ranks", "nvidia_smi": card, "ok": ok,
          "seconds": time.perf_counter() - t0, "problems": bad[:20]})
    if not ok:
        raise AssertionError("phase 54: %s" % bad[:20])
    return {m: got[0][m]["steps"][-1]["launches"] for m in MP_MODES}


def _mp_args(small=False):
    """Phase 54's sizes: BERT-base at S = 512, global B = 16, and MoE as
    ``MOE``; ``small`` for a rehearsal on the CPU."""
    if small:
        return {"bert_kw": dict(vocab_size=512, hidden=64, n_layers=4,
                                n_heads=4, ffn_hidden=128, max_seq=32,
                                dtype="float32"),
                "batch": 4, "seq": 32,
                "moe": dict(hidden=16, ffn=32, experts=8, tokens=64)}
    return {"bert_kw": {}, "batch": MP_BATCH, "seq": S, "moe": dict(MOE)}


def _pipe_program(fluid, pipelined):
    """The MLP ``PIPE`` names (tanh, so that no selection depends on a
    rounding), a mean squared error, SGD; pipelined, cut after each hidden
    layer into 3 sections over PIPE["microbatches"]."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[PIPE["width"]], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        h1 = L.fc(x, PIPE["hidden"], act="tanh",
                  param_attr=fluid.ParamAttr(name="w1"))
        h2 = L.fc(h1, PIPE["hidden"], act="tanh",
                  param_attr=fluid.ParamAttr(name="w2"))
        pred = L.fc(h2, 1, param_attr=fluid.ParamAttr(name="w3"))
        loss = L.mean(L.square_error_cost(pred, y))
        opt = fluid.optimizer.SGD(1e-3)
        if pipelined:
            opt = fluid.optimizer.PipelineOptimizer(
                opt, cut_list=[[h1], [h2]],
                num_microbatches=PIPE["microbatches"])
        opt.minimize(loss)
    params = sorted(p.name for p in main.global_block().all_parameters())
    return main, startup, loss, params


def _pipe_bounds(main, state, feed, loss_name, params):
    """The unpipelined program's forward section run by its own op rules in
    float64 on the CPU under ``BoundMode``, and the gradient of its loss
    into each parameter: (float64 reference, bound) by name.  A bound of a
    sum covers any order of its terms, so it holds the pipelined run too
    (microbatch sums added in turn, scaled by 1/M = 1/4, exactly)."""
    from paddle_tpu_torch.executor import _Plan, _run_calls
    from paddle_tpu_torch.tools.fp_bounds import BoundMode

    plan = _Plan(main, feed)
    env = {n: torch.as_tensor(v).double()
           for n, v in {**state, **feed}.items()}
    leaves = {p: env[p].requires_grad_(True) for p in params}
    mode = BoundMode()
    with mode:
        for v in env.values():
            if v.is_floating_point():
                mode.set_exact(v.detach())
        ctx = plan.context(torch.Generator().manual_seed(0))
        _run_calls(plan.fwd, env, ctx)
        ctx.env = None
        loss = env[loss_name].sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out = {p: (g.detach(), mode.bound(g).detach())
               for p, g in zip(leaves, grads)}
    return out, mode.ambiguous


def _pipe_run(fluid, place, pipelined, state, feeds, device):
    """The program on ``place`` from ``state``: per step the loss, the
    fetched gradients and ms."""
    from paddle_tpu_torch import convert

    main, _, loss, params = _pipe_program(fluid, pipelined)
    scope = convert.scope_from_numpy(state, fluid.Scope(), device)
    exe = fluid.Executor(place)
    out = []
    for f in feeds:
        _sync(device)
        t0 = time.perf_counter()
        got = exe.run(main, feed=f,
                      fetch_list=[loss] + [p + "@GRAD" for p in params],
                      scope=scope)
        _sync(device)
        out.append({"ms": (time.perf_counter() - t0) * 1e3,
                    "loss": float(got[0]),
                    "grads": dict(zip(params, got[1:]))})
    return out


def phase_model_parallel_one_rank(device_name, card, device="cuda", args=None):
    """Phase 54's one-rank part.  (a) BERT-base (bf16, S = 512, global
    B = 16, LAMB) with ``use_flash=False``: attention through
    ``ring_attention(axis=None)`` on eager ops, one step through
    ``build_bert_trainer`` against the flash step from the same seed: at
    every layer both attentions of the flash step's q, k, v within
    ``_attention_bound`` of the float64 one, the loss within MP_GRAD_LIMIT
    yardsticks of the flash step's (``_loss_yardstick``), LN / flash launches
    24 / 24 / 0 / 0.  (b) A ``PipelineOptimizer`` program (``PIPE``: an
    MLP, as the Fluid-layers encoder's float64 bound would not fit the
    card) over 4 microbatches and 3 sections against the unpipelined
    program: each one's fetched gradients within ``BoundMode``'s bound of
    the float64 gradient (``_pipe_bounds``), and ms a step."""
    import dataclasses

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch._tree import tree_map
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.ring_attention import ring_attention
    from paddle_tpu_torch.tools import fp_bounds

    args = args or _mp_args()
    device = torch.device(device)
    t_start = time.perf_counter()
    cfg = bert.bert_base_config(**args["bert_kw"])
    host = bert.synthetic_batches(cfg, 1, args["batch"], args["seq"], seed=54)
    batch = {k: torch.from_numpy(v).to(device) for k, v in host[0].items()}
    rec = {"phase": "model_parallel_one_rank", "nvidia_smi": card}
    tr = bert.build_bert_trainer(cfg, optimizer=None, seed=0, device=device)
    p0 = _clone(tr.state["params"])
    with _FlashCapture() as fo:
        loss_f = float(tr.step(batch, MP_LR))
    del tr
    # the loss's yardsticks: the flash loss on the rows reversed and in f32
    with torch.no_grad():
        loss_fn = bert.make_loss_fn(cfg)
        loss_perm = float(loss_fn(p0, {k: v.flip(0)
                                       for k, v in batch.items()}))
        loss_f32 = float(bert.make_loss_fn(dataclasses.replace(
            cfg, dtype="float32"))(tree_map(lambda t: t.float(), p0), batch))
    del p0
    nf = bert.build_bert_trainer(dataclasses.replace(cfg, use_flash=False),
                                 seed=0, device=device)
    _common.reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    loss_n = float(nf.step(batch, MP_LR))
    _sync(device)
    rec["no_flash"] = {"ms": (time.perf_counter() - t0) * 1e3,
                       "launches": dict(_common.launches), "loss": loss_n,
                       "loss_flash": loss_f, "loss_err": abs(loss_n - loss_f),
                       "loss_yardstick": _loss_yardstick(loss_f, loss_perm,
                                                         loss_f32),
                       "loss_yardstick_perm": abs(loss_perm - loss_f),
                       "loss_yardstick_f32": abs(loss_f32 - loss_f)}
    del nf

    worst = {"flash": 0.0, "ring": 0.0}
    for q, k, v, H, o_flash in fo.calls:
        o64, bound = _attention_bound(q, k, v, H)
        B, S_, HD = q.shape
        o_ring = ring_attention(
            *(t.reshape(B, S_, H, HD // H) for t in (q, k, v)),
            axis=None).reshape(B, S_, HD)
        for name, o in (("flash", o_flash), ("ring", o_ring)):
            worst[name] = max(worst[name], float(
                ((o.double() - o64).abs() / bound).max()))
        del o64, bound, o_ring
    rec["no_flash"]["attention_err_over_bound"] = worst
    rec["no_flash"]["layers_held"] = len(fo.calls)
    del fo
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # (b) the pipelined program
    main, startup, loss, params = _pipe_program(fluid, False)
    place = fluid.CUDAPlace(0) if device.type == "cuda" else fluid.CPUPlace()
    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    names = sorted(v.name for v in startup.list_vars() if v.persistable)
    state = convert.scope_to_numpy(scope, names)
    rng = np.random.RandomState(54)
    feeds = []
    for _ in range(PIPE["steps"]):
        xv = rng.rand(PIPE["batch"], PIPE["width"]).astype("f4")
        w = rng.rand(PIPE["width"], 1).astype("f4")
        feeds.append({"x": xv, "y": (xv @ w / PIPE["width"]).astype("f4")})
    pipe = _pipe_run(fluid, place, True, state, feeds, device)
    plain = _pipe_run(fluid, place, False, state, feeds, device)
    ref, ambiguous = _pipe_bounds(main, state, feeds[0], loss.name, params)
    held = {}
    for run_name, run in (("pipelined", pipe), ("unpipelined", plain)):
        for p in params:
            r, b = ref[p]
            h = fp_bounds.hold_to_bound(
                torch.as_tensor(run[0]["grads"][p]), r, b)
            held["%s %s" % (run_name, p)] = h
    rec["pipeline"] = {
        "program": "MLP %d -> %d -> %d -> 1 (tanh), B = %d, %d "
                   "microbatches, 3 sections" % (
                       PIPE["width"], PIPE["hidden"], PIPE["hidden"],
                       PIPE["batch"], PIPE["microbatches"]),
        "ms_pipelined": [s["ms"] for s in pipe],
        "ms_unpipelined": [s["ms"] for s in plain],
        "losses_pipelined": [s["loss"] for s in pipe],
        "losses_unpipelined": [s["loss"] for s in plain],
        "grad_err_over_bound": {k: h["ratio"] for k, h in held.items()},
        "exact_mismatches": sum(h["exact_mismatches"] for h in held.values()),
        "ambiguous": len(ambiguous)}
    bad = []
    nf_ = rec["no_flash"]
    on_card = device.type == "cuda"
    if not nf_["loss_err"] <= MP_GRAD_LIMIT * nf_["loss_yardstick"] or any(
            r > 1 for r in nf_["attention_err_over_bound"].values()):
        bad.append("no-flash: %s" % nf_)
    if on_card and nf_["launches"] != {k: PER_STEP.get(k, 0) if k.startswith(
            "layer_norm") else 0 for k in nf_["launches"]}:
        bad.append("no-flash launches %s" % nf_["launches"])
    if not all(h["ok"] for h in held.values()) or ambiguous:
        bad.append("pipeline %s" % rec["pipeline"])
    rec.update(ok=not bad, problems=bad, seconds=time.perf_counter() - t_start)
    emit(rec)
    if bad:
        raise AssertionError("phase 54 (one rank): %s" % bad)
    return rec


# -- item 5-C′: program-mode tp, the row-sharded DeepFM, Local SGD, the dryrun
# and the capacity guard (phase 55) ---------------------------------------------

P55_WORLD = 2                 # two gloo ranks sharing the one card
P55_ENC_BATCH = 8             # the Fluid encoder's global batch (cut from 16)
P55_FEED_SEED = 900
P55_DFM_STEPS, P55_DFM_LR = 3, 1.0
P55_LSGD = dict(batch=16, k=2, steps=4, lr=1e-4, sgd_lr=1.0)
P55_LIMIT = DP_F32_LIMIT      # yardsticks, as phases 51-54
P55_TIMEOUT_S = 600


def _p55_args(small=False):
    """Phase 55's sizes: the Fluid BERT-base encoder (``phase_encoder``'s
    program and widths, f32, Adam 1e-4, dropout 0.1) at global B =
    P55_ENC_BATCH, DeepFM at BASELINE config 5 (B = 8192), BERT-base bf16
    at its published widths for Local SGD; ``small`` for a rehearsal on the
    CPU."""
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.tools.programs import BERT_BASE_ENCODER

    if small:
        return {"enc_cfg": BERT_BASE_ENCODER._replace(
                    vocab=96, hidden=32, layers=2, heads=4, ffn=64, seq=16,
                    batch=4),
                "dfm_cfg": deepfm.deepfm_tiny_config(num_features=2000),
                "dfm_batch": 64,
                "bert_kw": dict(vocab_size=512, hidden=64, n_layers=2,
                                n_heads=4, ffn_hidden=128, max_seq=32),
                "seq": 32}
    return {"enc_cfg": BERT_BASE_ENCODER._replace(batch=P55_ENC_BATCH),
            "dfm_cfg": deepfm.DeepFMConfig(), "dfm_batch": DFM_B,
            "bert_kw": {}, "seq": S}


def _p55_loss_yardstick(loss, loss_perm):
    """A loss's yardstick: how far the one-rank step's loss moves on the
    batch's rows permuted, and at least one unit in the last place of the
    f32 loss (a permuted mean may round to the same bits)."""
    import numpy as np

    return max(abs(loss_perm - loss), float(np.spacing(np.float32(loss))))


def _p55_flip_units(name, t, cfg):
    """``t`` (the value or gradient of encoder var ``name``) with every
    axis a tp split cuts in reverse order: each layer's FFN units and
    attention heads, and the vocabulary's classes (with the labels mapped
    to ``vocab - 1 - label``, ``_p55_flip_labels``).  The same function,
    its products over those axes contracting in another order (the
    row-parallel fcs forward, the vocabulary fc's input gradient backward:
    the orders a tp split changes).  Other vars as they are."""
    nh, dh = cfg.heads, cfg.hidden // cfg.heads
    if not name.endswith((".w_0", ".b_0")):
        return t
    if name.startswith("mask_lm_out_fc."):
        return t.flip(-1)
    if "_ffn_fc_0." in name:
        return t.flip(-1)
    if "_ffn_fc_1.w_0" in name:
        return t.flip(0)
    if "_output_fc.w_0" in name:
        return t.reshape(nh, dh, -1).flip(0).reshape(t.shape)
    if any("_%s_fc." % k in name for k in ("query", "key", "value")):
        return t.reshape(*t.shape[:-1], nh, dh).flip(-2).reshape(t.shape)
    return t


def _rel_l2(a, b):
    """||a - b|| / ||b|| in float64 (0 where both are 0)."""
    a, b = a.double(), b.double()
    nb = float(b.norm())
    d = float((a - b).norm())
    return d / nb if nb > 0 else (0.0 if d == 0 else math.inf)


def _ulp_rel_l2(t):
    """One unit in the last place of ``t``'s largest element, as a
    relative L2 distance from ``t``: the least gap two roundings of it can
    show (a twin may round to the same bits)."""
    import numpy as np

    a = t.detach().float().abs().max().cpu().numpy()
    nb = float(t.detach().double().norm())
    return float(np.spacing(a)) / nb if nb > 0 else 0.0


def _p55_leaf_yardsticks(got, want, twins, names):
    """Each leaf's gap (relative L2 from ``want``) over its own yardstick:
    the largest gap of any of the one-rank ``twins`` ({kind: leaves}, the
    same function computed in another order) from ``want``, and at least
    one unit in the last place of the leaf.  The worst leaves first."""
    rows = []
    for i, name in enumerate(names):
        gap = _rel_l2(got[i], want[i])
        yards = {k: _rel_l2(t[i], want[i]) for k, t in twins.items()}
        yard = max(max(yards.values()), _ulp_rel_l2(want[i]))
        rows.append({"leaf": name, "gap": gap, "yardstick": yard,
                     "ratio": gap / yard if yard > 0 else math.inf,
                     **{"yardstick_" + k: v for k, v in yards.items()}})
    rows.sort(key=lambda r: -r["ratio"])
    ratios = sorted(r["ratio"] for r in rows)
    return {"leaves": len(rows), "ratio_max": rows[0]["ratio"],
            "ratio_median": ratios[len(ratios) // 2],
            "ratio_min": ratios[0], "worst": rows[:4]}


def _p55_flip_labels(feed, cfg):
    """The feed for ``_p55_flip_units``' parameters: each label's class
    reversed."""
    return dict(feed, labels=cfg.vocab - 1 - feed["labels"])


def _p55_whole_differ(scope, names):
    """The whole (not tp-split) persistables that differ from rank 0's."""
    return _pdp_replicas_differ(scope, [n for n in names
                                        if scope.split(n) is None])


def _p55_tp_encoder(rank, world, device, args):
    """(a) The Fluid-layers BERT-base encoder with the Megatron marks at
    tp = ``world``: a watched step at dropout 0.1 (collectives, the masks
    gathered) and a timed one; the fallback's gathers; the whole leaves
    bit for bit on both ranks.  Rank 0 runs the one-rank (tp = 1) program
    from the same state on the same batch: the masks bit for bit, the loss
    terms.  Then at dropout 0 the first loss against the one-rank step's
    in yardsticks (its own gap on the rows permuted), and every gathered
    gradient, the yardstick the larger of that gap and of the one-rank
    step's with every split axis reversed (``_p55_flip_units``: the FFN
    units, heads and classes, so the contraction order of the products the
    split cuts, which a row permutation does not change), each leaf
    against its own yardstick."""
    import numpy as np

    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.parallel import model_axes
    from paddle_tpu_torch.tools.programs import (bert_encoder_program,
                                                 encoder_feed)

    cfg = args["enc_cfg"]
    place = _pdp_place(device)
    on_card = torch.device(device).type == "cuda"
    feeds = [encoder_feed(cfg, P55_FEED_SEED + k) for k in range(2)]

    def build(c):
        main, startup, v = bert_encoder_program(fluid, c, tp_split=True)
        bs = fluid.BuildStrategy()
        bs.tensor_parallel_degree = world
        return main, startup, v, fluid.CompiledProgram(
            main).with_data_parallel(loss_name=v["loss"].name,
                                     build_strategy=bs)

    out = {}
    main, startup, v, prog = build(cfg)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    names = sorted(x.name for x in startup.list_vars() if x.persistable)
    params = [p.name for p in main.global_block().all_parameters()]
    init = _pdp_state(scope, names)
    ops = main.global_block().ops
    masks = [op.outputs["Mask"][0] for op in ops if op.type == "dropout"]
    terms = next(op.outputs["Loss"][0] for op in ops
                 if op.type == "softmax_with_cross_entropy")
    model_axes.reset_counts()
    steps = []
    for k, feed in enumerate(feeds):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        step = exe._step
        fetch = [v["loss"]] + ([terms] + masks if k == 0 else [])
        w = _DpWatch(device)
        _common.reset_launches()
        with w if k == 0 else contextlib.nullcontext():
            _sync(device)
            t0 = time.perf_counter()
            got = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope,
                          return_numpy=False)
            _sync(device)
            rec = {"step": k, "kind": ("watched", "timed")[k],
                   "ms": (time.perf_counter() - t0) * 1e3,
                   "loss": float(got[0]),
                   "launches": {n: c for n, c in _common.launches.items()
                                if c}}
        if k == 0:
            rec.update(collective_ms=w.seconds * 1e3,
                       collective_calls=w.calls, collective_bytes=w.bytes)
        if on_card:
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if k == 0 and rank == 0:
            rmain, _, rv = bert_encoder_program(fluid, cfg, tp_split=True)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            ref = _pdp_one_rank(place, rmain, init, step, feed,
                                [rv["loss"], terms] + masks)
            if on_card:
                out["one_rank_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            rec["masks"] = len(masks)
            rec["masks_bit_for_bit"] = all(
                _same_tensor_bits(a, b) for a, b in zip(got[2:], ref[2:]))
            rec["mask_keep_share"] = float(got[2].float().mean())
            rec["loss_one_rank"] = float(ref[0])
            rec["loss_err"] = abs(rec["loss"] - rec["loss_one_rank"])
            rec["loss_bound"] = _pdp_loss_bound(got[1], ref[1], rec["loss"],
                                                float(ref[0]), 1)
            del ref
        del got
        dist.barrier()
        steps.append(rec)
    out["steps"] = steps
    out["counts"] = model_axes.counts()
    out["split_leaf_bytes"] = {
        n: scope.find_var(n).numel() * scope.find_var(n).element_size()
        for n in names if scope.split(n) is not None}
    out["split_leaves"] = len(out["split_leaf_bytes"])
    out["whole_differ"] = _p55_whole_differ(scope, names)
    del exe, scope
    if on_card:
        torch.cuda.empty_cache()

    # the first loss and the gradient at dropout 0 (a row permutation
    # moves no mask), gathered whole
    c0 = cfg._replace(dropout=0.0)
    main0, startup0, v0, prog0 = build(c0)
    exe0, scope0 = fluid.Executor(place), fluid.Scope()
    for n in names:
        scope0.var(n)
        scope0.set(n, init[n].clone())
    gnames = [p + "@GRAD" for p in params]
    step = exe0._step
    model_axes.reset_counts()
    _common.reset_launches()
    got = exe0.run(prog0, feed=feeds[0], fetch_list=[v0["loss"]] + gnames,
                   scope=scope0, return_numpy=False)
    out["grad_step_counts"] = model_axes.counts()
    out["grad_step_launches"] = {n: c for n, c in _common.launches.items()
                                 if c}
    del exe0, scope0
    if rank == 0:
        rmain, _, rv = bert_encoder_program(fluid, c0, tp_split=True)
        perm = np.random.RandomState(1).permutation(cfg.batch)
        one = _pdp_one_rank(place, rmain, init, step, feeds[0],
                            [rv["loss"]] + gnames)
        onep = _pdp_one_rank(place, rmain, init, step,
                             {k: a[perm] for k, a in feeds[0].items()},
                             [rv["loss"]] + gnames)
        held = [i for i, p in enumerate(params)
                if not p.endswith("_key_fc.b_0")]
        pick = lambda gs: [gs[i] for i in held]
        hn = [params[i] for i in held]
        loss, loss_one, loss_perm = (float(got[0]), float(one[0]),
                                     float(onep[0]))
        out["loss0"] = {"loss": loss, "loss_one_rank": loss_one,
                        "loss_rows_permuted": loss_perm,
                        "err": abs(loss - loss_one),
                        "yardstick": _p55_loss_yardstick(loss_one,
                                                         loss_perm)}
        # the contraction order: the FFN units and heads reversed
        flipped = {n: _p55_flip_units(n, t, cfg) for n, t in init.items()}
        oneu = _pdp_one_rank(place, rmain, flipped, step,
                             _p55_flip_labels(feeds[0], cfg),
                             [rv["loss"]] + gnames)
        del flipped
        unflip = [float(oneu[0])] + [_p55_flip_units(p, g, cfg)
                                     for p, g in zip(params, oneu[1:])]
        out["grad"] = _grad_gap(pick(got[1:]), pick(one[1:]), 1, hn)
        out["grad_by_leaf"] = _p55_leaf_yardsticks(
            pick(got[1:]), pick(one[1:]),
            {"rows": pick(onep[1:]), "reversed": pick(unflip[1:])}, hn)
        out["loss0"]["loss_reversed"] = unflip[0]
        out["control_tp_times_grad"] = _p55_leaf_yardsticks(
            [g * world for g in pick(got[1:])], pick(one[1:]),
            {"rows": pick(onep[1:]), "reversed": pick(unflip[1:])}, hn)
        del oneu, unflip, one, onep
    del got, init
    if on_card:
        torch.cuda.empty_cache()
    return out


def _p55_segment_bound(ids, vals, height, rows, out):
    """The kernel's merged rows against ``segsum_plain``'s on the same
    inputs: the row ids equal, each merged value within the bound of two
    f32 sums of its run in any order (2 gamma(run length) times the run's
    absolute sum, from float64): (rows equal, max err over bound)."""
    from paddle_tpu_torch.kernels.segment_update import segsum_plain

    p_rows, p_out = segsum_plain(ids, vals, height)
    ones = torch.ones(ids.shape[0], 1, dtype=torch.float64, device=ids.device)
    _, count = segsum_plain(ids, ones, height)
    _, absum = segsum_plain(ids, vals.double().abs(), height)
    u = 2.0 ** -24
    g = count * u / (1 - count * u)
    bound = 2 * g * absum + 2.0 ** -149
    ratio = float(((out.double() - p_out.double()).abs() / bound).max())
    return bool(torch.equal(rows, p_rows)), ratio


def _p55_deepfm(rank, world, device, args):
    """(b) DeepFM at config 5 with both tables row-sharded over the two
    ranks (``build_deepfm_trainer(mesh=...)``: 500,000 rows of each table
    and 4096 rows of the batch a rank), P55_DFM_STEPS SGD steps at lr 1:
    each step's segment-sum launches a rank, every call held against its
    plain version.  Before each step the ranks take the sharded loss's
    table gradients from the same state (``deepfm_loss_sharded``), and the
    step's table update must be that gradient's SGD update bit for bit.
    Rank 0 gathers the state and the gradients: the loss against the
    one-rank segment trainer's, in yardsticks (the larger of its gap on
    the batch's rows permuted and of its float64 twin's), and each table's
    gradient against the one-rank loss's (``deepfm_loss``), in yardsticks:
    the larger of that gradient's gap on the batch's rows permuted and of
    its gap when taken as the mean of the batch's two halves (its products
    at the 4096 rows a rank runs, the shapes the sharding changes).  The
    gradient, not the update: an f32 update of a 0.01-sized weight keeps
    few bits of a ~1e-6 step, so gradients a unit in their last place
    apart round to updates far more apart.  Reported, not held: the
    sharded gradient against the two-halves one and against the float64
    twin's."""
    import dataclasses

    import numpy as np

    import torch.distributed as dist

    from paddle_tpu_torch._tree import tree_map
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.parallel import collectives as col
    from paddle_tpu_torch.parallel import embedding as pemb
    from paddle_tpu_torch.parallel.mesh import DP, make_mesh
    from paddle_tpu_torch.parallel.rules import P
    from paddle_tpu_torch.parallel.train import (gather_pytree, grads_of,
                                                 shard_batch)

    cfg, B = args["dfm_cfg"], args["dfm_batch"]
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    tables = ("embed", "w_linear")
    mesh = make_mesh(dp=world, device=device)
    specs = deepfm.deepfm_param_specs(cfg, DP)
    tr = deepfm.build_deepfm_trainer(
        cfg, device=device, mesh=mesh, params=deepfm.init_deepfm_params(
            torch.Generator().manual_seed(0), cfg, device))
    segment = deepfm.make_step_variants(cfg, P55_DFM_LR)["segment"]
    calls = []
    plain_call = pemb.dedup_segment_sum

    def recorded(ids, vals, height):
        r, o = plain_call(ids, vals, height)
        calls.append((ids.clone(), vals.clone(), height, r.clone(),
                      o.clone()))
        return r, o

    def sharded_grads(batch):
        local = shard_batch(mesh, {n: P(DP) for n in batch}, batch)
        with mesh:
            _, g = grads_of(lambda p: deepfm.deepfm_loss_sharded(
                p, local, cfg, DP), tr.state["params"])
        return {t: g[t] for t in tables}

    def one_rank_grads(params, batch, c=cfg):
        loss, g = grads_of(lambda p: deepfm.deepfm_loss(p, batch, c), params)
        return float(loss), {t: g[t] for t in tables}

    def halves_grads(params, batch):
        """The mean of the two halves' mean losses (the global mean): its
        products at a rank's rows."""
        h = [{n: a[i * (B // 2):(i + 1) * (B // 2)] for n, a in batch.items()}
             for i in range(2)]
        _, g = grads_of(lambda p: 0.5 * (deepfm.deepfm_loss(p, h[0], cfg)
                                         + deepfm.deepfm_loss(p, h[1], cfg)),
                        params)
        return {t: g[t] for t in tables}

    steps = []
    for k in range(P55_DFM_STEPS):
        b = deepfm.synthetic_batch(cfg, B, seed=P55_FEED_SEED + k)
        batch = {n: torch.from_numpy(a).to(device) for n, a in b.items()}
        whole = gather_pytree(_clone(tr.state["params"]), specs, mesh)
        old = {t: tr.state["params"][t].clone() for t in tables}
        g_s = sharded_grads(batch)
        calls.clear()
        _common.reset_launches()
        pemb.dedup_segment_sum = recorded
        try:
            _sync(device)
            t0 = time.perf_counter()
            loss = float(tr.step(batch, P55_DFM_LR))
            _sync(device)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            pemb.dedup_segment_sum = plain_call
        rec = {"step": k, "ms": ms, "loss": loss,
               "launches": {n: c for n, c in _common.launches.items() if c},
               "segment_calls": len(calls),
               "segment_shapes": [list(c[1].shape) for c in calls]}
        held = [_p55_segment_bound(*c) for c in calls]
        rec["segment_rows_equal"] = all(h[0] for h in held)
        rec["segment_err_over_bound"] = max(h[1] for h in held)
        calls.clear()
        rec["update_is_the_gradients"] = all(torch.equal(
            tr.state["params"][t], old[t] - P55_DFM_LR * g_s[t])
            for t in tables)
        g_whole = {t: col.backend_all_gather(g_s[t].contiguous(),
                                             mesh.groups[DP], 0)
                   for t in tables}
        del old, g_s
        if rank == 0:
            _, l_one = segment(whole, batch)
            perm = torch.from_numpy(np.random.RandomState(k).permutation(
                B)).to(device)
            pbatch = {n: a[perm] for n, a in batch.items()}
            _, l_perm = segment(whole, pbatch)
            g_half = halves_grads(whole, batch)
            _, g_one = one_rank_grads(whole, batch)
            _, g_perm = one_rank_grads(whole, pbatch)
            w64 = tree_map(lambda t: t.double(), whole)
            l64, g64 = one_rank_grads(w64, batch, cfg64)
            del w64
            rec["loss_one_rank"] = float(l_one)
            rec["loss_err"] = abs(loss - float(l_one))
            rec["loss_yardstick"] = max(
                _p55_loss_yardstick(float(l_one), float(l_perm)),
                abs(l64 - float(l_one)))
            for t in tables:
                rec[t + "_grad"] = _p55_leaf_yardsticks(
                    [g_whole[t]], [g_one[t]],
                    {"rows": [g_perm[t]], "halves": [g_half[t]]}, [t])
                rec[t + "_grad_from_halves"] = _rel_l2(g_whole[t], g_half[t])
                rec[t + "_grad_from_f64"] = _rel_l2(g_whole[t], g64[t])
                rec[t + "_one_rank_from_f64"] = _rel_l2(g_one[t], g64[t])
            del g_one, g_perm, g64, g_half, perm, pbatch
        del g_whole, whole
        dist.barrier()
        steps.append(rec)
    return {"steps": steps,
            "table_rows_a_rank": tr.state["params"]["embed"].shape[0],
            "batch_rows_a_rank": B // world}


def _p55_local_sgd(rank, world, device, args):
    """(c) Local SGD on BERT-base (bf16, published widths) at dp = 2, 8 rows
    a rank: LAMB at k = 2 for four steps, the replicas (every parameter,
    gathered) different after steps 1 and 3 and equal bit for bit after 2
    and 4; then at k = 1 with SGD one step against ``make_train_step``'s
    sync dp step (its loss the exact-gradient global mean) from the same
    state: each parameter's update in yardsticks (the sync step's own gap on
    the batch's rows permuted)."""
    import numpy as np

    from paddle_tpu_torch._tree import tree_leaves
    from paddle_tpu_torch.kernels import _common
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import MeshSpec, optim
    from paddle_tpu_torch.parallel import collectives as col
    from paddle_tpu_torch.parallel.local_sgd import (
        make_local_sgd_train_step, stack_local_state)
    from paddle_tpu_torch.parallel.mesh import DP, make_mesh
    from paddle_tpu_torch.parallel.rules import leaf_paths
    from paddle_tpu_torch.parallel.train import TrainState, make_train_step
    from paddle_tpu_torch.parallel.transformer import (
        grad_sync_axes, init_transformer_params, transformer_param_specs)

    cfg = bert.bert_base_config(**args["bert_kw"])
    mesh = MeshSpec(dp=world).build(device=device)
    alone = make_mesh(device=device)
    bert_loss = bert.make_loss_fn(cfg)

    def local_loss(p, b):           # this replica's own mean: no collective
        with alone:
            return bert_loss(p, b)

    def sync_loss(p, b):            # the global mean, exact gradients
        n = b["mask"].float().sum()
        return col.global_mean_loss(local_loss(p, b) * n,
                                    col.psum(n.detach(), DP), DP)

    start = init_transformer_params(torch.Generator().manual_seed(0), cfg,
                                    device=device)
    pspecs = transformer_param_specs(cfg)
    syncs = grad_sync_axes(cfg)
    bspecs = bert.batch_specs()
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in bert.synthetic_batches(cfg, P55_LSGD["steps"],
                                               P55_LSGD["batch"],
                                               args["seq"])]

    def replicas_equal(params):
        return all(_same_tensor_bits(*col.backend_all_gather(
            t.reshape(1, -1), mesh.groups[DP], 0).unbind(0))
            for t in tree_leaves(params))

    out = {"lamb": []}
    opt = optim.lamb()
    build = make_local_sgd_train_step(local_loss, mesh, pspecs, syncs, opt,
                                      bspecs, local_steps=P55_LSGD["k"])
    state = stack_local_state(TrainState.create(_clone(start), opt), world)
    step_fn, _ = build(state)
    for i, b in enumerate(batches):
        _common.reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        state, loss = step_fn(state, b, P55_LSGD["lr"])
        _sync(device)
        out["lamb"].append({
            "step": i + 1, "ms": (time.perf_counter() - t0) * 1e3,
            "loss": float(loss),
            "launches": {n: c for n, c in _common.launches.items() if c},
            "replicas_equal": replicas_equal(state["params"])})
    del state, step_fn
    # k = 1, SGD, in f32 (the replicas' bf16 roundings before the average
    # would swamp an update): Local SGD against the sync dp step, each
    # parameter's update held to the larger of the sync step's own gap on
    # the batch's rows permuted and one unit in the last place of the
    # parameters it writes
    cfg32 = bert.bert_base_config(**{**args["bert_kw"], "dtype": "float32"})
    bert32 = bert.make_loss_fn(cfg32)

    def local32(p, b):
        with alone:
            return bert32(p, b)

    def sync32(p, b):
        n = b["mask"].float().sum()
        return col.global_mean_loss(local32(p, b) * n,
                                    col.psum(n.detach(), DP), DP)

    start = init_transformer_params(torch.Generator().manual_seed(0), cfg32,
                                    device=device)
    sgd, lr, b = optim.sgd(), P55_LSGD["sgd_lr"], batches[0]
    state = stack_local_state(TrainState.create(_clone(start), sgd), world)
    step_fn, _ = make_local_sgd_train_step(
        local32, mesh, pspecs, syncs, sgd, bspecs, local_steps=1)(state)
    local, _ = step_fn(state, b, lr)
    sync_step = make_train_step(sync32, mesh, pspecs, syncs, sgd,
                                bspecs)(None)
    synced, _ = sync_step(TrainState.create(_clone(start), sgd), b, lr)
    perm = torch.from_numpy(np.random.RandomState(3).permutation(
        P55_LSGD["batch"])).to(device)
    permuted, _ = sync_step(TrainState.create(_clone(start), sgd),
                            {k: v[perm] for k, v in b.items()}, lr)
    leaves = []
    for name, p0, a, c, q in zip(
            leaf_paths(start)[0], tree_leaves(start),
            tree_leaves(local["params"]), tree_leaves(synced["params"]),
            tree_leaves(permuted["params"])):
        want = (c.double() - p0.double())
        nw = float(want.norm())
        ulp = float(torch.from_numpy(np.spacing(np.abs(
            c.detach().cpu().numpy()))).double().norm()) / nw
        gap = float((a.double() - c.double()).norm()) / nw
        yard = max(float((q.double() - c.double()).norm()) / nw, ulp)
        leaves.append((gap / yard, name, gap, yard))
    leaves.sort()
    out["k1_sgd"] = {
        "leaves": len(leaves), "ratio_max": leaves[-1][0],
        "ratio_max_leaf": leaves[-1][1], "gap_at_max": leaves[-1][2],
        "yardstick_at_max": leaves[-1][3],
        "ratio_median": leaves[len(leaves) // 2][0],
        "replicas_equal": replicas_equal(local["params"])}
    return out


def _p55_rank(rank, world, endpoint, results, args):
    """One rank of phase 55, in a spawned process: ``fleet.init()`` from a
    launcher's PADDLE_* env with gloo (both ranks on card 0), then (a), (b)
    and (c); its records go on ``results``."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TRAINER_ENDPOINTS": endpoint,
        "PADDLE_CURRENT_ENDPOINT": endpoint, "PADDLE_DISTRI_BACKEND": "gloo",
        "FLAGS_selected_gpus": "0",
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    device = fleet.init(
        device=None if args["device"] == "cuda" else args["device"]).device
    try:
        res = {"rank": rank, "backend": dist.get_backend()}
        t0 = time.perf_counter()
        res["tp_encoder"] = _p55_tp_encoder(rank, world, device, args)
        res["tp_encoder"]["seconds"] = time.perf_counter() - t0
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res["sharded_deepfm"] = _p55_deepfm(rank, world, device, args)
        res["sharded_deepfm"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["local_sgd"] = _p55_local_sgd(rank, world, device, args)
        res["local_sgd"]["seconds"] = time.perf_counter() - t0
        results.put(res)
    finally:
        dist.destroy_process_group()


def _p55_verdict(got, world, on_card):
    """The problems in the ranks' records."""
    bad = []
    seg = {"segment_sum": 2}
    for rank in range(world):
        enc, dfm, ls = (got[rank][k] for k in
                        ("tp_encoder", "sharded_deepfm", "local_sgd"))
        where = "rank %d" % rank
        if enc["whole_differ"]:
            bad.append("%s encoder whole leaves differ %s"
                       % (where, enc["whole_differ"][:3]))
        for key in ("counts", "grad_step_counts"):
            if enc[key]["activation_gathers"] or enc[key]["fallback_gathers"]:
                bad.append("%s encoder fallback gathers %s" % (where,
                                                               enc[key]))
        # program mode runs no LN or flash kernel: nothing launches
        for launched in [st["launches"] for st in enc["steps"]] + [
                enc["grad_step_launches"]]:
            if launched:
                bad.append("%s encoder launches %s" % (where, launched))
        if not all(math.isfinite(s["loss"]) for s in enc["steps"]):
            bad.append("%s encoder losses %s" % (where, enc["steps"]))
        for st in dfm["steps"]:
            if on_card and st["launches"] != seg:
                bad.append("%s deepfm step %d launches %s" % (
                    where, st["step"], st["launches"]))
            if not st["update_is_the_gradients"]:
                bad.append("%s deepfm step %d table update is not the "
                           "sharded gradients'" % (where, st["step"]))
            if st["segment_calls"] != 2 or not st["segment_rows_equal"] or \
                    st["segment_err_over_bound"] > 1:
                bad.append("%s deepfm step %d segment calls %d, rows %s, "
                           "err/bound %s" % (where, st["step"],
                                             st["segment_calls"],
                                             st["segment_rows_equal"],
                                             st["segment_err_over_bound"]))
        for st in ls["lamb"]:
            want = st["step"] % P55_LSGD["k"] == 0
            if st["replicas_equal"] != want or not math.isfinite(st["loss"]):
                bad.append("%s local SGD step %d replicas equal %s" % (
                    where, st["step"], st["replicas_equal"]))
            if on_card and st["launches"] != PER_STEP:
                bad.append("%s local SGD step %d launches %s" % (
                    where, st["step"], st["launches"]))
        if not ls["k1_sgd"]["replicas_equal"]:
            bad.append("%s local SGD k=1 replicas differ" % where)
    enc = got[0]["tp_encoder"]
    st = enc["steps"][0]
    if not st["masks_bit_for_bit"] or st["loss_bound"]["err_over_bound"] > 1:
        bad.append("encoder masks %s, loss %s" % (st["masks_bit_for_bit"],
                                                  st["loss_bound"]))
    l0 = enc["loss0"]
    if not l0["err"] <= P55_LIMIT * l0["yardstick"]:
        bad.append("encoder first loss %s over %s x %s" % (
            l0["err"], P55_LIMIT, l0["yardstick"]))
    by_leaf = enc["grad_by_leaf"]
    if not by_leaf["ratio_max"] <= P55_LIMIT:
        bad.append("encoder gradient leaves over %s yardsticks: %s" % (
            P55_LIMIT, by_leaf["worst"]))
    if not enc["control_tp_times_grad"]["ratio_median"] > P55_LIMIT:
        bad.append("encoder control (tp times) within %s yardsticks: %s"
                   % (P55_LIMIT, enc["control_tp_times_grad"]))
    for st in got[0]["sharded_deepfm"]["steps"]:
        if not st["loss_err"] <= P55_LIMIT * st["loss_yardstick"]:
            bad.append("deepfm step %d loss %s over %s x %s" % (
                st["step"], st["loss_err"], P55_LIMIT, st["loss_yardstick"]))
        for t in ("embed", "w_linear"):
            if not st[t + "_grad"]["ratio_max"] <= P55_LIMIT:
                bad.append("deepfm step %d %s gradient over %s yardsticks: "
                           "%s" % (st["step"], t, P55_LIMIT,
                                   st[t + "_grad"]["worst"]))
    k1 = got[0]["local_sgd"]["k1_sgd"]
    if not k1["ratio_max"] <= P55_LIMIT:
        bad.append("local SGD k=1 update of %s at %s yardsticks" % (
            k1["ratio_max_leaf"], k1["ratio_max"]))
    return bad


def phase_p55_dryrun(device="cuda", n=P55_WORLD):
    """(d) ``python -m paddle_tpu_torch.tools.dryrun N --device cuda``: exit
    0 and the reference's lines (the mesh, the BERT step, the MoE step and
    the tp_split program with kReduce; ZeRO needs dp > 1)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.tools.dryrun",
                        str(n), "--device", device], capture_output=True,
                       text=True, timeout=400)
    lines = r.stdout.splitlines()
    want = ["dryrun mesh:", "dp/pp/tp/sp train step OK",
            "ep (MoE all_to_all) step OK", "program-path dp="]
    ok = r.returncode == 0 and all(any(ln.startswith(w) for ln in lines)
                                   for w in want)
    emit({"phase": "tp_tables_dryrun", "n": n, "device": device,
          "rc": r.returncode, "lines": lines, "ok": ok,
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError("phase 55 (d): dryrun rc %d\n%s" % (
            r.returncode, (r.stdout + r.stderr)[-4000:]))


def phase_p55_capacity(device="cuda"):
    """(e) The embedding router's capacity guard reads the card's total
    memory (unless a budget is configured); past it, with
    ``use_host_sparse_table`` on, the table raises naming item 7, and with
    it off the capacity error naming the host parameter server."""
    from paddle_tpu_torch.monitor import memscope
    from paddle_tpu_torch.parallel import embedding as pemb

    total = torch.cuda.get_device_properties(0).total_memory
    configured = memscope._configured_limit()
    budget = pemb._hbm_bytes_per_chip()
    rows = int(budget * 0.6 / (16 * 4)) * 2          # twice the table budget
    gen = torch.Generator().manual_seed(0)
    raised = {}
    for on in (False, True):
        pemb.enable_host_sparse_table(on)
        try:
            pemb.init_embedding_table(gen, rows, 16, 1, device=device)
            raised[on] = None
        except (ValueError, NotImplementedError) as e:
            raised[on] = (type(e).__name__, str(e))
        finally:
            pemb.enable_host_sparse_table(False)
    ok = ((configured is not None or budget == total)
          and raised[False] is not None and raised[False][0] == "ValueError"
          and "host-RAM parameter-server" in raised[False][1]
          and raised[True] is not None
          and raised[True][0] == "NotImplementedError"
          and "item 7" in raised[True][1])
    emit({"phase": "tp_tables_capacity", "card_total_memory": total,
          "configured_limit": configured, "budget_per_card": budget,
          "table_rows_tried": rows, "dim": 16,
          "flag_off": raised[False], "flag_on": raised[True], "ok": ok})
    if not ok:
        raise AssertionError("phase 55 (e): %s" % raised)


def phase_tp_tables_two_ranks(device_name, card, device="cuda", args=None):
    """Phase 55: item 5-C′ over two gloo ranks sharing the one card, each a
    spawned process joining through ``fleet.init()``.  (a) The Fluid-layers
    BERT-base encoder with the Megatron marks (``bert_encoder_program(
    tp_split=True)``: 12 x 768, 12 heads, FFN 3072, S = 512, vocab 30528,
    f32, Adam 1e-4, dropout 0.1, global B = P55_ENC_BATCH) at tp = 2 through
    ``CompiledProgram(...).with_data_parallel`` (``tensor_parallel_degree
    = 2``): zero fallback gathers, the whole leaves bit for bit on both
    ranks, the dropout masks bit for bit the one-rank (tp = 1) run's, the
    loss within its derived bound; at dropout 0 the first loss and every
    gathered gradient within P55_LIMIT yardsticks of the one-rank step's (a
    row permutation's gap), tp times the gradient outside.  (b) DeepFM at
    config 5 with its tables row-sharded (``_p55_deepfm``): 2 segment-sum
    launches a rank a step, each call within its derived bound of the plain
    version; losses and table updates in yardsticks of the one-rank
    segment trainer's.  (c) Local SGD on BERT-base (``_p55_local_sgd``).
    Then (d) the dryrun at N = 2 on the card and (e) the capacity guard.
    Reports ms a step, collective ms, calls and bytes, peak GB a rank
    against the one-rank peak, each split leaf's bytes.  Returns the port
    kernels' launches a rank a step by part."""
    import multiprocessing as mp
    import queue

    args = dict(args or _p55_args(), device=device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    endpoint = "127.0.0.1:%d" % _free_port()
    procs = [ctx.Process(target=_p55_rank,
                         args=(r, P55_WORLD, endpoint, results, args))
             for r in range(P55_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + P55_TIMEOUT_S
        while len(got) < P55_WORLD:
            try:
                res = results.get(timeout=5)
                got[res["rank"]] = res
            except queue.Empty:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    raise AssertionError("phase 55: a rank failed, exit codes "
                                         "%s" % codes)
                if time.monotonic() > deadline:
                    raise AssertionError("phase 55: no result in %d s"
                                         % P55_TIMEOUT_S)
        for p in procs:
            p.join(120)
        codes = [p.exitcode for p in procs]
        if codes != [0] * P55_WORLD:
            raise AssertionError("phase 55: exit codes %s" % codes)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    on_card = torch.device(device).type == "cuda"
    bad = _p55_verdict(got, P55_WORLD, on_card)
    enc_cfg = args["enc_cfg"]
    for rank in range(P55_WORLD):
        emit({"phase": "tp_tables_two_ranks", "part": "a_tp_encoder",
              "rank": rank, "world": P55_WORLD, "tp": P55_WORLD,
              "backend": got[rank]["backend"],
              "batch_global": enc_cfg.batch, "seq": enc_cfg.seq,
              **got[rank]["tp_encoder"]})
        emit({"phase": "tp_tables_two_ranks", "part": "b_sharded_deepfm",
              "rank": rank, **got[rank]["sharded_deepfm"]})
        emit({"phase": "tp_tables_two_ranks", "part": "c_local_sgd",
              "rank": rank, **got[rank]["local_sgd"]})
    seconds = time.perf_counter() - t0
    ok = not bad
    emit({"phase": "tp_tables_two_ranks", "nvidia_smi": card, "ok": ok,
          "seconds": seconds, "problems": bad[:20]})
    if not ok:
        raise AssertionError("phase 55: %s" % bad[:20])
    if on_card:
        phase_p55_dryrun(device)
        phase_p55_capacity(device)
    emit({"phase": "tp_tables", "nvidia_smi": card,
          "seconds": time.perf_counter() - t0})
    return {"tp_encoder": got[0]["tp_encoder"]["steps"][-1]["launches"],
            "sharded_deepfm": got[0]["sharded_deepfm"]["steps"][-1][
                "launches"],
            "local_sgd": got[0]["local_sgd"]["lamb"][-1]["launches"]}


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
    phase_datafeed(card)
    ctr_per_step, ctr_times = phase_ctr_dataset(card, name)
    hostfed_per_step = phase_deepfm_hostfed(card)
    phase_dataloader(card)
    _common.reset_launches()
    phase_rules_3b(card)
    phase_encoder_parity(card)
    torch.cuda.empty_cache()
    phase_encoder(name, card)
    torch.cuda.empty_cache()
    phase_crnn_parity(card)
    phase_crnn(name, card)
    torch.cuda.empty_cache()
    phase_rules_5(card)
    phase_lac_parity(card)
    phase_lac(name, card)
    assert_no_launches("item 3-B's rules, the Fluid-layers encoder, the "
                       "CRNN and the LAC tagger")
    torch.cuda.empty_cache()
    phase_dygraph_parity(card)
    dy_net, dy_feed = phase_dygraph_resnet(name, card)
    phase_dygraph_serving(card, dy_net, dy_feed)
    del dy_net
    assert_no_launches("the dygraph mode (parity, ResNet-50, serving)")
    torch.cuda.empty_cache()
    nccl_launches = phase_dp_nccl(name, card)
    dp_launches = phase_dp_two_ranks(name, card)
    for rec in kernels:
        key = {"flash_attention_bwd_dq": "flash_attention_bwd",
               "flash_attention_bwd_dkv": "flash_attention_bwd"}.get(
                   rec["name"], rec["name"])
        if key in PER_STEP:
            rec["dp1_nccl_launches_per_step"] = nccl_launches[key] // DP_STEPS
            rec["dp2_launches_per_rank_step"] = dp_launches["bert"][key]
        if key in RN_PER_STEP:
            rec["sync_bn_dp2_launches_per_rank_step"] = dp_launches["resnet"][key]
    torch.cuda.empty_cache()
    _common.reset_launches()
    phase_program_dp_nccl(name, card)
    pdp_nccl = dict(_common.launches)
    assert_no_launches("program-mode data parallelism (one-rank NCCL)")
    pdp_launches = phase_program_dp_two_ranks(name, card)
    torch.cuda.empty_cache()
    _common.reset_launches()
    more_nccl, ctr_bytes = phase_program_dp_more_nccl(name, card)
    more_dp = phase_program_dp_more_two_ranks(name, card, ctr_bytes)
    for rec in kernels:
        key = {"flash_attention_bwd_dq": "flash_attention_bwd",
               "flash_attention_bwd_dkv": "flash_attention_bwd"}.get(
                   rec["name"], rec["name"])
        rec["program_dp_launches_per_step"] = {
            "phase52_nccl_encoder": pdp_nccl.get(key, 0) / PDP_STEPS,
            "phase52_two_ranks_per_rank": {
                r: pdp_launches[r].get(key, 0) for r in pdp_launches},
            "phase53_nccl": {m: c.get(key, 0) for m, c in more_nccl.items()},
            "phase53_two_ranks_per_rank": {
                r: {m: c.get(key, 0) for m, c in more_dp[r].items()}
                for r in more_dp}}
    torch.cuda.empty_cache()
    _common.reset_launches()
    mp_one = phase_model_parallel_one_rank(name, card)
    torch.cuda.empty_cache()
    mp_launches = phase_model_parallel_two_ranks(name, card)
    for rec in kernels:
        key = {"flash_attention_bwd_dq": "flash_attention_bwd",
               "flash_attention_bwd_dkv": "flash_attention_bwd"}.get(
                   rec["name"], rec["name"])
        rec["model_parallel_launches_per_rank_step"] = {
            mode: mp_launches[mode].get(key, 0) for mode in MP_MODES}
        rec["no_flash_launches_per_step"] = mp_one["no_flash"]["launches"].get(
            key, 0)
    torch.cuda.empty_cache()
    _common.reset_launches()
    p55 = phase_tp_tables_two_ranks(name, card)
    assert_no_launches("phase 55's parent process")
    for rec in kernels:
        key = {"flash_attention_bwd_dq": "flash_attention_bwd",
               "flash_attention_bwd_dkv": "flash_attention_bwd"}.get(
                   rec["name"], rec["name"])
        rec["phase55_launches_per_rank_step"] = {
            "tp_encoder": p55["tp_encoder"].get(key, 0),
            "sharded_deepfm": p55["sharded_deepfm"].get(key, 0),
            "local_sgd": p55["local_sgd"].get(key, 0)}
    for rec in kernels:
        if rec["name"] == "segment_sum":
            rec["ctr_dataset_launches_per_step"] = ctr_per_step
            rec["deepfm_hostfed_launches_per_step"] = hostfed_per_step
            rec["ctr_dataset_shapes"] = ctr_times
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
