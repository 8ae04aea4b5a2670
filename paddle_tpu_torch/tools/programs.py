"""Fluid programs with sub-blocks, built on whichever ``fluid`` the caller
passes (``paddle_tpu_torch``, or the JAX package in the parity tests), so
that ``chip_smoke.py`` and the tests build the same programs:

- ``while_beam_decode``: the program-mode beam decode of the JAX package's
  ``tests/test_rnn_beam_ops.py:213`` — a ``While`` loop over T steps
  driving the ``beam_search`` op, the step tokens and parents written into
  [T, B, K] accumulators through one-hot masks, then
  ``beam_search_decode``.  The per-step probabilities are fed whole,
  [T, B, K, V], and read by the loop body as a closure (not a carried
  var);
- ``cond_program``: a ``cond`` in a trained forward section, each branch
  with its own fc layer, trained by SGD;
- ``switch_program``: an LR-warmup style ``Switch`` with overlapping
  cases (the JAX package's Switch: the last matching case wins);
- ``bert_encoder_program``: a BERT encoder built only from public
  ``fluid.layers`` in the shape of Paddle 1.6's own Fluid BERT (fc
  projections, ``matmul`` attention with a mask bias, ``layer_norm``,
  a gelu FFN, a vocabulary ``fc`` and ``softmax_with_cross_entropy``),
  trained by Adam or SGD;
- ``crnn_ctc_program``: the CRNN-CTC text recognizer of PaddlePaddle's
  models repository (``PaddleCV/ocr_recognition/crnn_ctc_model.py``:
  ``ocr_convs``, ``encoder_net``, ``ctc_train_net``) in public
  ``fluid.layers``, with its evaluation program (greedy CTC decoding and
  the edit distance to the labels);
- ``lac_program``: the LAC lexical-analysis tagger of PaddlePaddle's
  models repository (``PaddleNLP/lexical_analysis``, ``nets.py``
  ``lex_net`` and ``creator.py``): an ``is_sparse`` word embedding, two
  bidirectional ``dynamic_gru`` layers, an fc to the tags as emissions,
  ``linear_chain_crf`` trained by Adam, and ``crf_decoding`` with
  ``chunk_eval`` (IOB) as its evaluation.

- ``dygraph_resnet``: the dygraph ResNet of PaddlePaddle models v1.6
  (``dygraph/resnet/train.py``), a ``Layer`` on ``fluid.dygraph`` with its
  optimizer, loss and step.

Each program builder returns ``(main, startup, vars)``, built under a fresh
``unique_name.guard()`` so the two packages name every var alike.
"""

import collections

import numpy as np

__all__ = ["while_beam_decode", "cond_program", "switch_program",
           "EncoderConfig", "BERT_BASE_ENCODER", "bert_encoder_program",
           "encoder_feed", "encoder_train_flops", "CRNNConfig", "CRNN_CTC",
           "crnn_ctc_program", "crnn_feed", "crnn_train_flops", "LACConfig",
           "LAC", "lac_program", "lac_feed", "lac_train_flops",
           "DygraphResNetConfig", "DYGRAPH_RESNET50", "dygraph_resnet",
           "dygraph_resnet_optimizer", "dygraph_resnet_loss",
           "dygraph_resnet_step", "dygraph_resnet_feed",
           "dygraph_resnet_train_flops"]


def while_beam_decode(fluid, T, B, K, V, end_id=0):
    """Feeds: "lp" [T, B, K, V] f32 probabilities, "ps" [B, K] f32 initial
    scores, "pi" [B, K] int32 initial ids.  vars["sent"]: [B, K, T] int32
    sentences, best first."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        lp = layers.data("lp", shape=[T, B, K, V], dtype="float32",
                         append_batch_size=False)
        ps = layers.data("ps", shape=[B, K], dtype="float32",
                         append_batch_size=False)
        pi = layers.data("pi", shape=[B, K], dtype="int32",
                         append_batch_size=False)
        blk = main.global_block()
        ids_arr = layers.fill_constant([T, B, K], "int32", 0)
        par_arr = layers.fill_constant([T, B, K], "int32", 0)
        t_var = layers.fill_constant([1], "int32", 0)
        tmax = layers.fill_constant([1], "int32", T)
        cond = layers.less_than(t_var, tmax)
        w = layers.While(cond)
        with w.block():
            lp_t = layers.reshape(layers.gather(lp, t_var), [B, K, V])
            sub = main.current_block()
            si = sub.create_var(name="bs_si", shape=(B, K), dtype="int32")
            ss = sub.create_var(name="bs_ss", shape=(B, K), dtype="float32")
            pa = sub.create_var(name="bs_pa", shape=(B, K), dtype="int32")
            sub.append_op(
                type="beam_search",
                inputs={"pre_scores": [ps.name], "scores": [lp_t.name],
                        "pre_ids": [pi.name]},
                outputs={"selected_ids": [si.name],
                         "selected_scores": [ss.name],
                         "parent_idx": [pa.name]},
                attrs={"beam_size": K, "end_id": end_id,
                       "is_accumulated": False})
            oh = layers.reshape(layers.one_hot(t_var, T), [T, 1, 1])
            keep = layers.cast(layers.scale(oh, scale=-1.0, bias=1.0), "int32")
            put = layers.cast(oh, "int32")
            layers.assign(ids_arr * keep + put * layers.reshape(si, [1, B, K]),
                          ids_arr)
            layers.assign(par_arr * keep + put * layers.reshape(pa, [1, B, K]),
                          par_arr)
            layers.assign(ss, ps)
            layers.assign(si, pi)
            layers.assign(layers.elementwise_add(
                t_var, layers.fill_constant([1], "int32", 1)), t_var)
            layers.assign(layers.less_than(t_var, tmax), cond)
        sent = blk.create_var(name="bs_sent", shape=(B, K, T), dtype="int32")
        blk.append_op(
            type="beam_search_decode",
            inputs={"Ids": [ids_arr.name], "ParentIdx": [par_arr.name]},
            outputs={"SentenceIds": [sent.name]})
    return main, startup, {"lp": lp, "ps": ps, "pi": pi, "sent": sent}


def cond_program(fluid, width=8, hidden=6, out=3, lr=0.1):
    """x [N, width] -> h = fc(x, hidden, tanh); pred = mean(h) < 0;
    r = cond(pred, fc_true(h), fc_false(h * 2)); loss = mean(r * r); SGD.
    Which branch a batch takes depends on its data."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        x = layers.data("x", shape=[width], dtype="float32")
        h = layers.fc(x, hidden, act="tanh")
        zero = layers.fill_constant([1], "float32", 0.0)
        pred = layers.less_than(layers.mean(h), zero)
        r = layers.cond(pred, lambda: layers.fc(h, out),
                        lambda: layers.fc(layers.scale(h, 2.0), out))
        loss = layers.mean(layers.elementwise_mul(r, r))
        fluid.optimizer.SGD(lr).minimize(loss)
    return main, startup, {"x": x, "h": h, "pred": pred, "r": r,
                           "loss": loss}


def switch_program(fluid):
    """step [1] f32 -> lr through a Switch of overlapping cases: step < 5
    gives 0.1, step < 10 gives 0.2, the default 0.3.  The last matching
    case wins, so steps below 5 give 0.2 (Paddle's first match would give
    0.1)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        step = layers.data("step", shape=[1], dtype="float32",
                           append_batch_size=False)
        lr = layers.create_global_var(shape=[1], value=0.0, dtype="float32",
                                      persistable=True, name="switch_lr")
        consts = [layers.fill_constant([1], "float32", v)
                  for v in (0.1, 0.2, 0.3, 5.0, 10.0)]
        with layers.Switch() as switch:
            with switch.case(layers.less_than(step, consts[3])):
                layers.assign(consts[0], lr)
            with switch.case(layers.less_than(step, consts[4])):
                layers.assign(consts[1], lr)
            with switch.default():
                layers.assign(consts[2], lr)
    return main, startup, {"step": step, "lr": lr}


# vocab, hidden, layers, heads, FFN width, sequence length, batch, dropout
# rate, learning rate and optimizer ("adam", "sgd" or "lamb")
EncoderConfig = collections.namedtuple(
    "EncoderConfig", "vocab hidden layers heads ffn seq batch dropout lr "
                     "optimizer")
# bench.py's BERT-base (paddle_tpu/models/bert.py bert_base_config) at
# S = 512, B = 16, in f32 with dropout 0.1 and Adam at 1e-4
BERT_BASE_ENCODER = EncoderConfig(vocab=30528, hidden=768, layers=12, heads=12,
                                  ffn=3072, seq=512, batch=16, dropout=0.1,
                                  lr=1e-4, optimizer="adam")


def bert_encoder_program(fluid, cfg, wrap_optimizer=None, tp_split=False):
    """Feeds (all [B, S, 1]): "src_ids" and "pos_ids" int64, "input_mask"
    f32 (1 for a real token), "labels" int64.  Per layer: q, k and v from
    ``fc(num_flatten_dims=2)``, reshaped and transposed into heads;
    ``matmul(q, k, transpose_y=True, alpha=d_head ** -0.5)`` plus the bias
    (mask mask^T - 1) 10000 stacked over the heads; softmax, dropout,
    ``matmul`` with v, back to [B, S, H]; an output fc, dropout, the
    residual and ``layer_norm``; then fc(gelu), fc, dropout, the residual
    and ``layer_norm``.  A vocabulary fc, ``softmax_with_cross_entropy``
    and ``mean`` give vars["loss"].  Dropout is upscale_in_train, as
    Paddle's BERT; weights start from a normal truncated at 2 std (0.02),
    as its initializer.  ``wrap_optimizer(opt)`` (for example
    ``fleet.distributed_optimizer``) wraps the optimizer before its
    ``minimize``.  ``tp_split``: the fcs carry the Megatron marks for
    ``tensor_parallel_degree`` > 1, q, k, v and the first FFN fc "col", the
    attention output and the second FFN fc "row", the vocabulary fc "col"
    (the vocab-parallel loss)."""
    B, S, H, nh = cfg.batch, cfg.seq, cfg.hidden, cfg.heads
    dh = H // nh
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        init = fluid.initializer.TruncatedNormal(scale=0.02)

        def attr(name):
            return fluid.ParamAttr(name=name, initializer=init)

        def fc(x, size, name, act=None, split=None):
            return L.fc(x, size, num_flatten_dims=2, act=act,
                        param_attr=attr(name + ".w_0"),
                        bias_attr=fluid.ParamAttr(name=name + ".b_0"),
                        tp_split=split if tp_split else None)

        def drop(x):
            if not cfg.dropout:
                return x
            return L.dropout(x, dropout_prob=cfg.dropout,
                             dropout_implementation="upscale_in_train")

        def norm(x, name):
            return L.layer_norm(x, begin_norm_axis=2,
                                param_attr=fluid.ParamAttr(name=name + "_scale"),
                                bias_attr=fluid.ParamAttr(name=name + "_bias"))

        def heads(x):
            return L.transpose(L.reshape(x, [0, 0, nh, dh]), [0, 2, 1, 3])

        feeds = {n: L.data(n, shape=[B, S, 1], dtype=dt, append_batch_size=False)
                 for n, dt in (("src_ids", "int64"), ("pos_ids", "int64"),
                               ("input_mask", "float32"), ("labels", "int64"))}
        x = L.elementwise_add(
            L.embedding(feeds["src_ids"], size=[cfg.vocab, H],
                        param_attr=attr("word_embedding")),
            L.embedding(feeds["pos_ids"], size=[S, H],
                        param_attr=attr("pos_embedding")))
        x = drop(norm(x, "pre_encoder_layer_norm"))
        mask = feeds["input_mask"]
        bias = L.scale(L.matmul(mask, mask, transpose_y=True), scale=10000.0,
                       bias=-1.0, bias_after_scale=False)
        bias = L.stack([bias] * nh, axis=1)
        bias.stop_gradient = True
        for i in range(cfg.layers):
            p = "encoder_layer_%d" % i
            q, k, v = (heads(fc(x, H, "%s_multi_head_att_%s_fc" % (p, n),
                                split="col"))
                       for n in ("query", "key", "value"))
            s = L.elementwise_add(
                L.matmul(q, k, transpose_y=True, alpha=dh ** -0.5), bias)
            ctxt = L.matmul(drop(L.softmax(s)), v)
            ctxt = L.reshape(L.transpose(ctxt, [0, 2, 1, 3]), [0, 0, H])
            att = drop(fc(ctxt, H, p + "_multi_head_att_output_fc",
                          split="row"))
            x = norm(L.elementwise_add(att, x), p + "_post_att_layer_norm")
            ffn = fc(fc(x, cfg.ffn, p + "_ffn_fc_0", act="gelu", split="col"),
                     H, p + "_ffn_fc_1", split="row")
            x = norm(L.elementwise_add(drop(ffn), x), p + "_post_ffn_layer_norm")
        logits = fc(x, cfg.vocab, "mask_lm_out_fc", split="col")
        loss = L.mean(L.softmax_with_cross_entropy(logits, feeds["labels"]))
        opt = {"adam": fluid.optimizer.Adam, "sgd": fluid.optimizer.SGD,
               "lamb": fluid.optimizer.Lamb}[cfg.optimizer](cfg.lr)
        if wrap_optimizer is not None:
            opt = wrap_optimizer(opt)
        opt.minimize(loss)
    return main, startup, dict(feeds, loss=loss, logits=logits)


def encoder_feed(cfg, seed):
    """A batch as ``bench.py`` makes BERT's: token ids and labels uniform
    over the vocabulary, positions 0..S-1, every token real (a mask of
    ones), from ``numpy.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    shape = (cfg.batch, cfg.seq, 1)
    pos = np.broadcast_to(np.arange(cfg.seq).reshape(1, -1, 1), shape)
    return {"src_ids": rng.randint(0, cfg.vocab, shape).astype(np.int64),
            "pos_ids": np.ascontiguousarray(pos, np.int64),
            "input_mask": np.ones(shape, np.float32),
            "labels": rng.randint(0, cfg.vocab, shape).astype(np.int64)}


def encoder_train_flops(cfg):
    """Matrix-product FLOPs of one training step (forward and backward, 3x
    the forward), as ``bench.py`` counts BERT's: per token and layer
    8 H^2 (q, k, v, output) + 4 H F (the FFN) + 4 S H (attention), plus
    2 H V for the vocabulary fc."""
    H, F, S, V = cfg.hidden, cfg.ffn, cfg.seq, cfg.vocab
    per_token = cfg.layers * (8 * H * H + 4 * H * F + 4 * S * H) + 2 * H * V
    return 3 * per_token * cfg.batch * S


CRNNConfig = collections.namedtuple(
    "CRNNConfig", "batch height width classes channels hidden label_min "
                  "label_max lr momentum l2")

# crnn_ctc_model.py at its published widths: data_reader.py's DATA_SHAPE
# [1, 48, 512] gray images, 95 classes and the blank, conv groups of
# 16 / 32 / 64 / 128 channels, GRUs of 200, Momentum(1e-3, 0.9) with
# L2Decay(4e-4); batch 32; label lengths 4-24 (synthetic labels)
CRNN_CTC = CRNNConfig(batch=32, height=48, width=512, classes=95,
                      channels=(16, 32, 64, 128), hidden=200, label_min=4,
                      label_max=24, lr=1e-3, momentum=0.9, l2=4e-4)


def crnn_ctc_program(fluid, cfg, wrap_optimizer=None):
    """Feeds: "pixel" [B, 1, H, W] f32, "label" [B, L] int32 padded ids in
    [0, classes), "label_length" [B] int64 (L = cfg.label_max).

    ``ocr_convs``: four groups of two 3 x 3 convolutions (pad 1), each with
    batch_norm + relu, of cfg.channels; the first three groups end in a
    2 x 2 max pool of stride 2 with ``ceil_mode``.  The features
    [B, C, H / 8, W / 8] become T = W / 8 steps of C H / 8 by
    ``im2sequence`` (filter [H / 8, 1], stride 1), reshaped to [B, T, C H / 8]
    (``im2sequence`` declares a 2-D output, its rule gives [B, T, C H / 8];
    the reshape makes the two agree for the fcs).  Two fcs of 3 hidden
    feed a forward and a reverse ``dynamic_gru``; an fc over both gives
    classes + 1 logits a step.  ``warpctc`` (blank = classes,
    ``norm_by_times``), ``reduce_sum``, then ``Momentum`` with ``L2Decay``
    on every parameter.  The initializers and learning-rate factors are
    the published ones (conv weights N(0, 0.0005) for the first, N(0,
    0.01) after; biases 0; fc and GRU weights N(0, 0.02), the GRU biases
    at learning rate 2).  The published ``candidate_activation="relu"``
    is passed; both packages' ``dynamic_gru`` ignore it and run tanh.

    ``wrap_optimizer(opt)`` (for example ``fleet.distributed_optimizer``)
    wraps the optimizer before its ``minimize``.

    Returns (main, startup, test, vars): ``test`` is main cloned for test
    before the optimizer, with the evaluation: ``ctc_greedy_decoder``
    (blank = classes) and ``edit_distance`` (normalized, as Paddle's
    ``EditDistance`` evaluator) against the labels; vars "loss", "logits",
    "decoded", "decoded_length", "distance"."""
    B, H, W = cfg.batch, cfg.height, cfg.width
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        reg = fluid.regularizer.L2Decay(cfg.l2)

        def attr(std, lr=1.0):
            return fluid.ParamAttr(regularizer=reg, learning_rate=lr,
                                   initializer=fluid.initializer.Normal(0.0, std))

        pixel = L.data("pixel", shape=[B, 1, H, W], dtype="float32",
                       append_batch_size=False)
        label = L.data("label", shape=[B, cfg.label_max], dtype="int32",
                       append_batch_size=False)
        label_length = L.data("label_length", shape=[B], dtype="int64",
                              append_batch_size=False)
        x = pixel
        for g, ch in enumerate(cfg.channels):
            for i in range(2):
                w = attr(0.0005 if g == 0 and i == 0 else 0.01)
                x = L.conv2d(x, num_filters=ch, filter_size=3, padding=1,
                             param_attr=w, act=None)
                x = L.batch_norm(x, act="relu", param_attr=attr(0.01),
                                 bias_attr=attr(0.0))
            if g < len(cfg.channels) - 1:
                x = L.pool2d(x, pool_size=2, pool_type="max", pool_stride=2,
                             ceil_mode=True)
        C, hf, T = x.shape[1], x.shape[2], x.shape[3]
        seq = L.im2sequence(x, filter_size=[hf, 1], stride=[1, 1])
        seq = L.reshape(seq, [B, T, C * hf])
        fcs = [L.fc(seq, cfg.hidden * 3, num_flatten_dims=2,
                    param_attr=attr(0.02), bias_attr=attr(0.02))
               for _ in range(2)]
        grus = [L.dynamic_gru(f, cfg.hidden, param_attr=attr(0.02),
                              bias_attr=attr(0.02, lr=2.0), is_reverse=rev,
                              candidate_activation="relu")
                for f, rev in zip(fcs, (False, True))]
        logits = L.fc(grus, cfg.classes + 1, num_flatten_dims=2,
                      param_attr=attr(0.02), bias_attr=attr(0.0))
        cost = L.warpctc(logits, label, blank=cfg.classes, norm_by_times=True,
                         label_length=label_length)
        loss = L.reduce_sum(cost)
        decoded, decoded_length = L.ctc_greedy_decoder(logits, blank=cfg.classes)
        distance, _ = L.edit_distance(decoded, label, normalized=True,
                                      input_length=decoded_length,
                                      label_length=label_length)
        test = main.clone(for_test=True)
        opt = fluid.optimizer.Momentum(cfg.lr, cfg.momentum)
        if wrap_optimizer is not None:
            opt = wrap_optimizer(opt)
        opt.minimize(loss)
    return main, startup, test, dict(
        pixel=pixel, label=label, label_length=label_length, loss=loss,
        logits=logits, decoded=decoded, decoded_length=decoded_length,
        distance=distance)


def crnn_feed(cfg, seed):
    """A batch from ``numpy.random.RandomState(seed)``: pixels uniform in
    [0, 1), label lengths uniform in [label_min, label_max], labels
    uniform over the classes (0 past each length)."""
    rng = np.random.RandomState(seed)
    n = rng.randint(cfg.label_min, cfg.label_max + 1, cfg.batch)
    lab = rng.randint(0, cfg.classes, (cfg.batch, cfg.label_max))
    lab[np.arange(cfg.label_max)[None, :] >= n[:, None]] = 0
    return {"pixel": rng.rand(cfg.batch, 1, cfg.height, cfg.width)
            .astype(np.float32),
            "label": lab.astype(np.int32), "label_length": n.astype(np.int64)}


def crnn_train_flops(cfg):
    """Multiply-add FLOPs of one training step (3x the forward): the
    convolutions, the three fcs and the two GRUs' recurrent products (the
    CTC recursion and the elementwise work are not counted)."""
    H, W, B = cfg.height, cfg.width, cfg.batch
    conv, cin = 0, 1
    for g, ch in enumerate(cfg.channels):
        conv += 2 * H * W * 9 * ch * (cin + ch)
        cin = ch
        if g < len(cfg.channels) - 1:
            H, W = -(-H // 2), -(-W // 2)
    T, feat, h = W, cfg.channels[-1] * H, cfg.hidden
    fcs = 2 * T * (2 * feat * 3 * h + 2 * h * (cfg.classes + 1))
    grus = 2 * T * 2 * (h * 2 * h + h * h)
    return 3 * B * (conv + fcs + grus)


LACConfig = collections.namedtuple(
    "LACConfig", "batch seq_len vocab emb hidden tags len_min len_max lr")

# lex_net's published hyperparameters (conf/args.yaml), which no caller
# varies: bigru_num 2, emb_learning_rate 5, crf_learning_rate 0.2,
# L2Decay(1e-4) and Uniform(-0.1, 0.1) initialisers
LAC_BIGRU_NUM = 2
LAC_EMB_LR = 5.0
LAC_CRF_LR = 0.2
LAC_L2 = 1e-4
LAC_INIT_BOUND = 0.1

# lex_net at its published widths (conf/args.yaml): a 20,940-word
# vocabulary, word_emb_dim 128, grnn_hidden_dim 128, 57 tags (28 chunk
# types in IOB and O), base_learning_rate 1e-3 (Adam); batch 300
# sentences of 8-64 words, padded to 64 (synthetic words and tags)
LAC = LACConfig(batch=300, seq_len=64, vocab=20940, emb=128, hidden=128,
                tags=57, len_min=8, len_max=64, lr=1e-3)


def lac_program(fluid, cfg, wrap_optimizer=None):
    """Feeds: "word" [B, T] int64 word ids, "target" [B, T] int64 IOB tag
    ids (chunk type k: B-k = 2 k, I-k = 2 k + 1; O = tags - 1), "length"
    [B] int64 (T = cfg.seq_len; padded, not LoD).

    ``lex_net``: ``embedding`` (``is_sparse``, Uniform(-b, b) with b =
    LAC_INIT_BOUND, learning rate LAC_EMB_LR), then LAC_BIGRU_NUM
    bidirectional layers, each direction an fc to 3 hidden and a
    ``dynamic_gru`` (the second ``is_reverse`` over each row's length),
    both with Uniform(-b, b) and L2Decay(LAC_L2), concatenated; an fc to
    the tags as the emissions; ``linear_chain_crf`` with the transition
    ``crfw`` (learning rate LAC_CRF_LR) over each row's length, ``mean`` as the loss, and
    ``crf_decoding`` with ``crfw`` and ``chunk_eval`` (IOB,
    ceil((tags - 1) / 2) chunk types, the lengths), as ``creator.py``
    builds them into the training program.

    ``wrap_optimizer(opt)`` wraps Adam before its ``minimize``.

    Returns (main, startup, test, vars): ``test`` is main cloned for test
    before Adam; vars "loss", "emission", "decoded", "precision",
    "recall", "f1", "num_infer", "num_label", "num_correct"."""
    B, T = cfg.batch, cfg.seq_len
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers

        def attr(**kw):
            return fluid.ParamAttr(
                initializer=fluid.initializer.Uniform(-LAC_INIT_BOUND,
                                                      LAC_INIT_BOUND), **kw)

        word = L.data("word", shape=[B, T], dtype="int64",
                      append_batch_size=False)
        target = L.data("target", shape=[B, T], dtype="int64",
                        append_batch_size=False)
        length = L.data("length", shape=[B], dtype="int64",
                        append_batch_size=False)
        x = L.embedding(word, size=[cfg.vocab, cfg.emb], is_sparse=True,
                        param_attr=attr(name="word_emb",
                                        learning_rate=LAC_EMB_LR))
        reg = fluid.regularizer.L2Decay(LAC_L2)
        for _ in range(LAC_BIGRU_NUM):
            grus = []
            for rev in (False, True):
                pre = L.fc(x, cfg.hidden * 3, num_flatten_dims=2,
                           param_attr=attr(regularizer=reg))
                grus.append(L.dynamic_gru(pre, cfg.hidden,
                                          param_attr=attr(regularizer=reg),
                                          is_reverse=rev, seq_len=length))
            x = L.concat(grus, axis=2)
        emission = L.fc(x, cfg.tags, num_flatten_dims=2,
                        param_attr=attr(regularizer=reg))
        crf_cost = L.linear_chain_crf(
            emission, target, length=length,
            param_attr=fluid.ParamAttr(name="crfw", learning_rate=LAC_CRF_LR))
        loss = L.mean(crf_cost)
        decoded = L.crf_decoding(emission, fluid.ParamAttr(name="crfw"),
                                 length=length)
        p, r, f1, ni, nl, nc = L.chunk_eval(
            decoded, target, "IOB", int(np.ceil((cfg.tags - 1) / 2.0)),
            seq_length=length)
        test = main.clone(for_test=True)
        opt = fluid.optimizer.Adam(cfg.lr)
        if wrap_optimizer is not None:
            opt = wrap_optimizer(opt)
        opt.minimize(loss)
    return main, startup, test, dict(
        word=word, target=target, length=length, loss=loss,
        emission=emission, decoded=decoded, precision=p, recall=r, f1=f1,
        num_infer=ni, num_label=nl, num_correct=nc)


def lac_feed(cfg, seed):
    """A batch from ``numpy.random.RandomState(seed)`` whose tags follow
    from its words.  Word w has the kind w mod (c + 1) of c =
    (tags - 1) // 2 chunk types, the last kind meaning O, for every seed.
    Each sentence (length uniform in [len_min, len_max]) is a run of
    kinds: each position keeps the kind before it with probability 0.5,
    else draws one uniformly, and takes a uniform word of that kind.  The
    tags are then valid IOB: O for an O word, I-k for a word of type k
    after a word of type k, else B-k; past each length, word 0 and O."""
    rng = np.random.RandomState(seed)
    B, T = cfg.batch, cfg.seq_len
    n = rng.randint(cfg.len_min, cfg.len_max + 1, B)
    n_types = (cfg.tags - 1) // 2
    kinds = n_types + 1
    go_on, fresh = rng.rand(B, T) < 0.5, rng.randint(0, kinds, (B, T))
    kind = fresh.copy()
    for t in range(1, T):
        kind[go_on[:, t], t] = kind[go_on[:, t], t - 1]
    words = kind + kinds * rng.randint(0, cfg.vocab // kinds, (B, T))
    after = np.concatenate([np.full((B, 1), -1), kind[:, :-1]], axis=1)
    tags = np.where(kind == n_types, cfg.tags - 1,
                    2 * kind + (kind == after))
    past = np.arange(T)[None, :] >= n[:, None]
    words[past] = 0
    tags[past] = cfg.tags - 1
    return {"word": words.astype(np.int64), "target": tags.astype(np.int64),
            "length": n.astype(np.int64)}


def lac_train_flops(cfg):
    """Multiply-add FLOPs of one training step (3x the forward) at every
    padded position: each bidirectional layer's two fcs to 3 hidden and
    the GRUs' recurrent products, and the emission fc (the CRF recursions,
    the embedding gather and the elementwise work are not counted)."""
    h, tokens = cfg.hidden, cfg.batch * cfg.seq_len
    per_token, width = 0, cfg.emb
    for _ in range(LAC_BIGRU_NUM):
        per_token += 2 * (2 * width * 3 * h + 2 * h * 3 * h)
        width = 2 * h
    per_token += 2 * width * cfg.tags
    return 3 * tokens * per_token


DygraphResNetConfig = collections.namedtuple(
    "DygraphResNetConfig", "depth base_width classes batch image")

# PaddlePaddle models v1.6 dygraph/resnet/train.py, which no caller varies:
# Momentum 0.9 over piecewise_decay from lr 0.1 (boundaries at epochs 30,
# 60, 90 of ImageNet's 1,281,167 images at the strategy's batch 256,
# values 0.1, 0.01, 0.001, 0.0001) and L2Decay(1e-4); the fc's
# Uniform(-1/sqrt(2048), 1/sqrt(2048)) initialiser
RESNET_MOMENTUM = 0.9
RESNET_BASE_LR = 0.1
RESNET_LR_EPOCHS = (30, 60, 90)
RESNET_TOTAL_IMAGES = 1281167
RESNET_STRATEGY_BATCH = 256
RESNET_L2 = 1e-4

# ResNet-50 at its published widths: bottlenecks [3, 4, 6, 3] of 64-512
# filters (x 4 out), 102 classes (flowers), batch 32, 224 x 224
DYGRAPH_RESNET50 = DygraphResNetConfig(depth=(3, 4, 6, 3), base_width=64,
                                       classes=102, batch=32, image=224)


def dygraph_resnet(fluid, cfg):
    """The dygraph ResNet of PaddlePaddle models v1.6
    ``dygraph/resnet/train.py`` on ``fluid``'s dygraph (call it under
    ``fluid.dygraph.guard``): ``ConvBNLayer`` (a ``Conv2D`` without bias,
    then ``BatchNorm(act)``), ``BottleneckBlock``s of ``cfg.depth`` with
    1x1 / 3x3 / 1x1 convolutions, a projection shortcut first in each
    stage, the add and a ReLU after it; a 7x7/2 stem, a 3/2/1 max pool, a
    global average pool, a reshape and a ``Linear`` to ``cfg.classes``
    with ``act="softmax"``.  The add, the ReLU and the reshape run the op
    rules through ``nn._lowering_apply``, as ``fluid.layers`` builds
    them in the source (``fluid.layers`` builds program ops under a
    dygraph guard in both packages)."""
    dg = fluid.dygraph
    lower = dg.nn._lowering_apply
    widths = [cfg.base_width * 2 ** i for i in range(len(cfg.depth))]

    class ConvBNLayer(dg.Layer):
        def __init__(self, num_channels, num_filters, filter_size, stride=1,
                     act=None):
            super().__init__("conv_bn_layer")
            self._conv = dg.Conv2D(
                num_channels=num_channels, num_filters=num_filters,
                filter_size=filter_size, stride=stride,
                padding=(filter_size - 1) // 2, act=None, bias_attr=False)
            self._batch_norm = dg.BatchNorm(num_channels=num_filters, act=act)

        def forward(self, inputs):
            return self._batch_norm(self._conv(inputs))

    class BottleneckBlock(dg.Layer):
        def __init__(self, num_channels, num_filters, stride, shortcut):
            super().__init__("bottleneck_block")
            self.conv0 = ConvBNLayer(num_channels, num_filters, 1, act="relu")
            self.conv1 = ConvBNLayer(num_filters, num_filters, 3,
                                     stride=stride, act="relu")
            self.conv2 = ConvBNLayer(num_filters, num_filters * 4, 1)
            if not shortcut:
                self.short = ConvBNLayer(num_channels, num_filters * 4, 1,
                                         stride=stride)
            self.shortcut = shortcut

        def forward(self, inputs):
            conv2 = self.conv2(self.conv1(self.conv0(inputs)))
            short = inputs if self.shortcut else self.short(inputs)
            y = lower("elementwise_add", ("X", "Y"), {"axis": -1}, "Out",
                      short, conv2)
            return lower("relu", ("X",), {}, "Out", y)

    class ResNet(dg.Layer):
        def __init__(self):
            super().__init__("resnet")
            self.conv = ConvBNLayer(3, widths[0], 7, stride=2, act="relu")
            self.pool2d_max = dg.Pool2D(pool_size=3, pool_stride=2,
                                        pool_padding=1, pool_type="max")
            self.blocks = []
            channels = widths[0]
            for stage, n in enumerate(cfg.depth):
                shortcut = False
                for i in range(n):
                    block = self.add_sublayer(
                        "bb_%d_%d" % (stage, i),
                        BottleneckBlock(channels, widths[stage],
                                        2 if i == 0 and stage != 0 else 1,
                                        shortcut))
                    self.blocks.append(block)
                    channels, shortcut = widths[stage] * 4, True
            self.pool2d_avg = dg.Pool2D(pool_size=7, pool_type="avg",
                                        global_pooling=True)
            self.features = channels
            stdv = 1.0 / np.sqrt(channels * 1.0)
            self.out = dg.Linear(
                channels, cfg.classes, act="softmax",
                param_attr=fluid.ParamAttr(
                    initializer=fluid.initializer.Uniform(-stdv, stdv)))

        def forward(self, inputs):
            y = self.pool2d_max(self.conv(inputs))
            for block in self.blocks:
                y = block(y)
            y = self.pool2d_avg(y)
            y = lower("reshape2", ("X",), {"shape": [-1, self.features]},
                      "Out", y)
            return self.out(y)

    return ResNet()


def dygraph_resnet_optimizer(fluid):
    """``train.py``'s ``optimizer_setting``: Momentum(RESNET_MOMENTUM) over
    ``PiecewiseDecay`` (RESNET_BASE_LR, a tenth at each boundary) with
    ``L2Decay(RESNET_L2)``, which neither package's dygraph optimizer
    applies."""
    step = int(RESNET_TOTAL_IMAGES / RESNET_STRATEGY_BATCH + 1)
    boundaries = [step * e for e in RESNET_LR_EPOCHS]
    values = [RESNET_BASE_LR * 0.1 ** i for i in range(len(boundaries) + 1)]
    return fluid.optimizer.Momentum(
        learning_rate=fluid.dygraph.PiecewiseDecay(boundaries, values, 0),
        momentum=RESNET_MOMENTUM,
        regularization=fluid.regularizer.L2Decay(RESNET_L2))


def dygraph_resnet_loss(fluid, net, img, label):
    """(mean cross-entropy, softmax output) of ``net`` on one batch of
    VarBases, through ``cross_entropy`` and ``mean`` as ``train.py`` takes
    them."""
    lower = fluid.dygraph.nn._lowering_apply
    out = net(img)
    loss = lower("cross_entropy", ("X", "Label"), {}, "Y", out, label)
    return lower("mean", ("X",), {}, "Out", loss), out


def dygraph_resnet_step(fluid, net, opt, img, label):
    """One training step as ``train.py`` takes it: the loss, ``backward``,
    ``minimize`` over the parameters and ``clear_gradients``.  Returns
    (loss, softmax output) as VarBases."""
    loss, out = dygraph_resnet_loss(fluid, net, img, label)
    loss.backward()
    opt.minimize(loss, parameter_list=net.parameters())
    net.clear_gradients()
    return loss, out


def dygraph_resnet_feed(cfg, seed):
    """Images [B, 3, S, S] f32 and labels [B, 1] int64 from
    ``numpy.random.RandomState(seed)``, as ``datasets/flowers.py``'s
    synthetic fallback makes them at 32 x 32, scaled to S: noise in
    [0, 0.3) and 0.7 added to one S/8 square, at cell label mod 64 of an
    8 x 8 grid, in channel label mod 3, so the label follows from the
    image (the pair is unique below 192 classes)."""
    rng = np.random.RandomState(seed)
    B, S = cfg.batch, cfg.image
    cell = S // 8
    label = rng.randint(0, cfg.classes, B)
    img = rng.rand(B, 3, S, S).astype(np.float32) * 0.3
    for b, lab in enumerate(label):
        r, c = divmod(int(lab) % 64, 8)
        img[b, lab % 3, r * cell:(r + 1) * cell, c * cell:(c + 1) * cell] += 0.7
    return img, label.reshape(B, 1).astype(np.int64)


def dygraph_resnet_train_flops(cfg):
    """Multiply-add FLOPs of one training step (3x the forward): every
    convolution and the fc (batch norm, pooling and the elementwise work
    not counted)."""
    S, B = cfg.image, cfg.batch
    widths = [cfg.base_width * 2 ** i for i in range(len(cfg.depth))]
    H = S // 2
    macs = H * H * 49 * 3 * widths[0]
    H = -(-H // 2)
    cin = widths[0]
    for stage, n in enumerate(cfg.depth):
        w = widths[stage]
        for i in range(n):
            stride = 2 if i == 0 and stage != 0 else 1
            Ho = -(-H // stride)
            macs += H * H * cin * w + Ho * Ho * (9 * w * w + w * 4 * w)
            if i == 0:
                macs += Ho * Ho * cin * 4 * w
            H, cin = Ho, 4 * w
    macs += cin * cfg.classes
    return 3 * 2 * B * macs
