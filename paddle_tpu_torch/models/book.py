"""Book-suite model builders (parity: python/paddle/fluid/tests/book/ —
test_word2vec.py, test_recommender_system.py, notest_understand_sentiment.py,
test_label_semantic_roles.py network definitions).

Each builder constructs the fluid-API static graph exactly the way the
reference book test does, returning the tensors its training loop fetches.
The corresponding convergence tests (tests/test_book_models.py) train to an
accuracy/cost threshold and fail on NaN — the book-test contract
(test_recognize_digits.py:126-147).  A copy of the JAX package's
``models/book.py``, with ``fluid`` the port."""

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers

__all__ = ["build_word2vec", "build_recommender", "build_sentiment_lstm",
           "build_sentiment_conv", "build_label_semantic_roles",
           "build_fit_a_line", "build_image_classification",
           "build_rnn_encoder_decoder",
           "resnet_cifar10", "vgg_bn_drop"]


# ---------------------------------------------------------------------------
# word2vec (ref tests/book/test_word2vec.py: 4-gram context -> next word,
# shared embedding, hidden sigmoid fc, softmax / hsigmoid / nce head)
# ---------------------------------------------------------------------------

def build_word2vec(words, next_word, dict_size, embed_size=32,
                   hidden_size=256, loss_type="softmax", is_sparse=False,
                   neg_num=5):
    """words: list of 4 [B,1] int64 vars (context); next_word: [B,1] int64.
    Returns (predict_or_none, avg_cost)."""
    embs = []
    for w in words:
        embs.append(layers.embedding(
            w, size=[dict_size, embed_size], dtype="float32",
            is_sparse=is_sparse,
            param_attr=fluid.ParamAttr(name="shared_w")))
    concat = layers.concat(embs, axis=1)
    concat = layers.reshape(concat, [-1, embed_size * len(words)])
    hidden = layers.fc(concat, size=hidden_size, act="sigmoid")
    if loss_type == "softmax":
        predict = layers.fc(hidden, size=dict_size, act="softmax")
        cost = layers.cross_entropy(input=predict, label=next_word)
    elif loss_type == "hsigmoid":
        predict = None
        cost = layers.hsigmoid(hidden, next_word, dict_size)
    elif loss_type == "nce":
        predict = None
        cost = layers.nce(hidden, next_word, dict_size,
                          num_neg_samples=neg_num)
    else:
        raise ValueError(loss_type)
    return predict, layers.mean(cost)


# ---------------------------------------------------------------------------
# recommender system (ref tests/book/test_recommender_system.py: user/movie
# feature towers -> cos_sim * 5 vs rating, square error)
# ---------------------------------------------------------------------------

def _usr_features(usr_id, usr_gender, usr_age, usr_job, max_usr, max_job):
    emb = layers.embedding(usr_id, size=[max_usr + 1, 32], is_sparse=True)
    usr_fc = layers.fc(emb, size=32)
    g_emb = layers.embedding(usr_gender, size=[2, 16], is_sparse=True)
    g_fc = layers.fc(g_emb, size=16)
    a_emb = layers.embedding(usr_age, size=[len([1, 18, 25, 35, 45, 50, 56]),
                                            16], is_sparse=True)
    a_fc = layers.fc(a_emb, size=16)
    j_emb = layers.embedding(usr_job, size=[max_job + 1, 16], is_sparse=True)
    j_fc = layers.fc(j_emb, size=16)
    concat = layers.concat([usr_fc, g_fc, a_fc, j_fc], axis=-1)
    return layers.fc(concat, size=200, act="tanh")


def _mov_features(mov_id, mov_categories, mov_title, cat_len, title_len,
                  max_mov, n_categories, title_vocab):
    emb = layers.embedding(mov_id, size=[max_mov + 1, 32], is_sparse=True)
    mov_fc = layers.fc(emb, size=32)
    cat_emb = layers.embedding(mov_categories, size=[n_categories, 32],
                               is_sparse=True)
    cat_pool = layers.sequence_pool(cat_emb, "sum", seq_len=cat_len)
    title_emb = layers.embedding(mov_title, size=[title_vocab, 32],
                                 is_sparse=True)
    title_conv = layers.sequence_conv(title_emb, num_filters=32,
                                      filter_size=3, act="tanh",
                                      seq_len=title_len)
    title_pool = layers.sequence_pool(title_conv, "sum", seq_len=title_len)
    concat = layers.concat([mov_fc, cat_pool, title_pool], axis=-1)
    return layers.fc(concat, size=200, act="tanh")


def build_recommender(usr_id, usr_gender, usr_age, usr_job, mov_id,
                      mov_categories, mov_title, score, cat_len, title_len,
                      max_usr, max_job, max_mov, n_categories, title_vocab):
    """Returns (scale_infer, avg_cost): predicted rating in [-5, 5] and the
    square-error training cost."""
    usr = _usr_features(usr_id, usr_gender, usr_age, usr_job, max_usr,
                        max_job)
    mov = _mov_features(mov_id, mov_categories, mov_title, cat_len,
                        title_len, max_mov, n_categories, title_vocab)
    inference = layers.cos_sim(usr, mov)
    scale_infer = layers.scale(inference, scale=5.0)
    cost = layers.square_error_cost(scale_infer, score)
    return scale_infer, layers.mean(cost)


# ---------------------------------------------------------------------------
# understand_sentiment (ref tests/book/notest_understand_sentiment.py:
# stacked dynamic-LSTM net and the convolution net)
# ---------------------------------------------------------------------------

def build_sentiment_lstm(words, seq_len, label, dict_size, class_dim=2,
                         emb_dim=32, hid_dim=32, stacked_num=3):
    """Stacked bi-directional dynamic LSTM (ref stacked_lstm_net)."""
    assert stacked_num % 2 == 1
    emb = layers.embedding(words, size=[dict_size, emb_dim],
                           is_sparse=True)
    fc1 = layers.fc(emb, size=hid_dim * 4, num_flatten_dims=2)
    lstm1, cell1 = layers.dynamic_lstm(fc1, size=hid_dim * 4,
                                       seq_len=seq_len)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        con = layers.concat(inputs, axis=-1)
        fc = layers.fc(con, size=hid_dim * 4, num_flatten_dims=2)
        lstm, cell = layers.dynamic_lstm(fc, size=hid_dim * 4,
                                         is_reverse=(i % 2) == 0,
                                         seq_len=seq_len)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(inputs[0], "max", seq_len=seq_len)
    lstm_last = layers.sequence_pool(inputs[1], "max", seq_len=seq_len)
    prediction = layers.fc(layers.concat([fc_last, lstm_last], axis=-1),
                           size=class_dim, act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    acc = layers.accuracy(input=prediction, label=label)
    return prediction, layers.mean(cost), acc


def build_sentiment_conv(words, seq_len, label, dict_size, class_dim=2,
                         emb_dim=32, hid_dim=32):
    """Convolution net (ref convolution_net: two sequence_conv_pool towers)."""
    emb = layers.embedding(words, size=[dict_size, emb_dim], is_sparse=True)
    convs = []
    for fs in (3, 4):
        conv = layers.sequence_conv(emb, num_filters=hid_dim, filter_size=fs,
                                    act="tanh", seq_len=seq_len)
        convs.append(layers.sequence_pool(conv, "max", seq_len=seq_len))
    prediction = layers.fc(layers.concat(convs, axis=-1), size=class_dim,
                           act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    acc = layers.accuracy(input=prediction, label=label)
    return prediction, layers.mean(cost), acc


# ---------------------------------------------------------------------------
# label_semantic_roles (ref tests/book/test_label_semantic_roles.py: 8
# feature embeddings -> mixed fc -> stacked bidirectional LSTM -> CRF)
# ---------------------------------------------------------------------------

def build_label_semantic_roles(word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
                               predicate, mark, target, seq_len, word_dict_len,
                               pred_dict_len, label_dict_len, word_dim=32,
                               mark_dim=5, hidden_dim=128, depth=4):
    """Returns (feature_out, crf_avg_cost, crf_decode)."""
    assert depth % 2 == 0
    predicate_embedding = layers.embedding(
        predicate, size=[pred_dict_len, word_dim],
        param_attr=fluid.ParamAttr(name="vemb"))
    mark_embedding = layers.embedding(mark, size=[2, mark_dim])
    word_inputs = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
    emb_layers = [layers.embedding(x, size=[word_dict_len, word_dim])
                  for x in word_inputs]
    emb_layers += [predicate_embedding, mark_embedding]

    hidden_0 = layers.sums([
        layers.fc(emb, size=hidden_dim, num_flatten_dims=2)
        for emb in emb_layers])
    lstm_0, _ = layers.dynamic_lstm(hidden_0, size=hidden_dim,
                                    candidate_activation="relu",
                                    seq_len=seq_len)
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = layers.sums([
            layers.fc(input_tmp[0], size=hidden_dim, num_flatten_dims=2),
            layers.fc(input_tmp[1], size=hidden_dim, num_flatten_dims=2)])
        lstm, _ = layers.dynamic_lstm(mix_hidden, size=hidden_dim,
                                      candidate_activation="relu",
                                      is_reverse=(i % 2) == 1,
                                      seq_len=seq_len)
        input_tmp = [mix_hidden, lstm]

    feature_out = layers.sums([
        layers.fc(input_tmp[0], size=label_dict_len, num_flatten_dims=2),
        layers.fc(input_tmp[1], size=label_dict_len, num_flatten_dims=2)])

    # the linear_chain_crf op already emits the positive NLL as its
    # LogLikelihood output (reference convention, ops/crf_ops.py:9-12)
    crf_cost = layers.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=fluid.ParamAttr(name="crfw"), length=seq_len)
    avg_cost = layers.mean(crf_cost)
    crf_decode = layers.crf_decoding(
        input=feature_out, param_attr=fluid.ParamAttr(name="crfw"),
        length=seq_len)
    return feature_out, avg_cost, crf_decode


# ---------------------------------------------------------------------------
# fit_a_line (ref tests/book/test_fit_a_line.py: linear regression on
# uci_housing)
# ---------------------------------------------------------------------------

def build_fit_a_line(x, y):
    """Returns (y_predict, avg_cost) — the 13-feature linear regressor."""
    y_predict = layers.fc(x, size=1, act=None)
    cost = layers.square_error_cost(input=y_predict, label=y)
    return y_predict, layers.mean(cost)


# ---------------------------------------------------------------------------
# image_classification (ref tests/book/test_image_classification.py:
# resnet_cifar10 + vgg16_bn_drop on cifar10)
# ---------------------------------------------------------------------------

def _conv_bn(input, ch_out, filter_size, stride, padding, act="relu",
             bias_attr=False):
    tmp = layers.conv2d(input, num_filters=ch_out, filter_size=filter_size,
                        stride=stride, padding=padding, act=None,
                        bias_attr=bias_attr)
    return layers.batch_norm(tmp, act=act)


def resnet_cifar10(input, depth=20):
    """The book test's pre-resnet CIFAR net ((depth-2) % 6 == 0)."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6

    def basicblock(x, ch_in, ch_out, stride):
        tmp = _conv_bn(x, ch_out, 3, stride, 1)
        tmp = _conv_bn(tmp, ch_out, 3, 1, 1, act=None, bias_attr=True)
        short = (x if ch_in == ch_out
                 else _conv_bn(x, ch_out, 1, stride, 0, act=None))
        return layers.elementwise_add(tmp, short, act="relu")

    def warp(x, ch_in, ch_out, count, stride):
        x = basicblock(x, ch_in, ch_out, stride)
        for _ in range(1, count):
            x = basicblock(x, ch_out, ch_out, 1)
        return x

    c1 = _conv_bn(input, 16, 3, 1, 1)
    r1 = warp(c1, 16, 16, n, 1)
    r2 = warp(r1, 16, 32, n, 2)
    r3 = warp(r2, 32, 64, n, 2)
    return layers.pool2d(r3, pool_size=8, pool_type="avg", pool_stride=1)


def vgg_bn_drop(input, groups=(2, 2)):
    """The book test's VGG backbone, shrunk by `groups` for test budgets
    (ref vgg16_bn_drop uses 5 conv blocks; the structure is identical)."""
    x = input
    num_filter = 64
    for g in groups:
        x = fluid.nets.img_conv_group(
            x, conv_num_filter=[num_filter] * g, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=0.0, pool_size=2, pool_stride=2,
            pool_type="max")
        num_filter *= 2
    drop = layers.dropout(x, dropout_prob=0.2)
    fc1 = layers.fc(drop, size=128, act=None)
    bn = layers.batch_norm(fc1, act="relu")
    drop2 = layers.dropout(bn, dropout_prob=0.2)
    return layers.fc(drop2, size=128, act=None)


def build_image_classification(images, label, net_type="resnet",
                               class_num=10):
    if net_type == "vgg":
        feat = vgg_bn_drop(images)
    else:
        feat = resnet_cifar10(images, depth=8)
    predict = layers.fc(feat, size=class_num, act="softmax")
    cost = layers.mean(layers.cross_entropy(input=predict, label=label))
    acc = layers.accuracy(input=predict, label=label)
    return predict, cost, acc


# ---------------------------------------------------------------------------
# rnn_encoder_decoder (ref tests/book/test_rnn_encoder_decoder.py: GRU
# seq2seq without attention; test_machine_translation.py adds beam decode —
# covered by models/transformer_nmt.beam_search on the transformer config)
# ---------------------------------------------------------------------------

def build_rnn_encoder_decoder(src, src_len, tgt_in, tgt_out, tgt_len,
                              src_vocab, tgt_vocab, embed_dim=32,
                              hidden_dim=32):
    """Returns (logits [B, T, V], avg_cost).  Encoder: embedding ->
    dynamic_gru, last valid state; decoder: embedding -> gru conditioned on
    the encoder state (concatenated per step), teacher-forced CE."""
    src_emb = layers.embedding(src, size=[src_vocab, embed_dim])
    enc_proj = layers.fc(src_emb, size=hidden_dim * 3, num_flatten_dims=2)
    enc = layers.dynamic_gru(enc_proj, size=hidden_dim, seq_len=src_len)
    enc_last = layers.sequence_pool(enc, "last", seq_len=src_len)  # [B, H]

    tgt_emb = layers.embedding(tgt_in, size=[tgt_vocab, embed_dim])
    T = tgt_emb.shape[1]
    ctx = layers.expand(layers.unsqueeze(enc_last, axes=[1]), [1, T, 1])
    dec_in = layers.concat([tgt_emb, ctx], axis=-1)
    dec_proj = layers.fc(dec_in, size=hidden_dim * 3, num_flatten_dims=2)
    dec = layers.dynamic_gru(dec_proj, size=hidden_dim, seq_len=tgt_len)
    logits = layers.fc(dec, size=tgt_vocab, num_flatten_dims=2)

    cost = layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(tgt_out, axes=[2]))
    mask = layers.cast(layers.sequence_mask(tgt_len, maxlen=T,
                                            dtype="float32"), "float32")
    cost = layers.reduce_sum(layers.squeeze(cost, axes=[2]) * mask) \
        / layers.reduce_sum(mask)
    return logits, cost
