"""The Fluid book suite's training programs, as the JAX package's
``tests/test_book_models.py`` builds them, on whichever ``fluid`` the
caller passes (``paddle_tpu_torch``, or the JAX package in the parity
tests), so that ``chip_smoke.py`` and the tests train the same programs on
the same data.

``build(fluid, book, datasets, model, **sizes)`` returns a ``BookRun``: the
main and startup programs (built under a fresh ``unique_name.guard()``, so
the two packages name every var alike), the feed (one batch, read through
``datasets``' loaders and the package's ``DataFeeder``), the fetches, the
convergence contract (threshold and step budget) and the Adam learning
rate (None under SGD).  ``book`` and ``datasets`` are the caller's
package's ``models.book`` and ``datasets``.

``MODELS`` names the eleven runs: word2vec with its three heads, the
recommender, sentiment (conv and stacked LSTM), semantic-role labelling,
fit_a_line, image classification (ResNet-CIFAR depth 8 and VGG) and the
RNN encoder-decoder, at the builders' default widths and the tests' batch
sizes, step budgets and thresholds.  ``sizes`` shrink a run for the CPU
parity tests (``n`` rows of data; SRL's ``hidden_dim`` and ``depth``), or
give the image nets another ``dtype`` (their parameters follow the
images'; ``chip_smoke.py`` runs them in float64 where f32 rounding flips a
ReLU mask).
"""

import warnings

import numpy as np

__all__ = ["BookRun", "MODELS", "build", "pin_random_ops", "converged",
           "sparse_tables", "param_errors"]

MODELS = ("word2vec_softmax", "word2vec_hsigmoid", "word2vec_nce",
          "recommender", "sentiment_conv", "sentiment_lstm", "semantic_roles",
          "fit_a_line", "image_resnet", "image_vgg", "rnn_encoder_decoder")

SRL_NAMES = ["word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
             "predicate", "mark", "target"]

# the negatives the parity runs fix for ``nce`` (its sampler's bits differ
# between the packages and between devices)
NCE_NEGATIVES = (3, 17, 42, 101, 150)


class BookRun:
    """One model's program and data.  ``contract``: ("below", threshold,
    steps) for a cost, ("acc", threshold, steps) for an accuracy fetched
    last, ("srl", ratio, steps) for the semantic-role test's cost ratio."""

    def __init__(self, main, startup, cost, feed, fetch, contract, adam_lr,
                 extra=None):
        self.main, self.startup, self.cost = main, startup, cost
        self.feed, self.fetch = feed, fetch
        self.contract, self.adam_lr = contract, adam_lr
        self.extra = extra or {}


def _word2vec(fluid, book, ds, loss_type, n=256, is_sparse=False):
    word_idx = ds.imikolov.build_dict()
    grams = np.asarray(list(ds.imikolov.train(word_idx, 5)())[:n], "int64")
    ws = [fluid.layers.data("w%d" % i, shape=[1], dtype="int64")
          for i in range(4)]
    nxt = fluid.layers.data("nxt", shape=[1], dtype="int64")
    _, cost = book.build_word2vec(ws, nxt, len(word_idx), loss_type=loss_type,
                                  is_sparse=is_sparse)
    feed = {("w%d" % i): grams[:, i:i + 1] for i in range(4)}
    feed["nxt"] = grams[:, 4:5]
    thresh = {"softmax": 2.0, "hsigmoid": 2.0, "nce": 1.0}[loss_type]
    steps = {"softmax": 300, "hsigmoid": 300, "nce": 400}[loss_type]
    return cost, feed, [cost], ("below", thresh, steps), 1e-2, None


def _recommender(fluid, book, ds, n=256):
    mv = ds.movielens
    samples = list(mv.train()())[:n]
    L = fluid.layers
    names = ["usr_id", "usr_gender", "usr_age", "usr_job", "mov_id"]
    ids = [L.data(nm, shape=[1], dtype="int64") for nm in names]
    mov_cat = L.data("mov_cat", shape=[-1], dtype="int64", lod_level=1)
    cat_len = L.data("mov_cat_seq_len", shape=[], dtype="int64")
    mov_title = L.data("mov_title", shape=[-1], dtype="int64", lod_level=1)
    title_len = L.data("mov_title_seq_len", shape=[], dtype="int64")
    score = L.data("score", shape=[1], dtype="float32")
    _, cost = book.build_recommender(
        *ids, mov_cat, mov_title, score, cat_len, title_len, mv.max_user_id(),
        mv.max_job_id(), mv.max_movie_id(), len(mv.movie_categories()),
        len(mv.get_movie_title_dict()) + 1)
    feeder = fluid.DataFeeder(feed_list=names + ["mov_cat", "mov_title",
                                                 "score"],
                              program=fluid.default_main_program())
    rows = [([s[0]], [s[1]], [s[2]], [s[3]], [s[4]], s[5], s[6] or [0],
             [s[7][0]]) for s in samples]
    return cost, feeder.feed(rows), [cost], ("below", 1.5, 250), 2e-3, None


def _sentiment(fluid, book, ds, net, n=48):
    it = iter(ds.imdb.train()())
    docs = []
    for _ in range(n):
        ids, lab = next(it)
        docs.append((ids[:40], [lab]))
    words = fluid.layers.data("words", shape=[-1], dtype="int64", lod_level=1)
    seq_len = fluid.layers.data("words_seq_len", shape=[], dtype="int64")
    label = fluid.layers.data("label", shape=[1], dtype="int64")
    build = (book.build_sentiment_conv if net == "conv"
             else book.build_sentiment_lstm)
    _, cost, acc = build(words, seq_len, label, ds.imdb.VOCAB)
    feed = fluid.DataFeeder(feed_list=["words", "label"],
                            program=fluid.default_main_program()).feed(docs)
    return cost, feed, [cost, acc], ("acc", 0.95, 120), 2e-3, None


def _semantic_roles(fluid, book, ds, n=48, hidden_dim=128, depth=4):
    word_dict, verb_dict, label_dict = ds.conll05.get_dict()
    samples = list(ds.conll05.test()())[:n]
    vars_ = [fluid.layers.data(nm, shape=[-1], dtype="int64", lod_level=1)
             for nm in SRL_NAMES]
    seq_len = fluid.layers.data("word_seq_len", shape=[], dtype="int64")
    _, cost, decode = book.build_label_semantic_roles(
        *vars_, seq_len=seq_len, word_dict_len=len(word_dict),
        pred_dict_len=len(verb_dict), label_dict_len=len(label_dict),
        depth=depth, hidden_dim=hidden_dim)
    feed = fluid.DataFeeder(feed_list=SRL_NAMES,
                            program=fluid.default_main_program()).feed(
        [tuple(s) for s in samples])
    return (cost, feed, [cost], ("srl", 0.6, 60), None,
            {"decode": decode, "n_labels": len(label_dict)})


def _fit_a_line(fluid, book, ds, n=256):
    samples = list(ds.uci_housing.train()())[:n]
    xs = np.asarray([s[0] for s in samples], "f4")
    ys = np.asarray([s[1] for s in samples], "f4").reshape(-1, 1)
    x = fluid.layers.data("x", shape=[xs.shape[1]], dtype="float32")
    y = fluid.layers.data("y", shape=[1], dtype="float32")
    _, cost = book.build_fit_a_line(x, y)
    return cost, {"x": xs, "y": ys}, [cost], ("below", 10.0, 300), None, None


def _image(fluid, book, ds, net_type, n=64, dtype="float32"):
    samples = list(ds.cifar.train10()())[:n]
    xs = np.asarray([s[0] for s in samples], dtype).reshape(-1, 3, 32, 32)
    ys = np.asarray([s[1] for s in samples], "int64").reshape(-1, 1)
    images = fluid.layers.data("images", shape=[3, 32, 32], dtype=dtype)
    label = fluid.layers.data("label", shape=[1], dtype="int64")
    _, cost, acc = book.build_image_classification(images, label,
                                                   net_type=net_type)
    return (cost, {"images": xs, "label": ys}, [cost, acc],
            ("acc", 0.9, 150), 2e-3, None)


def _rnn_encoder_decoder(fluid, book, ds, n=32):
    V, T = 20, 6
    L = fluid.layers
    src = L.data("src", shape=[T], dtype="int64")
    src_len = L.data("src_len", shape=[], dtype="int64")
    tgt_in = L.data("tgt_in", shape=[T], dtype="int64")
    tgt_out = L.data("tgt_out", shape=[T], dtype="int64")
    tgt_len = L.data("tgt_len", shape=[], dtype="int64")
    _, cost = book.build_rnn_encoder_decoder(src, src_len, tgt_in, tgt_out,
                                             tgt_len, V, V)
    s = np.random.RandomState(0).randint(2, V, (n, T)).astype("int64")
    feed = {"src": s, "src_len": np.full((n,), T, "int64"),
            "tgt_in": np.concatenate([np.zeros((n, 1), "int64"), s[:, :-1]], 1),
            "tgt_out": s, "tgt_len": np.full((n,), T, "int64")}
    return cost, feed, [cost], ("below", 0.5, 250), 5e-3, None


_BUILDERS = {
    "word2vec_softmax": lambda *a, **k: _word2vec(*a, "softmax", **k),
    "word2vec_hsigmoid": lambda *a, **k: _word2vec(*a, "hsigmoid", **k),
    "word2vec_nce": lambda *a, **k: _word2vec(*a, "nce", **k),
    "recommender": _recommender,
    "sentiment_conv": lambda *a, **k: _sentiment(*a, "conv", **k),
    "sentiment_lstm": lambda *a, **k: _sentiment(*a, "lstm", **k),
    "semantic_roles": _semantic_roles,
    "fit_a_line": _fit_a_line,
    "image_resnet": lambda *a, **k: _image(*a, "resnet", **k),
    "image_vgg": lambda *a, **k: _image(*a, "vgg", **k),
    "rnn_encoder_decoder": _rnn_encoder_decoder,
}


def build(fluid, book, datasets, model, optimizer=None, **sizes):
    """The test's program for ``model`` with its optimizer (Adam at the
    test's rate; SGD at 0.01 for fit_a_line; SGD on SRL's
    ``exponential_decay``), or ``optimizer(fluid, lr)`` in its place, which
    returns the optimizer to minimize with (``amp.decorate`` wraps one
    so)."""
    main, startup = fluid.Program(), fluid.Program()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # the synthetic-corpus notes
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            cost, feed, fetch, contract, lr, extra = _BUILDERS[model](
                fluid, book, datasets, **sizes)
            if model == "semantic_roles":
                opt = fluid.optimizer.SGD(
                    learning_rate=fluid.layers.exponential_decay(
                        learning_rate=0.01, decay_steps=100, decay_rate=0.5,
                        staircase=True))
            elif model == "fit_a_line":
                opt = fluid.optimizer.SGD(learning_rate=0.01)
            elif optimizer is not None:
                opt = optimizer(fluid, lr)
            else:
                opt = fluid.optimizer.Adam(lr)
            opt.minimize(cost)
    return BookRun(main, startup, cost, feed, fetch, contract, lr, extra)


def pin_random_ops(main):
    """Make ``main`` compute the same function on any device and in either
    package: ``nce`` draws ``NCE_NEGATIVES``, and ``dropout`` runs as the
    test clone runs it."""
    for op in main.global_block().ops:
        if op.type == "nce":
            op.attrs["custom_neg_classes"] = list(NCE_NEGATIVES)
        if op.type == "dropout":
            op.attrs["is_test"] = True


def converged(contract, values):
    """Whether the fetched values of the steps so far meet the contract:
    the last value below / at its threshold, or for SRL (after the budget)
    the last cost below ratio x the first."""
    kind, thresh, budget = contract
    if kind == "below":
        return values[-1] < thresh
    if kind == "acc":
        return values[-1] >= thresh
    return len(values) >= budget and values[-1] < values[0] * thresh


def sparse_tables(main):
    """The tables of ``main``'s ``is_sparse`` lookups: their gradient is a
    SelectedRows inside the executor, not a fetch."""
    return {op.inputs["W"][0] for op in main.global_block().ops
            if op.type in ("lookup_table", "lookup_table_v2")
            and op.attrs.get("is_sparse")}


def param_errors(got, want, grad_floor, small_g):
    """Per parameter, the largest |got - want| over the elements whose
    gradient stayed above ``small_g`` in every step (``grad_floor``: name ->
    the least |gradient| an element saw, from the reference run; a
    parameter without one counts as all above) and over the others, and
    the largest |want|: {name: (err_above, err_small, n_small_parted,
    scale)}, ``n_small_parted`` counting the small-gradient elements that
    parted by more than ``small_g``.  Under Adam an element whose gradient
    is rounding noise (a bias before a batch norm) moves by lr * sign(noise)
    a step, so two runs may part there by up to 2 * lr a step while the
    rest agree to rounding."""
    out = {}
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(got[name], np.float64) - w)
        floor = grad_floor.get(name)
        small = (np.zeros(w.shape, bool) if floor is None
                 else np.asarray(floor) <= small_g)
        out[name] = (float(err[~small].max(initial=0.0)),
                     float(err[small].max(initial=0.0)),
                     int((err[small] > small_g).sum()),
                     max(float(np.abs(w).max(initial=0.0)), 1e-30))
    return out
