"""The Fluid CTR program of the data path and the MultiSlot files it reads,
built with either package (``fluid`` is ``paddle_tpu_torch`` or the JAX
package), so that the CPU tests can hold the port to the JAX package on the
same files and startup values and ``chip_smoke.py`` can train it on the
card.

The program is the JAX package's ``tests/test_dataset.py`` CTR program
(two ``is_sparse`` tables, an embedding of width ``embed`` and a
first-order table of width 1, the FM interaction, a ReLU MLP, the sigmoid
cross-entropy, Adam), with the MLP's widths as a parameter: one layer of 32
in that test, 400-400-400 at BASELINE config 5's widths (``DeepFMConfig``).

Each line of a file is ``<n_fields> id ... 1 <label>``: the ids slot, then
the label slot.  The label is a fixed function of the ids (the sign of a
seeded weight's sum over them), so training can learn it.  Ids are uniform
over the vocabulary, or drawn from a Zipf law of exponent ``zipf`` over it
(rank k with probability proportional to k^-zipf, ranks scattered over the
ids by a seeded permutation), as CTR feature ids are.
"""

import collections
import os

import numpy as np

__all__ = ["CtrProgram", "write_ctr_files", "build_ctr_program",
           "make_dataset", "persistable_names"]

CtrProgram = collections.namedtuple(
    "CtrProgram", "main startup loss ids label tables auc",
    defaults=(None,))


def _zipf_ids(rng, vocab, shape, a):
    """Ids in [0, vocab) with P(rank k) ~ k^-a, ranks permuted over ids."""
    weights = np.arange(1, vocab + 1, dtype=np.float64) ** -a
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    perm = rng.permutation(vocab)
    ranks = np.searchsorted(cdf, rng.random_sample(shape), side="right")
    return perm[np.minimum(ranks, vocab - 1)]


def write_ctr_files(dirname, n_files=3, rows_per_file=64, n_fields=8,
                    vocab=200, seed=0, zipf=None, malformed_every=None):
    """Write ``n_files`` MultiSlot files into ``dirname``; returns their
    paths.  With ``malformed_every = k`` every k-th line is a truncated
    record (its ids slot promises more ids than follow), which the parsers
    drop."""
    rng = np.random.RandomState(seed)
    w = rng.randn(vocab) * 0.5
    os.makedirs(dirname, exist_ok=True)
    files = []
    for fi in range(n_files):
        if zipf is None:
            ids = rng.randint(0, vocab, (rows_per_file, n_fields))
        else:
            ids = _zipf_ids(rng, vocab, (rows_per_file, n_fields), zipf)
        label = (w[ids].sum(axis=1) > 0).astype(np.int64)
        ids_txt = [" ".join(map(str, r)) for r in ids.tolist()]
        lines = ["%d %s 1 %d.0\n" % (n_fields, t, lab)
                 for t, lab in zip(ids_txt, label.tolist())]
        if malformed_every:
            for i in range(malformed_every - 1, len(lines), malformed_every):
                lines[i] = "%d %s\n" % (n_fields, ids_txt[i].split(" ", 1)[0])
        path = os.path.join(dirname, "part-%05d" % fi)
        with open(path, "w") as f:
            f.writelines(lines)
        files.append(path)
    return files


def build_ctr_program(fluid, n_fields=8, vocab=200, embed=8, mlp=(32,),
                      lr=5e-3, wrap_optimizer=None, auc=False):
    """The CTR program under a fresh ``unique_name`` guard, so that both
    packages name its variables alike.  ``wrap_optimizer(opt)`` (for
    example ``fleet.distributed_optimizer``) wraps Adam before its
    ``minimize``.  With ``auc``, the program also computes the click
    probability's AUC (``layers.auc``); ``CtrProgram.auc`` is then a dict of
    its vars: "auc", "stat_pos", "stat_neg", "prob" and "terms" (the
    per-example losses)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data("feat_ids", shape=[n_fields], dtype="int64")
        label = fluid.layers.data("label", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(ids, size=[vocab, embed], is_sparse=True)
        first = fluid.layers.embedding(ids, size=[vocab, 1], is_sparse=True)
        # FM second-order interaction: 0.5*((sum v)^2 - sum v^2)
        s = fluid.layers.reduce_sum(emb, dim=1)                  # [B, D]
        sq = fluid.layers.reduce_sum(
            fluid.layers.elementwise_mul(emb, emb), dim=1)       # [B, D]
        fm = fluid.layers.reduce_sum(
            fluid.layers.elementwise_sub(
                fluid.layers.elementwise_mul(s, s), sq),
            dim=1, keep_dim=True)                                # [B, 1]
        lin = fluid.layers.reduce_sum(first, dim=1)              # [B, 1]
        deep = fluid.layers.reshape(emb, [-1, n_fields * embed])
        for width in mlp:
            deep = fluid.layers.fc(deep, width, act="relu")
        logit = fluid.layers.elementwise_add(
            fluid.layers.elementwise_add(fluid.layers.fc(deep, 1), lin),
            fluid.layers.scale(fm, 0.5))
        terms = fluid.layers.sigmoid_cross_entropy_with_logits(logit, label)
        loss = fluid.layers.mean(terms)
        metric = None
        if auc:
            prob = fluid.layers.sigmoid(logit)
            two = fluid.layers.concat(
                [fluid.layers.scale(prob, -1.0, bias=1.0), prob], axis=1)
            value, (stat_pos, stat_neg) = fluid.layers.auc(
                two, fluid.layers.cast(label, "int64"))
            metric = {"auc": value, "stat_pos": stat_pos,
                      "stat_neg": stat_neg, "prob": prob, "terms": terms}
        opt = fluid.optimizer.Adam(lr)
        if wrap_optimizer is not None:
            opt = wrap_optimizer(opt)
        opt.minimize(loss)
    tables = sorted(op.inputs["W"][0] for op in main.global_block().ops
                    if op.type in ("lookup_table", "lookup_table_v2"))
    return CtrProgram(main, startup, loss, ids, label, tables, metric)


def make_dataset(fluid, kind, files, prog, batch, thread=1):
    """A ``kind`` ("QueueDataset" or "InMemoryDataset") dataset over
    ``files`` feeding ``prog``'s ids and label."""
    ds = fluid.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_thread(thread)
    ds.set_filelist(list(files))
    ds.set_use_var([prog.ids, prog.label])
    return ds


def persistable_names(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)
