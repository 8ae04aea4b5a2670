"""Rule-based sharding core: ONE authority for how every leaf shards
(counterpart of ``paddle_tpu/parallel/rules.py``, a copy).

Sharding is DATA: an ordered list of ``(regex-over-leaf-path,
PartitionSpec)`` rules resolved against a tree's '/'-joined leaf paths
(``match_partition_rules``).  A ``ShardingAuthority`` bundles one rule tree
with (optionally) a mesh; the model spec builders
(``parallel/transformer.py``), the ZeRO step and ``shard_pytree`` resolve
their layouts through it, and ``hostps_row_range`` is the one definition of
which rank owns which rows of a host sparse table.

``PartitionSpec`` is the port's own: a tuple of axis names (or tuples of
them, or None) per dimension, as ``jax.sharding.PartitionSpec`` is.  Where
the reference places a tree with ``NamedSharding``, the authority's
``shard`` calls ``train.shard_pytree``: rank 0's value of a replicated leaf
on every rank, and this rank's slice of a sharded one.
"""

import math
import re

from .mesh import DP, PP, TP

__all__ = [
    "PartitionSpec",
    "P",
    "leaf_paths",
    "match_partition_rules",
    "SkeletonLeaf",
    "ShardingAuthority",
    "tp_split_specs",
    "tp_split_rules",
    "batch_spec",
    "row_sharded_table_spec",
    "hostps_row_range",
    "hostps_row_ranges",
    "transformer_rules",
    "deepfm_rules",
    "moe_rules",
]


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a leaf: ``P("dp", None)`` splits dim 0
    over dp and replicates dim 1; ``P()`` replicates the leaf.  A tuple, so
    a tree of specs treats each spec as one leaf."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        # pickle rebuilds a tuple subclass from these: the parts, unpacked
        return tuple(self)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec


def _map_paths(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists, the structure
    kept."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def leaf_paths(tree):
    """``(paths, leaves, tree)``: the '/'-joined string path of every leaf
    and the leaves, in ``jax.tree``'s order (lists by index, dicts by sorted
    key) — the canonical leaf addressing every rule matches against."""
    pairs = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            pairs.append(("/".join(path), t))

    walk(tree, ())
    return [p for p, _ in pairs], [v for _, v in pairs], tree


def _resolve(rules, name, leaf, strict, default):
    """One leaf's spec: scalars replicate, else first matching rule wins."""
    shape = getattr(leaf, "shape", None)
    if shape is not None and (len(shape) == 0 or math.prod(shape) == 1):
        return P()          # never partition scalars
    for rule, spec in rules:
        if re.search(rule, name) is not None:
            return spec if isinstance(spec, P) else P(*spec)
    if strict:
        raise ValueError(
            "no partition rule matches leaf %r (rules: %s)"
            % (name, [r for r, _ in rules]))
    return P() if default is None else default


def match_partition_rules(rules, tree, strict=True, default=None):
    """Resolve an ordered ``[(regex, PartitionSpec)]`` rule list against a
    tree -> a tree of PartitionSpec with the same structure.

    Leaf addressing is ``leaf_paths`` ('/'-joined).  Scalar leaves (shape
    () or one element) always get ``P()`` regardless of rules; leaves
    without a ``.shape`` (structure skeletons) skip that shortcut and must
    match a rule.  First matching rule wins — order rules specific-first.
    strict=False hands unmatched leaves ``default`` (``P()`` when None)
    instead of raising."""
    return _map_paths(lambda n, v: _resolve(rules, n, v, strict, default),
                      tree)


class SkeletonLeaf:
    """Shape-less placeholder leaf for resolving rules against a tree
    STRUCTURE when no live tensors exist yet: having no ``.shape``, it
    skips the scalar-replicate shortcut, so every leaf must match a rule."""


class ShardingAuthority:
    """One rule tree + (optionally) one mesh = every sharding decision.

    Consumers ask an authority instead of carrying their own PartitionSpec
    literals; swapping the rules (or the mesh) re-derives every layout."""

    def __init__(self, rules, mesh=None, strict=True, default=None):
        self.rules = list(rules)
        self.mesh = mesh
        self.strict = strict
        self.default = default

    # -- specs -----------------------------------------------------------
    def spec(self, name, leaf=None):
        """PartitionSpec for one leaf by path/name."""
        return _resolve(self.rules, name, leaf, self.strict, self.default)

    def spec_tree(self, tree):
        return match_partition_rules(self.rules, tree, strict=self.strict,
                                     default=self.default)

    # -- placement (mesh required) ---------------------------------------
    def _require_mesh(self):
        if self.mesh is None:
            raise ValueError("ShardingAuthority has no mesh: construct it "
                             "with mesh= to derive placements")
        return self.mesh

    def shard(self, tree):
        """Every leaf placed by its rule-derived spec (``shard_pytree``)."""
        from .train import shard_pytree

        return shard_pytree(tree, self.spec_tree(tree), self._require_mesh())

    # -- HostPS row partition --------------------------------------------
    def row_range(self, rank, world, vocab_size):
        return hostps_row_range(rank, world, vocab_size)


# -- compiler: _tp_split markers as rules -------------------------------------

def tp_split_specs(marks, model_axis="model"):
    """``{var_name: PartitionSpec}`` from a program's tensor-parallel
    markers — the one place the marker->spec translation lives.

    marks: ``{var_name: ("col"|"row", ndim)}`` — 'col' shards the LAST dim
    over the model axis (column-parallel fc weight [in, out], its bias,
    col-split embedding); 'row' shards the FIRST dim (row-parallel fc,
    vocab-split embedding).  One pass, exact names: compiler.py resolves
    its vars here directly (a regex rule per exact name would cost a
    linear scan PER VAR — quadratic on big programs — for no generality)."""
    specs = {}
    for name, (kind, nd) in marks.items():
        if kind == "col":
            spec = tuple([None] * (max(nd, 1) - 1) + [model_axis])
        elif kind == "row":
            spec = tuple([model_axis] + [None] * (max(nd, 1) - 1))
        else:
            raise ValueError("unknown tp split kind %r for %r" % (kind, name))
        specs[name] = P(*spec)
    return specs


def tp_split_rules(marks, model_axis="model"):
    """The same translation as an exact-match rule list, for consumers
    that want to COMPOSE tp markers with other rules in one authority."""
    return [(r"^%s$" % re.escape(name), spec)
            for name, spec in sorted(tp_split_specs(marks,
                                                    model_axis).items())]


def batch_spec(axis=DP):
    """THE [batch, ...] data layout: batch split over `axis` (dp), trailing
    dims replicated (pp microbatching happens inside the step).  mesh.py's
    batch_spec and the multichip dryrun's feed specs delegate here."""
    return P(axis)


# -- HostPS / row-sharded embedding tables ------------------------------------

def row_sharded_table_spec(axis=DP):
    """THE row-sharded [V, D] table layout (embedding_spec, the HostPS
    router, DeepFM's tables): rows over `axis`, columns replicated."""
    return P(axis, None)


def hostps_row_range(rank, world, vocab_size):
    """Contiguous row range ``[lo, hi)`` of a [vocab, D] host sparse table
    owned by `rank` in a `world`-process fleet — the single definition of
    the HostPS row partition.  Balanced: the first ``vocab % world`` ranks
    hold one extra row.  The elastic checkpoint re-sharder (ft/ckpt.py)
    uses this to repartition saved row shards for a NEW world size, and the
    RUNTIME shard router (hostps/shard_router.py) routes every live
    pull/push by the same function — checkpoint-time and wire-time
    partitions can never disagree."""
    rank, world, vocab_size = int(rank), int(world), int(vocab_size)
    if world <= 0 or not (0 <= rank < world):
        raise ValueError("rank %d outside world %d" % (rank, world))
    base, extra = divmod(vocab_size, world)
    lo = rank * base + min(rank, extra)
    hi = lo + base + (1 if rank < extra else 0)
    return lo, hi


def hostps_row_ranges(world, vocab_size):
    """Every rank's ``[lo, hi)`` for one world size, ascending rank — the
    shard router's routing table (adjacent, disjoint, covering
    [0, vocab))."""
    return [hostps_row_range(r, world, vocab_size) for r in range(world)]


# -- model rule trees ---------------------------------------------------------
# New models get sharded by ADDING A RULE LIST HERE (or next to the model)
# and resolving it with match_partition_rules — not by writing spec code.

def transformer_rules(cfg):
    """Rule list reproducing the transformer layout: tp shards attention /
    mlp weights when attn_mode == "heads" (ring mode replicates over tp),
    pp leads the stacked-layer arrays when cfg.pp > 1, tok_emb is
    vocab-parallel over tp."""
    tp = TP if cfg.attn_mode == "heads" else None
    lead = (PP, None) if cfg.pp > 1 else (None,)

    def L(*dims):       # a [L, ...] (or [pp, L/pp, ...]) stacked-layer leaf
        return P(*(lead + dims))

    return [
        (r"^tok_emb$", P(TP, None)),                 # vocab-parallel
        (r"^pos_emb$|^lnf_", P()),
        (r"/ln[12]_(scale|bias)$", L(None)),
        (r"/(wq|wk|wv|bqkv)$", L(None, tp)),
        (r"/wo$", L(tp, None)),
        (r"/(bo|b2)$", L(None)),
        (r"/(w1)$", L(None, tp)),
        (r"/b1$", L(tp)),
        (r"/w2$", L(tp, None)),
    ]


def deepfm_rules(axis=DP):
    """DeepFM: embedding tables row-sharded over `axis` (the same layout
    the HostPS router serves from host RAM past the HBM budget), dense MLP
    + bias replicated."""
    return [
        (r"^(w_linear|embed)$", row_sharded_table_spec(axis)),
        (r"^bias$|^mlp/", P()),
    ]


def moe_rules(ep_axis=DP):
    """MoE: experts sharded over `ep_axis`, router replicated (its grads
    must be psum'd over ep)."""
    return [
        (r"^router$", P()),
        (r"^w[12]$", P(ep_axis)),
    ]
