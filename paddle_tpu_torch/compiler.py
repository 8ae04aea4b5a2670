"""CompiledProgram + Build/Execution strategies.

Parity: python/paddle/fluid/compiler.py:65 (CompiledProgram,
with_data_parallel :138) and framework/details/build_strategy.h.  The
counterpart of the JAX package's ``compiler.py``, which shards the batch of
one jitted step over a device mesh's data axis, so the sharded program
computes what the one-device program computes on the global batch.  Here a
data-parallel program runs over the ranks of the ``torch.distributed``
world (one process and one card a rank, ``fleet.init()`` or the launcher
makes the world): ``_ShardingInfo`` gives each rank its rows of every feed
(``parallel/rules.py`` ``batch_spec``), gathers batch-shaped fetches back to
the global value, and names the optimizer accumulators that kReduce holds as
1/n of their rows; the executor runs the program through the batch-axis
table (``parallel/batch_axes.py``).  Outside a world the program runs on one
rank.

As in the reference, ``places`` is recorded and not used (more than one
place in a process outside a world warns once: one process drives one
card); ``num_trainers``, ``trainer_id``, ``gradient_scale_strategy`` and
``sync_batch_norm`` are recorded and change nothing (every batch reduction
is already global), nor do the knobs that name fusions or memory passes.

Tensor parallelism (``tensor_parallel_degree = tp``, in a BuildStrategy or a
fleet ``DistributedStrategy``) lays the world out as the reference lays its
devices, ``reshape(-1, tp)`` over (data, model): the mesh is
``make_mesh(dp=world // tp, tp=tp)``, rank = d * tp + t.  The weights that
``layers.fc`` / ``layers.embedding(tp_split=...)`` marked, and the optimizer
accumulators that carry the mark, are held as this rank's block of their
split dim (``_tp_specs``, through ``rules.tp_split_specs``: "col" the last
dim, "row" the first; a dim that does not divide stays whole, and a split
accumulator ignores kReduce), and the executor runs the program through the
model-axis table (``parallel/model_axes.py``) behind the batch-axis one;
the data axis is the mesh's dp group.
"""

import warnings

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy",
           "is_data_parallel"]


class BuildStrategy:
    """Parity: details/build_strategy.h:49-148."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1      # accumulators held as 1/n of their rows a rank

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_broadcast_ops = True
        self.fuse_all_optimizer_ops = True
        self.memory_optimize = True
        self.enable_inplace = True
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        # tensor parallelism over the mesh's model axis: layers.fc /
        # layers.embedding mark their weights with tp_split
        self.tensor_parallel_degree = 1


class ExecutionStrategy:
    """Parity: details/execution_strategy.h."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.allow_op_delay = False


class _ShardingInfo:
    """One data-parallel run's layout over the mesh: this rank's rows of
    the global batch over the data axis, the fetch gather and the kReduce
    state set (the JAX ``_ShardingInfo``'s in_shardings, ``shard_feed`` and
    ``shard_state_names``), and the tensor-parallel split of the marked
    vars over the model axis (``tp_specs``: var name -> split dim)."""

    def __init__(self, mesh, data_axis=None, shard_state_names=(),
                 tp_specs=None):
        from .parallel.mesh import DP, PP, TP, WORLD

        self.mesh = mesh
        self.data_axis = data_axis or DP
        self.n = mesh.shape[self.data_axis]
        self.rank = mesh.coords[self.data_axis]
        self.group = mesh.groups.get(self.data_axis)      # None at one rank
        self.tp = mesh.shape[TP]
        self.tp_rank = mesh.coords[TP]
        self.tp_group = mesh.groups.get(TP)
        # the ranks a whole parameter's gradient sums over: the data group
        # times the model group, those of this rank's pipeline coordinate
        # (the world's group when the mesh has no pp axis)
        self.world = self.n * self.tp
        if mesh.shape[PP] == 1:
            groups = (mesh.groups.get(WORLD),)
        else:
            groups = (self.group, self.tp_group)
        self.world_groups = tuple(g for g in groups if g is not None)
        self.tp_specs = dict(tp_specs or {})
        self.shard_state_names = frozenset(shard_state_names)
        self.key = (self.n, self.rank, self.tp, self.tp_rank,
                    self.shard_state_names,
                    tuple(sorted(self.tp_specs.items())))

    def tp_dim(self, name, shape):
        """The dim a marked var of ``shape`` is split at over the model
        axis, or None: unmarked, or its dim does not divide (it stays
        whole, as the reference's guard keeps it replicated)."""
        d = self.tp_specs.get(name)
        if d is None or self.tp == 1 or d >= len(shape):
            return None
        return d if shape[d] % self.tp == 0 else None

    def rows(self, size):
        per = size // self.n
        return self.rank * per, (self.rank + 1) * per

    def shard_feed(self, name, value, microbatches=1):
        """This rank's rows of a feed: the feed's dimension the batch spec
        splits over the data axis (0) must divide by the world's size, as
        the reference's ``device_put`` requires.  A PipelineOptimizer
        program's batch-major feed splits into ``microbatches`` of the
        global batch first, and the rank keeps its rows of each (so that
        every global microbatch is the one-device run's); its size must
        then divide by both."""
        from .parallel import rules as shard_rules

        dim = list(shard_rules.batch_spec(self.data_axis)).index(self.data_axis)
        shape = tuple(getattr(value, "shape", ()))
        if len(shape) <= dim or shape[dim] % (self.n * microbatches):
            raise ValueError(
                "feed %r: the global size of its dimension %d should be "
                "divisible by %d ranks%s, but the full shape is %s"
                % (name, dim, self.n, "" if microbatches == 1 else
                   " times %d microbatches" % microbatches, shape))
        if self.n == 1:
            return value
        if microbatches == 1:
            lo, hi = self.rows(shape[dim])
            return value[(slice(None),) * dim + (slice(lo, hi),)]
        per = shape[dim] // microbatches
        lo, hi = self.rows(per)
        parts = [value[(slice(None),) * dim + (slice(k * per + lo,
                                                     k * per + hi),)]
                 for k in range(microbatches)]
        if isinstance(value, torch.Tensor):
            return torch.cat(parts, dim)
        return np.concatenate(parts, dim)

    def row_sharded(self, shape):
        """Whether an accumulator of ``shape`` (named in
        ``shard_state_names``) is held as 1/n of its rows: its first
        dimension must divide over the ranks, as in the reference."""
        return (self.n > 1 and len(shape) >= 1 and shape[0] >= self.n
                and shape[0] % self.n == 0)

    def gather(self, t, dim):
        """The global value of a tensor sharded on ``dim``."""
        from .parallel.collectives import backend_all_gather

        if self.group is None:
            return t
        return backend_all_gather(t.contiguous(), self.group, dim)


class CompiledProgram:
    """Parity: compiler.py:65.  Wraps a Program; ``with_data_parallel`` runs
    it over the data axis of the world's mesh."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._mesh = None
        self._mesh_cache = {}
        self._places = None
        self._is_data_parallel = False

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None, mesh=None):
        """Parity: compiler.py:138.  ``mesh``: a ``parallel/mesh.py`` mesh
        whose data axis spans the ranks; by default the mesh of the
        ``torch.distributed`` world, or of this process alone outside one."""
        from .parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                "with_data_parallel(mesh=...) takes a paddle_tpu_torch."
                "parallel.mesh Mesh (make_mesh(dp=...)), not %s"
                % type(mesh).__name__)
        self._build_strategy = build_strategy or self._build_strategy
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._places = None if places is None else list(places)
        self._mesh = mesh
        self._is_data_parallel = True
        if (self._places is not None and len(self._places) > 1
                and not dist.is_initialized()):
            # the default warning filter shows it once
            warnings.warn(
                "with_data_parallel(places=%d places): one process drives one "
                "card, so the program runs on this process's card alone; run "
                "one process a card with `python -m paddle_tpu_torch."
                "distributed.launch --nproc_per_node N script.py` and "
                "fleet.init() in the script" % len(self._places), stacklevel=2)
        return self

    def _program_for_run(self):
        """The program the executor runs."""
        return self._program

    def _accumulator_names(self):
        cached = getattr(self, "_acc_cache", None)
        if cached is None or cached[0] != self._program._version:
            names = [v.name for v in self._program.list_vars()
                     if getattr(v, "_is_optimizer_accumulator", False)]
            cached = self._acc_cache = (self._program._version, names)
        return cached[1]

    def _tp_specs(self):
        """var name -> split dim of the ``_tp_split``-marked vars, through
        the sharding authority (``rules.tp_split_specs`` owns the col/row
        translation); cached per program version."""
        from .parallel import rules as shard_rules
        from .parallel.mesh import TP

        cached = getattr(self, "_tp_specs_cache", None)
        if cached is not None and cached[0] == self._program._version:
            return cached[1]
        marks = {}
        for v in self._program.list_vars():
            spl = getattr(v, "_tp_split", None)
            shape = getattr(v, "shape", None)
            if spl is None or not shape:
                continue
            marks[v.name] = (spl, len(shape))
        specs = {name: list(spec).index(TP) for name, spec
                 in shard_rules.tp_split_specs(marks, model_axis=TP).items()}
        self._tp_specs_cache = (self._program._version, specs)
        return specs

    def _sharding_info(self, device):
        """The data-parallel layout for a run on ``device``, or None for a
        program that was not made data-parallel."""
        from .parallel.mesh import TP, make_mesh

        if not self._is_data_parallel:
            return None
        tp = int(getattr(self._build_strategy, "tensor_parallel_degree", 1))
        tp_specs = self._tp_specs() if tp > 1 else {}
        shard = ()
        if (self._build_strategy.reduce_strategy
                == BuildStrategy.ReduceStrategy.Reduce):
            shard = self._accumulator_names()
        mesh = self._mesh
        if mesh is not None:
            if tp_specs and mesh.shape[TP] == 1:
                if not getattr(self, "_tp_warned", False):
                    self._tp_warned = True
                    warnings.warn(
                        "tensor_parallel_degree=%d with an explicit mesh "
                        "that has no tp axis (%r): the tensor-parallel "
                        "splits are dropped; make the mesh with make_mesh("
                        "dp=..., tp=...) or drop the explicit mesh"
                        % (tp, mesh), stacklevel=4)
                tp_specs = {}
        else:
            world = dist.get_world_size() if dist.is_initialized() else 1
            if world % tp:
                raise ValueError(
                    "tensor_parallel_degree=%d does not divide the %d ranks "
                    "of the world" % (tp, world))
            key = (str(device), world, tp)
            mesh = self._mesh_cache.get(key)
            if mesh is None:
                mesh = self._mesh_cache[key] = make_mesh(
                    dp=world // tp, tp=tp, device=device)
        return _ShardingInfo(mesh, shard_state_names=shard,
                             tp_specs=tp_specs)


def is_data_parallel(program):
    """Whether the executor runs ``program`` data-parallel: a
    ``with_data_parallel`` CompiledProgram, or a program that
    ``fleet.distributed_optimizer`` or the transpiler tagged (a GeoSGD-tagged
    one runs locally)."""
    if isinstance(program, CompiledProgram):
        return program._is_data_parallel
    dist_info = getattr(program, "_dist_info", None)
    if dist_info is not None and dist_info.get("mode") == "geo":
        return False
    return (getattr(program, "_fleet_strategy", None) is not None
            or dist_info is not None)
