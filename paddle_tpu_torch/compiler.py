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
is already global), nor do the knobs that name fusions or memory passes.  A
tensor-parallel degree above 1 raises, naming item 5-C.
"""

import warnings

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy",
           "is_data_parallel"]

_TENSOR_PARALLEL = "ROADMAP Queue 1 item 5-C, tensor parallelism"


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
        self.tensor_parallel_degree = 1


class ExecutionStrategy:
    """Parity: details/execution_strategy.h."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.allow_op_delay = False


class _ShardingInfo:
    """One data-parallel run's layout over the mesh's data axis: this rank's
    rows of the global batch, the fetch gather and the kReduce state set
    (the JAX ``_ShardingInfo``'s in_shardings, ``shard_feed`` and
    ``shard_state_names``)."""

    def __init__(self, mesh, data_axis=None, shard_state_names=()):
        from .parallel.mesh import DP

        self.mesh = mesh
        self.data_axis = data_axis or DP
        self.n = mesh.shape[self.data_axis]
        self.rank = mesh.coords[self.data_axis]
        self.group = mesh.groups.get(self.data_axis)      # None at one rank
        self.shard_state_names = frozenset(shard_state_names)
        self.key = (self.n, self.rank, self.shard_state_names)

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
        self._check_layout()
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

    def _check_layout(self):
        bs = self._build_strategy
        if int(getattr(bs, "tensor_parallel_degree", 1)) > 1:
            raise NotImplementedError(
                "BuildStrategy.tensor_parallel_degree = %d waits (%s)"
                % (bs.tensor_parallel_degree, _TENSOR_PARALLEL))

    def _program_for_run(self):
        """The program the executor runs."""
        self._check_layout()
        return self._program

    def _accumulator_names(self):
        cached = getattr(self, "_acc_cache", None)
        if cached is None or cached[0] != self._program._version:
            names = [v.name for v in self._program.list_vars()
                     if getattr(v, "_is_optimizer_accumulator", False)]
            cached = self._acc_cache = (self._program._version, names)
        return cached[1]

    def _sharding_info(self, device):
        """The data-parallel layout for a run on ``device``, or None for a
        program that was not made data-parallel."""
        from .parallel.mesh import make_mesh

        if not self._is_data_parallel:
            return None
        self._check_layout()
        shard = ()
        if (self._build_strategy.reduce_strategy
                == BuildStrategy.ReduceStrategy.Reduce):
            shard = self._accumulator_names()
        mesh = self._mesh
        if mesh is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
            key = (str(device), world)
            mesh = self._mesh_cache.get(key)
            if mesh is None:
                mesh = self._mesh_cache[key] = make_mesh(dp=world,
                                                         device=device)
        return _ShardingInfo(mesh, shard_state_names=shard)


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
