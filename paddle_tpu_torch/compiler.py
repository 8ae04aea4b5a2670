"""CompiledProgram + Build/Execution strategies at one device.

Parity: python/paddle/fluid/compiler.py:65 (CompiledProgram,
with_data_parallel :138) and framework/details/build_strategy.h.  The
counterpart of the JAX package's ``compiler.py``, which shards the batch of
one jitted step over a device mesh.  Here a program runs on one card:
``with_data_parallel`` over one place runs the program as it is (the
executor unwraps it), and every other layout (more than one place, an
explicit mesh, trainers, sync-BN) raises ``NotImplementedError`` naming
ROADMAP Queue 1 item 5-B, program-mode data parallelism (a tensor-parallel
degree above 1 names item 5-C).
The BuildStrategy knobs that name fusions or memory passes are accepted and
recorded, as in the reference, and change nothing.
"""

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]

_MULTI_GPU = "ROADMAP Queue 1 item 5-B, program-mode data parallelism"
_TENSOR_PARALLEL = "ROADMAP Queue 1 item 5-C, tensor parallelism"


class BuildStrategy:
    """Parity: details/build_strategy.h:49-148."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

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


class CompiledProgram:
    """Parity: compiler.py:65.  Wraps a Program; the executor runs the
    program it wraps, after checking that the layout is one device."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._places = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None, mesh=None):
        """Parity: compiler.py:138.  Data parallelism over one card is the
        program itself; more than one place, or a mesh, raises."""
        if mesh is not None:
            raise NotImplementedError(
                "with_data_parallel(mesh=...): a device mesh waits (%s)"
                % _MULTI_GPU)
        self._build_strategy = build_strategy or self._build_strategy
        self._places = None if places is None else list(places)
        self._check_layout()
        return self

    def _check_layout(self):
        bs = self._build_strategy
        if self._places is not None and len(self._places) > 1:
            raise NotImplementedError(
                "data parallelism over %d places waits (%s)"
                % (len(self._places), _MULTI_GPU))
        if int(bs.num_trainers) > 1:
            raise NotImplementedError(
                "BuildStrategy.num_trainers = %d: multi-trainer execution "
                "waits (%s)" % (bs.num_trainers, _MULTI_GPU))
        if int(getattr(bs, "tensor_parallel_degree", 1)) > 1:
            raise NotImplementedError(
                "BuildStrategy.tensor_parallel_degree = %d waits (%s)"
                % (bs.tensor_parallel_degree, _TENSOR_PARALLEL))
        if bs.sync_batch_norm:
            raise NotImplementedError(
                "BuildStrategy.sync_batch_norm: synchronised batch norm "
                "across devices waits (%s)" % _MULTI_GPU)

    def _program_for_run(self):
        """The program the executor runs, once the layout (which a caller
        may have changed after ``with_data_parallel``) is one device."""
        self._check_layout()
        return self._program
