"""Fleet — the unified distributed training facade (counterpart of
``paddle_tpu/distributed/fleet.py``).

Parity: incubate/fleet/base/fleet_base.py:38 (Fleet lifecycle:
init/is_first_worker/worker_num/init_worker/stop_worker),
incubate/fleet/collective/__init__.py:41 (Collective fleet;
DistributedStrategy :94 extending BuildStrategy; CollectiveOptimizer :325).

``fleet.init()`` bootstraps the ``torch.distributed`` world from the role
maker's PADDLE_* env, where the reference calls
``jax.distributed.initialize`` (the gen_nccl_id analogue): rank 0's store
listens on the endpoint list's head, and the backend follows the device
(NCCL on a card, gloo on the CPU; ``PADDLE_DISTRI_BACKEND`` names it
instead).  The world is initialised whenever the env names one (a
launcher's worker, one rank or more); a plain process with no endpoints in
its env runs alone, as in the reference.  A failed bootstrap raises.

``distributed_optimizer(opt).minimize(loss)`` tags the program as the
reference does, and the executor runs a tagged program data-parallel over
the world ``init`` made (``compiler.py``, ``parallel/batch_axes.py``): each
rank is fed the global batch and keeps its rows, and the program computes
what the one-device program computes on it.  The functional engine
(``parallel/``: ``build_bert_trainer(cfg, MeshSpec(dp=...))`` and its kin)
runs over the same world.
"""

import os

import torch
import torch.distributed as dist

from .role_maker import PaddleCloudRoleMaker
from ..compiler import BuildStrategy
from ..kernels._common import resolve_device
from ..parallel.mesh import init_world

__all__ = ["init", "is_first_worker", "worker_index", "worker_num",
           "is_worker", "is_server", "init_worker", "stop_worker",
           "distributed_optimizer", "DistributedStrategy", "fleet"]


class DistributedStrategy(BuildStrategy):
    """Parity: incubate/fleet/collective/__init__.py:94 — BuildStrategy plus
    fleet knobs."""

    def __init__(self):
        super().__init__()
        self.use_local_sgd = False
        self.local_sgd_steps = 1
        self.forward_recompute = False
        self.recompute_checkpoints = []
        self.use_amp = False
        self.amp_loss_scale = 1.0  # kept for API parity; bf16 needs no scaling
        self.nccl_comm_num = 1
        # PSLib parity: route embedding tables past the devices' budget to
        # the host-RAM sparse service (parallel/embedding.py's router hands
        # them to hostps.HostPSEmbedding)
        self.use_host_sparse_table = False
        self.host_sparse_cache_slots = 0


class _Fleet:
    def __init__(self):
        self._role_maker = None
        self._initialized = False
        self.device = None

    # -- lifecycle (fleet_base.py:38) -----------------------------------
    def init(self, role_maker=None, device=None):
        """Read the role, pick this rank's device (``cuda`` unless named:
        the card ``FLAGS_selected_gpus`` names, else the rank modulo the
        cards) and join the world."""
        self._role_maker = role_maker or PaddleCloudRoleMaker()
        self._role_maker.generate_role()
        self._initialized = True
        self.device = self._rank_device(device)
        self._maybe_init_world()
        return self

    def _rank_device(self, device):
        if device is not None:
            return resolve_device(device)       # the caller named it
        resolve_device(None)                    # raises without a card
        sel = os.environ.get("FLAGS_selected_gpus", "")
        index = (int(sel.split(",")[0]) if sel else
                 self._role_maker.worker_index() % torch.cuda.device_count())
        return torch.device("cuda", index)

    def _maybe_init_world(self):
        """init_process_group from the PADDLE_* env contract (the
        c_gen_nccl_id / gen_nccl_id analogue, c_gen_nccl_id_op.cc:37)."""
        if os.environ.get("PADDLE_TPU_SKIP_DIST_INIT"):
            return
        if not os.environ.get("PADDLE_TRAINER_ENDPOINTS") \
                and self._role_maker.worker_num() <= 1:
            return          # a plain process: no world to join
        if dist.is_initialized():
            return          # benign re-init (second fleet.init() in one process)
        # a genuine bootstrap failure (bad address, port conflict) must
        # surface instead of degrading to inconsistent single-process
        # training — no exception swallowing here
        init_world(self._role_maker.worker_index(),
                   self._role_maker.worker_num(),
                   self._role_maker.get_trainer_endpoints()[0], self.device)

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def init_worker(self):
        pass

    def init_server(self, *args, **kwargs):
        pass

    def run_server(self):
        raise RuntimeError(
            "no parameter-server processes exist in this runtime: PS modes "
            "are served by all-reduce DP (SURVEY.md §2.9); run every "
            "process as a worker")

    def stop_worker(self):
        pass

    def distributed_optimizer(self, optimizer, strategy=None):
        return DistributedOptimizer(optimizer, strategy or DistributedStrategy(),
                                    self)

    # -- checkpoint passthroughs (fleet_base.py save_*) ------------------
    def save_inference_model(self, *args, **kwargs):
        from .. import io

        return io.save_inference_model(*args, **kwargs)

    def save_persistables(self, exe, dirname, main_program=None):
        from .. import io

        return io.save_persistables(exe, dirname, main_program)


class DistributedOptimizer:
    """Parity: fleet_base.py:240 / collective CollectiveOptimizer :325.

    minimize() runs the base optimizer's minimize, then marks the program
    with the fleet strategy, as the reference does: the executor runs a
    tagged program data-parallel with the strategy as its BuildStrategy.
    """

    def __init__(self, optimizer, strategy, fleet_):
        self._optimizer = optimizer
        self._strategy = strategy
        self._fleet = fleet_
        # the routing knob applies now (tables are usually made before
        # minimize), and the newest strategy decides whether tables past
        # the budget go to the host-RAM sparse service or raise the
        # capacity error
        from ..parallel import embedding as _embedding

        _embedding.enable_host_sparse_table(
            bool(getattr(strategy, "use_host_sparse_table", False)),
            cache_slots=getattr(strategy, "host_sparse_cache_slots", None))

    _warned_local_sgd = False

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if (getattr(self._strategy, "use_local_sgd", False)
                and not DistributedOptimizer._warned_local_sgd):
            import warnings

            warnings.warn(
                "DistributedStrategy.use_local_sgd: the program-mode fleet "
                "path runs synchronous DP (per-step gradient all-reduce); "
                "real Local SGD (periodic replica averaging) lives in the "
                "functional engine — parallel/local_sgd.py "
                "make_local_sgd_train_step", stacklevel=2)
            DistributedOptimizer._warned_local_sgd = True
        if getattr(self._strategy, "forward_recompute", False):
            self._optimizer._use_remat = True
        result = self._optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        program = loss.block.program
        program._fleet_strategy = self._strategy
        return result

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


fleet = _Fleet()

# module-level convenience API (paddle.distributed.fleet style)
init = fleet.init
is_first_worker = fleet.is_first_worker
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_worker = fleet.is_worker
is_server = fleet.is_server
init_worker = fleet.init_worker
stop_worker = fleet.stop_worker
distributed_optimizer = fleet.distributed_optimizer
