"""DistributeTranspiler — the API-compatible program rewriter (counterpart
of ``paddle_tpu/distributed/transpiler.py``).

Parity surface: transpiler/distribute_transpiler.py:230 (transpile :495,
modes "pserver" / "nccl2" / "collective", DistributeTranspilerConfig :131)
and transpiler/collective.py:36 (GradAllReduce :178, LocalSGD :269).

As in the JAX package, every mode folds into one data-parallel program
whose gradients are all-reduced (SURVEY.md §2.9: parameter servers fold
into all-reduce data parallelism for dense models).  ``transpile()``
records the cluster spec (trainer_id, trainers, endpoints) and tags the
program, which the executor then runs data-parallel over the world
(``fleet.init()``); in "pserver" mode the server programs are empty, so
that launcher scripts written for the reference keep working with every
rank a trainer.  ``geo_sgd_mode`` tags the program "geo": it runs locally,
and a started ``Communicator`` averages the parameters every K runs.
"""

import warnings

from ..framework import Program, default_main_program

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig"]

class DistributeTranspilerConfig:
    """Parity: distribute_transpiler.py:131."""

    slice_var_up = True
    split_method = None
    min_block_size = 8192
    enable_dc_asgd = False
    mode = "pserver"
    print_log = False
    wait_port = True
    runtime_split_send_recv = False
    sync_mode = True
    nccl_comm_num = 1
    use_hierarchical_allreduce = False
    hierarchical_allreduce_inter_nranks = 0
    geo_sgd_mode = False
    geo_sgd_need_push_nums = 100


class DistributeTranspiler:
    """Parity: distribute_transpiler.py:230."""

    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()

    def transpile(self, trainer_id, program=None, pservers="127.0.0.1:6174",
                  trainers=1, sync_mode=True, startup_program=None,
                  current_endpoint="127.0.0.1:6174"):
        program = program or default_main_program()
        self.trainer_id = trainer_id
        self.sync_mode = sync_mode
        if isinstance(trainers, int):
            self.trainer_num = trainers
            self.trainer_endpoints = None
        else:
            self.trainer_endpoints = trainers.split(",")
            self.trainer_num = len(self.trainer_endpoints)
        self.pserver_endpoints = pservers.split(",") if pservers else []

        mode = getattr(self.config, "mode", "pserver")
        if mode == "pserver" and self.pserver_endpoints:
            warnings.warn(
                "pserver mode: pserver processes get empty programs and "
                "every rank is a trainer (all-reduce data parallelism)")
        if getattr(self.config, "geo_sgd_mode", False):
            # GeoSGD (communicator.h:332): K local steps, then the
            # parameters are averaged across the group every
            # geo_sgd_need_push_nums steps (the LocalSGD family)
            mode = "geo"
        elif not sync_mode:
            # async-PS stale-pull semantics (communicator.h:285) have no
            # equivalent: the tag asks for synchronous updates every step
            warnings.warn(
                "sync_mode=False: asynchronous parameter-server updates "
                "have no counterpart (the tag asks for synchronous "
                "all-reduce; geo_sgd_mode=True for periodic-sync local "
                "steps)")
        # the tag for data-parallel execution (the c_allreduce insertion
        # point, transpiler/collective.py:178)
        program._dist_info = {
            "trainer_id": trainer_id,
            "trainer_num": self.trainer_num,
            "mode": mode,
            "sync_mode": sync_mode,
            "geo_sgd_need_push_nums": getattr(
                self.config, "geo_sgd_need_push_nums", 100),
        }
        self._program = program
        self._startup = startup_program

    def get_trainer_program(self, wait_port=True):
        """The trainer program is the original program (the gradient
        all-reduce is a property of its execution, not extra ops)."""
        return self._program

    def get_pserver_program(self, endpoint):
        """An empty program: a process running it exits at once (there is
        no parameter-server role)."""
        return Program()

    def get_pserver_programs(self, endpoint):
        return self.get_pserver_program(endpoint), Program()

    def get_startup_program(self, endpoint=None, pserver_program=None,
                            startup_program=None):
        return self._startup if self._startup is not None else Program()
