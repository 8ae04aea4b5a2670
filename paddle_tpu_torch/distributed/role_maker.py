"""Role makers (counterpart of ``paddle_tpu/distributed/role_maker.py``, a
copy; parity: incubate/fleet/base/role_maker.py:30 — PaddleCloudRoleMaker
:328 env-var based, UserDefinedRoleMaker :423).

The env-var cluster contract is the reference's
(distributed/launch.py:147+): PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM,
PADDLE_TRAINER_ENDPOINTS, PADDLE_CURRENT_ENDPOINT.  Here the same contract
feeds ``torch.distributed.init_process_group`` (rank 0's store listens on
the endpoint list's head).
"""

import os

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._trainer_id = 0
        self._trainers_num = 1
        self._endpoints = ["127.0.0.1:6170"]
        self._generated = False

    def generate_role(self):
        self._generated = True

    def is_worker(self):
        return True

    def is_server(self):
        # no pserver processes exist (SURVEY.md §2.9: PS modes fold into
        # all-reduce DP)
        return False

    def is_first_worker(self):
        return self._trainer_id == 0

    def worker_index(self):
        return self._trainer_id

    def worker_num(self):
        return self._trainers_num

    def get_trainer_endpoints(self):
        return list(self._endpoints)


class PaddleCloudRoleMaker(RoleMakerBase):
    """Parity: role_maker.py:328 — reads the PADDLE_* env contract."""

    def __init__(self, is_collective=True):
        super().__init__()
        self._is_collective = is_collective

    def generate_role(self):
        self._trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        self._trainers_num = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._endpoints = eps.split(",") if eps else ["127.0.0.1:6170"]
        self._current_endpoint = os.environ.get(
            "PADDLE_CURRENT_ENDPOINT", self._endpoints[self._trainer_id]
            if self._trainer_id < len(self._endpoints) else "127.0.0.1:6170")
        self._generated = True


class UserDefinedRoleMaker(RoleMakerBase):
    """Parity: role_maker.py:423."""

    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None):
        super().__init__()
        self._trainer_id = current_id
        self._trainers_num = worker_num
        self._role = role
        self._endpoints = server_endpoints or ["127.0.0.1:6170"]

    def is_server(self):
        return self._role == Role.SERVER
