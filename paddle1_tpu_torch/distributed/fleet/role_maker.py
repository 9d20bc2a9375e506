"""Role makers: who am I in the job? (port of
``paddle1_tpu/distributed/fleet/role_maker.py``)

Analog of the reference's ``PaddleCloudRoleMaker``/``UserDefinedRoleMaker``
(python/paddle/distributed/fleet/base/role_maker.py) which parse the launcher
env protocol (PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM,
PADDLE_TRAINER_ENDPOINTS, TRAINING_ROLE…) that
``paddle1_tpu_torch.distributed.launch`` sets; the PS roles (server/heter)
are accepted, collective is the mode the port runs.
"""

from __future__ import annotations

import os
from typing import List, Optional

__all__ = ["Role", "PaddleCloudRoleMaker", "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def __init__(self):
        self._is_collective = True

    def is_worker(self) -> bool:
        return True

    def is_server(self) -> bool:
        return False

    def is_first_worker(self) -> bool:
        return self.worker_index() == 0

    def worker_num(self) -> int:
        raise NotImplementedError

    def worker_index(self) -> int:
        raise NotImplementedError

    def server_num(self) -> int:
        return 0

    def server_index(self) -> int:
        return -1

    def role_id(self) -> int:
        return self.worker_index()

    def get_trainer_endpoints(self) -> List[str]:
        return []

    def _barrier(self, comm_world=None):
        from ..collective import barrier
        barrier()


class PaddleCloudRoleMaker(RoleMakerBase):
    """Parses the launcher's env protocol (reference role_maker.py:946LoC
    class; env names at launch_utils.py:452 start_local_trainers)."""

    def __init__(self, is_collective: bool = True, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._role = (Role.SERVER
                      if os.environ.get("TRAINING_ROLE", "TRAINER").upper()
                      == "PSERVER" else Role.WORKER)

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def worker_num(self) -> int:
        return int(os.environ.get(
            "PADDLE_TRAINERS_NUM", os.environ.get("WORLD_SIZE", "1")))

    def worker_index(self) -> int:
        return int(os.environ.get(
            "PADDLE_TRAINER_ID", os.environ.get("RANK", "0")))

    def get_trainer_endpoints(self) -> List[str]:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else ["127.0.0.1:6170"]


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """Explicit role assignment (reference UserDefinedRoleMaker)."""

    def __init__(self, is_collective: bool = True, current_id: int = 0,
                 worker_num: int = 1, role: int = Role.WORKER,
                 worker_endpoints: Optional[List[str]] = None, **kwargs):
        super().__init__(is_collective=is_collective)
        self._current_id = current_id
        self._worker_num = worker_num
        self._role = role
        self._worker_endpoints = worker_endpoints or ["127.0.0.1:6170"]

    def worker_num(self) -> int:
        return self._worker_num

    def worker_index(self) -> int:
        return self._current_id

    def get_trainer_endpoints(self) -> List[str]:
        return list(self._worker_endpoints)
