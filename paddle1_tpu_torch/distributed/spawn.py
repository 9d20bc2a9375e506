"""Start the ranks of a job as processes on this host (port of
``paddle1_tpu/distributed/spawn.py``, Paddle's ``paddle.distributed.spawn``).

``spawn(func, args, nprocs)`` runs ``func(*args)`` in ``nprocs`` fresh
processes with the launcher's environment protocol set
(``PADDLE_TRAINER_ID``/``RANK``, ``PADDLE_TRAINERS_NUM``/``WORLD_SIZE``,
``PADDLE_RANK_IN_NODE``/``LOCAL_RANK``); ``func`` calls
``init_parallel_env`` itself. Processes start with the ``spawn`` method:
a forked child would inherit the parent's CUDA context, which CUDA does
not allow. ``func`` must be importable by name (a module-level function).

With ``join`` the parent waits for every rank; the first rank to exit
with a non-zero code, or the ``timeout``, ends the others (terminate,
then kill), and the call raises: a dead rank can never leave the others
waiting forever on a collective.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from typing import List, Optional, Tuple

from ..core.errors import ExecutionTimeoutError, FatalError

__all__ = ["spawn"]

_POLL_S = 0.05


def _set_env(rank: int, nprocs: int) -> None:
    for key in ("PADDLE_TRAINER_ID", "RANK", "PADDLE_RANK_IN_NODE",
                "LOCAL_RANK"):
        os.environ[key] = str(rank)
    for key in ("PADDLE_TRAINERS_NUM", "WORLD_SIZE"):
        os.environ[key] = str(nprocs)


def _worker(fn, rank: int, nprocs: int, args):
    _set_env(rank, nprocs)
    fn(*args)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + 5.0
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join(5.0)


def spawn(func, args: Tuple = (), nprocs: int = 1, join: bool = True,
          daemon: bool = False, timeout: Optional[float] = None,
          **options) -> List[mp.Process]:
    """Run ``func(*args)`` on ``nprocs`` ranks. With ``join`` (the
    default), return once every rank exited 0; raise
    :class:`~paddle1_tpu_torch.core.errors.FatalError` when one exits
    otherwise, or :class:`ExecutionTimeoutError` after ``timeout``
    seconds, having ended the others either way. Returns the processes."""
    if nprocs < 1:
        raise FatalError(f"spawn needs nprocs >= 1, got {nprocs}")
    ctx = mp.get_context("spawn")
    procs = []
    try:
        for rank in range(nprocs):
            p = ctx.Process(target=_worker, args=(func, rank, nprocs, args),
                            daemon=daemon)
            p.start()
            procs.append(p)
    except BaseException:
        _stop(procs)
        raise
    if not join:
        return procs
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c is not None and c != 0]
            if failed:
                raise FatalError(
                    f"spawned rank {failed[0][0]} exited with code "
                    f"{failed[0][1]}; the other ranks were stopped")
            if all(c == 0 for c in codes):
                return procs
            if deadline is not None and time.monotonic() > deadline:
                raise ExecutionTimeoutError(
                    f"spawned ranks did not finish within {timeout} s "
                    f"(exit codes {codes}); they were stopped")
            time.sleep(_POLL_S)
    finally:
        _stop(procs)
