"""Process-group bootstrap and the eager data-parallel wrapper (port of
``paddle1_tpu/distributed/parallel.py``: ``init_parallel_env``,
``ParallelEnv``, ``DataParallel``).

One process drives one rank. :func:`init_parallel_env` joins this
process to the job's ``torch.distributed`` process group: NCCL when the
rank's device is a card (the default), gloo only when the caller asks
for the CPU or names the backend. A missing card is a typed error, never
a quiet fall back to gloo on the CPU.

:class:`DataParallel` averages each parameter's gradient over the ranks
in a hook as backward produces it (one ``AVG`` all-reduce per
parameter, in backward's order, which is the same on every rank). It is
a passthrough while no process group is initialized, as the JAX wrapper
is outside a trace.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..core.device import resolve_device
from ..core.errors import (InvalidArgumentError, PreconditionNotMetError)
from ..core.flags import flag
from . import collective, env
from .collective import ReduceOp

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "DataParallel"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _rank_device(device) -> torch.device:
    """The rank's device: ``device`` when given, else the card of this
    rank's local index (raising without a card)."""
    if device is not None:
        return resolve_device(device)
    dev = resolve_device(None)
    local = env.get_local_rank()
    n = torch.cuda.device_count()
    if local >= n:
        raise InvalidArgumentError(
            f"local rank {local} needs card {local}, this host has {n}; "
            "pass device= to place ranks explicitly")
    return torch.device(dev.type, local)


def init_parallel_env(strategy=None, backend: Optional[str] = None,
                      device=None, init_method: Optional[str] = None):
    """Join this process to the job's process group (rank and world size
    from the launcher's environment, ``env.get_rank()`` /
    ``env.get_world_size()``) and return a :class:`ParallelEnv`.

    * ``device``: this rank's device; default the card of its local rank
      (``torch.cuda.set_device`` is called on it). ``"cpu"`` runs the rank
      on the CPU.
    * ``backend``: default ``"nccl"`` on a card, ``"gloo"`` on the CPU;
      a name given here is used as it is (gloo also reduces CUDA tensors,
      which lets two ranks share one card).
    * ``init_method``: the rendezvous (``"tcp://host:port"``,
      ``"file:///path"``, ``"env://"``); default the first of
      ``PADDLE_TRAINER_ENDPOINTS``, else ``env://`` when ``MASTER_ADDR``
      and ``MASTER_PORT`` are set, else an in-process store for a world
      of one rank.

    The ``collective_timeout_s`` flag bounds the rendezvous and every
    collective. A second call returns the existing environment."""
    if dist.is_initialized():
        return ParallelEnv()
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    rank, nranks = env.get_rank(), env.get_world_size()
    kw = dict(backend=backend, rank=rank, world_size=nranks,
              timeout=datetime.timedelta(
                  seconds=float(flag("collective_timeout_s"))))
    endpoints = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    if init_method is not None:
        kw["init_method"] = init_method
    elif endpoints:
        kw["init_method"] = "tcp://" + endpoints.split(",")[0]
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        kw["init_method"] = "env://"
    elif nranks == 1:
        kw["store"] = dist.HashStore()
    else:
        raise PreconditionNotMetError(
            f"init_parallel_env: a {nranks}-rank job needs a rendezvous: "
            "set PADDLE_TRAINER_ENDPOINTS (or MASTER_ADDR/MASTER_PORT), "
            "or pass init_method")
    dist.init_process_group(**kw)
    return ParallelEnv()


def get_rank() -> int:
    return collective.get_rank()


def get_world_size() -> int:
    return collective.get_world_size()


class ParallelEnv:
    """Rank, world size and endpoints of this process, as the launcher's
    environment gives them."""

    @property
    def rank(self) -> int:
        return env.get_rank()

    @property
    def local_rank(self) -> int:
        return env.get_local_rank()

    @property
    def world_size(self) -> int:
        return env.get_world_size()

    @property
    def nranks(self) -> int:
        return env.get_world_size()

    @property
    def device_id(self) -> int:
        return self.local_rank

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else ["127.0.0.1:6170"]


class DataParallel(nn.Module):
    """Data-parallel model wrapper (Paddle's ``paddle.DataParallel``):
    each rank runs ``layers`` on its own shard of the batch, and each
    trainable parameter's gradient is averaged over the ranks (``AVG``)
    by a hook as backward produces it, so every rank then holds the
    gradient of the mean loss over all shards. ``comm_dtype`` casts the
    gradient for the all-reduce and back. Inside :meth:`no_sync` the
    hooks pass gradients through; :meth:`apply_collective_grads` then
    averages the accumulated ``.grad`` of every parameter. With no
    process group initialized the wrapper is a passthrough."""

    def __init__(self, layers: nn.Module, strategy=None,
                 comm_buffer_size: int = 25, last_comm_buffer_size: int = 1,
                 find_unused_parameters: bool = False, group=None,
                 comm_dtype=None):
        super().__init__()
        if comm_dtype is not None and str(comm_dtype).replace(
                "torch.", "") not in _DTYPES:
            raise InvalidArgumentError(
                f"DataParallel comm_dtype must be one of {sorted(_DTYPES)}, "
                f"got {comm_dtype!r}")
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._group = group
        self._grad_sync_enabled = True
        self._comm_dtype = None if comm_dtype is None else \
            _DTYPES[str(comm_dtype).replace("torch.", "")]
        # torch's own hook, on the accumulated gradient, also for Paddle
        # parameters (whose register_hook fires per incoming edge): one
        # all-reduce per parameter, whichever backward API runs
        self._hook_handles = [torch.Tensor.register_hook(p, self._sync_grad)
                              for p in layers.parameters() if p.requires_grad]

    def _sync_grad(self, grad: torch.Tensor) -> torch.Tensor:
        if not self._grad_sync_enabled or not dist.is_initialized():
            return grad
        cdt = self._comm_dtype
        g = grad.to(cdt if cdt is not None and grad.is_floating_point()
                    else grad.dtype, copy=True)
        collective.all_reduce(g, ReduceOp.AVG, self._group)
        return g.to(grad.dtype)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """Identity: the hooks average, so the loss needs no scaling."""
        return loss

    def apply_collective_grads(self) -> None:
        """Average every parameter's ``.grad`` over the ranks (after
        gradients accumulated under :meth:`no_sync`)."""
        if not dist.is_initialized():
            return
        for p in self._layers.parameters():
            if p.grad is not None:
                collective.all_reduce(p.grad, ReduceOp.AVG, self._group)

    @contextlib.contextmanager
    def no_sync(self):
        """Leave gradients rank-local inside the context (gradient
        accumulation); call :meth:`apply_collective_grads` afterwards."""
        prev = self._grad_sync_enabled
        self._grad_sync_enabled = False
        try:
            yield
        finally:
            self._grad_sync_enabled = prev

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_dict = set_state_dict
