"""Process launcher (port of ``paddle1_tpu/distributed/launch.py``):
``python -m paddle1_tpu_torch.distributed.launch --nproc_per_node n
train.py [args]`` starts n workers on this host, one a card, each with
the reference's environment protocol (``launch_utils.trainer_env``), and
exits with the first failed worker's code after stopping the rest.

``--nnodes``/``--node_rank``/``--ips`` start this host's pod of a
multi-host job (every host runs the same command with its own
``--node_rank``); ``--master`` is the first endpoint, which
``init_parallel_env`` dials. One process on one host runs the script in
place. The JAX launcher's supervision flags (``--ft_*``, ROADMAP Queue 1
item 6) and parameter-server mode (``--server_num``/``--servers``, item
8) raise.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..core.errors import UnimplementedError

__all__ = ["launch", "main"]


def _parse_args(argv):
    p = argparse.ArgumentParser("paddle1_tpu_torch.distributed.launch")
    p.add_argument("--nnodes", type=int,
                   default=int(os.environ.get("PADDLE_NNODES", "1")),
                   help="number of hosts")
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")))
    p.add_argument("--master", type=str,
                   default=os.environ.get("PADDLE_MASTER", "127.0.0.1:6170"),
                   help="the first rank's host:port")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes on this host, one a card")
    p.add_argument("--ips", type=str, default=None,
                   help="comma-separated host list")
    p.add_argument("--gpus", "--devices", dest="devices", type=str,
                   default=None, help="cards of this host, one a worker "
                   "(default 0..nproc_per_node-1)")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--ft_supervise", type=str, default=None)
    p.add_argument("--ft_hang_timeout", type=float, default=None)
    p.add_argument("--ft_max_worker_restarts", type=int, default=None)
    p.add_argument("--server_num", type=int, default=0)
    p.add_argument("--servers", type=str, default="")
    p.add_argument("--trainer_num", type=int, default=None)
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch(argv: Optional[List[str]] = None):
    from .launch_utils import (get_cluster, start_local_trainers,
                               watch_local_trainers)
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    if args.server_num > 0 or args.servers or args.trainer_num is not None:
        raise UnimplementedError(
            "launch: parameter-server mode (--server_num/--servers) is "
            "ROADMAP Queue 1 item 8")
    if args.ft_supervise not in (None, "off") or \
            args.ft_hang_timeout is not None or \
            args.ft_max_worker_restarts is not None:
        raise UnimplementedError(
            "launch: supervised workers (--ft_*) are ROADMAP Queue 1 "
            "item 6")
    nproc = args.nproc_per_node
    host, port = (args.master.split(":") + ["6170"])[:2]
    extra = {}
    if args.devices is not None:
        cards = args.devices.split(",")
        if len(cards) != nproc:
            raise SystemExit(f"--gpus lists {len(cards)} cards for "
                             f"--nproc_per_node={nproc}")
        extra["CUDA_VISIBLE_DEVICES"] = args.devices
    if args.nnodes <= 1 and nproc <= 1:
        env = dict(os.environ)
        env.setdefault("PADDLE_TRAINER_ID", "0")
        env.setdefault("PADDLE_TRAINERS_NUM", "1")
        env.update(extra)
        os.execve(sys.executable,
                  [sys.executable, "-u", args.training_script] +
                  args.training_script_args, env)
    node_ips = args.ips.split(",") if args.ips else [host]
    if len(node_ips) != args.nnodes:
        if args.ips:
            raise SystemExit(f"--ips lists {len(node_ips)} hosts but "
                             f"--nnodes={args.nnodes}")
        node_ips = [host] * args.nnodes   # a local simulation of N nodes
    cluster = get_cluster(node_ips, nproc, base_port=int(port))
    if args.ips is None and args.nnodes > 1 and \
            host in ("127.0.0.1", "localhost"):
        pods = cluster.pods   # the local simulation hosts every pod
    else:
        pods = [cluster.pod(args.node_rank)]
    procs = []
    for pod in pods:
        procs.extend(start_local_trainers(
            cluster, pod, args.training_script, args.training_script_args,
            log_dir=args.log_dir, extra_env=extra))
    rc = watch_local_trainers(procs)
    if rc != 0:
        sys.exit(rc)


def main():
    launch()


if __name__ == "__main__":
    main()
