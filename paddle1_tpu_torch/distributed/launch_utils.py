"""The launcher's cluster model and worker processes (port of
``paddle1_tpu/distributed/launch_utils.py``: ``Trainer``, ``Pod``,
``Cluster``, ``get_cluster``, ``trainer_env``, ``start_local_trainers``,
``terminate_local_procs``, ``watch_local_trainers``).

The launcher builds the cluster from the host list, starts one worker
process a rank with the reference's environment protocol, and watches
them: the first worker to exit with a non-zero code ends the others and
its code becomes the job's. A worker is one process driving one card
(its ``LOCAL_RANK``), as ``distributed.init_parallel_env`` expects.
The JAX package's supervised watch (heartbeats, restarts, elastic
resize) is ROADMAP Queue 1 item 6; its parameter-server processes are
item 8.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["Trainer", "Pod", "Cluster", "get_cluster", "trainer_env",
           "start_local_trainers", "watch_local_trainers",
           "terminate_local_procs"]


class Trainer:
    """One worker process slot."""

    def __init__(self, endpoint: str, rank: int,
                 accelerators: Optional[List[int]] = None):
        self.endpoint = endpoint
        self.rank = rank
        self.accelerators = accelerators or []

    def __repr__(self):
        return f"Trainer(rank={self.rank}, endpoint={self.endpoint!r})"


class Pod:
    """All trainers on one host."""

    def __init__(self, rank: int, addr: str):
        self.rank = rank
        self.addr = addr
        self.trainers: List[Trainer] = []

    @property
    def endpoints(self) -> List[str]:
        return [t.endpoint for t in self.trainers]

    def __repr__(self):
        return f"Pod(rank={self.rank}, addr={self.addr!r}, " \
               f"trainers={self.trainers})"


class Cluster:
    """The whole job."""

    def __init__(self):
        self.pods: List[Pod] = []

    def trainers_endpoints(self) -> List[str]:
        return [t.endpoint for p in self.pods for t in p.trainers]

    def world_size(self) -> int:
        return sum(len(p.trainers) for p in self.pods)

    def pod(self, node_rank: int) -> Pod:
        return self.pods[node_rank]

    def __repr__(self):
        return f"Cluster(pods={self.pods})"


def get_cluster(node_ips: List[str], nproc_per_node: int,
                base_port: int = 6170) -> Cluster:
    """One pod a host and one trainer a process, ranks pod-major, so that
    ``PADDLE_TRAINER_ID`` indexes the endpoint list. Distinct hosts reuse
    one port block; a repeated host (a local simulation of several
    nodes) gives every rank its own port."""
    cluster = Cluster()
    rank = 0
    local_sim = len(set(node_ips)) != len(node_ips)
    for node_rank, ip in enumerate(node_ips):
        pod = Pod(node_rank, ip)
        for i in range(nproc_per_node):
            off = rank if local_sim else i
            pod.trainers.append(Trainer(f"{ip}:{base_port + off}", rank,
                                        [i]))
            rank += 1
        cluster.pods.append(pod)
    return cluster


def trainer_env(cluster: Cluster, pod: Pod, trainer) -> dict:
    """The environment of one rank's worker: the reference's protocol
    (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
    ``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_TRAINER_ENDPOINTS``,
    ``PADDLE_NODE_RANK``, ``PADDLE_NNODES``, ``RANK``, ``WORLD_SIZE``),
    and the card it drives: ``PADDLE_RANK_IN_NODE`` / ``LOCAL_RANK`` and
    ``FLAGS_selected_gpus``."""
    endpoints = cluster.trainers_endpoints()
    world = cluster.world_size()
    local = pod.trainers.index(trainer)
    return {
        "PADDLE_TRAINER_ID": str(trainer.rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_CURRENT_ENDPOINT": trainer.endpoint,
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_NODE_RANK": str(pod.rank),
        "PADDLE_NNODES": str(len(cluster.pods)),
        "PADDLE_RANK_IN_NODE": str(local),
        "LOCAL_RANK": str(local),
        "RANK": str(trainer.rank),
        "WORLD_SIZE": str(world),
        "FLAGS_selected_gpus": str(local),
    }


def start_local_trainers(cluster: Cluster, pod: Pod, training_script: str,
                         training_script_args: List[str],
                         log_dir: Optional[str] = None,
                         extra_env: Optional[dict] = None):
    """Start this pod's workers (``python -u script args``, each with its
    :func:`trainer_env`); with ``log_dir`` each writes
    ``workerlog.<rank>`` there. Returns the processes."""
    procs = []
    for t in pod.trainers:
        env = dict(os.environ)
        env.update(trainer_env(cluster, pod, t))
        if extra_env:
            env.update(extra_env)
        cmd = [sys.executable, "-u", training_script] + \
            list(training_script_args)
        stdout = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            stdout = open(os.path.join(log_dir, f"workerlog.{t.rank}"),
                          "w")
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=stdout,
            stderr=subprocess.STDOUT if stdout else None))
        if stdout is not None:
            stdout.close()
    return procs


def terminate_local_procs(procs) -> None:
    """SIGTERM the workers still running, SIGKILL those that outlive 10
    seconds."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + 10
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def watch_local_trainers(procs, poll_s: float = 0.2) -> int:
    """Block until every worker has exited; the first non-zero exit ends
    the others and is returned (0 when all succeed)."""
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                terminate_local_procs(procs)
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(poll_s)
    except BaseException:
        terminate_local_procs(procs)
        raise
