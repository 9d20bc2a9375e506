"""The port's launcher (``python -m paddle1_tpu_torch.distributed.launch``)
against the behaviour ``tests/test_launch.py`` holds the JAX launcher to:
the cluster model, each worker's environment, a two-rank gloo job that
rendezvouses through the launcher's endpoints, and fail-fast (a worker's
non-zero exit ends the others and becomes the launcher's code). The
workers are small scripts written to the test's temporary directory; the
environment-only ones import nothing but the standard library.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "RANK", "WORLD_SIZE",
                                "LOCAL_RANK"))}
    env["PYTHONPATH"] = REPO
    return env


def _launch(tmp_path, script, *args):
    path = tmp_path / "worker.py"
    path.write_text(textwrap.dedent(script))
    cmd = [sys.executable, "-m", "paddle1_tpu_torch.distributed.launch",
           "--master", f"127.0.0.1:{_free_port()}", *args, str(path),
           str(tmp_path)]
    return subprocess.run(cmd, env=_env(), cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=TIMEOUT_S)


def test_get_cluster_equals_the_jax_launchers():
    from paddle1_tpu.distributed.launch_utils import get_cluster as jget
    from paddle1_tpu_torch.distributed.launch_utils import get_cluster
    for ips, n in ((["10.0.0.1", "10.0.0.2"], 2), (["127.0.0.1"] * 2, 2),
                   (["10.0.0.9"], 4)):
        got, want = get_cluster(ips, n, 7000), jget(ips, n, 7000)
        assert got.trainers_endpoints() == want.trainers_endpoints()
        assert got.world_size() == want.world_size()
        assert [[t.rank for t in p.trainers] for p in got.pods] == \
            [[t.rank for t in p.trainers] for p in want.pods]


ENV_WORKER = """
    import json, os, sys
    keys = ["PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_CURRENT_ENDPOINT", "PADDLE_TRAINER_ENDPOINTS",
            "PADDLE_NODE_RANK", "PADDLE_NNODES", "PADDLE_RANK_IN_NODE",
            "LOCAL_RANK", "RANK", "WORLD_SIZE", "FLAGS_selected_gpus",
            "CUDA_VISIBLE_DEVICES"]
    rank = os.environ["PADDLE_TRAINER_ID"]
    with open(os.path.join(sys.argv[1], f"env{rank}.json"), "w") as f:
        json.dump({k: os.environ.get(k) for k in keys}, f)
"""


def test_launch_sets_each_workers_environment(tmp_path):
    res = _launch(tmp_path, ENV_WORKER, "--nproc_per_node", "3",
                  "--gpus", "3,5,7")
    assert res.returncode == 0, res.stderr[-2000:]
    envs = [json.loads((tmp_path / f"env{r}.json").read_text())
            for r in range(3)]
    eps = envs[0]["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(set(eps)) == 3
    for r, e in enumerate(envs):
        assert e["PADDLE_TRAINER_ID"] == e["RANK"] == str(r)
        assert e["PADDLE_TRAINERS_NUM"] == e["WORLD_SIZE"] == "3"
        assert e["PADDLE_CURRENT_ENDPOINT"] == eps[r]
        assert e["PADDLE_RANK_IN_NODE"] == e["LOCAL_RANK"] == \
            e["FLAGS_selected_gpus"] == str(r)
        assert e["PADDLE_NODE_RANK"] == "0" and e["PADDLE_NNODES"] == "1"
        assert e["CUDA_VISIBLE_DEVICES"] == "3,5,7"   # card r: the r-th
    # one process runs the script in place, with the rank-0 defaults
    res = _launch(tmp_path, ENV_WORKER)
    assert res.returncode == 0, res.stderr[-2000:]
    e = json.loads((tmp_path / "env0.json").read_text())
    assert e["PADDLE_TRAINER_ID"] == "0" and e["PADDLE_TRAINERS_NUM"] == "1"


def test_launch_two_gloo_ranks_rendezvous_and_all_reduce(tmp_path):
    res = _launch(tmp_path, """
        import os, sys
        import torch
        from paddle1_tpu_torch import distributed as dist
        dist.init_parallel_env(device="cpu")
        t = torch.full((3,), float(dist.get_rank() + 1))
        dist.all_reduce(t)
        assert dist.get_world_size() == 2
        with open(os.path.join(sys.argv[1], f"sum{dist.get_rank()}"),
                  "w") as f:
            f.write(str(t.tolist()))
        dist.destroy_process_group()
    """, "--nproc_per_node", "2")
    assert res.returncode == 0, res.stderr[-3000:]
    for r in range(2):
        assert (tmp_path / f"sum{r}").read_text() == "[3.0, 3.0, 3.0]"


def test_launch_fails_fast_with_the_workers_code(tmp_path):
    t0 = time.monotonic()
    res = _launch(tmp_path, """
        import os, sys, time
        if os.environ["PADDLE_TRAINER_ID"] == "1":
            time.sleep(0.5)
            sys.exit(7)
        time.sleep(100)
    """, "--nproc_per_node", "2", "--log_dir", "logs")
    assert res.returncode == 7
    assert time.monotonic() - t0 < 60     # the sleeper was stopped
    assert sorted(os.listdir(tmp_path / "logs")) == ["workerlog.0",
                                                    "workerlog.1"]


@pytest.mark.parametrize("flags", [["--server_num", "1"],
                                   ["--ft_supervise", "restart"]])
def test_launch_modes_of_later_items_raise(tmp_path, flags):
    from paddle1_tpu_torch.core.errors import UnimplementedError
    from paddle1_tpu_torch.distributed.launch import launch
    with pytest.raises(UnimplementedError, match="item [68]"):
        launch([*flags, "script.py"])
