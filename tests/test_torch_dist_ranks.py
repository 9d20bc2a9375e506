"""The rank side of ``tests/test_torch_dist.py``: jobs that run inside
the gloo ranks ``paddle1_tpu_torch.distributed.spawn`` starts on the
CPU. Each rank joins the job through a ``FileStore`` under the test's
temporary directory, runs single-threaded, and writes what it computed
to ``<out>/<case>_rank<r>.npz``; the tests read and compare those. This
module imports torch and the port only, so a rank starts without JAX.
It holds no tests itself.
"""

import os

import numpy as np
import torch

from paddle1_tpu_torch import distributed as dist
from paddle1_tpu_torch.core.errors import InvalidArgumentError
from paddle1_tpu_torch.core.flags import flags_guard

KERNELS = dict(conv_nhwc="always", fused_bn="always", fused_bn_bwd="always")
PLAIN = dict(conv_nhwc="never", fused_bn="never", fused_bn_bwd="never")
STEPS = 3
# the SyncBatchNorm case: the global [8, 64, 4, 4] batch of
# tests/test_fused_bn.py's cross-replica check, and its weights
SBN_SHAPE, SBN_SEED = (8, 64, 4, 4), 0
# the DataParallel cases' global batch
DP_BATCH, DP_SEED = 8, 21


def _rank():
    return int(os.environ["PADDLE_TRAINER_ID"])


def _save(out, case, **arrays):
    np.savez(os.path.join(out, f"{case}_rank{_rank()}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in arrays.items()})


def sbn_inputs():
    """The SyncBatchNorm case's global x, weight and bias."""
    rng = np.random.default_rng(SBN_SEED)
    x = rng.standard_normal(SBN_SHAPE).astype(np.float32) * 2 + 1
    c = SBN_SHAPE[1]
    w = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    return x, w, b


def dp_inputs():
    rng = np.random.default_rng(DP_SEED)
    return {"x": rng.standard_normal((DP_BATCH, 6)).astype(np.float32),
            "t": rng.standard_normal((DP_BATCH, 3)).astype(np.float32),
            "img": rng.standard_normal((DP_BATCH, 3, 5, 5)).astype(
                np.float32)}


def mlp():
    from paddle1_tpu_torch.nn import Linear, ReLU, Sequential
    gen = torch.Generator().manual_seed(DP_SEED)
    return Sequential(Linear(6, 8, device="cpu", generator=gen), ReLU(),
                      Linear(8, 3, device="cpu", generator=gen))


def conv_bn(sync):
    from paddle1_tpu_torch.nn import (BatchNorm2D, Conv2D, ReLU, Sequential,
                                      SyncBatchNorm)
    gen = torch.Generator().manual_seed(DP_SEED + 1)
    bn = (SyncBatchNorm if sync else BatchNorm2D)(8, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 8))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, 8))
    return Sequential(Conv2D(3, 8, 3, padding=1, device="cpu",
                             generator=gen), bn, ReLU())


def _shard(a):
    n, r = dist.get_world_size(), dist.get_rank()
    k = a.shape[0] // n
    return a[r * k:(r + 1) * k]


# ---------------------------------------------------------------------------
# cases


def collectives_case(out):
    """Every collective on per-rank data ``arange(6) + 10 * rank``."""
    from paddle1_tpu_torch.distributed import ReduceOp
    r, n = dist.get_rank(), dist.get_world_size()
    base = torch.arange(6, dtype=torch.float32) + 10.0 * r
    res = {}
    for name in ("SUM", "AVG", "MAX", "MIN", "PROD"):
        t = base.clone()
        assert dist.all_reduce(t, getattr(ReduceOp, name)) is t
        res[name] = t
    res["broadcast"] = dist.broadcast(base.clone(), src=n - 1)
    parts = []
    res["all_gather"] = dist.all_gather(parts, base)
    assert len(parts) == n
    res["reduce"] = dist.reduce(base.clone(), dst=1, op=ReduceOp.SUM)
    x = base.clone().requires_grad_()
    y = dist.differentiable_all_reduce(x)
    (y * torch.full((6,), r + 1.0)).sum().backward()
    res["dar_y"], res["dar_grad"] = y, x.grad
    pair = dist.new_group([0, 1])
    res["pair_sum"] = dist.all_reduce(base.clone(), group=pair)
    res["pair_rank"] = pair.rank
    res["backend_gloo"] = torch.distributed.get_backend() == "gloo"
    dist.barrier()
    _save(out, f"collectives{n}", **res)


def sync_bn_case(out):
    """SyncBatchNorm under a dp binding on this rank's shard of the
    global batch, in both batch-norm arms: y, dx, the all-reduced
    dgamma/dbeta (the global batch's) and the running statistics."""
    from paddle1_tpu_torch.distributed import ReduceOp
    from paddle1_tpu_torch.nn import SyncBatchNorm
    x, w, b = sbn_inputs()
    res = {}
    for arm in ("always", "never"):
        bn = SyncBatchNorm(SBN_SHAPE[1], device="cpu")
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(w))
            bn.bias.copy_(torch.from_numpy(b))
        xs = torch.from_numpy(_shard(x).copy()).requires_grad_()
        with flags_guard(conv_nhwc="always", fused_bn=arm,
                         fused_bn_bwd=arm), \
                dist.spmd_axes(dp=dist.get_group()):
            y = bn(xs)
        (y ** 2).sum().backward()
        dg, db = bn.weight.grad.clone(), bn.bias.grad.clone()
        dist.all_reduce(dg, ReduceOp.SUM)
        dist.all_reduce(db, ReduceOp.SUM)
        res.update({f"{arm}_y": y, f"{arm}_dx": xs.grad, f"{arm}_dg": dg,
                    f"{arm}_db": db, f"{arm}_mean": bn._mean,
                    f"{arm}_var": bn._variance})
    _save(out, "sync_bn", **res)


def data_parallel_case(out):
    """DataParallel gradients on this rank's shard: an MLP, the same with
    no_sync + apply_collective_grads, and a conv + SyncBatchNorm under a
    dp binding."""
    from paddle1_tpu_torch.distributed import DataParallel
    data = {k: torch.from_numpy(_shard(v).copy())
            for k, v in dp_inputs().items()}
    res = {}
    net = DataParallel(mlp())
    ((net(data["x"]) - data["t"]) ** 2).mean().backward()
    res.update({"mlp." + k: p.grad.clone()
                for k, p in net._layers.named_parameters()})
    for p in net._layers.parameters():
        p.grad = None
    with net.no_sync():
        ((net(data["x"]) - data["t"]) ** 2).mean().backward()
    res["mlp_local_w"] = net._layers[0].weight.grad.clone()
    net.apply_collective_grads()
    res.update({"nosync." + k: p.grad.clone()
                for k, p in net._layers.named_parameters()})
    net16 = DataParallel(mlp(), comm_dtype="bfloat16")
    ((net16(data["x"]) - data["t"]) ** 2).mean().backward()
    res.update({"bf16comm." + k: p.grad
                for k, p in net16._layers.named_parameters()})
    assert set(net.state_dict()) == set(mlp().state_dict())
    conv = DataParallel(conv_bn(sync=True))
    with dist.spmd_axes(dp=dist.get_group()):
        (conv(data["img"]) ** 2).mean().backward()
    res.update({"conv." + k: p.grad for k, p in
                conv._layers.named_parameters()})
    res.update({"conv." + k: t for k, t in conv._layers.named_buffers()})
    _save(out, "data_parallel", **res)


def resnet_engine_case(out, state_file, batch_file):
    """ResNet-18 through ParallelEngine on a dp mesh: STEPS Momentum steps
    on the global batch, in both batch-norm arms. Rank 1 starts from
    shifted weights and statistics, which rank 0's broadcast undoes."""
    from paddle1_tpu_torch.convert import state_from_jax
    from paddle1_tpu_torch.nn import functional as F
    from paddle1_tpu_torch.optimizer import Momentum
    from paddle1_tpu_torch.vision.models import resnet18
    state = dict(np.load(state_file))
    batch = dict(np.load(batch_file))
    res = {}
    for arm, flags in (("plain", PLAIN), ("kernel", KERNELS)):
        tm = resnet18(num_classes=10, device="cpu")
        tm.load_state_dict(state_from_jax(state, tm))
        if dist.get_rank() == 1:
            with torch.no_grad():
                for t in tm.state_dict().values():
                    t.add_(0.5)
        tm.train()
        eng = dist.ParallelEngine(
            tm, Momentum(learning_rate=1e-3, momentum=0.9,
                         parameters=tm.parameters()),
            lambda m, b: F.cross_entropy(m(b["x"]), b["y"]),
            mesh=dist.build_mesh(dp=dist.get_world_size()))
        with flags_guard(**flags):
            res[arm + "_losses"] = [float(eng.step(batch))
                                    for _ in range(STEPS)]
        res.update({f"{arm}.{k}": v for k, v in tm.state_dict().items()})
    try:
        eng.shard_batch({"x": batch["x"][:5]})
        res["indivisible_raised"] = False
    except InvalidArgumentError:
        res["indivisible_raised"] = True
    _save(out, "resnet_engine", **res)


def unequal_shards_case(out):
    """A SyncBatchNorm whose ranks hold different row counts raises."""
    from paddle1_tpu_torch.nn import SyncBatchNorm
    bn = SyncBatchNorm(8, device="cpu")
    x = torch.ones(4 + 2 * dist.get_rank(), 8, 3, 3)
    raised = False
    try:
        with dist.spmd_axes(dp=dist.get_group()):
            bn(x)
    except InvalidArgumentError:
        raised = True
    _save(out, "unequal", raised=raised)


def mesh_case(out):
    """Meshes of two ranks on every axis: this rank's coordinates and the
    ranks of its group along the axis; the engine refuses pp for a model
    without a pipelined body (a TransformerEncoder) and takes the rest."""
    from paddle1_tpu_torch.core.errors import EnforceNotMet
    from paddle1_tpu_torch.optimizer import SGD
    res = {}
    for axis in ("dp", "mp", "sharding", "pp", "sp"):
        m = dist.build_mesh(**{axis: 2})
        res[axis + "_coord"] = m.coords[axis]
        res[axis + "_group"] = m.groups[axis].ranks
        res[axis + "_data"] = m.data_group.ranks
        try:
            dist.ParallelEngine(mlp(), SGD(learning_rate=0.1),
                                lambda mod, b: mod(b).sum(), mesh=m)
            res[axis + "_engine"] = ""
        except EnforceNotMet as e:
            res[axis + "_engine"] = str(e)
    _save(out, "mesh", **res)


def place_case(out):
    """Layers made without a device after ``init_parallel_env`` land on
    the rank's place, which it made the current place (here the CPU)."""
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.nn import Linear
    with paddle.utils.unique_name.guard():
        lin = Linear(4, 6)
    place = paddle.get_device()
    _save(out, "place", kind=place.kind, index=place.index,
          on_cpu=all(p.device.type == "cpu" for p in lin.parameters()),
          tensor_on_cpu=paddle.to_tensor([1.0]).device.type == "cpu")


# ---------------------------------------------------------------------------
# jobs: one spawn per world size


def job(out, init_file, cases):
    """Join the gloo job through the FileStore ``init_file`` and run
    ``cases``: ``(name, args)`` pairs of this module's ``*_case``
    functions."""
    torch.set_num_threads(1)
    dist.init_parallel_env(device="cpu", init_method=f"file://{init_file}")
    try:
        for name, args in cases:
            globals()[name + "_case"](out, *args)
    finally:
        dist.destroy_process_group()


def fail_on_rank0():
    if dist.get_rank() == 0:
        raise SystemExit(3)
    import time
    time.sleep(120)


def sleep_long():
    import time
    time.sleep(120)
