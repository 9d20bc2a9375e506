"""The rank side of ``tests/test_torch_hybrid.py``: jobs that run inside
the gloo ranks ``paddle1_tpu_torch.distributed.spawn`` starts on the CPU,
one job per world size. Each rank joins through a ``FileStore`` under the
test's temporary directory, runs single-threaded and writes what it
computed to ``<out>/<case>_rank<r>.npz``; the tests read and compare
those. This module imports torch, numpy and the port only, so a rank
starts without JAX (``chip_smoke``, whose collective counter it uses,
imports none either). It holds no tests itself.
"""

import os

import numpy as np
import torch

import chip_smoke
from paddle1_tpu_torch import distributed as dist
from paddle1_tpu_torch.distributed import collective as C

STEPS = 3
LR = 1e-3
# the tiny BERT of tests/test_parallel_engine.py
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
# (name, build_mesh degrees, engine kwargs): the five meshes of the
# engine parity, on four ranks
MESHES = (("dp2_sh2_z2", dict(dp=2, sharding=2), dict(zero_stage=2)),
          ("mp2_sh2_z2", dict(mp=2, sharding=2), dict(zero_stage=2)),
          ("mp4", dict(mp=4), {}),
          ("sh4_z3", dict(sharding=4), dict(zero_stage=3)),
          ("dp2_mp2_ga2_clip", dict(dp=2, mp=2),
           dict(grad_accum=2, clip_global_norm=0.5)))
# (mesh, fault): chip_smoke.hy_plant's faults planted in a mesh, which the
# cross-rank check must fail
PLANTED = (("dp2_sh2_z2", "zero_shard"), ("dp2_sh2_z2", "unaveraged"),
           ("mp2_sh2_z2", "drop_f"))
# the mp layers' sizes (two ranks)
MP_IN, MP_OUT, MP_VOCAB, MP_ROWS = 6, 8, 10, 5


def _rank():
    return int(os.environ["PADDLE_TRAINER_ID"])


def _save(out, case, **arrays):
    np.savez(os.path.join(out, f"{case}_rank{_rank()}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in arrays.items()})


def base(r, n=6):
    return torch.arange(n, dtype=torch.float32) + 10.0 * r


def mp_inputs():
    """The mp layers' whole weights and inputs (the same on every rank)."""
    rng = np.random.default_rng(7)
    f = np.float32
    return {"w": rng.standard_normal((MP_IN, MP_OUT)).astype(f),
            "b": rng.standard_normal(MP_OUT).astype(f),
            "x": rng.standard_normal((MP_ROWS, MP_IN)).astype(f),
            "dy": rng.standard_normal((MP_ROWS, MP_OUT)).astype(f),
            "emb": rng.standard_normal((MP_VOCAB, MP_OUT)).astype(f),
            "ids": rng.integers(0, MP_VOCAB, (MP_ROWS, 3)).astype(np.int64),
            "logits": rng.standard_normal((MP_ROWS, MP_VOCAB)).astype(f),
            "label": rng.integers(0, MP_VOCAB, (MP_ROWS,)).astype(np.int64)}


# ---------------------------------------------------------------------------
# cases


def collectives_case(out):
    """Every collective added to the port's ``collective.py``, on the
    per-rank data ``arange(6) + 10 * rank``, and the Megatron pairs'
    forward and backward over the world."""
    r, n = dist.get_rank(), dist.get_world_size()
    res = {}
    objs = []
    dist.all_gather_object(objs, {"rank": r, "tag": f"r{r}"})
    res["objects"] = [o["rank"] for o in objs]
    res["object_tags"] = np.array([o["tag"] for o in objs])
    full = torch.arange(2 * n, dtype=torch.float32) + 100.0 * r
    shard = torch.zeros(2)
    assert dist.reduce_scatter(shard, full) is shard
    res["reduce_scatter"] = shard
    res["reduce_scatter_avg"] = dist.reduce_scatter(
        torch.zeros(2), list(full.reshape(n, 2)), op=dist.ReduceOp.AVG)
    res["reduce_scatter_max"] = dist.reduce_scatter(
        torch.zeros(2), full, op=dist.ReduceOp.MAX)
    src_list = [base(j) + 1000.0 for j in range(n)] if r == n - 1 else None
    res["scatter"] = dist.scatter(torch.zeros(6), src_list, src=n - 1)
    outs = []
    got = dist.alltoall([base(r) + j for j in range(n)], outs)
    res["alltoall"] = got
    assert len(outs) == n
    res["alltoall_tensor"] = dist.all_to_all(
        torch.stack([base(r) * (j + 1) for j in range(n)]))
    nxt, prv = (r + 1) % n, (r - 1) % n
    if r % 2 == 0:
        dist.send(base(r), dst=nxt)
        res["recv"] = dist.recv(torch.zeros(6), src=prv)
    else:
        res["recv"] = dist.recv(torch.zeros(6), src=prv)
        dist.send(base(r), dst=nxt)
    buf = torch.zeros(6)
    work = [dist.isend(base(r) * 2, dst=nxt), dist.irecv(buf, src=prv)]
    for w in work:
        assert w.wait()
    assert dist.wait(buf) is None
    res["irecv"] = buf
    gathered = torch.zeros(2 * n)
    res["all_gather_into"] = C.all_gather_into(gathered,
                                               torch.full((2,), float(r)))
    # hierarchical: pairs inside, across pairs outside (one pair on 2)
    pairs = [dist.new_group([2 * i, 2 * i + 1]) for i in range(n // 2)]
    across = [dist.new_group(list(range(j, n, 2))) for j in range(2)]
    res["hier"] = dist.hierarchical_all_reduce(
        torch.stack([base(r), base(r) + 1]), pairs[r // 2], across[r % 2])
    res["hier_odd"] = dist.hierarchical_all_reduce(
        base(r)[:5], pairs[r // 2], across[r % 2])
    # the Megatron pairs over the world, each against its hand-derived
    # gradient: the cotangent of rank r is (r + 1) * ones
    world = dist.get_group()
    w = torch.full((6,), r + 1.0)
    x = base(r).requires_grad_()
    y = C._c_identity(x, world)
    (y * w).sum().backward()
    res["ident_y"], res["ident_g"] = y, x.grad
    x = base(r).requires_grad_()
    y = C._mp_allreduce(x, world)
    (y * w).sum().backward()
    res["allred_y"], res["allred_g"] = y, x.grad
    x = base(r).reshape(2, 3).requires_grad_()
    y = C._c_concat(x, world)
    (y * torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
     * (r + 1)).sum().backward()
    res["concat_y"], res["concat_g"] = y, x.grad
    x = torch.arange(2.0 * 2 * n).reshape(2, 2 * n).requires_grad_()
    y = C._c_split(x, world)
    (y * (r + 1)).sum().backward()
    res["split_y"], res["split_g"] = y, x.grad
    res["split_fn"] = dist.split(x.detach(), n, axis=-1, group=world)
    dist.barrier()
    _save(out, f"collectives{n}", **res)


def topology_case(out):
    """This rank's coordinates and group ranks on four-rank meshes."""
    res = {}
    for tag, kw in (("dp2_mp2", dict(dp=2, mp=2)),
                    ("sh2_mp2", dict(sharding=2, mp=2)),
                    ("pp2_dp2", dict(pp=2, dp=2)),
                    ("dp2_sh2", dict(dp=2, sharding=2)),
                    ("sp2_sh2", dict(sp=2, sharding=2))):
        m = dist.build_mesh(**kw)
        res[f"{tag}_coords"] = [m.coords[a] for a in m.axis_names]
        for a in m.axis_names:
            res[f"{tag}_{a}"] = m.groups[a].ranks
        res[f"{tag}_data"] = m.data_group.ranks
        t = torch.full((1,), float(dist.get_rank()))
        dist.all_reduce(t, group=m.groups["mp"] if kw.get("mp")
                        else m.data_group)
        res[f"{tag}_sum"] = t
    from paddle1_tpu_torch.core.errors import EnforceNotMet
    raised = []
    for kw in (dict(pp=2, dp=2), dict(sp=2, dp=2)):
        try:
            dist.ParallelEngine(torch.nn.Linear(2, 2), _adamw(),
                                lambda m, b: m(b).sum(),
                                mesh=dist.build_mesh(**kw))
            raised.append("")
        except EnforceNotMet as e:
            raised.append(str(e))
    res["engine_raises"] = np.array(raised)
    _save(out, "topology", **res)


def _adamw(params=None):
    from paddle1_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=LR, parameters=params)


def mp_layers_case(out):
    """The four mp layers on the world (two ranks) with the whole weights
    of :func:`mp_inputs` carried in: outputs, input and weight gradients
    (each rank's shard)."""
    from paddle1_tpu_torch.distributed import meta_parallel as mpl
    from paddle1_tpu_torch.utils import unique_name
    d = {k: torch.from_numpy(v) for k, v in mp_inputs().items()}
    g = dist.get_group()
    r, n = g.rank, g.nranks
    res = {}
    with unique_name.guard():
        for gather in (True, False):
            col = mpl.ColumnParallelLinear(MP_IN, MP_OUT,
                                           gather_output=gather,
                                           mp_group=g, device="cpu")
            k = MP_OUT // n
            with torch.no_grad():
                col.weight.copy_(d["w"][:, r * k:(r + 1) * k])
                col.bias.copy_(d["b"][r * k:(r + 1) * k])
            x = d["x"].clone().requires_grad_()
            y = col(x)
            dy = d["dy"] if gather else d["dy"][:, r * k:(r + 1) * k]
            (y * dy).sum().backward()
            tag = f"col_{int(gather)}"
            res.update({tag + "_y": y, tag + "_dx": x.grad,
                        tag + "_dw": col.weight.grad,
                        tag + "_db": col.bias.grad})
        for parallel in (False, True):
            row = mpl.RowParallelLinear(MP_IN if not parallel else 2 * n,
                                        MP_OUT, input_is_parallel=parallel,
                                        mp_group=g, device="cpu")
            w = d["w"] if not parallel else d["w"][:2 * n]
            k = w.shape[0] // n
            with torch.no_grad():
                row.weight.copy_(w[r * k:(r + 1) * k])
                row.bias.copy_(d["b"])
            x = d["x"] if not parallel else d["x"][:, :2 * n]
            x = (x if not parallel else x[:, r * k:(r + 1) * k]) \
                .clone().requires_grad_()
            y = row(x)
            (y * d["dy"]).sum().backward()
            tag = f"row_{int(parallel)}"
            res.update({tag + "_y": y, tag + "_dx": x.grad,
                        tag + "_dw": row.weight.grad,
                        tag + "_db": row.bias.grad})
        emb = mpl.VocabParallelEmbedding(MP_VOCAB, MP_OUT, mp_group=g,
                                         device="cpu")
        k = MP_VOCAB // n
        with torch.no_grad():
            emb.weight.copy_(d["emb"][r * k:(r + 1) * k])
        y = emb(d["ids"])
        (y * d["dy"][:, None, :]).sum().backward()
        res.update({"emb_y": y, "emb_dw": emb.weight.grad})
        ce = mpl.ParallelCrossEntropy(mp_group=g)
        lg = d["logits"][:, r * k:(r + 1) * k].clone().requires_grad_()
        loss = ce(lg, d["label"])
        (loss.squeeze(-1) * torch.arange(1.0, MP_ROWS + 1)).sum().backward()
        res.update({"ce_loss": loss, "ce_dlogits": lg.grad})
    _save(out, "mp_layers", **res)


def bert(state_file):
    from paddle1_tpu_torch.convert import state_from_jax
    from paddle1_tpu_torch.text.models import (BertForPretraining,
                                               BertModel,
                                               apply_megatron_sharding)
    from paddle1_tpu_torch.utils import unique_name
    with unique_name.guard():
        tm = BertForPretraining(BertModel(device="cpu", **BERT))
    tm.load_state_dict(state_from_jax(dict(np.load(state_file)), tm))
    return apply_megatron_sharding(tm)


def bert_loss():
    from paddle1_tpu_torch.text.models import BertPretrainingCriterion
    crit = BertPretrainingCriterion(BERT["vocab_size"])

    def loss_fn(m, b):
        s, rel = m(b["ids"])
        return crit(s, rel, b["mlm"], b["nsp"])
    return loss_fn


def engine_case(out, state_file, batch_file, batch16_file):
    """The tiny BERT, Megatron-tagged, through ParallelEngine on each of
    MESHES, then on the meshes of PLANTED with the fault planted: STEPS
    AdamW steps on the global batch (8 rows; 16 as [2, 8] under
    grad_accum); rank 0 saves the whole state and the first step's
    gradient (every shard gathered), each rank its slot bytes and the
    collectives of its last step."""
    meshes = {name: (degrees, kw) for name, degrees, kw in MESHES}
    runs = [(name, name, None) for name in meshes] + \
        [(f"{name}_planted_{fault}", name, fault) for name, fault in PLANTED]
    for case, name, fault in runs:
        degrees, kw = meshes[name]
        tm = bert(state_file)
        mesh = dist.build_mesh(**degrees)
        eng = dist.ParallelEngine(tm, _adamw(tm.parameters()), bert_loss(),
                                  mesh=mesh, **kw)
        if fault is not None:
            chip_smoke.hy_plant(eng, fault)
        b = dict(np.load(batch_file))
        if kw.get("grad_accum", 1) > 1:
            b = {k: v.reshape((kw["grad_accum"], -1) + v.shape[1:])
                 for k, v in np.load(batch16_file).items()}
        losses = [float(eng.step(b))]
        grads = eng.full_grad_dict()
        losses += [float(eng.step(b)) for _ in range(STEPS - 2)]
        with chip_smoke.CollectiveCount() as calls:
            losses.append(float(eng.step(b)))
        state = eng.full_state_dict()
        res = {"losses": losses, "slot_bytes": eng.slot_bytes(),
               "param_numel": sum(p.nelement() for p in eng.params),
               **{f"calls_{k}": v for k, v in calls.n.items()}}
        if dist.get_rank() == 0:
            res.update({"state." + k: v for k, v in state.items()})
            res.update({"grad." + k: v for k, v in grads.items()})
        _save(out, "engine_" + case, **res)


def fleet_case(out):
    """fleet on the world: an MLP through distributed_model /
    distributed_optimizer at dp = n (one SGD step on this rank's shard),
    then the tiny BERT's tagged layers through ModelParallel at mp = n
    (forward and backward on the whole batch, an AdamW step)."""
    from paddle1_tpu_torch.distributed import fleet
    from paddle1_tpu_torch.nn import Linear, ReLU, Sequential
    from paddle1_tpu_torch.optimizer import SGD
    from paddle1_tpu_torch.utils import unique_name
    n, r = dist.get_world_size(), dist.get_rank()
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": n}
    fleet.init(is_collective=True, strategy=strategy)
    with unique_name.guard():
        gen = torch.Generator().manual_seed(31)
        net = Sequential(Linear(6, 8, device="cpu", generator=gen), ReLU(),
                         Linear(8, 3, device="cpu", generator=gen))
    model = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(SGD(learning_rate=0.1,
                                          parameters=net.parameters()))
    k = 8 // n
    loss = ((model(x[r * k:(r + 1) * k]) - t[r * k:(r + 1) * k]) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    res = {"dp." + k2: v for k2, v in net.state_dict().items()}
    res["dp_worker_num"] = fleet.worker_num()
    res["dp_worker_index"] = fleet.worker_index()
    res["hcg_dp"] = fleet.get_hybrid_communicate_group() \
        .get_data_parallel_world_size()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": n}
    fleet.init(is_collective=True, strategy=strategy)
    state_file, batch_file = out + "/bert_state.npz", out + "/batch.npz"
    tm = bert(state_file)
    model = fleet.distributed_model(tm)
    opt = fleet.distributed_optimizer(_adamw(tm.parameters()))
    b = {k2: torch.from_numpy(v) for k2, v in np.load(batch_file).items()}
    loss = bert_loss()(model, b)
    loss.backward()
    opt.step()
    res["mp_loss"] = loss
    hcg = fleet.get_hybrid_communicate_group()
    res["hcg_mp"] = hcg.get_model_parallel_world_size()
    res["hcg_mp_rank"] = hcg.get_model_parallel_rank()
    mp = hcg.get_model_parallel_group()
    for k2, v in tm.state_dict(keep_vars=True).items():
        axes = tuple(getattr(v, "sharding_axes", None) or ())
        if "mp" in axes:
            parts = []
            dist.all_gather(parts, v.detach().contiguous(), mp)
            v = torch.cat(parts, dim=axes.index("mp"))
        res["mp." + k2] = v
    from paddle1_tpu_torch.distributed import meta_parallel as mpl
    mpl.model_parallel_random_seed(100)
    tracker = mpl.get_rng_state_tracker()
    res["rng_default"] = torch.rand(4)
    with tracker.rng_state():
        res["rng_tracked"] = torch.rand(4)
    res["rng_default_after"] = torch.rand(4)
    _save(out, "fleet", **res)


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
