"""The rank side of ``tests/test_torch_sequence_cut.py``,
``tests/test_torch_zero_units.py`` and ``tests/test_torch_checkpoint.py``:
jobs that run inside the gloo ranks ``paddle1_tpu_torch.distributed.spawn``
starts on the CPU, one job per world size and file. Each rank joins
through a ``FileStore`` under the test's temporary directory, runs
single-threaded and writes what it computed to
``<out>/<case>_rank<r>.npz``; the tests read and compare those. This
module imports torch, numpy and the port only, so a rank starts without
JAX (``chip_smoke``, whose planted faults, gap measures and collective
counter it uses, imports none either). It holds no tests itself.
"""

import os

import numpy as np
import torch

import chip_smoke
from paddle1_tpu_torch import distributed as dist
from paddle1_tpu_torch.distributed.sharding_specs import data_partition_spec

STEPS = 3
LR = 1e-3
# a tiny BERT: four heads (two a rank after an mp or sp cut), depth 2,
# sequence 16, dropout off (so each rank's random draws do not matter)
BERT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
SEQ = data_partition_spec(("dp", "sharding"), seq_axis="sp")
# (name, build_mesh degrees, engine kwargs): the sequence cut
SEQ_MESHES_2 = (("sp2", dict(sp=2), {}),)
SEQ_MESHES_4 = (("sp4", dict(sp=4), {}),
                ("sp2_dp2", dict(sp=2, dp=2), {}),
                ("sp2_sh2_z2", dict(sp=2, sharding=2), dict(zero_stage=2)),
                ("sp2_sh2_z3", dict(sp=2, sharding=2), dict(zero_stage=3)),
                ("sp2_mp2", dict(sp=2, mp=2), {}),
                ("sp2_dp2_rc_tuple", dict(sp=2, dp=2),
                 dict(recompute=True, batch_spec=(("dp", "sharding"),
                                                  "sp"))))
# chip_smoke.SQ_PLANTS, each planted in its mesh: the phase-49 check must
# fail every one
SEQ_PLANTED = (("sp2_dp2", "sp_sum"), ("sp2_dp2", "input_grad"),
               ("sp2_dp2", "mask_cut"), ("sp2_sh2_z2", "unit_offset"))
# ZeRO's units, every control on: grad_accum 2, the clip, check_finite
ZERO_KW = dict(grad_accum=2, clip_global_norm=0.5, check_finite=True)
ZERO_MESHES_2 = tuple((f"sh2_z{s}", dict(sharding=2),
                       dict(zero_stage=s, **ZERO_KW)) for s in (1, 2, 3))
ZERO_MESHES_4 = tuple((f"dp2_sh2_z{s}", dict(dp=2, sharding=2),
                       dict(zero_stage=s, **ZERO_KW)) for s in (1, 2, 3))
# bf16: stage 3 gathers the 16-bit leaves after the cast, stage 2 casts
# the whole parameters: the same step
ZERO_AMP_2 = tuple((f"sh2_z{s}_bf16", dict(sharding=2),
                    dict(zero_stage=s, amp_dtype="bfloat16"))
                   for s in (2, 3))


def _rank():
    return int(os.environ["PADDLE_TRAINER_ID"])


def _save(out, case, **arrays):
    np.savez(os.path.join(out, f"{case}_rank{_rank()}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in arrays.items()})


def bert(state_file):
    """The tiny BERT with the JAX package's weights, Megatron-tagged."""
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


def engine(state_file, mesh, **kw):
    from paddle1_tpu_torch.optimizer import AdamW
    tm = bert(state_file)
    return dist.ParallelEngine(tm, AdamW(learning_rate=LR,
                                         parameters=tm.parameters()),
                               bert_loss(), mesh=mesh, **kw)


def batch_of(batch_file, kw):
    b = dict(np.load(batch_file))
    n = kw.get("grad_accum", 1)
    if n > 1:
        b = {k: v.reshape((n, -1) + v.shape[1:]) for k, v in b.items()}
    return b


def _engine_runs(out, state_file, batch_file, runs):
    """STEPS AdamW steps of each run ``(case, degrees, kw, fault)``: rank 0
    saves the whole state after them and the first step's gradient (every
    shard gathered); every rank its losses, its replicated tensors' gap
    to rank 0's, its ZeRO counters and the collectives of its last
    step."""
    for case, degrees, kw, fault in runs:
        eng = engine(state_file, dist.build_mesh(**degrees), **kw)
        plant = chip_smoke.PlantedSeq(eng, fault) if fault else None
        if plant is not None:
            plant.__enter__()
        try:
            b = batch_of(batch_file, kw)
            losses = [float(eng.step(b))]
            grads = eng.full_grad_dict()
            for _ in range(STEPS - 2):
                losses.append(float(eng.step(b)))
            with chip_smoke.CollectiveCount() as calls:
                losses.append(float(eng.step(b)))
        finally:
            if plant is not None:
                plant.__exit__(None, None, None)
        state = eng.full_state_dict()
        norms = chip_smoke.pp_rep_norms(state, torch.device("cpu"))
        res = {"losses": losses, "rep_norm_keys": np.array(sorted(norms)),
               "rep_norms": [norms[k] for k in sorted(norms)],
               **{f"calls_{k}": v for k, v in calls.n.items()}}
        z = eng._zero
        if z is not None:
            res.update(
                units=[u.n for u in z["units"]],
                max_grad_buffer=z["max_grad_buffer"],
                max_unit_gathered=z["max_unit_gathered"],
                max_gathered=z["max_gathered"],
                whole_grad_buffer=eng._flat is not None,
                param_numel=sum(p.nelement() for p in eng.params),
                slot_bytes=eng.slot_bytes())
        if dist.get_rank() == 0:
            res.update({"state." + k: v for k, v in state.items()})
            res.update({"grad." + k: v for k, v in grads.items()})
        _save(out, case, **res)


def seq_case(out, state_file, batch_file, meshes, planted=()):
    """The sequence cut on each mesh of ``meshes`` (``(name, degrees,
    kw)``; kw's batch_spec by default :data:`SEQ`), then each fault of
    ``planted`` (``(mesh, fault)``) planted in its mesh."""
    kws = {name: (degrees, {"batch_spec": SEQ, **kw})
           for name, degrees, kw in SEQ_MESHES_2 + SEQ_MESHES_4}
    runs = [(name, degrees, {"batch_spec": SEQ, **kw}, None)
            for name, degrees, kw in meshes] + \
        [(f"{mesh}_planted_{fault}", *kws[mesh], fault)
         for mesh, fault in planted]
    _engine_runs(out, state_file, batch_file, runs)


def seq_refusals_case(out, state_file, batch_file, bad_batch_file):
    """What the sequence cut refuses on this world: a leaf whose sequence
    does not divide over sp, a cut sequence at pp > 1 (item 5(iv-c)), and
    Ulysses with heads that do not divide over sp."""
    from paddle1_tpu_torch.core.errors import EnforceNotMet
    n = dist.get_world_size()
    said = {}
    eng = engine(state_file, dist.build_mesh(sp=n), batch_spec=SEQ)
    try:
        eng.shard_batch(dict(np.load(bad_batch_file)))
        said["indivisible"] = ""
    except EnforceNotMet as e:
        said["indivisible"] = f"{type(e).__name__}: {e}"
    if n == 4:
        try:
            engine(state_file, dist.build_mesh(pp=2, sp=2), batch_spec=SEQ)
            said["pp_sp"] = ""
        except EnforceNotMet as e:
            said["pp_sp"] = f"{type(e).__name__}: {e}"
    q = torch.zeros(1, 4, 3, 2)
    try:
        from paddle1_tpu_torch.distributed import sequence_parallel as sqp
        sqp._ulysses_heads(q, q, q, dist.get_group())
        said["heads"] = ""
    except EnforceNotMet as e:
        said["heads"] = f"{type(e).__name__}: {e}"
    _save(out, f"refusals{n}", **{k: np.array(v) for k, v in said.items()})


def fleet_sep_case(out, state_file, batch_file):
    """fleet at ``sep_degree`` = the world with ``batch_spec`` passed
    through ``fleet.parallel_engine``: the mesh, the cut and the losses."""
    from paddle1_tpu_torch.distributed import fleet, topology
    from paddle1_tpu_torch.optimizer import AdamW
    n = dist.get_world_size()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"sep_degree": n}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        tm = bert(state_file)
        eng = fleet.parallel_engine(
            tm, AdamW(learning_rate=LR, parameters=tm.parameters()),
            bert_loss(), batch_spec=SEQ)
        b = dict(np.load(batch_file))
        losses = [float(eng.step(b)) for _ in range(STEPS)]
        _save(out, "fleet_sep", losses=losses,
              sp=eng.mesh.shape["sp"], dp=eng.mesh.shape["dp"],
              cut=eng._sp is not None)
    finally:
        topology.set_hybrid_communicate_group(None)


def zero_case(out, state_file, batch_file, meshes):
    """ZeRO's units on each mesh of ``meshes``."""
    _engine_runs(out, state_file, batch_file,
                 [(name, degrees, kw, None) for name, degrees, kw in meshes])


def _mlp_engine(degrees, zero_stage, seed):
    """tests/test_sharded_checkpoint.py's engine: an MLP 8 -> 16 -> 4
    with its deterministic weights, AdamW(1e-2), the mean square loss;
    ``degrees`` None: world size 1."""
    from paddle1_tpu_torch.nn import Linear, ReLU, Sequential
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.utils import unique_name
    with unique_name.guard():
        model = Sequential(Linear(8, 16, device="cpu"), ReLU(),
                           Linear(16, 4, device="cpu"))
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.copy_(torch.from_numpy(
                np.random.default_rng(100 + i).standard_normal(
                    tuple(p.shape)).astype(np.float32) * 0.1))
    opt = AdamW(learning_rate=1e-2, parameters=model.parameters())
    rng = np.random.default_rng(seed)
    batch = {"x": rng.standard_normal((8, 8)).astype(np.float32),
             "y": rng.standard_normal((8, 4)).astype(np.float32)}
    mesh = None if degrees is None else dist.build_mesh(**degrees)
    return dist.ParallelEngine(model, opt,
                               lambda m, b: ((m(b["x"]) - b["y"]) ** 2)
                               .mean(), mesh=mesh, zero_stage=zero_stage), \
        batch


def _state(eng):
    return {k: v.detach().clone() for k, v in eng.full_state_dict().items()}


def checkpoint_case(out):
    """tests/test_sharded_checkpoint.py's four scenarios on this world (4
    ranks): the same topology, another topology (dp 2 x sharding 2 at
    ZeRO 2 into dp 4), ``sync_model`` after a load at dp 2, and the
    manager's retention and latest step over ranks."""
    res = {}
    eng, batch = _mlp_engine({"dp": 2, "sharding": 2}, 2, 0)
    for _ in range(2):
        eng.step(batch)
    path = eng.save_checkpoint(os.path.join(out, "ck_same"))
    again, _ = _mlp_engine({"dp": 2, "sharding": 2}, 2, 1)
    again.load_checkpoint(path)
    a, b = _state(eng), _state(again)
    res["same_state_equal"] = all(torch.equal(a[k], b[k]) for k in a)
    res["same_next"] = [float(eng.step(batch)), float(again.step(batch))]
    eng, batch = _mlp_engine({"dp": 2, "sharding": 2}, 2, 0)
    eng.step(batch)
    path = eng.save_checkpoint(os.path.join(out, "ck_other"))
    other, _ = _mlp_engine({"dp": 4}, 0, 2)
    other.load_checkpoint(path)
    a, b = _state(eng), _state(other)
    res["other_state_equal"] = all(torch.equal(a[k], b[k]) for k in a)
    res["other_next"] = [float(eng.step(batch)), float(other.step(batch))]
    eng, batch = _mlp_engine({"dp": 2, "sharding": 2}, 0, 0)
    eng.step(batch)
    path = eng.save_checkpoint(os.path.join(out, "ck_sync"))
    synced, _ = _mlp_engine({"dp": 2, "sharding": 2}, 0, 3)
    synced.load_checkpoint(path)
    res["sync_layer_equal"] = all(
        torch.equal(p, q) for p, q in zip(eng.model.state_dict().values(),
                                          synced.model.state_dict().values()))
    mgr = dist.CheckpointManager(os.path.join(out, "ckpts"), max_to_keep=2)
    eng, batch = _mlp_engine({"dp": 4}, 0, 0)
    for s in (1, 2, 3):
        eng.step(batch)
        mgr.save(s, {"params": eng.full_state_dict()})
    res["latest"] = mgr.latest_step()
    res["kept"] = sorted(int(d) for d in os.listdir(mgr.directory)
                         if d.isdigit())
    got, step = mgr.restore({"params": eng.full_state_dict()})
    res["restored_step"] = step
    a = eng.full_state_dict()
    res["restored_equal"] = all(torch.equal(got["params"][k], a[k])
                                for k in a)
    _save(out, "checkpoint", **res)


def resume_case(out, state_file, batch_file):
    """ZeRO 3 at sharding 2 (two ranks): STEPS - 1 steps, a save, two more;
    a fresh engine restored takes the same two: both runs' losses and
    states (rank 0), and the state at the save for world size 1's
    restore."""
    mesh = dist.build_mesh(sharding=2)
    b = dict(np.load(batch_file))
    eng = engine(state_file, mesh, zero_stage=3)
    for _ in range(STEPS - 1):
        eng.step(b)
    path = eng.save_checkpoint(os.path.join(out, "ck_z3"))
    at_save = eng.full_state_dict()
    want = [float(eng.step(b)) for _ in range(2)]
    whole = eng.full_state_dict()
    again = engine(state_file, mesh, zero_stage=3)
    again.load_checkpoint(path)
    got = [float(again.step(b)) for _ in range(2)]
    resumed = again.full_state_dict()
    res = {"losses": want, "resumed_losses": got,
           "state_bit_equal": all(torch.equal(whole[k], resumed[k])
                                  for k in whole)}
    if dist.get_rank() == 0:
        res.update({"at_save." + k: v for k, v in at_save.items()})
    _save(out, "resume", **res)


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
