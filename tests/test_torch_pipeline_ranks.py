"""The rank side of ``tests/test_torch_pipeline_engine.py`` and
``tests/test_torch_sequence_parallel.py``: jobs that run inside the gloo
ranks ``paddle1_tpu_torch.distributed.spawn`` starts on the CPU, one job
per world size and file. Each rank joins through a ``FileStore`` under
the test's temporary directory, runs single-threaded and writes what it
computed to ``<out>/<case>_rank<r>.npz``; the tests read and compare
those. This module imports torch, numpy and the port only, so a rank
starts without JAX (``chip_smoke``, whose planted faults and collective
counter it uses, imports none either). It holds no tests itself.
"""

import os

import numpy as np
import torch

import chip_smoke
from paddle1_tpu_torch import distributed as dist

STEPS = 3
LR = 0.05
# the tiny BERT of tests/test_pipeline_v2.py:25-31 (four blocks, dropout
# off, so each block's random draws do not matter)
BERT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=4,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
# (name, build_mesh degrees, engine kwargs): the engine at pp > 1 on four
# ranks, SGD steps on the global batch of 8 rows (16 as [2, 8] under
# grad_accum); pp_microbatches defaults to pp
MESHES = (("pp4", dict(pp=4), {}),
          ("pp2_dp2", dict(pp=2, dp=2), {}),
          ("pp2_sh2_z2", dict(pp=2, sharding=2),
           dict(zero_stage=2, pp_microbatches=4)),
          ("pp2_mp2_finite", dict(pp=2, mp=2),
           dict(pp_microbatches=4, check_finite=True)),
          ("pp2_dp2_ga2_clip_rc", dict(pp=2, dp=2),
           dict(grad_accum=2, clip_global_norm=0.5, recompute=True)),
          ("sp2_dp2", dict(sp=2, dp=2), {}))
# chip_smoke.PP_PLANTS planted in the pp2 x dp2 mesh: the cross-rank check
# (chip_smoke.pp_verdict) must fail each
PLANTED = tuple(("pp2_dp2", f) for f in chip_smoke.PP_PLANTS)
# pipeline_apply: four stages of tanh(x @ w + b) over micro-batches
PA_STAGES, PA_MICRO, PA_ROWS, PA_D = 4, 6, 3, 5
# ring / Ulysses: q, k, v of tests/test_sequence_parallel.py's shape
SP_SHAPE = (2, 64, 4, 16)


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


def sgd(params):
    from paddle1_tpu_torch.optimizer import SGD
    return SGD(learning_rate=LR, parameters=params)


def accum(batch, kw):
    n = kw.get("grad_accum", 1)
    if n == 1:
        return batch
    return {k: v.reshape((n, -1) + v.shape[1:]) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# cases


def engine_case(out, state_file, batch_file, batch16_file):
    """The tiny BERT through ParallelEngine on each of MESHES, then on the
    meshes of PLANTED with the fault planted: STEPS SGD steps (the last
    two as one ``step_many`` under grad_accum); rank 0 saves the whole
    state and the first step's gradient (every stage and shard gathered),
    every rank its losses, parameter count and the norms of its
    replicated tensors' gaps to rank 0's."""
    import contextlib
    meshes = {name: (degrees, kw) for name, degrees, kw in MESHES}
    runs = [(name, name, None) for name in meshes] + \
        [(f"{name}_planted_{fault}", name, fault)
         for name, fault in PLANTED]
    for case, name, fault in runs:
        degrees, kw = meshes[name]
        tm = bert(state_file)
        eng = dist.ParallelEngine(tm, sgd(tm.parameters()), bert_loss(),
                                  mesh=dist.build_mesh(**degrees), **kw)
        plant = chip_smoke.PlantedHandoff(fault) if fault else \
            contextlib.nullcontext()
        b = accum(dict(np.load(batch16_file if kw.get("grad_accum", 1) > 1
                               else batch_file)), kw)
        with plant:
            losses = [float(eng.step(b))]
            grads = eng.full_grad_dict()
            if kw.get("grad_accum", 1) > 1:
                losses += [float(x) for x in eng.step_many([b, b]).numpy()]
            else:
                losses += [float(eng.step(b)) for _ in range(STEPS - 1)]
        state = eng.full_state_dict()
        norms = chip_smoke.pp_rep_norms(state, torch.device("cpu"))
        encs = [m for m in tm.modules()
                if getattr(m, "pipeline_group", None) is not None]
        res = {"losses": losses,
               "param_numel": sum(p.nelement() for p in eng.params),
               "micro": [m.pipeline_microbatches for m in encs],
               "rep_keys": np.array(sorted(norms)),
               "rep_norms": [norms[k] for k in sorted(norms)]}
        if dist.get_rank() == 0:
            res.update({"state." + k: v for k, v in state.items()})
            res.update({"grad." + k: v for k, v in grads.items()})
        _save(out, "engine_" + case, **res)


def sync_case(out, state_file, batch_file):
    """pp 4: after two SGD steps ``sync_model`` gathers every stage into
    the model (its state equal to ``full_state_dict``'s), the whole model
    runs eagerly, and the next step drops the other stages' blocks
    again."""
    tm = bert(state_file)
    eng = dist.ParallelEngine(tm, sgd(tm.parameters()), bert_loss(),
                              mesh=dist.build_mesh(pp=4))
    b = dict(np.load(batch_file))
    held = sum(p.nelement() for p in tm.parameters())
    eng.step(b)
    eng.step(b)
    full = eng.full_state_dict()
    eng.sync_model()
    whole = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        eager = bert_loss()(tm, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
    eng.step(b)
    _save(out, "sync", held=held,
          whole_numel=sum(v.nelement() for v in whole.values()),
          after_step=sum(p.nelement() for p in tm.parameters()),
          eager_loss=eager,
          max_gap=max(float((whole[k] - v).abs().max())
                      for k, v in full.items()),
          same_keys=sorted(whole) == sorted(full))


def _pa_inputs():
    rng = np.random.default_rng(11)
    f = np.float32
    return {"w": rng.standard_normal((PA_STAGES, PA_D, PA_D)).astype(f) / 2,
            "b": rng.standard_normal((PA_STAGES, PA_D)).astype(f),
            "x": rng.standard_normal((PA_MICRO, PA_ROWS, PA_D)).astype(f),
            "aux": rng.standard_normal((PA_MICRO, 1, PA_D)).astype(f),
            "dy": rng.standard_normal((PA_MICRO, PA_ROWS, PA_D)).astype(f)}


def pa_stage(p, x, aux=None):
    y = torch.tanh(x @ p["w"] + p["b"])
    return y if aux is None else y * aux


def pipeline_apply_case(out):
    """``pipeline_apply`` over the world as the pp group: the stacked
    parameters of every stage (each rank takes its own) and this rank's
    stage alone (leading dim 1), without and with ``micro_aux``: outputs
    and the gradients of ``sum(y * dy)``."""
    d = {k: torch.from_numpy(v) for k, v in _pa_inputs().items()}
    r = dist.get_rank()
    res = {}
    for tag, local, aux in (("all", False, None), ("own", True, d["aux"])):
        w = d["w"].clone().requires_grad_()
        b = d["b"].clone().requires_grad_()
        x = d["x"].clone().requires_grad_()
        params = dist.stack_stage_params(
            [{"w": w[i], "b": b[i]} for i in range(PA_STAGES)])
        if local:
            params = {"w": params["w"][r:r + 1], "b": params["b"][r:r + 1]}
        y = dist.pipeline_apply(pa_stage, params, x, "pp", micro_aux=aux,
                                group=dist.get_group())
        (y * d["dy"]).sum().backward()
        res.update({f"{tag}_y": y, f"{tag}_dx": x.grad,
                    f"{tag}_dw": w.grad[r], f"{tag}_db": b.grad[r]})
    _save(out, "pipeline_apply", **res)


def sequence_case(out, data_file):
    """Ring and Ulysses attention over the world as the sequence group,
    each rank on its piece of the sequence, causal and not: outputs and
    the gradients of ``sum(out ** 2)`` over every rank (each rank's
    pieces of them), and Ulysses refusing a head count the group does
    not divide."""
    from paddle1_tpu_torch.core.errors import InvalidArgumentError
    data = dict(np.load(data_file))
    g, r = dist.get_group(), dist.get_rank()
    nl = SP_SHAPE[1] // g.nranks
    res = {}
    for name, fn in (("ring", dist.ring_attention),
                     ("ulysses", dist.ulysses_attention)):
        for causal in (False, True):
            q, k, v = (torch.from_numpy(data[t][:, r * nl:(r + 1) * nl])
                       .requires_grad_() for t in "qkv")
            o = fn(q, k, v, "sp", causal=causal, group=g)
            (o ** 2).sum().backward()
            tag = f"{name}_{int(causal)}"
            res.update({tag + "_o": o, tag + "_dq": q.grad,
                        tag + "_dk": k.grad, tag + "_dv": v.grad})
    q = torch.zeros(1, 4, g.nranks - 1, 8)
    try:
        dist.ulysses_attention(q, q, q, "sp", group=g)
        res["heads_raise"] = ""
    except InvalidArgumentError as e:
        res["heads_raise"] = str(e)
    _save(out, "sequence", **res)


def fleet_case(out, state_file, batch_file):
    """fleet at pp_degree 2 on two ranks: ``distributed_model`` of a
    PipelineLayer is a ``PipelineParallel``; ``parallel_engine`` takes
    ``pipeline_configs.accumulate_steps`` as the micro-batch count and
    runs STEPS SGD steps of the tiny BERT."""
    from paddle1_tpu_torch.distributed import fleet, topology
    from paddle1_tpu_torch.distributed.meta_parallel import (
        LayerDesc, PipelineLayer, PipelineParallel)
    from paddle1_tpu_torch.nn import Linear
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": 2, "dp_degree": 1,
                               "mp_degree": 1}
    strategy.pipeline_configs = {"accumulate_steps": 4,
                                 "micro_batch_size": 2}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        layer = PipelineLayer([LayerDesc(Linear, 4, 4, device="cpu")
                               for _ in range(4)], loss_fn=lambda o, y: o)
        wrapped = fleet.distributed_model(layer)
        tm = bert(state_file)
        eng = fleet.parallel_engine(tm, sgd(tm.parameters()), bert_loss())
        b = dict(np.load(batch_file))
        losses = [float(eng.step(b)) for _ in range(STEPS)]
        state = eng.full_state_dict()
        encs = [m for m in tm.modules()
                if getattr(m, "pipeline_group", None) is not None]
        res = {"wrapper": type(wrapped).__name__,
               "is_pp": isinstance(wrapped, PipelineParallel),
               "stages": layer.num_stages, "parts": layer.segment_parts,
               "micro": [m.pipeline_microbatches for m in encs],
               "pp": eng.mesh.shape["pp"], "losses": losses}
        if dist.get_rank() == 0:
            res.update({"state." + k: v for k, v in state.items()})
        _save(out, "fleet", **res)
    finally:
        topology.set_hybrid_communicate_group(None)


# ---------------------------------------------------------------------------
# jobs: one spawn per world size and file


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
