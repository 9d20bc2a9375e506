"""Slice 4b(iv) of the PyTorch port: ring and Ulysses attention on four
gloo ranks on the CPU (``tests/test_torch_pipeline_ranks.py``'s
``sequence_case``, one spawn) against the JAX functions under
``shard_map`` over four virtual devices (``tests/test_sequence_parallel.py``'s
setting), causal and not, and their gradients against dense attention;
on one rank (no group) both are dense attention. Float32; each tolerance
is stated where it is used.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import test_torch_pipeline_ranks as ranks
from paddle1_tpu.distributed.sequence_parallel import (
    ring_attention as jring, ulysses_attention as julysses)
from paddle1_tpu_torch import distributed as tdist
from paddle1_tpu_torch.nn.functional.attention import attention_ref

JOB_TIMEOUT_S = 300
# tests/test_sequence_parallel.py's limits: outputs against the JAX
# functions (and dense attention) 2e-5, gradients against dense 5e-4
OUT_TOL, GRAD_TOL = 2e-5, 5e-4
N_RANKS = 4


def _data():
    rng = np.random.default_rng(0)
    return {t: rng.standard_normal(ranks.SP_SHAPE).astype(np.float32)
            for t in "qkv"}


@pytest.fixture(scope="module")
def seq_job(tmp_path_factory):
    """One 4-rank job: ring and Ulysses over the world."""
    tmp = tmp_path_factory.mktemp("seq")
    np.savez(tmp / "qkv.npz", **_data())
    tdist.spawn(ranks.job, args=(str(tmp), str(tmp / "store"),
                                 [("sequence", (str(tmp / "qkv.npz"),))]),
                nprocs=N_RANKS, timeout=JOB_TIMEOUT_S)
    return [dict(np.load(os.path.join(tmp, f"sequence_rank{r}.npz")))
            for r in range(N_RANKS)]


def _jax_sharded(fn, causal, d):
    try:
        from jax import shard_map
    except ImportError:   # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map
    mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("sp",))
    spec = P(None, "sp")
    f = shard_map(lambda q, k, v: fn(q, k, v, "sp", causal=causal),
                  mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
    return np.asarray(f(*(jnp.asarray(d[t]) for t in "qkv")))


def _dense(d, causal):
    q, k, v = (torch.from_numpy(d[t]).requires_grad_() for t in "qkv")
    o = attention_ref(q, k, v, is_causal=causal)
    (o ** 2).sum().backward()
    return o.detach(), q.grad, k.grad, v.grad


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_on_4_ranks_equal_the_jax_functions_and_dense_gradients(
        name, causal, seq_job):
    d = _data()
    want = _jax_sharded(jring if name == "ring" else julysses, causal, d)
    o, dq, dk, dv = _dense(d, causal)
    nl = ranks.SP_SHAPE[1] // N_RANKS
    tag = f"{name}_{int(causal)}"
    for r, got in enumerate(seq_job):
        cut = slice(r * nl, (r + 1) * nl)
        np.testing.assert_allclose(got[tag + "_o"], want[:, cut],
                                   atol=OUT_TOL, rtol=0)
        np.testing.assert_allclose(got[tag + "_o"], o[:, cut], atol=OUT_TOL,
                                   rtol=0)
        for g, w in (("_dq", dq), ("_dk", dk), ("_dv", dv)):
            np.testing.assert_allclose(got[tag + g], w[:, cut],
                                       atol=GRAD_TOL, rtol=0,
                                       err_msg=tag + g)


def test_ulysses_refuses_heads_the_group_does_not_divide(seq_job):
    for got in seq_job:
        msg = str(got["heads_raise"])
        assert "num_heads 3 not divisible by sp=4" in msg


@pytest.mark.parametrize("causal", [False, True])
def test_on_one_rank_both_are_dense_attention(causal):
    d = _data()
    o, dq, dk, dv = _dense(d, causal)
    for fn in (tdist.ring_attention, tdist.ulysses_attention):
        q, k, v = (torch.from_numpy(d[t]).requires_grad_() for t in "qkv")
        got = fn(q, k, v, "sp", causal=causal)
        (got ** 2).sum().backward()
        np.testing.assert_allclose(got.detach(), o, atol=OUT_TOL, rtol=0)
        for a, b in ((q.grad, dq), (k.grad, dk), (v.grad, dv)):
            np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=0)
