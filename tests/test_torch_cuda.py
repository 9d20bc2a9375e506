"""Checks of the PyTorch port that need a CUDA card.

Marked ``cuda``; without a card they skip. On the card, from the repo
root (this file imports nothing of JAX, so the JAX test conftest is
left out)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

They hold that on CUDA tensors the functionals always go through the
kernels' wrappers: inputs outside a kernel's contract raise instead of
running the plain version, and a bf16 KV pool under f32 queries runs the
kernel and agrees with the plain version.
"""

import numpy as np
import pytest
import torch

from paddle1_tpu_torch.core.errors import InvalidArgumentError
from paddle1_tpu_torch.nn import functional as F
from paddle1_tpu_torch.ops import layer_norm as ln
from paddle1_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

PA_TOL = 2e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _paged(dev, w=1, h=2, d=16, ps=8, mpps=4, q_dtype=torch.float32,
           kv_dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    s_ = 3
    n_pages = s_ * mpps + 1
    q = torch.from_numpy(rng.standard_normal((s_, w, h, d)).astype(
        np.float32)).to(dev, q_dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, ps, h, d)).astype(np.float32)).to(dev, kv_dtype)
        for _ in range(2))
    table = torch.zeros(s_, mpps, dtype=torch.int32)
    table[:2] = torch.arange(1, 2 * mpps + 1, dtype=torch.int32).view(2, -1)
    pos = torch.tensor([5, mpps * ps - 1, w], dtype=torch.int32)
    return q, kp, vp, table.to(dev), pos.to(dev)


def test_layer_norm_outside_the_contract_raises_on_the_card(dev):
    x = torch.randn(4, 64, device=dev, dtype=torch.float16)
    w = torch.ones(64, device=dev, dtype=torch.float16)
    with pytest.raises(InvalidArgumentError, match="contract"):
        F.layer_norm(x, 64, w, torch.zeros_like(w))


@pytest.mark.parametrize("kw", [
    dict(q_dtype=torch.float16, kv_dtype=torch.float16),
    dict(kv_dtype=torch.float16),
    dict(w=128, h=2, d=64, ps=16),   # past one CTA's shared memory
])
def test_paged_attention_outside_the_contract_raises_on_the_card(dev, kw):
    q, kp, vp, table, pos = _paged(dev, **kw)
    with pytest.raises(InvalidArgumentError, match="contract"):
        F.paged_attention(q, kp, vp, table, pos)


def test_f32_query_over_bf16_pools_runs_the_kernel(dev):
    q, kp, vp, table, pos = _paged(dev, w=2, kv_dtype=torch.bfloat16)
    before = pa.paged_attention.launches
    got = F.paged_attention(q, kp, vp, table, pos)
    assert pa.paged_attention.launches == before + 1
    want = pa.paged_attention_ref(q, kp, vp, table, pos - 2)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= PA_TOL


def test_layer_norm_on_the_card_runs_the_kernel(dev):
    x = torch.randn(2, 3, 8, 16, device=dev)
    w, b = torch.randn(8, 16, device=dev), torch.randn(8, 16, device=dev)
    before = ln.fused_layer_norm.launches
    got = F.layer_norm(x, [8, 16], w, b)
    assert ln.fused_layer_norm.launches == before + 1
    want = torch.nn.functional.layer_norm(x, (8, 16), w, b, 1e-5)
    assert float((got - want).abs().max()) <= 1e-5
