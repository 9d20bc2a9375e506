"""The paged-attention kernel's split-and-merge arithmetic, on the CPU.

``ops/cuda/paged_attention.cu`` cuts each (slot, head)'s live pages into
splits of ``SPLIT_PAGES`` pages, takes a softmax per split and merges the
splits in order. ``paged_attention_split_emulation`` does the same
arithmetic in plain PyTorch; here it is held to the JAX Pallas kernel (in
interpret mode, as the JAX package's own tests run it) and to the plain
version, on seeded numpy inputs with ragged bases: parked slots, a slot
shorter than one split, a last split with one live page, a slot at full
capacity (its last split partial), page ids past the cursor that lie
outside the pool, f32 and bf16 pools, windows of 1 and 4. f32
throughout: 1e-5 abs.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle1_tpu.ops.pallas import paged_attention as jpa
from paddle1_tpu_torch.ops import paged_attention as tpa

TOL = dict(atol=1e-5, rtol=0)
# MPPS 11: splits of 4 pages, the last of 3
H, D, PS, MPPS, NP = 2, 16, 8, 11, 100


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _case(seed, w):
    """Six slots: parked (base 0, its row on page 0), shorter than one
    split, ending on a split's first page, at full capacity, with
    out-of-pool ids past its cursor, and one at a random length."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((6, w, H, D)).astype(np.float32)
    kp = rng.standard_normal((NP, PS, H, D)).astype(np.float32)
    vp = rng.standard_normal((NP, PS, H, D)).astype(np.float32)
    cap = MPPS * PS
    base = np.array([0, 3, tpa.SPLIT_PAGES * PS + 2 - w, cap - w,
                     PS + 1, int(rng.integers(0, cap - w + 1))], np.int32)
    table = np.zeros((6, MPPS), np.int32)
    free = list(rng.permutation(np.arange(1, NP)))
    for s in range(1, 6):
        n = -(-(int(base[s]) + w) // PS)
        table[s, :n] = [free.pop() for _ in range(n)]
    table[4, 2:5] = [NP + 7, -3, 10 ** 6]   # outside the pool, never read
    return q, kp, vp, table, base


def _pools(kp, vp, kv):
    if kv == "bf16":
        bf = jnp.bfloat16
        return ((jnp.asarray(kp, bf), jnp.asarray(vp, bf)),
                (_t(kp).to(torch.bfloat16), _t(vp).to(torch.bfloat16)))
    return (kp, vp), (_t(kp), _t(vp))


@pytest.mark.parametrize("kv", ["f32", "bf16"])
@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_emulation_matches_pallas_kernel_and_plain_version(seed, w,
                                                                 kv):
    q, kp, vp, table, base = _case(seed, w)
    (jk, jv), (tk, tv) = _pools(kp, vp, kv)
    got = tpa.paged_attention_split_emulation(_t(q), tk, tv, _t(table),
                                              _t(base))
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = np.asarray(jpa.paged_attention(q, jk, jv, table, base))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the plain version gathers through the table, so it needs ids inside
    # the pool; the ids past slot 4's cursor are never read
    inside = np.where((table >= 0) & (table < NP), table, 0)
    ref = tpa.paged_attention_ref(_t(q), tk, tv, _t(inside), _t(base))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("w", [1, 4])
def test_split_emulation_reads_page_0_for_an_out_of_pool_id(w):
    q, kp, vp, table, base = _case(7, w)
    bad = table.copy()
    bad[3, [0, MPPS - 1]] = [NP, -1]     # inside slot 3's live pages
    zero = np.where((bad >= 0) & (bad < NP), bad, 0)
    got = tpa.paged_attention_split_emulation(_t(q), _t(kp), _t(vp),
                                              _t(bad), _t(base))
    same = tpa.paged_attention_split_emulation(_t(q), _t(kp), _t(vp),
                                               _t(zero), _t(base))
    assert torch.equal(got, same)
    want = np.asarray(jpa.paged_attention(q, kp, vp, zero, base))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_split_emulation_gives_0_for_a_row_that_sees_no_key():
    # base + W <= 0 for slot 0, and row 0 of slot 1 (base -1, W 2) sees
    # nothing while its row 1 sees key 0: the kernel contract is 0, as
    # the Pallas kernel gives
    q, kp, vp, table, base = _case(5, 2)
    base = base.copy()
    base[:2] = [-2, -1]
    got = tpa.paged_attention_split_emulation(_t(q), _t(kp), _t(vp),
                                              _t(table), _t(base)).numpy()
    want = np.asarray(jpa.paged_attention(q, kp, vp, table, base))
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_array_equal(got[1, 0], 0.0)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("split", [1, 2, 3, 4, 5])
def test_split_emulation_agrees_at_any_split(split):
    # one split of all pages is the unsplit softmax; the merge of smaller
    # splits agrees with it to rounding, and with the JAX kernel
    q, kp, vp, table, base = _case(11, 4)
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(base))
    whole = tpa.paged_attention_split_emulation(*args, split_pages=MPPS)
    got = tpa.paged_attention_split_emulation(*args, split_pages=split)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)
    want = np.asarray(jpa.paged_attention(q, kp, vp, table, base))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_split_pages_and_shared_memory_mirror_the_cuda_source():
    src = (Path(tpa.__file__).parent / "cuda" / "paged_attention.cu"
           ).read_text()
    assert int(re.search(r"kSplitPages = (\d+);", src).group(1)) == \
        tpa.SPLIT_PAGES
    # the serving shape: 4 pages of 16 keys, D 64, f32 and bf16 pools
    keys = tpa.SPLIT_PAGES * 16
    assert tpa.smem_bytes(1, 64, 16) == 2 * keys * 64 * 4 + 4 * (
        64 + keys + 2)
    assert tpa.smem_bytes(1, 64, 16, 2) == 2 * keys * 64 * 2 + 4 * (
        64 + keys + 2)
