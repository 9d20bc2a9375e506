"""Kernel modules of the PyTorch port against the JAX package, on the CPU.

Each port kernel module holds a hand-written CUDA kernel and its plain
PyTorch version; on the CPU the wrappers run the plain version (CUDA
kernels are checked on the card by ``chip_smoke.py``). The JAX side
runs its Pallas kernels in interpret mode, as its own tests do.
Inputs come from numpy with a seed; everything is float32.
"""

import os

import numpy as np
import pytest
import torch

from paddle1_tpu.core.flags import flags_guard as jax_flags_guard
from paddle1_tpu.nn import functional as jF
from paddle1_tpu.ops.pallas import layer_norm as jln
from paddle1_tpu.ops.pallas import paged_attention as jpa
from paddle1_tpu_torch.core import flags as tflags
from paddle1_tpu_torch.core.errors import (InvalidArgumentError,
                                           KernelBuildError)
from paddle1_tpu_torch.nn import functional as tF
from paddle1_tpu_torch.ops import layer_norm as tln
from paddle1_tpu_torch.ops import paged_attention as tpa
from paddle1_tpu_torch.ops.cuda import build

LN_TOL = dict(atol=1e-5, rtol=1e-5)
PA_TOL = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# LayerNorm


@pytest.mark.parametrize("rows,h", [(16, 128), (64, 256), (8, 512),
                                    (24, 384)])
def test_layer_norm_ref_matches_pallas_kernel(rows, h):
    rng = np.random.default_rng(rows * 1000 + h)
    x = (rng.standard_normal((rows, h)) * 3 + 0.5).astype(np.float32)
    w = rng.standard_normal(h).astype(np.float32)
    b = rng.standard_normal(h).astype(np.float32)
    want = np.asarray(jln.fused_layer_norm(x, w, b, 1e-5))
    got = tln.layer_norm_ref(_t(x), _t(w), _t(b), 1e-5).numpy()
    np.testing.assert_allclose(got, want, **LN_TOL)


def test_layer_norm_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((2, 5, 96)).astype(np.float32))
    w = _t(rng.standard_normal(96).astype(np.float32))
    b = _t(rng.standard_normal(96).astype(np.float32))
    before = tln.fused_layer_norm.launches
    got = tln.fused_layer_norm(x, w, b)
    assert tln.fused_layer_norm.launches == before  # no kernel on CPU
    np.testing.assert_array_equal(got.numpy(),
                                  tln.layer_norm_ref(x, w, b).numpy())


@pytest.mark.parametrize("mode", ["auto", "always", "never"])
def test_functional_layer_norm_matches_jax(mode):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 8, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    want = np.asarray(jF.layer_norm(x, 128, w, b).numpy())
    with tflags.flags_guard(fused_layer_norm=mode):
        got = tF.layer_norm(_t(x), 128, _t(w), _t(b)).numpy()
    np.testing.assert_allclose(got, want, **LN_TOL)


def test_layer_norm_gate_is_rederived_for_the_gpu():
    # any width works on the GPU (the TPU needed H % 128 == 0)
    assert tln.supported((16, 512))
    assert tln.supported((7, 100))
    assert tln.supported((2, 3, 33), torch.bfloat16)
    assert not tln.supported((512,))
    assert not tln.supported((16, 512), torch.float64)


# ---------------------------------------------------------------------------
# paged attention


def _paged_case(seed, S=4, W=1, H=2, D=16, NP=12, ps=8, mpps=3):
    """Pools, a table whose rows include parked (page 0) entries past
    each slot's chain and one fully parked slot, and per-slot bases."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, W, H, D)).astype(np.float32)
    kp = rng.standard_normal((NP, ps, H, D)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, H, D)).astype(np.float32)
    table = np.zeros((S, mpps), np.int32)
    base = np.zeros(S, np.int32)
    free = list(rng.permutation(np.arange(1, NP)))
    for s in range(S - 1):
        live = int(rng.integers(1, mpps * ps - W + 1))
        base[s] = live - 1
        n = -(-(base[s] + W) // ps)
        table[s, :n] = [free.pop() for _ in range(n)]
    # slot S-1 is parked: whole row on page 0, cursor 0
    return q, kp, vp, table, base


@pytest.mark.parametrize("seed,w", [(0, 1), (1, 1), (2, 4), (3, 2)])
def test_paged_attention_ref_matches_pallas_and_jax_ref(seed, w):
    q, kp, vp, table, base = _paged_case(seed, W=w)
    assert jpa.supported(q.shape, kp.shape)
    want_kernel = np.asarray(jpa.paged_attention(q, kp, vp, table, base))
    want_ref = np.asarray(jpa.paged_attention_ref(q, kp, vp, table, base))
    got = tpa.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table),
                                  _t(base)).numpy()
    np.testing.assert_allclose(got, want_ref, **PA_TOL)
    # the Pallas kernel agrees with both refs on every live slot (a
    # parked slot still sees key 0, so every row here is live)
    np.testing.assert_allclose(got, want_kernel, **PA_TOL)


def test_paged_attention_row_with_no_visible_key():
    # base + W <= 0: the kernel contract is 0; the JAX Pallas kernel
    # agrees, the plain versions average uniformly (never read live)
    q, kp, vp, table, base = _paged_case(5, S=2, W=1)
    base = np.array([-1, 3], np.int32)
    want = np.asarray(jpa.paged_attention(q, kp, vp, table, base))
    np.testing.assert_array_equal(want[0], 0.0)
    got = tpa.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table),
                                  _t(base)).numpy()
    np.testing.assert_allclose(got[1], want[1], **PA_TOL)


@pytest.mark.parametrize("mode", ["auto", "always", "never"])
def test_functional_paged_attention_matches_jax(mode):
    q, kp, vp, table, base = _paged_case(7, W=2)
    pos = base + q.shape[1]
    with jax_flags_guard(pallas_paged_attention="always"):
        want = np.asarray(jF.paged_attention(q, kp, vp, table, pos).numpy())
    with tflags.flags_guard(pallas_paged_attention=mode):
        got = tF.paged_attention(_t(q), _t(kp), _t(vp), _t(table),
                                 _t(pos)).numpy()
    np.testing.assert_allclose(got, want, **PA_TOL)


def test_paged_attention_wrapper_runs_plain_version_on_cpu():
    q, kp, vp, table, base = _paged_case(9, W=3)
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(base))
    assert tpa.paged_attention.launches == before
    np.testing.assert_array_equal(
        got.numpy(), tpa.paged_attention_ref(_t(q), _t(kp), _t(vp),
                                             _t(table), _t(base)).numpy())


def test_paged_attention_gate_is_the_shared_memory_budget():
    # serving shapes, odd page sizes and widths the TPU tiling refused
    assert tpa.supported((16, 1, 8, 64), (513, 16, 8, 64))
    assert tpa.supported((4, 4, 2, 12), (9, 5, 2, 12))
    assert tpa.supported((2, 80, 2, 64), (9, 16, 2, 64))
    # one split of 4 pages: K and V [64, 64] f32, q [1, 64], scores
    # [1, 64], m and l
    assert tpa.smem_bytes(1, 64, 16) == 2 * 64 * 64 * 4 + 4 * (64 + 64 + 2)
    # every shape the first design's budget took (4 warps, each with a K
    # and a V page of D + 1 f32 columns, scores, an accumulator, m and l)
    # still fits
    for w in (1, 4, 16, 64, 80, 127):
        for d in (8, 12, 64, 128, 256):
            for ps in (5, 8, 16, 64, 256):
                old = 4 * (w * d + 4 * (2 * ps * (d + 1) + w * ps + w * d
                                        + 2 * w))
                if old <= 232448:
                    assert tpa.supported((2, w, 2, d), (9, ps, 2, d))
    # too much shared memory for one CTA
    assert not tpa.supported((1, 64, 1, 256), (4, 256, 1, 256))
    assert not tpa.supported((16, 1, 8, 64), (513, 16, 4, 64))  # heads
    assert not tpa.supported((16, 1, 8, 64), (513, 16, 8, 64),
                             torch.float16)


def test_functional_layer_norm_over_trailing_axes_matches_jax():
    # two normalized axes are flattened into the one the kernel reduces
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 4, 8, 16)).astype(np.float32)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal((8, 16)).astype(np.float32)
    want = np.asarray(jF.layer_norm(x, [8, 16], w, b).numpy())
    got = tF.layer_norm(_t(x), [8, 16], _t(w), _t(b)).numpy()
    np.testing.assert_allclose(got, want, **LN_TOL)
    with pytest.raises(InvalidArgumentError, match="trailing shape"):
        tF.layer_norm(_t(x), [4, 16], _t(w), _t(b))


def test_paged_attention_f32_query_over_bf16_pools_matches_pallas():
    # a bf16 KV cache under an f32 model: q, K and V each read as f32
    import jax.numpy as jnp
    q, kp, vp, table, base = _paged_case(17, W=2)
    want = np.asarray(jpa.paged_attention(
        q, jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16),
        table, base))
    assert want.dtype == np.float32
    got = tpa.paged_attention_ref(_t(q), _t(kp).to(torch.bfloat16),
                                  _t(vp).to(torch.bfloat16), _t(table),
                                  _t(base))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **PA_TOL)
    assert tpa.supported(q.shape, kp.shape, torch.float32, torch.bfloat16)
    assert not tpa.supported(q.shape, kp.shape, torch.float32,
                             torch.float16)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _route_layer_norm(dtype):
    x, w, b = _meta((4, 512), dtype), _meta(512, dtype), _meta(512, dtype)
    with tflags.flags_guard(fused_layer_norm="always"):
        tF.layer_norm(x, 512, w, b)


def _route_paged(q_shape, kp_shape, dtype=torch.float32, kv_dtype=None):
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    q = _meta(q_shape, dtype)
    kp, vp = _meta(kp_shape, kv_dtype), _meta(kp_shape, kv_dtype)
    table = _meta((q_shape[0], 4), torch.int32)
    pos = _meta(q_shape[0], torch.int32)
    with tflags.flags_guard(pallas_paged_attention="always"):
        tF.paged_attention(q, kp, vp, table, pos)


@pytest.mark.parametrize("case,route,match", [
    ("layer_norm f16", lambda: _route_layer_norm(torch.float16),
     "contract"),
    ("paged f16", lambda: _route_paged((2, 1, 2, 16), (9, 8, 2, 16),
                                       torch.float16), "contract"),
    ("paged f16 pools", lambda: _route_paged((2, 1, 2, 16), (9, 8, 2, 16),
                                             torch.float32, torch.float16),
     "contract"),
    ("paged window past smem", lambda: _route_paged((2, 600, 8, 64),
                                                    (9, 16, 8, 64)),
     "contract"),
    ("paged heads", lambda: _route_paged((2, 1, 8, 64), (9, 16, 4, 64)),
     "contract"),
    # inside the contract, but no CUDA tensor: still no plain version
    ("layer_norm meta", lambda: _route_layer_norm(torch.float32),
     "unsupported device"),
    ("paged meta", lambda: _route_paged((2, 1, 2, 16), (9, 8, 2, 16),
                                        torch.float32, torch.bfloat16),
     "unsupported device"),
])
def test_kernel_route_raises_instead_of_running_the_plain_version(
        case, route, match):
    # with the flag active on a non-CPU tensor the functionals always go
    # through the kernel's wrapper, which raises on inputs outside its
    # contract; the plain version is never a silent substitute
    with pytest.raises(InvalidArgumentError, match=match):
        route()


# ---------------------------------------------------------------------------
# flags and the kernel builder


def test_flag_active_resolves_against_the_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    with tflags.flags_guard(fused_layer_norm="auto"):
        assert not tflags.flag_active("fused_layer_norm", cpu)
        assert tflags.flag_active("fused_layer_norm", cuda)
    with tflags.flags_guard(fused_layer_norm="always"):
        assert tflags.flag_active("fused_layer_norm", cpu)
    with tflags.flags_guard(fused_layer_norm="never"):
        assert not tflags.flag_active("fused_layer_norm", cuda)
    with pytest.raises(InvalidArgumentError):
        tflags.set_flags({"fused_layer_norm": "sometimes"})
    with pytest.raises(InvalidArgumentError):
        tflags.flag("serve_gen_spec_tokens")  # not part of this slice


def test_flag_env_override(monkeypatch):
    monkeypatch.setenv("FLAGS_p1t_test_flag", "7")
    tflags.define_flag("p1t_test_flag", 3)
    try:
        assert tflags.flag("p1t_test_flag") == 7
    finally:
        tflags._registry.pop("p1t_test_flag")


def test_serving_flags_keep_the_jax_names_and_defaults():
    from paddle1_tpu.core import flags as jflags
    for name in ("serve_gen_slots", "serve_gen_max_seq",
                 "serve_gen_prefill_buckets", "serve_gen_token_budget",
                 "serve_gen_stream_buffer", "serve_gen_paged",
                 "serve_gen_kv_page_size", "serve_gen_kv_pages",
                 "serve_gen_prefix_cache", "serve_queue_depth",
                 "serve_deadline_ms", "pallas_paged_attention",
                 "fused_layer_norm"):
        assert tflags._registry[name].default == \
            jflags._registry[name].default, name


def test_kernel_sources_and_build_flags():
    for name in build.SOURCES:
        src = os.path.join(os.path.dirname(build.__file__), f"{name}.cu")
        text = open(src).read()
        assert 'extern "C"' in text
        assert "paddle1_tpu/ops/pallas/" in text  # names what it replaces
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    assert build.build_dir().name == "_build"


def test_missing_nvcc_is_a_typed_build_error(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_target",
                        lambda name: tmp_path / f"lib{name}-absent.so")
    with pytest.raises(KernelBuildError, match="nvcc not found"):
        build.build_all()


# ---------------------------------------------------------------------------
# training kernels (flash forward/backward, fused Adam): gates and routes


def test_flash_gate_keeps_the_semantic_gates_and_drops_vmem():
    from paddle1_tpu_torch.ops import flash_attention as tfa
    assert tfa.supported((128, 128, 12, 64), (128, 128, 12, 64))
    assert tfa.supported((2, 128, 2, 256), (2, 384, 2, 256), causal=True)
    # the TPU's VMEM gate refused K+V rows past 8 MiB; one CTA holds one
    # key tile here whatever N
    assert tfa.supported((1, 16384, 1, 64), (1, 16384, 1, 64))
    assert not tfa.supported((2, 256, 2, 64), (2, 128, 2, 64), causal=True)
    assert not tfa.supported((2, 120, 2, 64), (2, 128, 2, 64))  # ragged
    assert not tfa.supported((2, 128, 2, 60), (2, 128, 2, 60))  # d % 8
    assert not tfa.supported((2, 128, 2, 264), (2, 128, 2, 264))
    assert not tfa.supported((2, 128, 64), (2, 128, 64))


def _route_flash(dtype=torch.float32, shape=(2, 128, 2, 32), mask=True):
    q, k, v = (_meta(shape, dtype) for _ in range(3))
    pm = _meta((shape[0], shape[1]), torch.bool) if mask else None
    from paddle1_tpu_torch.ops import flash_attention as tfa
    tfa.flash_fwd(q, k, v, 0.125, False, pm)


def _route_flash_bwd(which):
    from paddle1_tpu_torch.ops import flash_attention_bwd as tfb
    q, k, v, do = (_meta((2, 128, 2, 32)) for _ in range(4))
    lse, delta = _meta((2, 2, 128)), _meta((2, 2, 128))
    getattr(tfb, which)(q, k, v, do, lse, delta, 0.125)


def _route_adam(dtype=torch.float32):
    from paddle1_tpu_torch.ops import fused_adam as tad
    p, g = _meta(10, dtype), _meta(10, dtype)
    m1, m2 = _meta(10), _meta(10)
    tad.fused_adam_([p], [g], [m1], [m2], _meta(3), [0.0], 0.9, 0.999, 1e-8)


@pytest.mark.parametrize("case,route,match", [
    ("flash f16", lambda: _route_flash(torch.float16), "contract"),
    ("flash ragged", lambda: _route_flash(shape=(2, 100, 2, 32)),
     "contract"),
    ("flash meta", lambda: _route_flash(), "unsupported device"),
    ("flash no mask meta", lambda: _route_flash(mask=False),
     "unsupported device"),
    ("dkv meta", lambda: _route_flash_bwd("flash_bwd_dkv"),
     "unsupported device"),
    ("dq meta", lambda: _route_flash_bwd("flash_bwd_dq"),
     "unsupported device"),
    ("adam f16", lambda: _route_adam(torch.float16), "contract"),
    ("adam meta", lambda: _route_adam(), "unsupported device"),
])
def test_training_kernel_routes_raise_instead_of_the_plain_version(
        case, route, match):
    with pytest.raises(InvalidArgumentError, match=match):
        route()


def test_flash_and_adam_wrappers_count_no_launch_on_cpu():
    from paddle1_tpu_torch.ops import flash_attention as tfa
    from paddle1_tpu_torch.ops import flash_attention_bwd as tfb
    from paddle1_tpu_torch.ops import fused_adam as tad
    rng = np.random.default_rng(1)
    q, k, v, do = (_t(rng.standard_normal((1, 128, 2, 16)).astype(
        np.float32)) for _ in range(4))
    before = (tfa.flash_fwd.launches, tfb.flash_bwd_dkv.launches,
              tfb.flash_bwd_dq.launches, tad.fused_adam_.launches)
    out, lse = tfa.flash_fwd(q, k, v, 0.25)
    tfb.flash_attention_bwd(q, k, v, out, lse, do, 0.25)
    tad.fused_adam_([q], [k], [torch.zeros_like(q)], [torch.zeros_like(q)],
                    torch.tensor([1e-3, 0.1, 0.001]), [0.0], 0.9, 0.999,
                    1e-8)
    assert (tfa.flash_fwd.launches, tfb.flash_bwd_dkv.launches,
            tfb.flash_bwd_dq.launches, tad.fused_adam_.launches) == before


# ---------------------------------------------------------------------------
# row softmax (the eager slice's kernel)

SM_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("rows,h", [(16, 128), (8, 256)])
def test_softmax_ref_and_function_match_pallas_kernel(rows, h):
    import jax
    from paddle1_tpu.ops.pallas import softmax as jsm
    from paddle1_tpu_torch.ops import softmax as tsm
    rng = np.random.default_rng(rows + h)
    x = (rng.standard_normal((rows, h)) * 4).astype(np.float32)
    dy = rng.standard_normal((rows, h)).astype(np.float32)
    assert jsm.supported((rows, h), -1)
    with jax_flags_guard({"fused_softmax": "always"}):
        want, vjp = jax.vjp(jsm.fused_softmax, x)
        want_dx, = vjp(dy)
        grad = jax.grad(lambda a: (jsm.fused_softmax(a) * dy).sum())(x)
    np.testing.assert_allclose(np.asarray(want_dx), np.asarray(grad),
                               **SM_TOL)
    np.testing.assert_allclose(tsm.softmax_ref(_t(x)).numpy(),
                               np.asarray(want), **SM_TOL)
    xt = _t(x).requires_grad_(True)
    y = tsm.fused_softmax(xt)
    y.backward(_t(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               **SM_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad), **SM_TOL)
    p = tsm.softmax_ref(_t(x))
    np.testing.assert_allclose(tsm.softmax_bwd_ref(p, _t(dy)).numpy(),
                               np.asarray(want_dx), **SM_TOL)


def test_softmax_wrapper_runs_plain_version_on_cpu():
    from paddle1_tpu_torch.ops import softmax as tsm
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((3, 5, 1003)).astype(np.float32))
    before = tsm.fused_softmax.launches
    got = tsm.fused_softmax(x)
    assert tsm.fused_softmax.launches == before   # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), tsm.softmax_ref(x).numpy())
    xb = x.to(torch.bfloat16)
    assert tsm.softmax_fwd(xb).dtype == torch.bfloat16
    # an all -inf row is NaN, a row with a -inf entry puts 0 there
    row = torch.tensor([[-float("inf")] * 3, [-float("inf"), 0.0, 0.0]])
    y = tsm.softmax_ref(row)
    assert torch.isnan(y[0]).all()
    assert y[1].tolist() == [0.0, 0.5, 0.5]


def test_softmax_gate_keeps_the_semantic_gates_and_drops_the_layout():
    from paddle1_tpu.ops.pallas import softmax as jsm
    from paddle1_tpu_torch.ops import softmax as tsm
    # the TPU refused h % 128 and row counts off its block ladder
    for shape in ((64, 10), (32, 1000), (1000, 1003), (2048, 32000),
                  (2, 3, 30522), (196608, 128)):
        assert tsm.supported(shape, -1)
        assert tsm.supported(shape, len(shape) - 1)
    assert not jsm.supported((64, 10), -1)
    for shape, axis in (((10,), -1), ((4, 8), 0), ((0, 8), -1),
                        ((4, 0), -1), ((2, 4, 8), 1)):
        assert not tsm.supported(shape, axis)
        assert not jsm.supported(shape, axis)
    # the gate is on shape and axis alone, as the JAX package's: the
    # wrapper, not the gate, refuses a dtype the kernel lacks
    assert set(tsm._DTYPES) == {torch.float32, torch.bfloat16,
                                torch.float16}
    assert not tsm.supported((2 ** 31, 8), -1)


def _route_softmax(dtype=torch.float32, shape=(4, 8)):
    from paddle1_tpu_torch.ops import softmax as tsm
    tsm.fused_softmax(_meta(shape, dtype))


@pytest.mark.parametrize("case,route,match", [
    # f16 is a kernel dtype: only the meta device is refused
    ("softmax f16", lambda: _route_softmax(torch.float16),
     "unsupported device"),
    ("softmax f64", lambda: _route_softmax(torch.float64), "contract"),
    ("softmax 1-d", lambda: _route_softmax(shape=(8,)), "contract"),
    ("softmax meta", lambda: _route_softmax(), "unsupported device"),
])
def test_softmax_kernel_route_raises_instead_of_the_plain_version(
        case, route, match):
    with pytest.raises(InvalidArgumentError, match=match):
        route()


def test_softmax_flag_keeps_the_jax_name_and_defaults_to_the_card():
    from paddle1_tpu.core import flags as jflags
    assert tflags.flag("fused_softmax") == "auto" == \
        jflags._registry["fused_softmax"].default
    assert tflags.flag_active("fused_softmax", torch.device("cuda", 0))
    assert not tflags.flag_active("fused_softmax", torch.device("cpu"))
    assert "softmax" in build.SOURCES
