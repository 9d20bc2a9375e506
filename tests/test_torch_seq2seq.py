"""The attention LSTM seq2seq path against the JAX package on the CPU:
``chip_smoke.py``'s user script (``ls_model``: ``nn.LSTM`` encoder, an
``nn.RNN`` over two ``nn.LSTMCell``s with input feeding and Luong's
"general" attention through ``F.softmax``, the example's masked cross
entropy, ``Adam`` with a global-norm clip, beam search through
``nn.BeamSearchDecoder`` and ``nn.dynamic_decode(..., memory=...)``) run
by both packages at a narrow size: vocabularies 40 / 30, width 16, 2
layers, the JAX package's seeded weights carried across by
``convert.state_from_jax``.

Tolerances (f32): the forward within 1e-5, the gradients and three
clipped Adam steps within 1e-4, the greedy and beam-search (beam 3) token
ids exactly. The kernel flags ``always`` route the port's softmax and Adam
through their kernels' wrappers (the plain versions on CPU tensors).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core.flags import flags_guard

NARROW = dict(src_vocab=40, tgt_vocab=30, d=16, layers=2)
FWD_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-4
KERNELS = dict(fused_softmax="always", fused_adam="always")


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


def _pair(seed=0, dropout=0.0):
    """The narrow model in both packages, the port's carrying the JAX
    package's weights."""
    from paddle1_tpu.nn import layer_base as jlb
    from paddle1_tpu_torch.nn import layer_base as tlb
    saved = [dict(m._global_layer_name_counts) for m in (jlb, tlb)]
    jp.seed(seed)
    jm = cs.ls_model(jp, dropout=dropout, **NARROW)
    with tp.utils.unique_name.guard():
        tm = cs.ls_model(tp, dropout=dropout, **NARROW)
    for m, old in zip((jlb, tlb), saved):
        m._global_layer_name_counts.clear()
        m._global_layer_name_counts.update(old)
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    tm.load_state_dict(state_from_jax(state, tm))
    return jm, tm


def _batches(pkg, n=2, batch=4, seed=5, max_len=7):
    rng = np.random.default_rng(seed)
    return [cs.ls_batch(pkg, rng, batch, NARROW["src_vocab"],
                        NARROW["tgt_vocab"], 2, max_len) for _ in range(n)]


def _np(t):
    return t.detach().cpu().numpy() if type(t) is torch.Tensor else \
        np.asarray(t.numpy())


def test_the_full_size_model_has_the_issue_s_parameter_count():
    """At the path's widths (built on the CPU, 108 MB): 26,935,808
    parameters, in the counts of each piece."""
    with tp.utils.unique_name.guard():
        m = cs.ls_model(tp)
    cell = m.decoder.cell

    def n(*layers):
        return sum(p.nelement() for x in layers for p in x.parameters())
    assert n(m.src_embedding) == 8801792 and n(m.tgt_embedding) == 3947008
    assert n(m.encoder) == 4202496
    assert n(cell.lstm[0]) == 3149824 and n(cell.lstm[1]) == 2101248
    assert n(cell.w_a, cell.w_c) == 786432 and n(m.output) == 3947008
    assert n(m) == cs.LS_PARAMS


@pytest.mark.parametrize("flags", [{}, KERNELS], ids=["plain", "kernels"])
def test_forward_and_gradients_match_the_reference(flags):
    jm, tm = _pair()
    (jb,), (tb,) = _batches(jp, 1), _batches(tp, 1)
    jl = jm(jb["src"], jb["tgt_in"])
    with flags_guard(**flags):
        tl = tm(tb["src"], tb["tgt_in"])
    assert tuple(tl.shape) == (4, jb["tgt_steps"], NARROW["tgt_vocab"])
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=FWD_TOL, atol=FWD_TOL)
    jloss = cs.ls_loss(jp, jl, jb["label"], jb["tgt_len"])
    tloss = cs.ls_loss(tp, tl, tb["label"], tb["tgt_len"])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=FWD_TOL)
    jloss.backward()
    tloss.backward()
    jg = {n: p.grad for n, p in jm.named_parameters()}
    tg = {n: p.grad for n, p in tm.named_parameters()}
    assert sorted(jg) == sorted(tg)
    for n, g in jg.items():
        assert (g is None) == (tg[n] is None), n
        np.testing.assert_allclose(_np(tg[n]), _np(g), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=n)


def test_three_clipped_adam_steps_match_the_reference():
    jm, tm = _pair()
    losses = {}
    for pkg, m in ((jp, jm), (tp, tm)):
        opt = cs.ls_optimizer(pkg, m)
        with flags_guard(**(KERNELS if pkg is tp else {})):
            step = cs.ls_step_fn(pkg, m, opt, _batches(pkg))
            losses[pkg.__name__] = [float(step()) for _ in range(3)]
        assert step.trail == [b["tgt_steps"] for b in _batches(pkg)] + \
            [_batches(pkg)[0]["tgt_steps"]]
    np.testing.assert_allclose(losses["paddle1_tpu_torch"],
                               losses["paddle1_tpu"], rtol=STEP_TOL,
                               atol=STEP_TOL)
    tstate = {n: _np(p) for n, p in tm.named_parameters()}
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(tstate[n], _np(p), rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=n)


def test_the_loss_falls_over_cycled_batches():
    _, tm = _pair(seed=1, dropout=0.2)
    bs = _batches(tp)
    opt = cs.ls_optimizer(tp, tm, lr=1e-2)
    before = cs.ls_eval_loss(tp, tm, bs)
    step = cs.ls_step_fn(tp, tm, opt, bs)
    for _ in range(20):
        step()
    assert cs.ls_eval_loss(tp, tm, bs) < 0.8 * before


@pytest.mark.parametrize("beam", [1, 3], ids=["greedy", "beam3"])
def test_decoded_token_ids_equal_the_reference_s(beam):
    jm, tm = _pair(seed=3)
    out = {}
    for pkg, m in ((jp, jm), (tp, tm)):
        b = _batches(pkg, 1, batch=3, seed=7)[0]
        with flags_guard(**(KERNELS if pkg is tp else {})):
            ids = cs.ls_decode(pkg, m, b["src"], beam=beam, max_step_num=9)
        out[pkg.__name__] = _np(ids)
    want, got = out["paddle1_tpu"], out["paddle1_tpu_torch"]
    assert got.shape == want.shape
    assert got.shape[0] == 3 and (beam == 1 or got.shape[2] == 3)
    np.testing.assert_array_equal(got, want)


def test_beam_search_runs_to_the_limit_without_an_end_token():
    _, tm = _pair(seed=4)
    b = _batches(tp, 1, batch=2, seed=8)[0]
    ids = cs.ls_decode(tp, tm, b["src"], beam=3, max_step_num=6,
                       end_token=NARROW["tgt_vocab"])
    assert list(ids.shape) == [2, 7, 3]


def test_the_attention_hides_the_source_pads():
    """A source's pads (the end id) get no attention: changing the
    encoder's outputs at the pads leaves the logits as they were."""
    _, tm = _pair(seed=5)
    tm.eval()
    b = _batches(tp, 1, batch=3, seed=9)[0]
    src = b["src"]
    memory, states = tm.encode(src)
    values, keys, bias = memory
    pad = (src == cs.LS_EOS)[:, :, None].float()
    assert pad.sum() > 0
    cell = tm.decoder.cell
    x = tm.tgt_embedding(b["tgt_in"][:, 0])
    out1, _ = cell(x, states, memory)
    out2, _ = cell(x, states, (values + 7.0 * pad, keys, bias))
    np.testing.assert_allclose(_np(out2), _np(out1), rtol=1e-6, atol=1e-6)


def test_the_batch_is_ragged_and_its_targets_map_its_sources():
    rng = np.random.default_rng(0)
    b = cs.ls_batch(tp, rng, 64)
    src, lab = _np(b["src"]), _np(b["label"])[..., 0]
    lens = (src != cs.LS_EOS).sum(1)
    assert lens.min() >= cs.LS_MIN_LEN and lens.max() <= cs.LS_MAX_LEN
    assert src.shape[1] == lens.max() == b["src_steps"]
    assert b["tgt_steps"] == src.shape[1] + 1
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(
            lab[i, :n], (src[i, :n] * 7 + 11) % (cs.LS_TGT_VOCAB - 2) + 2)
        assert (lab[i, n:] == cs.LS_EOS).all()
    np.testing.assert_array_equal(_np(b["tgt_len"]), lens + 1)
    assert b["tokens"] == int((lens + 1).sum())


def test_row_7_is_held_alone_at_the_shapes_the_phases_build():
    """``chip_smoke.ls_sm_shapes`` takes row 7's shapes from the batches
    phases 32-33 build from their seeds (each training batch's and the
    decode batch's longest source) and adds the length limit; the card
    tests hold row 7 at the same shapes."""
    from test_torch_cuda import LS_SM_SHAPES
    train, beam = cs.ls_path_arrays()
    shapes = cs.ls_sm_shapes()
    for b in train:
        assert (cs.LS_BATCH, b["src_steps"]) in shapes
    assert (cs.LS_BEAM_BATCH * cs.LS_BEAM, beam["src_steps"]) in shapes
    assert (cs.LS_BATCH, cs.LS_MAX_LEN) in shapes
    assert (cs.LS_BEAM_BATCH * cs.LS_BEAM, cs.LS_MAX_LEN) in shapes
    assert shapes == LS_SM_SHAPES
    b = cs.ls_tensors(tp, beam)
    assert list(b["src"].shape) == [cs.LS_BEAM_BATCH, beam["src_steps"]]
