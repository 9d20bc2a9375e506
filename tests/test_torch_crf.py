"""``nn/functional/crf.py`` against the JAX package on the CPU:
``linear_chain_crf``'s log-likelihood and its gradients (emissions and
transitions), ``crf_decoding``'s Viterbi paths and label marks, on ragged
lengths and on tied scores (ties go to the lowest tag in both packages,
as ``jnp.argmax`` breaks them), and a narrow BiGRU-CRF tagger (embedding
16, hidden 16, two ``BiRNN(GRUCell)`` layers, 7 tags) whose loss,
gradients and Viterbi paths equal the JAX package's with its weights
carried across; and ``crf_cases`` of ``tests/test_torch_nn_cases.py``
(phase 28's on the card) through both packages. Floats within 1e-5
(gradients 1e-4), paths exactly.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu_torch.convert import state_from_jax

from test_torch_nn_cases import crf_cases
from test_torch_op_cases import ids
from test_torch_op_parity import run

TOL, GRAD_TOL = 1e-5, 1e-4
B, T, N = 4, 6, 5
LENGTHS = np.array([6, 3, 1, 4], np.int64)


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


def _np(t):
    return t.detach().cpu().numpy() if type(t) is torch.Tensor else \
        np.asarray(t.numpy())


def _inputs(seed=0, tied=False):
    rng = np.random.default_rng(seed)
    if tied:
        # few distinct values: many candidates tie in every max
        e = rng.integers(0, 2, (B, T, N)).astype(np.float32)
        w = rng.integers(-1, 1, (N + 2, N)).astype(np.float32)
    else:
        e = rng.standard_normal((B, T, N)).astype(np.float32)
        w = rng.standard_normal((N + 2, N)).astype(np.float32)
    y = rng.integers(0, N, (B, T)).astype(np.int64)
    return e, w, y


@pytest.mark.parametrize("lengths", [None, LENGTHS], ids=["full", "ragged"])
def test_log_likelihood_and_gradients_match_the_reference(lengths):
    e, w, y = _inputs()
    res = []
    for pkg in (jp, tp):
        et, wt = pkg.to_tensor(e), pkg.to_tensor(w)
        et.stop_gradient = wt.stop_gradient = False
        ll = pkg.nn.functional.linear_chain_crf(
            et, wt, pkg.to_tensor(y),
            None if lengths is None else pkg.to_tensor(lengths))
        (ll * pkg.to_tensor(np.arange(1, B + 1, dtype=np.float32)[:, None])
         ).sum().backward()
        res.append((_np(ll), _np(et.grad), _np(wt.grad)))
    (jl, je, jw), (tl, te, tw) = res
    assert tl.shape == (B, 1)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(te, je, rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tw, jw, rtol=GRAD_TOL, atol=GRAD_TOL)
    assert (tl <= 0).all()
    if lengths is not None:
        # padding steps carry no gradient
        pad = np.arange(T)[None, :] >= lengths[:, None]
        assert not te[pad].any()


CASES = crf_cases()


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_crf_case_matches_the_reference(case):
    """``tests/test_torch_nn_cases.py``'s CRF cases (which ``chip_smoke.py``
    phase 28 runs on the card) through both packages."""
    run(case, jp.nn.functional, tp.nn.functional)


def test_log_likelihood_is_a_normalised_distribution():
    """Over every path of a short sequence, p(path) sums to 1."""
    import itertools
    e, w, _ = _inputs(1)
    e, n_steps = e[:1, :3, :3], 3
    w = w[:5, :3]
    paths = np.array(list(itertools.product(range(3), repeat=n_steps)))
    ll = tp.nn.functional.linear_chain_crf(
        tp.to_tensor(np.repeat(e, len(paths), 0)), tp.to_tensor(w),
        tp.to_tensor(paths))
    np.testing.assert_allclose(np.exp(_np(ll)).sum(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("lengths", [None, LENGTHS], ids=["full", "ragged"])
def test_viterbi_paths_match_the_reference(lengths, tied):
    e, w, y = _inputs(2, tied)
    outs = []
    for pkg in (jp, tp):
        F = pkg.nn.functional
        ln = None if lengths is None else pkg.to_tensor(lengths)
        path = F.crf_decoding(pkg.to_tensor(e), pkg.to_tensor(w), None, ln)
        marks = F.crf_decoding(pkg.to_tensor(e), pkg.to_tensor(w),
                               pkg.to_tensor(y), ln)
        outs.append((_np(path), _np(marks)))
    (jpath, jm), (tpath, tm) = outs
    assert tpath.dtype == np.int32 and tm.dtype == np.int32
    np.testing.assert_array_equal(tpath, jpath)
    np.testing.assert_array_equal(tm, jm)
    if lengths is not None:
        pad = np.arange(T)[None, :] >= lengths[:, None]
        assert not tpath[pad].any() and not tm[pad].any()


def test_viterbi_ties_go_to_the_lowest_tag():
    """All-equal scores: every candidate ties, and both packages pick tag
    0 at every step; a tie between tags 2 and 3 above the rest picks 2."""
    e = np.zeros((1, 3, 4), np.float32)
    w = np.zeros((6, 4), np.float32)
    for pkg in (jp, tp):
        path = pkg.nn.functional.crf_decoding(pkg.to_tensor(e),
                                              pkg.to_tensor(w))
        np.testing.assert_array_equal(_np(path), [[0, 0, 0]])
        e2 = e.copy()
        e2[0, :, 2:] = 1.0
        path = pkg.nn.functional.crf_decoding(pkg.to_tensor(e2),
                                              pkg.to_tensor(w))
        np.testing.assert_array_equal(_np(path), [[2, 2, 2]])


def test_viterbi_path_scores_highest():
    """The decoded path's likelihood is the largest over every path."""
    import itertools
    e, w, _ = _inputs(3)
    e, w = e[:1, :4, :3], w[:5, :3]
    paths = np.array(list(itertools.product(range(3), repeat=4)))
    ll = _np(tp.nn.functional.linear_chain_crf(
        tp.to_tensor(np.repeat(e, len(paths), 0)), tp.to_tensor(w),
        tp.to_tensor(paths)))[:, 0]
    best = _np(tp.nn.functional.crf_decoding(tp.to_tensor(e),
                                             tp.to_tensor(w)))[0]
    assert ll[(paths == best).all(1)][0] == ll.max()


# the narrow BiGRU-CRF tagger: embedding 16, hidden 16, two BiRNN(GRUCell)
# layers, 7 tags
VOCAB, EMB, HID, TAGS = 20, 16, 16, 7


def _tagger(pkg):
    nn = pkg.nn

    class Tagger(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(VOCAB, EMB)
            self.rnn1 = nn.BiRNN(nn.GRUCell(EMB, HID), nn.GRUCell(EMB, HID))
            self.rnn2 = nn.BiRNN(nn.GRUCell(2 * HID, HID),
                                 nn.GRUCell(2 * HID, HID))
            self.out = nn.Linear(2 * HID, TAGS)
            self.transition = self.create_parameter(
                [TAGS + 2, TAGS],
                default_initializer=nn.initializer.Uniform(-0.1, 0.1))

        def forward(self, ids):
            h, _ = self.rnn1(self.emb(ids))
            h, _ = self.rnn2(h)
            return self.out(h)
    return Tagger()


def test_bigru_crf_tagger_matches_the_reference():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, VOCAB, (B, T)).astype(np.int64)
    tags = rng.integers(0, TAGS, (B, T)).astype(np.int64)
    jp.seed(5)
    jm = _tagger(jp)
    with tp.utils.unique_name.guard():
        tm = _tagger(tp)
    tm.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in jm.functional_state().items()}, tm))
    res = []
    for pkg, m in ((jp, jm), (tp, tm)):
        F = pkg.nn.functional
        em = m(pkg.to_tensor(ids))
        ll = F.linear_chain_crf(em, m.transition, pkg.to_tensor(tags),
                                pkg.to_tensor(LENGTHS))
        loss = -ll.mean()
        loss.backward()
        path = F.crf_decoding(em, m.transition, None,
                              pkg.to_tensor(LENGTHS))
        grads = {n: _np(p.grad) for n, p in m.named_parameters()}
        res.append((float(_np(loss)), grads, _np(path)))
    (jl, jg, jpath), (tl, tg, tpath) = res
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert sorted(jg) == sorted(tg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=n)
    np.testing.assert_array_equal(tpath, jpath)


def _positional(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()
            if p.kind != p.KEYWORD_ONLY]


def test_crf_names_are_ported_with_the_reference_signature():
    jm = importlib.import_module("paddle1_tpu.nn.functional.crf")
    tm = importlib.import_module("paddle1_tpu_torch.nn.functional.crf")
    assert set(jm.__all__) <= set(tm.__all__)
    for name in jm.__all__:
        assert getattr(tp.nn.functional, name) is getattr(tm, name)
        assert _positional(getattr(tm, name)) == \
            _positional(getattr(jm, name))
