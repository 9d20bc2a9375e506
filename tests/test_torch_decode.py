"""``nn.decode`` against the JAX package on the CPU, with a cell both
packages build: an ``Embedding``, a ``Linear`` + ``tanh`` recurrence over
a nested state ``[h, (h_prev,)]`` and a ``Linear`` output projection, the
JAX package's seeded weights carried across by ``convert.state_from_jax``
(``nn.layer_rnn`` is not ported yet).

Covered: ``BeamSearchDecoder`` (the token ids, parents, scores and final
states, beam 1 against greedy decoding, finished beams emitting the end
token, ``tile_beam_merge_with_batch`` over a nested structure),
``BasicDecoder`` with ``TrainingHelper`` and ``GreedyEmbeddingHelper``,
``dynamic_decode``'s ``max_step_num`` (the loop breaks after the step that
passes it), ``impute_finished`` and ``return_length``, and
``SampleEmbeddingHelper`` by its own contract: its draws repeat under a
seed or a generator, and follow ``softmax(logits / temperature)``. Ids
compare exactly, floats within 1e-5 (f32).
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu_torch.convert import state_from_jax

V, H, TOL = 12, 8, 1e-5


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


def _cell(pkg, bias_end=0.0):
    nn = pkg.nn

    class Cell(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(V, H)
            self.lin = nn.Linear(2 * H, H)
            self.out = nn.Linear(H, V)
            self.bias_end = bias_end

        def forward(self, x, states):
            h, (prev,) = states
            new = pkg.tanh(self.lin(pkg.concat([x, h], axis=-1)))
            return new + 0.5 * prev, [new, (h,)]

        def project(self, h):
            logits = self.out(h)
            if self.bias_end:
                logits = logits + pkg.to_tensor(
                    np.eye(V, dtype=np.float32)[1] * self.bias_end)
            return logits
    return Cell()


def _pair(seed=0, bias_end=0.0):
    jp.seed(seed)
    jc = _cell(jp, bias_end)
    with tp.utils.unique_name.guard():
        tc = _cell(tp, bias_end)
    tc.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in jc.functional_state().items()}, tc))
    return jc, tc


def _states(pkg, b=2, seed=1):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, H)).astype(np.float32)
    return [pkg.to_tensor(h), (pkg.to_tensor(h * 0.5),)]


def _np(t):
    return t.detach().cpu().numpy() if type(t) is torch.Tensor else \
        np.asarray(t.numpy())


def _same(want, got, what="out"):
    if isinstance(want, (list, tuple)):
        assert len(want) == len(got), what
        for i, (a, b) in enumerate(zip(want, got)):
            _same(a, b, f"{what}[{i}]")
        return
    a, b = _np(want), _np(got)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=what)
    else:
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=what)


def _beam(pkg, cell, beam, max_step_num=6, **kw):
    dec = pkg.nn.BeamSearchDecoder(cell, 0, 1, beam, embedding_fn=cell.emb,
                                   output_fn=cell.project)
    return pkg.nn.dynamic_decode(dec, inits=_states(pkg),
                                 max_step_num=max_step_num,
                                 return_length=True, **kw)


def test_every_decode_name_is_ported_with_the_reference_signature():
    jm = importlib.import_module("paddle1_tpu.nn.decode")
    tm = importlib.import_module("paddle1_tpu_torch.nn.decode")
    assert set(jm.__all__) <= set(tm.__all__)
    for name in jm.__all__:
        assert hasattr(tp.nn, name), name
        jo, to = getattr(jm, name), getattr(tm, name)
        fns = [(jo, to)] if not inspect.isclass(jo) else [
            (getattr(jo, m), getattr(to, m)) for m in vars(jo)
            if callable(getattr(jo, m)) and not m.startswith("__") or
            m == "__init__"]
        for jf, tf in fns:
            want = list(inspect.signature(jf).parameters)
            got = [n for n, p in inspect.signature(tf).parameters.items()
                   if p.kind != p.KEYWORD_ONLY]
            if name == "sample_logits_array":
                want[1] = "generator"   # a torch generator for the key
            assert got == want, (name, jf.__name__)


@pytest.mark.parametrize("beam,bias_end", [(3, 0.0), (3, 2.0), (4, 3.5)],
                         ids=["beam3", "beam3-ends", "beam4-ends-early"])
def test_beam_search_matches_the_reference(beam, bias_end):
    jc, tc = _pair(seed=beam, bias_end=bias_end)
    (jids, jst, jlen), (tids, tst, tlen) = _beam(jp, jc, beam), \
        _beam(tp, tc, beam)
    _same(jids, tids, "ids")
    _same(jlen, tlen, "lengths")
    _same(jst.log_probs, tst.log_probs, "log_probs")
    _same(jst.finished, tst.finished, "finished")
    _same(jst.cell_states, tst.cell_states, "cell_states")
    assert list(tids.shape)[::2] == [2, beam]


def test_finished_beams_emit_the_end_token():
    _, tc = _pair(seed=4, bias_end=3.5)
    ids, st, lens = _beam(tp, tc, 4, max_step_num=8)
    ids = _np(ids)                          # [B, T, beam]
    assert _np(st.finished).any()
    for b in range(ids.shape[0]):
        for k in range(ids.shape[2]):
            seq = ids[b, :, k]
            ends = np.flatnonzero(seq == 1)
            if len(ends):
                assert (seq[ends[0]:] == 1).all(), seq
                assert _np(lens)[b, k] == ends[0] + 1


@pytest.mark.parametrize("beam", [1, 3])
def test_beam_step_keeps_its_ranked_candidates(beam):
    """``candidates``: the step's best 2 x beam of ``beam x vocab`` in
    rank order, whose first ``beam`` are the step's choices (flat index
    ``parent * V + token``, and their scores)."""
    _, tc = _pair(seed=6, bias_end=1.0)
    seen = []

    class Recorded(tp.nn.BeamSearchDecoder):
        def _beam_search_step(self, *args):
            out, state = super()._beam_search_step(*args)
            seen.append((out, [t.clone() for t in self.candidates]))
            return out, state
    dec = Recorded(tc, 0, 1, beam, embedding_fn=tc.emb,
                   output_fn=tc.project)
    tp.nn.dynamic_decode(dec, inits=_states(tp), max_step_num=4)
    assert seen
    for out, (sc, ix) in seen:
        assert list(sc.shape) == list(ix.shape) == [2, 2 * beam]
        np.testing.assert_array_equal(
            _np(ix[:, :beam]), _np(out.parent_ids * V + out.predicted_ids))
        np.testing.assert_array_equal(_np(sc[:, :beam]), _np(out.scores))
        assert (_np(sc[:, :-1]) >= _np(sc[:, 1:])).all()


def test_beam_of_one_is_greedy_decoding():
    _, tc = _pair(seed=5, bias_end=1.0)
    ids, _, lens = _beam(tp, tc, 1, max_step_num=7)
    helper = tp.nn.GreedyEmbeddingHelper(tc.emb, np.zeros(2, np.int64), 1)
    out, _, glens = tp.nn.dynamic_decode(
        tp.nn.BasicDecoder(tc, helper, output_fn=tc.project),
        inits=_states(tp), max_step_num=7, return_length=True)
    beam_ids, greedy = _np(ids)[..., 0], _np(out.sample_ids)
    np.testing.assert_array_equal(_np(lens)[:, 0], _np(glens))
    for b, n in enumerate(_np(glens)):
        np.testing.assert_array_equal(beam_ids[b, :n], greedy[b, :n])


def test_tile_beam_merge_with_batch_matches_the_reference():
    x = np.arange(2 * 3, dtype=np.float32).reshape(2, 3)
    m = MultiCache = tp.nn.MultiHeadAttention.Cache
    nested = lambda pkg, C: [pkg.to_tensor(x), (C(pkg.to_tensor(x * 2),  # noqa: E731
                                                  pkg.to_tensor(x[:, :1])),)]
    want = jp.nn.BeamSearchDecoder.tile_beam_merge_with_batch(
        nested(jp, jp.nn.MultiHeadAttention.Cache), 3)
    got = tp.nn.BeamSearchDecoder.tile_beam_merge_with_batch(
        nested(tp, m), 3)
    _same(want, got)
    assert isinstance(got[1][0], MultiCache)
    np.testing.assert_array_equal(_np(got[0])[:3], np.repeat(x[:1], 3, 0))


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("impute", [False, True])
def test_basic_decoder_with_training_helper_matches_the_reference(
        time_major, impute):
    jc, tc = _pair(seed=6)
    seq = np.random.default_rng(2).standard_normal((2, 5, H)).astype(
        np.float32)
    if time_major:
        seq = seq.transpose(1, 0, 2).copy()
    outs = []
    for pkg, c in ((jp, jc), (tp, tc)):
        helper = pkg.nn.TrainingHelper(pkg.to_tensor(seq), [3, 5],
                                       time_major=time_major)
        outs.append(pkg.nn.dynamic_decode(
            pkg.nn.BasicDecoder(c, helper, output_fn=c.project),
            inits=_states(pkg), impute_finished=impute,
            output_time_major=time_major, return_length=True))
    (jo, js, jl), (to, ts, tl) = outs
    _same(jo.cell_outputs, to.cell_outputs, "cell_outputs")
    _same(jo.sample_ids, to.sample_ids, "sample_ids")
    _same(js, ts, "states")
    _same(jl, tl, "lengths")
    np.testing.assert_array_equal(_np(tl), [3, 5])
    if impute:
        # entry 0 finished after 3 steps: its state is the one of step 3
        _same(js[0][0:1], ts[0][0:1])


def test_greedy_embedding_helper_matches_the_reference():
    jc, tc = _pair(seed=7, bias_end=1.5)
    outs = []
    for pkg, c in ((jp, jc), (tp, tc)):
        helper = pkg.nn.GreedyEmbeddingHelper(c.emb, [0, 3], 1)
        outs.append(pkg.nn.dynamic_decode(
            pkg.nn.BasicDecoder(c, helper, output_fn=c.project),
            inits=_states(pkg), max_step_num=9, return_length=True))
    (jo, _, jl), (to, _, tl) = outs
    _same(jo.sample_ids, to.sample_ids, "sample_ids")
    _same(jo.cell_outputs, to.cell_outputs, "cell_outputs")
    _same(jl, tl, "lengths")


@pytest.mark.parametrize("max_step_num", [0, 1, 4])
def test_dynamic_decode_breaks_after_the_step_that_passes_max_step_num(
        max_step_num):
    jc, tc = _pair(seed=8)
    got = []
    for pkg, c in ((jp, jc), (tp, tc)):
        # an end token no step samples: only max_step_num stops the loop
        helper = pkg.nn.GreedyEmbeddingHelper(c.emb, [0, 3], V + 5)
        out, _, lens = pkg.nn.dynamic_decode(
            pkg.nn.BasicDecoder(c, helper, output_fn=c.project),
            inits=_states(pkg), max_step_num=max_step_num,
            return_length=True)
        got.append((_np(out.sample_ids), _np(lens)))
    (jids, jl), (tids, tl) = got
    assert tids.shape == jids.shape == (2, max_step_num + 1)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tl, jl)


def test_sample_embedding_helper_repeats_under_a_seed_and_a_generator():
    _, tc = _pair(seed=9)

    def run(**kw):
        helper = tp.nn.SampleEmbeddingHelper(tc.emb, [0, 3, 5], 1,
                                             softmax_temperature=2.0, **kw)
        out, _ = tp.nn.dynamic_decode(
            tp.nn.BasicDecoder(tc, helper, output_fn=tc.project),
            inits=_states(tp, b=3), max_step_num=6)
        return _np(out.sample_ids)
    np.testing.assert_array_equal(run(seed=11), run(seed=11))
    a = run(generator=torch.Generator().manual_seed(3))
    b = run(generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("temperature", [None, 0.5, 2.0])
def test_sample_embedding_helper_draws_from_the_tempered_softmax(
        temperature):
    logits = np.log(np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    n = 40000
    rows = tp.to_tensor(np.tile(logits, (n, 1)))
    helper = tp.nn.SampleEmbeddingHelper(lambda x: x, np.zeros(n, np.int64),
                                         1, softmax_temperature=temperature,
                                         generator=torch.Generator()
                                         .manual_seed(4))
    ids = _np(helper.sample(0, rows, None))
    t = 1.0 if temperature is None else temperature
    p = np.exp(logits / t)
    p /= p.sum()
    freq = np.bincount(ids, minlength=4) / n
    np.testing.assert_allclose(freq, p, atol=0.01)


class _GRUFixture:
    """``tests/test_decode.py``'s fixture in one package: a ``GRUCell`` whose
    weights are set from a seeded rng, an embedding and an affine output
    projection from the same rng."""

    EMB, HID, VOCAB, BATCH = 5, 6, 9, 2

    def __init__(self, pkg, seed=0):
        rng = np.random.default_rng(seed)
        e, h, v = self.EMB, self.HID, self.VOCAB
        self.pkg = pkg
        self.emb_w = rng.standard_normal((v, e)).astype(np.float32)
        self.proj_w = rng.standard_normal((h, v)).astype(np.float32) * 2.0
        self.proj_b = rng.standard_normal(v).astype(np.float32)
        with tp.utils.unique_name.guard():
            self.cell = pkg.nn.GRUCell(e, h)
        for name, shape, scale in (("weight_ih", (3 * h, e), 0.5),
                                   ("weight_hh", (3 * h, h), 0.5),
                                   ("bias_ih", (3 * h,), 0.1),
                                   ("bias_hh", (3 * h,), 0.1)):
            getattr(self.cell, name).set_value(
                rng.standard_normal(shape).astype(np.float32) * scale)
        self.h0 = rng.standard_normal((self.BATCH, h)).astype(np.float32)

    def embedding_fn(self, ids):
        return self.pkg.nn.functional.embedding(
            ids, self.pkg.to_tensor(self.emb_w))

    def output_fn(self, h):
        return self.pkg.matmul(h, self.pkg.to_tensor(self.proj_w)) + \
            self.pkg.to_tensor(self.proj_b)


@pytest.mark.parametrize("beam,end", [(3, 1), (4, 2)], ids=["beam3", "beam4"])
def test_gru_cell_drives_beam_search_as_in_the_reference(beam, end):
    out = []
    for pkg in (jp, tp):
        fx = _GRUFixture(pkg)
        dec = pkg.nn.BeamSearchDecoder(fx.cell, 0, end, beam,
                                       embedding_fn=fx.embedding_fn,
                                       output_fn=fx.output_fn)
        out.append(pkg.nn.dynamic_decode(dec, inits=pkg.to_tensor(fx.h0),
                                         max_step_num=7, return_length=True))
    (jids, jst, jlen), (tids, tst, tlen) = out
    _same(jids, tids, "ids")
    _same(jlen, tlen, "lengths")
    _same(jst.log_probs, tst.log_probs, "log_probs")
    _same(jst.finished, tst.finished, "finished")
    _same(jst.cell_states, tst.cell_states, "cell_states")
    assert list(tids.shape)[::2] == [_GRUFixture.BATCH, beam]
