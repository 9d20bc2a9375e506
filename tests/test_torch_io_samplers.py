"""The port's samplers against the JAX package's (``paddle1_tpu.io``).

Every sampler draws its epoch seed from its own package's generator, so
each check forces the same seed on both through ``set_state_dict({"seed":
s})`` and holds the index orders and the ``state_dict`` forms equal.
``DistributedBatchSampler`` is a pure function of (epoch, rank, world):
strided and elastic layouts, ``rank="all"`` and the resize checks. A
DataLoader state written by one package restores the other's loader to
the same remaining indices.
"""

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.core import errors as jerr
from paddle1_tpu_torch.core import errors as terr


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tp.device_guard("cpu"):
        yield


class Idx:
    """A map-style dataset whose sample ``i`` is ``[i]`` (int64)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.array([i], np.int64)


def _pair(name):
    return getattr(jp.io, name), getattr(tp.io, name)


def _seeded_order(sampler, seed):
    sampler.set_state_dict({"seed": seed})
    order = list(sampler)
    return order, sampler.state_dict()


@pytest.mark.parametrize("kw", [
    {}, {"replacement": True}, {"num_samples": 7},
    {"replacement": True, "num_samples": 40}],
    ids=["permutation", "replacement", "num_samples", "replacement_40"])
@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 1])
def test_random_sampler_order_and_state_match(kw, seed):
    J, T = _pair("RandomSampler")
    jo, js = _seeded_order(J(Idx(23), **kw), seed)
    to, ts = _seeded_order(T(Idx(23), **kw), seed)
    assert to == jo and ts == js == {"seed": seed}
    assert len(T(Idx(23), **kw)) == len(J(Idx(23), **kw))


@pytest.mark.parametrize("replacement", [True, False])
def test_weighted_random_sampler_order_and_state_match(replacement):
    J, T = _pair("WeightedRandomSampler")
    w = np.random.default_rng(3).random(17) + 0.1
    jo, js = _seeded_order(J(w, 9, replacement), 77)
    to, ts = _seeded_order(T(w, 9, replacement), 77)
    assert to == jo and ts == js


def test_sequence_sampler_matches():
    J, T = _pair("SequenceSampler")
    assert list(T(Idx(5))) == list(J(Idx(5))) == list(range(5))
    assert T(Idx(5)).state_dict() == J(Idx(5)).state_dict() == {}


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_sampler_order_and_state_match(shuffle, drop_last):
    J, T = _pair("BatchSampler")
    js = J(dataset=Idx(22), shuffle=shuffle, batch_size=4,
           drop_last=drop_last)
    ts = T(dataset=Idx(22), shuffle=shuffle, batch_size=4,
           drop_last=drop_last)
    st = {"sampler": {"seed": 99}} if shuffle else {"sampler": {}}
    js.set_state_dict(st)
    ts.set_state_dict(st)
    assert list(ts) == list(js)
    assert ts.state_dict() == js.state_dict()
    assert len(ts) == len(js) == (5 if drop_last else 6)


def test_batch_sampler_over_a_sampler_and_its_errors():
    J, T = _pair("BatchSampler")
    assert list(T(sampler=tp.io.SequenceSampler(Idx(5)), batch_size=2)) == \
        list(J(sampler=jp.io.SequenceSampler(Idx(5)), batch_size=2))
    with pytest.raises(terr.InvalidArgumentError):
        T(batch_size=2)
    with pytest.raises(jerr.InvalidArgumentError):
        J(batch_size=2)


def _dist(pk, n=21, **kw):
    return pk.io.DistributedBatchSampler(Idx(n), **kw)


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, num_replicas=2, rank=0),
    dict(batch_size=3, num_replicas=2, rank=1, drop_last=True),
    dict(batch_size=2, num_replicas=4, rank=3, shuffle=True),
    dict(batch_size=3, num_replicas=2, rank=0, elastic=True),
    dict(batch_size=3, num_replicas=2, rank=1, elastic=True, shuffle=True),
    dict(batch_size=2, num_replicas=3, rank=2, elastic=True, drop_last=True),
    dict(batch_size=3, num_replicas=2, rank="all", elastic=True,
         shuffle=True),
], ids=["strided_r0", "strided_r1_drop", "strided_shuffle", "elastic_r0",
        "elastic_r1_shuffle", "elastic_drop", "elastic_all"])
@pytest.mark.parametrize("epoch", [0, 3])
def test_distributed_batch_sampler_matches(kw, epoch):
    js, ts = _dist(jp, **kw), _dist(tp, **kw)
    js.set_epoch(epoch)
    ts.set_epoch(epoch)
    assert list(ts) == list(js)
    assert len(ts) == len(js)
    assert ts.state_dict() == js.state_dict()
    assert ts.checkpointable() and js.checkpointable()


def test_elastic_ranks_concatenate_to_the_global_stream():
    whole = list(_dist(tp, batch_size=3, num_replicas=2, rank="all",
                       elastic=True, shuffle=True))
    parts = [list(_dist(tp, batch_size=3, num_replicas=2, rank=r,
                        elastic=True, shuffle=True)) for r in range(2)]
    assert whole == [a + b for a, b in zip(*parts)]


@pytest.mark.parametrize("old,new,ok", [
    (dict(num_replicas=4, batch_size=2, elastic=True),
     dict(num_replicas=2, batch_size=4, elastic=True), True),
    (dict(num_replicas=4, batch_size=2, elastic=True),
     dict(num_replicas=2, batch_size=2, elastic=True), False),
    (dict(num_replicas=4, batch_size=2),
     dict(num_replicas=2, batch_size=4), False),
    (dict(num_replicas=2, batch_size=2),
     dict(num_replicas=2, batch_size=2, elastic=True), False),
], ids=["elastic_resize", "elastic_global_changed", "strided_resize",
        "layout_changed"])
def test_distributed_resize_checks_match(old, new, ok):
    outcomes = []
    for pk, err in ((jp, jerr.InvalidArgumentError),
                    (tp, terr.InvalidArgumentError)):
        st = _dist(pk, rank=0, **old).state_dict()
        target = _dist(pk, rank=0, **new)
        try:
            target.set_state_dict(st)
            outcomes.append(("ok", None))
        except err as e:
            outcomes.append(("raised", str(e)))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1][0] == "ok") == ok


def test_rank_all_requires_elastic_in_both():
    with pytest.raises(jerr.InvalidArgumentError, match="elastic"):
        _dist(jp, batch_size=2, num_replicas=2, rank="all")
    with pytest.raises(terr.InvalidArgumentError, match="elastic"):
        _dist(tp, batch_size=2, num_replicas=2, rank="all")


def test_distributed_batch_sampler_reads_the_ports_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    s = _dist(tp, batch_size=2)
    assert (s.local_rank, s.nranks) == (1, 3)
    assert list(s) == list(_dist(jp, batch_size=2, num_replicas=3, rank=1))


def test_epoch_seed_comes_from_torch_or_the_given_generator():
    s = tp.io.RandomSampler(Idx(10))
    torch.manual_seed(5)
    a = list(s)
    torch.manual_seed(5)
    assert list(s) == a
    g = torch.Generator().manual_seed(8)
    s2 = tp.io.RandomSampler(Idx(10), generator=g)
    first = list(s2)
    seed = s2.state_dict()["seed"]
    assert 0 <= seed < 2 ** 31
    assert first == np.random.RandomState(seed).permutation(10).tolist()
    g.manual_seed(8)
    assert list(s2) == first


def test_random_split_draws_from_a_torch_generator():
    parts = tp.io.random_split(Idx(10), [3, 7],
                               generator=torch.Generator().manual_seed(1))
    again = tp.io.random_split(Idx(10), [3, 7],
                               generator=torch.Generator().manual_seed(1))
    assert [p.indices for p in parts] == [p.indices for p in again]
    assert sorted(parts[0].indices + parts[1].indices) == list(range(10))
    assert [len(p) for p in parts] == [3, 7]
    assert int(parts[1][0][0]) == parts[1].indices[0]
    with pytest.raises(terr.InvalidArgumentError):
        tp.io.random_split(Idx(10), [3, 3])


def _indices(batches):
    return [np.asarray(b.numpy()).ravel().tolist() for b in batches]


@pytest.mark.parametrize("src,dst", [(jp, tp), (tp, jp)],
                         ids=["jax_to_port", "port_to_jax"])
def test_loader_state_restores_the_other_packages_loader(src, dst):
    a = src.io.DataLoader(Idx(30), batch_size=4, shuffle=True)
    it = iter(a)
    for _ in range(3):
        next(it)
    st = a.state_dict()
    rest = _indices(it)
    b = dst.io.DataLoader(Idx(30), batch_size=4, shuffle=True)
    b.set_state_dict(st)
    assert _indices(iter(b)) == rest
    assert len(rest) == 8 - 3
    assert b.state_dict() == {"version": 1, "epoch": 1, "cursor": 0,
                              "sampler": None}
