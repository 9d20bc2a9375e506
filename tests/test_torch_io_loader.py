"""The port's DataLoader (single-process iterator and thread pool) against
the JAX package's.

Each scenario runs the same dataset, loader arguments and chaos spec
through both packages and holds what comes out equal: batches of dict,
tuple and scalar samples, ``drop_last`` and a ragged last batch,
iterable datasets, the bad-sample policies with their records and the
quarantine file, the stall watchdog's typed and sticky error,
``peek_many``, the resume state, and the out-of-core file datasets.
Batches are compared as numpy arrays; the port's land on the caller's
place, here the CPU.
"""

import json
import threading

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.core import chaos as jchaos
from paddle1_tpu.core import flags as jflags
from paddle1_tpu_torch.core import chaos as tchaos
from paddle1_tpu_torch.core import errors as terr
from paddle1_tpu_torch.core import flags as tflags
from paddle1_tpu_torch.core import place as tplace

PACKS = {"jax": (jp, jchaos, jflags), "port": (tp, tchaos, tflags)}


@pytest.fixture(autouse=True)
def _isolated():
    jchaos.reset()
    tchaos.reset()
    with tp.device_guard("cpu"):
        yield
    jchaos.reset()
    tchaos.reset()


class DetDS:
    """Sample ``i`` is ``np.full((dim,), i)``; raises on ``bad`` indices
    and counts fetches."""

    def __init__(self, n=16, bad=(), dim=3, kind="array"):
        self.n, self.bad, self.dim, self.kind = n, frozenset(bad), dim, kind
        self.fetches = 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.fetches += 1
        if i in self.bad:
            raise ValueError(f"corrupt record {i}")
        x = np.full((self.dim,), i, np.float32)
        if self.kind == "tuple":
            return x, np.array([i % 3], np.int64)
        if self.kind == "dict":
            return {"x": x, "y": np.int64(i), "w": np.float32(i) / 2}
        if self.kind == "scalar":
            return np.float32(i)
        return x


def _np(leaf):
    return np.asarray(leaf.numpy() if hasattr(leaf, "numpy") else leaf)


def _flat(batch, key=()):
    """A batch as a list of (key path, numpy array) pairs."""
    if isinstance(batch, dict):
        return [p for k, v in batch.items() for p in _flat(v, key + (k,))]
    if isinstance(batch, (list, tuple)):
        return [p for i, v in enumerate(batch) for p in _flat(v, key + (i,))]
    return [(key, _np(batch))]


# the JAX package keeps 64-bit types in 32 bits (no x64 mode)
JAX_DTYPE = {np.dtype(np.int64): np.dtype(np.int32),
             np.dtype(np.float64): np.dtype(np.float32)}


def _leaves(batch):
    if isinstance(batch, dict):
        return [v for b in batch.values() for v in _leaves(b)]
    if isinstance(batch, (list, tuple)):
        return [v for b in batch for v in _leaves(b)]
    return [batch]


def _kind(batch):
    return type(batch).__name__ if isinstance(batch, (dict, list, tuple)) \
        else "tensor"


def _same(jb, tb):
    assert len(jb) == len(tb)
    for j, t in zip(jb, tb):
        assert _kind(t) == _kind(j)
        fj, ft = _flat(j), _flat(t)
        assert [k for k, _ in fj] == [k for k, _ in ft]
        for (_, a), (_, b) in zip(fj, ft):
            assert a.dtype in (b.dtype, JAX_DTYPE.get(b.dtype))
            assert b.shape == a.shape
            np.testing.assert_array_equal(b, a)


def _both(fn):
    return fn(*PACKS["jax"]), fn(*PACKS["port"])


@pytest.mark.parametrize("kind", ["array", "tuple", "dict", "scalar"])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("return_list", [True, False])
def test_map_style_batches_match(kind, drop_last, return_list):
    def run(pk, chaos, flags):
        dl = pk.io.DataLoader(DetDS(10, kind=kind), batch_size=4,
                              drop_last=drop_last, return_list=return_list)
        return list(iter(dl)), len(dl)
    (jb, jn), (tb, tn) = _both(run)
    _same(jb, tb)
    assert jn == tn == (2 if drop_last else 3) == len(tb)
    leaves = [v for b in tb for v in _leaves(b)]
    # numpy scalars are no int or float: both packages keep them a list
    assert all(isinstance(v, tp.Tensor) and v.device.type == "cpu" or
               isinstance(v, np.generic) for v in leaves)
    assert any(isinstance(v, tp.Tensor) for v in leaves) == (kind != "scalar")


class Stream:
    """An iterable dataset of ``n`` samples; the base class is the
    package's."""

    @staticmethod
    def make(pk, n=11, bad_at=None):
        class S(pk.io.IterableDataset):
            def __iter__(self):
                for i in range(n):
                    if i == bad_at:
                        raise ValueError("bad record")
                    yield np.full((2,), i, np.float32), np.int64(i)
        return S()


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset_batches_match(drop_last):
    def run(pk, chaos, flags):
        dl = pk.io.DataLoader(Stream.make(pk), batch_size=4,
                              drop_last=drop_last)
        return list(iter(dl))
    jb, tb = _both(run)
    _same(jb, tb)
    assert len(tb) == (2 if drop_last else 3)


def test_iterable_dataset_raise_propagates_in_both():
    for pk, _, _ in PACKS.values():
        dl = pk.io.DataLoader(Stream.make(pk, bad_at=5), batch_size=4)
        with pytest.raises(ValueError, match="bad record"):
            list(iter(dl))


@pytest.mark.parametrize("policy", ["skip", "quarantine"])
@pytest.mark.parametrize("workers", [0, 2], ids=["thread", "pool"])
def test_bad_sample_policies_match(policy, workers, tmp_path):
    def run(pk, chaos, flags):
        qfile = tmp_path / f"{pk.__name__}.jsonl"
        with flags.flags_guard(loader_quarantine_file=str(qfile)):
            dl = pk.io.DataLoader(DetDS(16, bad={3, 9, 10}, kind="tuple"),
                                  batch_size=4, bad_sample_policy=policy,
                                  num_workers=workers,
                                  use_shared_memory=False)
            out = list(iter(dl))
        lines = ([json.loads(l) for l in qfile.read_text().splitlines()]
                 if qfile.exists() else [])
        return out, dl.bad_sample_count, dl.quarantine, lines
    (jb, jc, jq, jl), (tb, tc, tq, tl) = _both(run)
    _same(jb, tb)
    assert tc == jc == 3
    assert tq == jq and tl == jl
    assert len(tq) == (3 if policy == "quarantine" else 0)


def test_raise_policy_is_the_default_in_both():
    for pk, _, _ in PACKS.values():
        dl = pk.io.DataLoader(DetDS(16, bad={5}), batch_size=4)
        assert dl.bad_sample_policy == "raise"
        with pytest.raises(ValueError, match="corrupt record 5"):
            list(iter(dl))
    with pytest.raises(terr.InvalidArgumentError):
        tp.io.DataLoader(DetDS(8), batch_size=4, bad_sample_policy="yolo")


@pytest.mark.parametrize("spec,stream", [
    ("corrupt_sample@6:0", False), ("corrupt_sample@3:0", True)])
def test_chaos_corrupt_sample_matches(spec, stream):
    def run(pk, chaos, flags):
        chaos.configure(spec)
        ds = Stream.make(pk, 12) if stream else DetDS(16)
        dl = pk.io.DataLoader(ds, batch_size=4,
                              bad_sample_policy="quarantine")
        # fire-once: the second epoch replays clean
        first, again = list(iter(dl)), list(iter(dl))
        recs = [{k: (v.split(":")[0] if k == "error" else v)
                 for k, v in r.items()} for r in dl.quarantine]
        return first, again, recs
    (jf, ja, jr), (tf, ta, tr) = _both(run)
    _same(jf, tf)
    _same(ja, ta)
    assert tr == jr and len(tr) == 1


def test_all_quarantined_batch_advances_the_cursor_in_both():
    def run(pk, chaos, flags):
        dl = pk.io.DataLoader(DetDS(16, bad={4, 5, 6, 7}), batch_size=4,
                              bad_sample_policy="quarantine")
        it = iter(dl)
        got = [next(it) for _ in range(3)]
        return got, dl.state_dict()
    (jb, js), (tb, ts) = _both(run)
    _same(jb, tb)
    assert ts == js and ts["cursor"] == 4


def test_stall_watchdog_is_typed_and_sticky():
    tchaos.configure("loader_stall@2:0")
    with tflags.flags_guard(loader_chaos_stall_s=1.0):
        dl = tp.io.DataLoader(DetDS(16), batch_size=4, stall_timeout_s=0.4)
        it = iter(dl)
        next(it)
        with pytest.raises(tp.io.DataLoaderStalled, match="producer"):
            for _ in range(8):
                next(it)
        assert dl.stall_events == 1
        with pytest.raises(tp.io.DataLoaderStalled):
            next(it)
        it._thread.join(timeout=5)
        assert not it._thread.is_alive()
    from paddle1_tpu_torch.obs import registry
    assert registry.process_registry().counter(
        "loader_stalls_total").value >= 1


@pytest.mark.parametrize("k", [1, 3, 10])
def test_peek_many_matches(k):
    def run(pk, chaos, flags):
        it = iter(pk.io.DataLoader(DetDS(20), batch_size=4))
        out = []
        while True:
            try:
                out.append(it.peek_many(k))
            except StopIteration:
                return out
    jb, tb = _both(run)
    assert [len(g) for g in tb] == [len(g) for g in jb]
    _same([b for g in jb for b in g], [b for g in tb for b in g])


def _arrs(batches):
    return [_np(b) for b in batches]


def test_state_resume_is_bit_exact_and_loads_no_skipped_sample():
    tp.seed(21)
    dl = tp.io.DataLoader(DetDS(64), batch_size=4, shuffle=True)
    it = iter(dl)
    for _ in range(8):
        next(it)
    st = dl.state_dict()
    rest = _arrs(it)
    ds2 = DetDS(64)
    dl2 = tp.io.DataLoader(ds2, batch_size=4, shuffle=True)
    dl2.set_state_dict(st)
    tail = _arrs(dl2)
    assert len(tail) == len(rest) == 8
    for a, b in zip(tail, rest):
        np.testing.assert_array_equal(a, b)
    assert ds2.fetches == 8 * 4
    with pytest.raises(terr.InvalidArgumentError):
        dl2.set_state_dict({"version": 99})


def test_epoch_boundary_snapshot_draws_a_fresh_seed():
    tp.seed(5)
    dl = tp.io.DataLoader(DetDS(32), batch_size=4, shuffle=True)
    _arrs(dl)
    e1_ref = _arrs(dl)
    tp.seed(5)
    dl2 = tp.io.DataLoader(DetDS(32), batch_size=4, shuffle=True)
    _arrs(dl2)
    st = dl2.state_dict()
    assert st["sampler"] is None and st["epoch"] == 1
    dl3 = tp.io.DataLoader(DetDS(32), batch_size=4, shuffle=True)
    dl3.set_state_dict(st)
    for a, b in zip(_arrs(dl3), e1_ref):
        np.testing.assert_array_equal(a, b)


def test_iterable_state_tracks_the_consumed_position_in_both():
    def run(pk, chaos, flags):
        class Stateful(pk.io.IterableDataset):
            def __init__(self):
                self.cursor = 0

            def __iter__(self):
                while self.cursor < 30:
                    self.cursor += 1
                    yield np.full((2,), self.cursor - 1, np.float32)

            def state_dict(self):
                return {"cursor": self.cursor}

            def set_state_dict(self, st):
                self.cursor = int(st["cursor"])

        dl = pk.io.DataLoader(Stateful(), batch_size=4)
        it = iter(dl)
        next(it)
        st = dl.state_dict()
        dl2 = pk.io.DataLoader(Stateful(), batch_size=4)
        dl2.set_state_dict(st)
        return st, list(iter(dl2)), list(it)
    (js, jt, jr), (ts, tt, tr) = _both(run)
    assert ts == js and ts["dataset"] == {"cursor": 4}
    _same(jt, tt)
    _same(tr, tt)


def test_default_collate_fn_outside_a_loader_uses_the_current_place():
    batch = [{"a": np.ones(2, np.float32), "b": (np.int64(i), [1.5, 2.5])}
             for i in range(3)]
    got = tp.io.default_collate_fn(batch)
    want = jp.io.default_collate_fn(batch)
    assert isinstance(got["a"], tp.Tensor) and got["a"].device.type == "cpu"
    np.testing.assert_array_equal(_np(got["a"]), _np(want["a"]))
    np.testing.assert_array_equal(_np(got["b"][0]), _np(want["b"][0]))
    tensors = [tp.to_tensor(np.full(2, i, np.float32)) for i in range(3)]
    stacked = tp.io.default_collate_fn(tensors)
    np.testing.assert_array_equal(_np(stacked), np.repeat(
        np.arange(3, dtype=np.float32)[:, None], 2, 1))


def test_host_work_runs_on_the_cpu_place_in_the_producer_and_the_pool():
    seen = []

    class Probe(DetDS):
        def __getitem__(self, i):
            seen.append((threading.current_thread().name,
                         tp.get_device().kind))
            return super().__getitem__(i)

    def collate(samples):
        seen.append(("collate", tp.get_device().kind))
        return tp.io.default_collate_fn(samples)

    for workers in (0, 2):
        dl = tp.io.DataLoader(Probe(8), batch_size=4, num_workers=workers,
                              use_shared_memory=False, collate_fn=collate)
        assert len(list(iter(dl))) == 2
    assert seen and all(kind == "cpu" for _, kind in seen)


def test_a_caller_on_another_place_is_honoured_by_the_producer(monkeypatch):
    # the producer thread takes the place of the thread that called
    # iter(): a fresh thread would start on CUDAPlace(0)
    class Marked(tplace.CPUPlace):
        pass

    marked = Marked()
    monkeypatch.setattr(tplace._tls, "place", marked, raising=False)
    it = iter(tp.io.DataLoader(DetDS(8), batch_size=4))
    assert it._place is marked
    list(it)
    seen = []
    orig = tplace.set_device

    def spy(device):
        seen.append((threading.current_thread(), device))
        return orig(device)
    monkeypatch.setattr(tplace, "set_device", spy)
    list(iter(tp.io.DataLoader(DetDS(8), batch_size=4)))
    assert [d for t, d in seen if t is not threading.current_thread()][0] \
        is marked


def test_chaos_specs_parse_alike():
    spec = ("loader_worker_kill@4:0,corrupt_sample@3:1,loader_stall@2:0,"
            "nan_batch@3")
    jchaos.configure(spec)
    tchaos.configure(spec)
    assert tchaos.active_spec() == jchaos.active_spec()
    assert tchaos.enabled() and jchaos.enabled()
    tchaos.reset()
    assert tchaos.active_spec() == "" and not tchaos.enabled()
    with tflags.flags_guard(ft_chaos="loader_raise@1"):
        tchaos.configure_from_flags()
    assert tchaos.active_spec() == "loader_raise@1"
    dl = tp.io.DataLoader(DetDS(8), batch_size=4)
    with pytest.raises(tchaos.ChaosInjectedError):
        list(iter(dl))


def test_loader_flags_have_the_jax_packages_defaults():
    for name in ("ft_chaos", "loader_bad_sample",
                 "loader_max_worker_restarts", "loader_stall_timeout_s",
                 "loader_chaos_stall_s", "loader_quarantine_file"):
        assert tflags.flag(name) == jflags.flag(name), name


@pytest.fixture
def text_files(tmp_path):
    paths = []
    for f in range(3):
        p = tmp_path / f"part-{f}.txt"
        p.write_text("".join(f"{f * 10 + i} {i % 2}\n" for i in range(5)))
        paths.append(str(p))
    return paths


def _parse(line):
    a, b = line.split()
    return np.array([float(a)], np.float32), np.array([int(b)], np.int64)


@pytest.mark.parametrize("kind", ["InMemoryDataset", "QueueDataset"])
def test_file_datasets_match(kind, text_files):
    def run(pk, chaos, flags):
        ds = pk.io.DatasetFactory().create_dataset(kind)
        ds.set_filelist(text_files)
        ds.set_parse_fn(_parse)
        if kind == "InMemoryDataset":
            ds.load_into_memory()
        return list(iter(pk.io.DataLoader(ds, batch_size=4)))
    jb, tb = _both(run)
    _same(jb, tb)
    assert sum(len(_np(b[0])) for b in tb) == 15


def test_file_dataset_pipe_command_matches(text_files):
    def run(pk, chaos, flags):
        ds = pk.io.DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_filelist(text_files)
        ds.set_pipe_command("grep ' 1$'")
        ds.set_parse_fn(_parse)
        ds.load_into_memory()
        return [ds[i] for i in range(len(ds))]
    jb, tb = _both(run)
    assert len(tb) == len(jb) > 0
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b[0], a[0])


def test_tensor_dataset_and_composed_datasets():
    xs = np.arange(12, dtype=np.float32).reshape(6, 2)
    ys = np.arange(6, dtype=np.int64)
    td = tp.io.TensorDataset([tp.to_tensor(xs), tp.to_tensor(ys)])
    jd = jp.io.TensorDataset([jp.to_tensor(xs), jp.to_tensor(ys)])
    assert len(td) == len(jd) == 6
    for i in range(6):
        for a, b in zip(jd[i], td[i]):
            np.testing.assert_array_equal(_np(b), np.asarray(a.numpy()))
    tc = tp.io.ComposeDataset([DetDS(4), DetDS(4, dim=2)])
    jc = jp.io.ComposeDataset([DetDS(4), DetDS(4, dim=2)])
    for i in range(4):
        for a, b in zip(jc[i], tc[i]):
            np.testing.assert_array_equal(b, a)
    chain = tp.io.ChainDataset([Stream.make(tp, 3), Stream.make(tp, 2)])
    assert [int(s[1]) for s in chain] == [0, 1, 2, 0, 1]
    sub = tp.io.Subset(DetDS(10), [7, 2])
    assert [float(sub[i][0]) for i in range(2)] == [7.0, 2.0]
    assert torch.equal(torch.as_tensor(td[2][0]),
                       torch.tensor([4.0, 5.0]))


def _positional(fn):
    import inspect
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [n for n, p in sig.parameters.items()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


JAX_IO_NAMES = sorted(n for n in vars(jp.io) if not n.startswith("_") and
                      n not in ("bad_samples", "dataloader", "dataset",
                                "file_dataset"))


@pytest.mark.parametrize("name", JAX_IO_NAMES)
def test_every_io_name_takes_the_jax_packages_positions(name):
    j, t = getattr(jp.io, name), getattr(tp.io, name)
    assert _positional(t) == _positional(j)
    for attr in ("state_dict", "set_state_dict", "set_epoch", "peek_many"):
        if hasattr(j, attr):
            assert _positional(getattr(t, attr)) == \
                _positional(getattr(j, attr))


def test_the_io_module_has_every_name_and_the_package_exports_it():
    assert len(JAX_IO_NAMES) == 21
    assert all(hasattr(tp.io, n) for n in JAX_IO_NAMES)
    assert "io" in tp.__all__ and jp.io.__name__ == "paddle1_tpu.io"
