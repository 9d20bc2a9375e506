"""The port's DataLoader with worker processes over the shared-memory
arena (``core/native``), against its own single-process iterator and the
JAX package's loader.

Two workers, a worker killed through the chaos point and recovered in
order, ``get_worker_info``, a worker that sees the CPU as its place while
its parent's place is the card, the resume state, a worker's error, and
a ``DatasetFolder`` of ``.npy`` images through both packages' loaders
with two workers and the deterministic eval pipeline. Every iterator is
shut down in ``finally``, so no worker outlives its test.
"""

import os
import warnings

import numpy as np
import pytest

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.core import chaos as jchaos
from paddle1_tpu_torch.core import chaos as tchaos
from paddle1_tpu_torch.core import native
from paddle1_tpu_torch.core import place as tplace
from paddle1_tpu_torch.io import dataloader as tdl

MEAN, STD = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]


@pytest.fixture(autouse=True)
def _isolated():
    jchaos.reset()
    tchaos.reset()
    with tp.device_guard("cpu"):
        yield
    jchaos.reset()
    tchaos.reset()


class DetDS:
    """Sample ``i``: (``np.full((4,), i)``, ``[i % 5]``)."""

    def __init__(self, n=32):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i < 0 or i >= self.n:
            raise IndexError(i)
        return np.full((4,), i, np.float32), np.array([i % 5], np.int64)


def _arrs(batches):
    return [tuple(np.asarray(t.numpy()) for t in b) for b in batches]


def _epoch(loader):
    """One epoch's batches as numpy arrays, the iterator shut down."""
    it = iter(loader)
    try:
        return type(it).__name__, _arrs(it)
    finally:
        it.shutdown()


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_two_workers_match_the_single_process_iterator():
    assert native.available(), native.build_error()
    kind, got = _epoch(tp.io.DataLoader(DetDS(30), batch_size=4,
                                        num_workers=2))
    assert kind == "_MultiProcessIter"
    _, want = _epoch(tp.io.DataLoader(DetDS(30), batch_size=4))
    _equal(got, want)
    assert len(got) == 8 and got[-1][0].shape == (2, 4)


def test_a_killed_worker_is_replaced_and_the_epoch_arrives_in_order():
    tchaos.configure("loader_worker_kill@2:1")
    dl = tp.io.DataLoader(DetDS(32), batch_size=4, num_workers=2,
                          stall_timeout_s=20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        kind, got = _epoch(dl)
    assert kind == "_MultiProcessIter"
    assert dl.worker_restart_count == 1
    _equal(got, _epoch(tp.io.DataLoader(DetDS(32), batch_size=4))[1])
    # fire-once: the next epoch's fleet runs clean
    _, again = _epoch(dl)
    assert dl.worker_restart_count == 1 and len(again) == 8


class Probe:
    """Reports, from where it is loaded: the worker's id and count
    (``get_worker_info``), the kind of its current place, and where a
    ``to_tensor`` there lands (0 the CPU, 1 a card)."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = tp.io.get_worker_info()
        place = tp.get_device().kind
        made = tp.to_tensor(np.ones(1, np.float32)).device.type
        return np.array([i, -1 if info is None else info.id,
                         -1 if info is None else info.num_workers,
                         place == "gpu", made == "cuda", os.getpid()],
                        np.int64)


def test_get_worker_info_inside_and_outside_the_workers():
    assert tp.io.get_worker_info() is None
    it = iter(tp.io.DataLoader(Probe(), batch_size=2, num_workers=2))
    try:
        rows = np.concatenate([np.asarray(b.numpy()) for b in it])
    finally:
        it.shutdown()
    assert rows[:, 0].tolist() == list(range(8))
    # batch k goes to worker k % 2
    assert rows[:, 1].tolist() == [0, 0, 1, 1, 0, 0, 1, 1]
    assert set(rows[:, 2].tolist()) == {2}
    assert len(set(rows[:, 5].tolist())) == 2
    assert os.getpid() not in rows[:, 5].tolist()


def test_workers_see_the_cpu_while_the_caller_is_on_the_card(monkeypatch):
    # the caller's place is the card; the batches are staged on the CPU
    # here (no card), but each worker must find the CPU as its place
    monkeypatch.setattr(tplace._tls, "place", tplace.CUDAPlace(0),
                        raising=False)
    cpu_stager = tdl._Stager
    monkeypatch.setattr(tdl, "_Stager",
                        lambda place: cpu_stager(tplace.CPUPlace()))
    it = iter(tp.io.DataLoader(Probe(), batch_size=2, num_workers=2))
    try:
        assert type(it).__name__ == "_MultiProcessIter"
        assert it._place == tplace.CUDAPlace(0)
        rows = np.concatenate([np.asarray(b.numpy()) for b in it])
    finally:
        it.shutdown()
    assert rows[:, 3].tolist() == [0] * 8     # the place: the CPU
    assert rows[:, 4].tolist() == [0] * 8     # to_tensor: on the CPU
    assert tp.get_device() == tplace.CUDAPlace(0)


def test_worker_state_resume_is_bit_exact():
    tp.seed(31)
    dl = tp.io.DataLoader(DetDS(40), batch_size=4, shuffle=True,
                          num_workers=2)
    it = iter(dl)
    try:
        for _ in range(3):
            next(it)
        st = dl.state_dict()
        rest = _arrs(it)
    finally:
        it.shutdown()
    dl2 = tp.io.DataLoader(DetDS(40), batch_size=4, shuffle=True,
                           num_workers=2)
    dl2.set_state_dict(st)
    _, tail = _epoch(dl2)
    assert len(tail) == 7
    _equal(tail, rest)


def test_a_worker_error_reaches_the_caller_and_stays():
    class Bad(DetDS):
        def __getitem__(self, i):
            if i == 9:
                raise ValueError("corrupt record 9")
            return super().__getitem__(i)

    it = iter(tp.io.DataLoader(Bad(16), batch_size=4, num_workers=2))
    try:
        with pytest.raises(RuntimeError, match="corrupt record 9"):
            for _ in range(4):
                next(it)
        with pytest.raises(RuntimeError, match="corrupt record 9"):
            next(it)
    finally:
        it.shutdown()
    assert it._workers == []


def test_the_arena_round_trips_arrays_and_views():
    arena = native.ShmArena(f"/p1t_test_{os.getpid()}", size=1 << 20)
    try:
        a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        desc = arena.put_array(a)
        np.testing.assert_array_equal(arena.get_array(desc), a)
        view = arena.view_array(desc)
        assert not view.flags.owndata
        np.testing.assert_array_equal(view, a)
        assert arena.used() >= a.nbytes
        with pytest.raises(MemoryError):
            arena.put_array(np.zeros(1 << 20, np.uint8))
    finally:
        arena.close(unlink=True)


def test_a_failed_arena_build_keeps_its_log_and_falls_back(
        monkeypatch, tmp_path):
    src = tmp_path / "native" / "src" / "arena.cc"
    src.parent.mkdir(parents=True)
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "_build_dir", lambda: tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", None)
    assert not native.available()
    err = native.build_error()
    assert "g++ exit" in err
    logs = list((tmp_path / "_build").glob("*.failed-*.log"))
    assert len(logs) == 1 and "error" in logs[0].read_text()
    # the loader then runs its thread-pool iterator, as the JAX package's
    # does without its native library
    kind, got = _epoch(tp.io.DataLoader(DetDS(8), batch_size=4,
                                        num_workers=2))
    assert kind == "_SingleProcessIter" and len(got) == 2


def _npy_tree(root, rng, classes=3, per_class=4):
    for c in range(classes):
        d = root / f"n{c:08d}"
        d.mkdir(parents=True)
        for i in range(per_class):
            h, w = rng.integers(40, 72, 2)
            np.save(d / f"img_{i}.npy",
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _eval_pipeline(T):
    return T.Compose([T.Resize(36), T.CenterCrop(32), T.Transpose(),
                      T.Normalize(mean=MEAN, std=STD, data_format="CHW")])


def test_a_dataset_folder_through_both_packages_with_two_workers(tmp_path):
    _npy_tree(tmp_path, np.random.default_rng(0))
    state = {"version": 1, "epoch": 0, "cursor": 0,
             "sampler": {"sampler": {"seed": 4242}}}
    out = {}
    for name, pk in (("jax", jp), ("port", tp)):
        T = pk.vision.transforms
        ds = pk.vision.datasets.DatasetFolder(
            str(tmp_path), loader=np.load, extensions=(".npy",),
            transform=_eval_pipeline(T))
        dl = pk.io.DataLoader(ds, batch_size=4, shuffle=True,
                              drop_last=True, num_workers=2)
        dl.set_state_dict(state)
        out[name] = _epoch(dl)
    assert out["port"][0] == "_MultiProcessIter"
    assert len(out["port"][1]) == 3
    for (jx, jy), (tx, ty) in zip(out["jax"][1], out["port"][1]):
        assert tx.shape == (4, 3, 32, 32) and tx.dtype == np.float32
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
