"""Item 6's first part of the PyTorch port, on the CPU:
``distributed/checkpoint.py`` (one file a rank, an index of every piece
by tensor name and element range) and ``ParallelEngine.save_checkpoint``
/ ``load_checkpoint``, against the JAX package's contract
(``tests/test_sharded_checkpoint.py``; ``paddle1_tpu/distributed/
checkpoint.py``): the same topology, another topology, ``sync_model``
after a load, the manager's retention and latest step, the atomic
commit, the fallback past a corrupt checkpoint and the GC. The on-disk
format is the port's own (ROADMAP Queue 3, departures); the manifest's
tree spec and digest are the JAX package's for the same state.

The multi-rank cases run in gloo ranks that the port's ``spawn`` starts
(``tests/test_torch_zero_seq_ranks.py`` holds their side).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_zero_seq_ranks as ranks
from paddle1_tpu_torch import distributed as tdist
from paddle1_tpu_torch.distributed import checkpoint as tck

JOB_TIMEOUT_S = 300


def _load(out, case, n):
    return [dict(np.load(os.path.join(out, f"{case}_rank{r}.npz")))
            for r in range(n)]


@pytest.fixture(scope="module")
def bert_case(tmp_path_factory):
    import paddle1_tpu as paddle
    from paddle1_tpu.text.models import BertForPretraining, BertModel
    tmp = tmp_path_factory.mktemp("bert")
    paddle.seed(0)
    jm = BertForPretraining(BertModel(**ranks.BERT))
    np.savez(tmp / "state.npz", **{k: np.asarray(v) for k, v in
                                   jm.functional_state().items()})
    rng = np.random.default_rng(0)
    np.savez(tmp / "batch.npz",
             ids=rng.integers(1, 128, (8, 16)).astype(np.int32),
             mlm=rng.integers(0, 128, (8, 16)).astype(np.int32),
             nsp=rng.integers(0, 2, (8,)).astype(np.int32))
    return tmp


@pytest.fixture(scope="module")
def job4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("job4")
    tdist.spawn(ranks.job, args=(str(tmp), str(tmp / "store4"),
                                 [("checkpoint", ())]),
                nprocs=4, timeout=JOB_TIMEOUT_S)
    return str(tmp)


@pytest.fixture(scope="module")
def job2(tmp_path_factory, bert_case):
    tmp = tmp_path_factory.mktemp("job2")
    tdist.spawn(ranks.job, args=(str(tmp), str(tmp / "store2"), [
        ("resume", (str(bert_case / "state.npz"),
                    str(bert_case / "batch.npz")))]),
        nprocs=2, timeout=JOB_TIMEOUT_S)
    return str(tmp)


# ---------------------------------------------------------------------------
# tests/test_sharded_checkpoint.py's four scenarios, on four ranks


def test_save_restore_same_topology(job4):
    """dp 2 x sharding 2 at ZeRO 2: the restored engine's whole state is
    the saved one's, and training continues identically."""
    for got in _load(job4, "checkpoint", 4):
        assert bool(got["same_state_equal"])
        a, b = got["same_next"]
        assert a == b


def test_restore_into_different_topology(job4):
    """Saved at dp 2 x sharding 2, ZeRO 2, restored at dp 4 (no ZeRO):
    each rank reads the runs its pieces cover; the values are identical,
    the next loss within 1e-5."""
    for got in _load(job4, "checkpoint", 4):
        assert bool(got["other_state_equal"])
        a, b = got["other_next"]
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_sync_model_after_load(job4):
    """The layer itself carries the restored weights."""
    for got in _load(job4, "checkpoint", 4):
        assert bool(got["sync_layer_equal"])


def test_manager_retention_and_latest(job4, tmp_path):
    """Three saves at max_to_keep 2 keep steps 2 and 3; the restore is
    step 3's; an empty directory has nothing to restore."""
    for got in _load(job4, "checkpoint", 4):
        assert int(got["latest"]) == 3
        assert got["kept"].tolist() == [2, 3]
        assert int(got["restored_step"]) == 3
        assert bool(got["restored_equal"])
    with pytest.raises(FileNotFoundError):
        tck.CheckpointManager(str(tmp_path / "empty")).restore(
            {"params": {"w": torch.zeros(2)}})


# ---------------------------------------------------------------------------
# the ZeRO 3 resume on two ranks, and world size 1's restore


def test_resume_at_zero_3_on_two_ranks_is_bit_equal(job2):
    for got in _load(job2, "resume", 2):
        assert got["losses"].tolist() == got["resumed_losses"].tolist()
        assert bool(got["state_bit_equal"])


def test_world_size_1_restores_the_sharded_checkpoint_bit_for_bit(
        job2, bert_case):
    """The checkpoint two ZeRO-3 ranks wrote, restored by an engine at
    world size 1: its whole state is the state at the save, bit for bit,
    and it steps on."""
    from paddle1_tpu_torch.optimizer import AdamW
    at_save = {k[len("at_save."):]: v for k, v in
               _load(job2, "resume", 2)[0].items()
               if k.startswith("at_save.")}
    tm = ranks.bert(str(bert_case / "state.npz"))
    with torch.no_grad():
        for p in tm.parameters():
            p.zero_()
    eng = tdist.ParallelEngine(tm, AdamW(learning_rate=ranks.LR,
                                         parameters=tm.parameters()),
                               ranks.bert_loss())
    eng.load_checkpoint(os.path.join(job2, "ck_z3"))
    mine = eng.full_state_dict()
    assert set(mine) == set(at_save)
    for k, v in at_save.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)
    assert np.isfinite(float(eng.step(dict(np.load(bert_case /
                                                    "batch.npz")))))


# ---------------------------------------------------------------------------
# the contract, in one process


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "b": torch.randn(4, generator=g)},
            "opt_state": ({"w": {"moment1": torch.zeros(3, 4)},
                           "b": {"moment1": torch.zeros(4)}},
                          torch.tensor(2, dtype=torch.int32))}


def _jax_state(state):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(conv(v) for v in x)
        return jnp.asarray(x.numpy())
    return conv(state)


def test_manifest_tree_spec_and_digest_equal_the_jax_packages(tmp_path):
    """The same state (nested dicts and a tuple, f32 and int32 leaves)
    stamps the same tree spec (keystr paths, shapes, dtypes) and digest in
    both packages; a Piece stands for its whole tensor."""
    from paddle1_tpu.distributed import checkpoint as jck
    state = _state()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tck.write_manifest(str(tmp_path / "t"), state, meta={"step": 2})
    jck.write_manifest(str(tmp_path / "j"), _jax_state(state),
                       meta={"step": 2})
    mine = json.loads((tmp_path / "t" / tck.MANIFEST_NAME).read_text())
    theirs = json.loads((tmp_path / "j" / jck.MANIFEST_NAME).read_text())
    assert mine["tree"] == theirs["tree"]
    assert mine["digest"] == theirs["digest"]
    assert mine["meta"] == theirs["meta"]
    w = state["params"]["w"]
    pieces = {**state, "params": {"w": tck.Piece(w.reshape(-1)[4:], 4,
                                                 w.shape),
                                  "b": state["params"]["b"]}}
    assert tck._tree_spec(pieces) == tck._tree_spec(state)


def test_save_and_load_pieces_across_layouts(tmp_path):
    """A tensor saved as one run restores into a run of another layout, in
    place, and into a whole tensor; a piece the records do not cover, or
    a target of another shape, raises CheckpointCorruptError."""
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    flat = w.reshape(-1)
    path = tck.save_sharded(str(tmp_path / "ck"),
                            {"w": tck.Piece(flat, 0, w.shape)})
    idx = json.loads(open(os.path.join(path, tck.INDEX_NAME)).read())
    assert idx["records"] == [["['w']", 0, 12, [3, 4], "float32",
                               "shard-00000.pt"]]
    run = torch.empty(4)
    target = {"w": tck.Piece(run, 4, w.shape)}
    assert tck.load_sharded(path, target)["w"] is target["w"]
    assert torch.equal(run, flat[4:8])
    whole = tck.load_sharded(path, {"w": torch.zeros(3, 4)})
    assert torch.equal(whole["w"], w)
    with pytest.raises(tck.CheckpointCorruptError, match="covered"):
        tck.load_sharded(path, {"w": tck.Piece(torch.empty(4), 10,
                                               w.shape)})
    with pytest.raises(tck.CheckpointCorruptError, match="saved as"):
        tck.load_sharded(path, {"w": torch.zeros(4, 3)})


def _both(tmp_path, scenario):
    """``scenario(module, directory, state)`` run with the port's and the
    JAX package's checkpoint module; returns both results."""
    from paddle1_tpu.core import chaos as jchaos
    from paddle1_tpu.distributed import checkpoint as jck
    from paddle1_tpu_torch.core import chaos as tchaos
    out = []
    for mod, chaos, state in ((tck, tchaos, _state()),
                              (jck, jchaos, _jax_state(_state()))):
        chaos.reset()
        try:
            out.append(scenario(mod, chaos, str(tmp_path / mod.__name__),
                                state))
        finally:
            chaos.reset()
    return out


def test_a_failed_commit_leaves_uncommitted_debris_in_both_packages(
        tmp_path):
    """An injected failure between the write and the manifest
    (``ckpt_fail``) raises, leaves no committed step and the previous
    checkpoint the latest; the next save sweeps this process's debris."""
    def scenario(mod, chaos, d, state):
        mgr = mod.CheckpointManager(d, max_to_keep=3)
        mgr.save(1, state)
        chaos.configure("ckpt_fail@1")
        with pytest.raises(IOError):
            mgr.save(2, state)
        chaos.reset()
        debris = sorted(x for x in os.listdir(d) if ".tmp" in x)
        after = (mgr.all_steps(), mgr.latest_step(), len(debris))
        mgr.save(3, state)
        return after + (mgr.all_steps(),
                        sorted(x for x in os.listdir(d) if ".tmp" in x))
    mine, theirs = _both(tmp_path, scenario)
    assert mine == theirs == ([1], 1, 1, [1, 3], [])


def test_restore_falls_back_past_a_corrupt_checkpoint_in_both_packages(
        tmp_path):
    """The newest checkpoint's manifest no longer matches its target (or
    its data is gone): the restore warns and returns the newest one that
    verifies; with every one corrupt it raises CheckpointCorruptError."""
    def scenario(mod, chaos, d, state):
        mgr = mod.CheckpointManager(d, max_to_keep=3)
        mgr.save(1, state)
        mgr.save(2, state)
        man = os.path.join(d, "2", mod.MANIFEST_NAME)
        doc = json.loads(open(man).read())
        doc["tree"][0][1] = [99]
        open(man, "w").write(json.dumps(doc))
        with pytest.warns(UserWarning, match="falling back"):
            _, step = mgr.restore(state)
        os.remove(os.path.join(d, "1", mod.MANIFEST_NAME))
        raised = None
        try:
            mgr.restore(state)
        except mod.CheckpointCorruptError:
            raised = "corrupt"
        return step, mgr.all_steps(), raised
    mine, theirs = _both(tmp_path, scenario)
    assert mine == theirs == (1, [2], "corrupt")


def test_gc_counts_committed_steps_only_in_both_packages(tmp_path):
    """A numeric directory without a manifest is neither counted nor
    deleted; stale debris of another process is swept, fresh debris is
    left for its writer."""
    def scenario(mod, chaos, d, state):
        mgr = mod.CheckpointManager(d, max_to_keep=1)
        os.makedirs(os.path.join(d, "7"))
        os.makedirs(os.path.join(d, "5.tmp-1"))
        os.makedirs(os.path.join(d, "6.tmp-2"))
        old = os.path.getmtime(d) - 10 * mgr._DEBRIS_MIN_AGE_S
        os.utime(os.path.join(d, "5.tmp-1"), (old, old))
        mgr.save(1, state)
        mgr.save(2, state)
        return mgr.all_steps(), sorted(os.listdir(d))
    mine, theirs = _both(tmp_path, scenario)
    assert mine == theirs == ([2], ["2", "6.tmp-2", "7"])


def test_sidecars_and_meta_round_trip_and_verify(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path / "c"))
    mgr.save(4, _state(), meta={"seed": np.int64(3)},
             sidecars={"ledger": {"ids": np.arange(5)}})
    assert mgr.read_meta()["seed"] == 3
    np.testing.assert_array_equal(mgr.read_sidecar("ledger")["ids"],
                                  np.arange(5))
    fp = os.path.join(mgr.directory, "4", "sidecar-ledger.npz")
    with open(fp, "ab") as f:
        f.write(b"x")
    with pytest.raises(tck.CheckpointCorruptError, match="digest"):
        mgr.read_sidecar("ledger")
    with pytest.raises(tck.CheckpointCorruptError, match="JSON"):
        mgr.save(5, _state(), meta={"bad": object()})


def test_a_model_axis_change_raises_reshard_error(tmp_path):
    """A checkpoint saved at mp 2 restored into an mp 1 target: the resize
    is refused before a byte is read (``ensure_reshardable``)."""
    from paddle1_tpu_torch.distributed.topology import (MeshDescriptor,
                                                        ReshardError)
    saved = MeshDescriptor(axes={"mp": 2, "dp": 1}, device_count=2)
    target = MeshDescriptor(axes={"dp": 2}, device_count=2)
    x = torch.ones(4)
    path = tck.save_sharded(str(tmp_path / "ck"),
                            {"x": tck.Piece(x, 0, x.shape, saved)})
    assert tck.tree_mesh_descriptor({"x": tck.Piece(x, 0, x.shape,
                                                    saved)}) == saved
    with pytest.raises(ReshardError, match="mp=2"):
        tck.load_sharded(path, {"x": tck.Piece(torch.empty(4), 0, x.shape,
                                               target)})
