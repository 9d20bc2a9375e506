"""The slice as a whole on the CPU: Paddle 2.0's quick start (LeNet on
MNIST through ``vision.datasets.MNIST``, ``transforms.Normalize`` and
``io.DataLoader(shuffle=True)``) in both packages, on IDX files the test
writes.

The epoch seed is forced equal (``set_state_dict``), so the two loaders
give the same batches; from the JAX package's weights (``state_from_jax``)
three eager Adam steps on those batches agree within
``tests/test_torch_eager.py``'s ``STEP_TOL`` (1e-4).
"""

import gzip
import struct

import numpy as np
import pytest

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.vision.models.lenet import LeNet as JLeNet
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.vision.models import LeNet as TLeNet

STEP_TOL = dict(atol=1e-4, rtol=1e-4)
N, BATCH, SEED = 200, 64, 20201


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tp.device_guard("cpu"):
        yield


def write_mnist(root, n, seed):
    """IDX files in MNIST's layout: ``n`` seeded 28 x 28 uint8 images,
    each label the argmax of 10 seeded projections of its image."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    proj = rng.standard_normal((784, 10)).astype(np.float32)
    labels = np.argmax((images.reshape(n, -1) / 255.0) @ proj, 1).astype(
        np.uint8)
    img_p, lab_p = root / "images-idx3-ubyte.gz", root / "labels-idx1-ubyte.gz"
    with gzip.open(img_p, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with gzip.open(lab_p, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return str(img_p), str(lab_p), images, labels


def _loader(pk, paths):
    T = pk.vision.transforms
    train = pk.vision.datasets.MNIST(
        *paths, mode="train",
        transform=T.Normalize(mean=[127.5], std=[127.5], data_format="CHW"))
    dl = pk.io.DataLoader(train, batch_size=BATCH, shuffle=True)
    dl.set_state_dict({"version": 1, "epoch": 0, "cursor": 0,
                       "sampler": {"sampler": {"seed": SEED}}})
    return dl


def test_mnist_batches_match_and_three_adam_steps_agree(tmp_path):
    img_p, lab_p, images, labels = write_mnist(tmp_path, N, 0)
    jbatches = [(np.asarray(x.numpy()), np.asarray(y.numpy()))
                for x, y in _loader(jp, (img_p, lab_p))]
    tdl = _loader(tp, (img_p, lab_p))
    tbatches = list(iter(tdl))
    assert tdl.state_dict()["epoch"] == 1
    assert len(tbatches) == len(jbatches) == 4
    order = np.random.RandomState(SEED).permutation(N)
    for k, ((jx, jy), (tx, ty)) in enumerate(zip(jbatches, tbatches)):
        assert isinstance(tx, tp.Tensor) and tx.device.type == "cpu"
        idx = order[k * BATCH:(k + 1) * BATCH]
        np.testing.assert_array_equal(tx.numpy(), jx)
        np.testing.assert_array_equal(ty.numpy(), jy)
        np.testing.assert_array_equal(ty.numpy()[:, 0], labels[idx])
        np.testing.assert_array_equal(
            tx.numpy(), (images[idx, None].astype(np.float32) - 127.5) /
            127.5)
    assert tbatches[-1][0].shape == [N - 3 * BATCH, 1, 28, 28]

    jp.seed(1)
    jm = JLeNet()
    tm = TLeNet()
    tm.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in jm.functional_state().items()}, tm))
    losses = {}
    for name, pk, model, batches in (
            ("jax", jp, jm, [(jp.to_tensor(x), jp.to_tensor(y))
                             for x, y in jbatches]),
            ("port", tp, tm, tbatches)):
        opt = pk.optimizer.Adam(learning_rate=1e-3,
                                parameters=model.parameters())
        out = []
        for x, y in batches[:3]:
            loss = pk.nn.functional.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss.numpy()))
        losses[name] = out
    np.testing.assert_allclose(losses["port"], losses["jax"], **STEP_TOL)
    jstate = jm.functional_state()
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate[k]),
                                   err_msg=k, **STEP_TOL)
