"""The port's ``vision.transforms`` and ``vision.datasets`` against the JAX
package's.

Transforms are numpy on the host in both packages and draw from Python's
``random`` in the same order: under one ``random.seed`` each gives the
same array bit for bit. Datasets read files the tests write in the
standard layouts (MNIST's IDX, gzipped and plain; CIFAR's tar of
pickles; a class-folder tree; Flowers' tgz and .mat files; VOC2012's
tar) and give the JAX package's items.
"""

import gzip
import io
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest

import paddle1_tpu as jp
import paddle1_tpu_torch as tp

JT, TT = jp.vision.transforms, tp.vision.transforms
JD, TD = jp.vision.datasets, tp.vision.datasets
MEAN, STD = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tp.device_guard("cpu"):
        yield


def _img(seed=0, h=37, w=45, c=3, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    return rng.random((h, w, c)).astype(dtype)


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


TRANSFORMS = [
    ("Resize_int", lambda T: T.Resize(24)),
    ("Resize_hw", lambda T: T.Resize((20, 30))),
    ("Resize_nearest", lambda T: T.Resize(24, interpolation="nearest")),
    ("RandomCrop", lambda T: T.RandomCrop(20)),
    ("RandomCrop_pad", lambda T: T.RandomCrop(48, padding=2,
                                              pad_if_needed=True)),
    ("CenterCrop", lambda T: T.CenterCrop((21, 17))),
    ("RandomHorizontalFlip", lambda T: T.RandomHorizontalFlip(0.5)),
    ("RandomVerticalFlip", lambda T: T.RandomVerticalFlip(0.5)),
    ("RandomResizedCrop", lambda T: T.RandomResizedCrop(24)),
    ("RandomResizedCrop_scale", lambda T: T.RandomResizedCrop(
        (16, 20), scale=(0.5, 0.9), ratio=(0.8, 1.2))),
    ("RandomRotation", lambda T: T.RandomRotation(30)),
    ("RandomRotation_expand", lambda T: T.RandomRotation(
        (-20, 40), expand=True)),
    ("ColorJitter", lambda T: T.ColorJitter(0.4, 0.4, 0.4, 0.1)),
    ("Grayscale", lambda T: T.Grayscale(3)),
    ("Pad", lambda T: T.Pad((1, 2, 3, 4))),
    ("Pad_reflect", lambda T: T.Pad(3, padding_mode="reflect")),
    ("Pad_edge", lambda T: T.Pad([2, 5], padding_mode="edge")),
    ("Transpose", lambda T: T.Transpose()),
    ("BrightnessTransform", lambda T: T.BrightnessTransform(0.5)),
    ("ContrastTransform", lambda T: T.ContrastTransform(0.5)),
    ("SaturationTransform", lambda T: T.SaturationTransform(0.5)),
    ("HueTransform", lambda T: T.HueTransform(0.2)),
    ("Normalize_hwc", lambda T: T.Normalize(MEAN, STD, data_format="HWC")),
    ("Normalize_rgb", lambda T: T.Normalize(MEAN, STD, data_format="HWC",
                                            to_rgb=True)),
    ("train_recipe", lambda T: T.Compose([
        T.RandomResizedCrop(32), T.RandomHorizontalFlip(), T.Transpose(),
        T.Normalize(mean=MEAN, std=STD, data_format="CHW")])),
    ("eval_recipe", lambda T: T.Compose([
        T.Resize(40), T.CenterCrop(32), T.Transpose(),
        T.Normalize(mean=MEAN, std=STD, data_format="CHW")])),
]


@pytest.mark.parametrize("make", [m for _, m in TRANSFORMS],
                         ids=[n for n, _ in TRANSFORMS])
@pytest.mark.parametrize("seed", [0, 7])
def test_transform_matches_the_jax_package_under_one_seed(make, seed):
    img = _img(seed)
    random.seed(seed)
    want = [make(JT)(img) for _ in range(3)]
    random.seed(seed)
    got = [make(TT)(img) for _ in range(3)]
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_every_transform_name_is_ported():
    assert sorted(TT.__all__) == sorted(JT.__all__)
    assert len(TT.__all__) == 20
    for name in TT.__all__:
        assert hasattr(TT, name)


@pytest.mark.parametrize("data_format", ["CHW", "HWC"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_to_tensor_matches_and_lands_on_the_current_place(data_format,
                                                          dtype):
    img = _img(3, 9, 7, dtype=dtype)
    got = TT.ToTensor(data_format)(img)
    want = JT.ToTensor(data_format)(img)
    assert isinstance(got, tp.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(TT.functional.to_tensor(
        img, data_format)), _np(want))


def test_normalize_of_a_tensor_returns_a_port_tensor():
    x = _img(4, 5, 6, dtype=np.float32).transpose(2, 0, 1)
    got = TT.functional.normalize(tp.to_tensor(x), [0.5] * 3, [0.25] * 3)
    want = JT.functional.normalize(jp.to_tensor(x), [0.5] * 3, [0.25] * 3)
    assert isinstance(got, tp.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=0)


def test_keyed_transforms_and_pil_input_match():
    Image = pytest.importorskip("PIL.Image")
    pil = Image.fromarray(_img(5))
    for T in (JT, TT):
        assert T.functional._as_hwc(pil).shape == (37, 45, 3)
    random.seed(1)
    want = JT.Compose([JT.Resize(20), JT.RandomCrop(16)])(pil)
    random.seed(1)
    got = TT.Compose([TT.Resize(20), TT.RandomCrop(16)])(pil)
    np.testing.assert_array_equal(_np(got), _np(want))
    pair = (_img(6), _img(7)[..., :1])
    random.seed(2)
    jw = JT.RandomHorizontalFlip(1.0, keys=("image", "mask"))(pair)
    random.seed(2)
    tw = TT.RandomHorizontalFlip(1.0, keys=("image", "mask"))(pair)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(_np(b), _np(a))


# ---------------------------------------------------------------------------
# datasets


def _items_equal(jds, tds):
    assert len(tds) == len(jds)
    for i in range(len(jds)):
        ji, ti = jds[i], tds[i]
        assert type(ti) is type(ji) and len(ti) == len(ji)
        for a, b in zip(ji, ti):
            a, b = _np(a), _np(b)
            assert b.dtype == a.dtype and b.shape == a.shape
            np.testing.assert_array_equal(b, a)


def _write_idx(path, images, labels, gz):
    opener = gzip.open if gz else open
    with opener(path[0], "wb") as f:
        f.write(struct.pack(">IIII", 2051, len(images), 28, 28))
        f.write(images.tobytes())
    with opener(path[1], "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)))
        f.write(labels.tobytes())


@pytest.mark.parametrize("gz", [True, False], ids=["gz", "plain"])
@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST"])
def test_mnist_files_give_the_jax_packages_items(tmp_path, gz, name):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (12, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 12).astype(np.uint8)
    ext = ".gz" if gz else ""
    paths = (str(tmp_path / f"img{ext}"), str(tmp_path / f"lab{ext}"))
    _write_idx(paths, images, labels, gz)
    for transform in (None, "normalize"):
        def make(D, T):
            tf = None if transform is None else T.Normalize(
                mean=[127.5], std=[127.5], data_format="CHW")
            return getattr(D, name)(*paths, mode="train", transform=tf)
        tds, jds = make(TD, TT), make(JD, JT)
        _items_equal(jds, tds)
    assert tds[0][0].shape == (1, 28, 28)


def _cifar_tar(path, n_classes, rng):
    """CIFAR-10's five-way training split (two of its files here) and test
    file, or CIFAR-100's ``train`` and ``test`` files."""
    key = b"labels" if n_classes == 10 else b"fine_labels"
    files = ((("data_batch_1", 5), ("data_batch_2", 3), ("test_batch", 4))
             if n_classes == 10 else (("train", 8), ("test", 4)))
    with tarfile.open(path, "w:gz") as tf:
        for name, n in files:
            batch = {b"data": rng.integers(0, 256, (n, 3072),
                                           dtype=np.uint8),
                     key: rng.integers(0, n_classes, n).tolist()}
            raw = pickle.dumps(batch)
            info = tarfile.TarInfo(f"cifar/{name}")
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))


@pytest.mark.parametrize("name,classes", [("Cifar10", 10),
                                          ("Cifar100", 100)])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_cifar_archives_give_the_jax_packages_items(tmp_path, name, classes,
                                                    mode):
    path = str(tmp_path / "cifar.tar.gz")
    _cifar_tar(path, classes, np.random.default_rng(1))
    tds = getattr(TD, name)(path, mode=mode, transform=TT.Transpose())
    jds = getattr(JD, name)(path, mode=mode, transform=JT.Transpose())
    _items_equal(jds, tds)
    assert len(tds) == (8 if mode == "train" else 4)


def test_fake_data_matches():
    tds = TD.FakeData(10, (3, 8, 6), 4, seed=3)
    jds = JD.FakeData(10, (3, 8, 6), 4, seed=3)
    _items_equal(jds, tds)


def _npy_tree(root, rng):
    for c in ("b_cls", "a_cls"):
        (root / c).mkdir()
        for i in range(3):
            np.save(root / c / f"{i}.npy",
                    rng.integers(0, 256, (9, 7, 3), dtype=np.uint8))
    (root / "a_cls" / "notes.txt").write_text("not an image")


def test_dataset_folder_and_image_folder_match(tmp_path):
    _npy_tree(tmp_path, np.random.default_rng(2))
    kw = dict(loader=np.load, extensions=(".npy",))
    tds = TD.DatasetFolder(str(tmp_path), transform=TT.Transpose(), **kw)
    jds = JD.DatasetFolder(str(tmp_path), transform=JT.Transpose(), **kw)
    assert tds.classes == jds.classes == ["a_cls", "b_cls"]
    assert tds.class_to_idx == jds.class_to_idx
    assert [(p, c) for p, c in tds.samples] == \
        [(p, c) for p, c in jds.samples]
    _items_equal(jds, tds)
    flat = TD.ImageFolder(str(tmp_path / "a_cls"), **kw)
    jflat = JD.ImageFolder(str(tmp_path / "a_cls"), **kw)
    _items_equal(jflat, flat)
    with pytest.raises(RuntimeError):
        TD.DatasetFolder(str(tmp_path / "a_cls"), **kw)


def test_every_dataset_name_is_ported_and_downloads_teach():
    assert sorted(TD.__all__) == sorted(JD.__all__)
    assert len(TD.__all__) == 10
    assert TD.IMG_EXTENSIONS == JD.IMG_EXTENSIONS
    for name in ("MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
                 "VOC2012"):
        with pytest.raises(RuntimeError) as te:
            getattr(TD, name)()
        with pytest.raises(RuntimeError) as je:
            getattr(JD, name)()
        assert str(te.value) == str(je.value)


def _encoded(arr, fmt):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def _tar_add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def test_flowers_matches(tmp_path):
    pytest.importorskip("PIL")
    sio = pytest.importorskip("scipy.io")
    rng = np.random.default_rng(3)
    data = tmp_path / "102flowers.tgz"
    with tarfile.open(data, "w:gz") as tf:
        for i in range(1, 6):
            _tar_add(tf, f"jpg/image_{i:05d}.jpg", _encoded(
                rng.integers(0, 256, (8, 10, 3), dtype=np.uint8), "JPEG"))
    sio.savemat(tmp_path / "labels.mat", {"labels": np.array([[5, 6, 7, 8,
                                                                  9]])})
    sio.savemat(tmp_path / "setid.mat", {"trnid": np.array([[1, 3, 5]]),
                                         "valid": np.array([[2]]),
                                         "tstid": np.array([[4]])})
    args = (str(data), str(tmp_path / "labels.mat"),
            str(tmp_path / "setid.mat"))
    for mode in ("train", "valid", "test"):
        _items_equal(JD.Flowers(*args, mode=mode, transform=JT.Resize(6)),
                     TD.Flowers(*args, mode=mode, transform=TT.Resize(6)))


def test_voc2012_matches(tmp_path):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(4)
    p = tmp_path / "voc.tar"
    root = "VOCdevkit/VOC2012"
    with tarfile.open(p, "w") as tf:
        _tar_add(tf, f"{root}/ImageSets/Segmentation/train.txt", b"a\nb\n")
        _tar_add(tf, f"{root}/ImageSets/Segmentation/val.txt", b"c\n")
        for n in "abc":
            _tar_add(tf, f"{root}/JPEGImages/{n}.jpg", _encoded(
                rng.integers(0, 256, (6, 9, 3), dtype=np.uint8), "JPEG"))
            _tar_add(tf, f"{root}/SegmentationClass/{n}.png", _encoded(
                rng.integers(0, 21, (6, 9), dtype=np.uint8), "PNG"))
    for mode in ("train", "val"):
        _items_equal(JD.VOC2012(str(p), mode=mode),
                     TD.VOC2012(str(p), mode=mode))


def _positional(fn):
    import inspect
    return [n for n, p in inspect.signature(fn).parameters.items()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


@pytest.mark.parametrize("name", sorted(n for n in JT.__all__
                                        if n != "functional"))
def test_every_transform_takes_the_jax_packages_positions(name):
    assert _positional(getattr(TT, name)) == _positional(getattr(JT, name))


@pytest.mark.parametrize("name", sorted(n for n in vars(JT.functional)
                                        if not n.startswith("_") and
                                        callable(vars(JT.functional)[n]) and
                                        vars(JT.functional)[n].__module__ ==
                                        JT.functional.__name__))
def test_every_functional_takes_the_jax_packages_positions(name):
    assert _positional(getattr(TT.functional, name)) == \
        _positional(getattr(JT.functional, name))


@pytest.mark.parametrize("name", sorted(n for n in JD.__all__
                                        if n != "IMG_EXTENSIONS"))
def test_every_dataset_takes_the_jax_packages_positions(name):
    assert _positional(getattr(TD, name)) == _positional(getattr(JD, name))
