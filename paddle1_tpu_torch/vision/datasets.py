"""Builtin vision datasets (reference python/paddle/vision/datasets/:
MNIST, FashionMNIST, Cifar10/100, Flowers, VOC2012, DatasetFolder,
ImageFolder). Port of ``paddle1_tpu/vision/datasets.py``, host code over
local files, unchanged: ``download=True`` raises with instructions (no
network egress); parsers read the standard archive formats from
``data_file``/``image_path`` like the reference. PIL and ``scipy.io`` are
imported only where an image file or a ``.mat`` file is decoded (the
default folder loader, ``Flowers``, ``VOC2012``). ``FakeData`` provides
deterministic synthetic images so examples and tests run hermetically."""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "FakeData"]


def _no_download(name):
    raise RuntimeError(
        f"{name}: automatic download is unavailable (no network egress). "
        "Place the official archive locally and pass its path "
        "(image_path/label_path or data_file).")


class MNIST(Dataset):
    """IDX-format parser (reference vision/datasets/mnist.py)."""

    NAME = "MNIST"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="cv2"):
        self.mode = mode.lower()
        self.transform = transform
        if image_path is None or label_path is None:
            _no_download(self.NAME)
        self.images = self._parse_images(image_path)
        self.labels = self._parse_labels(label_path)

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else \
            open(path, "rb")

    def _parse_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            assert magic == 2051, f"bad MNIST image magic {magic}"
            data = np.frombuffer(f.read(n * rows * cols), np.uint8)
            return data.reshape(n, rows, cols)

    def _parse_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            assert magic == 2049, f"bad MNIST label magic {magic}"
            return np.frombuffer(f.read(n), np.uint8).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([label], np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    NAME = "FashionMNIST"


class Cifar10(Dataset):
    """cifar-10-python.tar.gz parser (reference vision/datasets/cifar.py)."""

    NAME = "Cifar10"
    _SUB = {"train": "data_batch", "test": "test_batch"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2"):
        self.mode = mode.lower()
        self.transform = transform
        if data_file is None:
            _no_download(self.NAME)
        self.data = []
        with tarfile.open(data_file, "r:*") as tf:
            names = [n for n in tf.getnames()
                     if self._SUB[self.mode] in n]
            for name in sorted(names):
                batch = pickle.load(tf.extractfile(name), encoding="bytes")
                images = batch[b"data"].reshape(-1, 3, 32, 32)
                labels = batch.get(b"labels", batch.get(b"fine_labels"))
                for img, lab in zip(images, labels):
                    self.data.append((img, lab))

    def __getitem__(self, idx):
        img, label = self.data[idx]
        img = img.transpose(1, 2, 0)  # HWC for transforms
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([label], np.int64)

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    NAME = "Cifar100"
    _SUB = {"train": "train", "test": "test"}


class FakeData(Dataset):
    """Deterministic synthetic image classification data (hermetic tests)."""

    def __init__(self, num_samples=256, image_shape=(3, 32, 32),
                 num_classes=10, transform=None, seed=0):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self._rng = np.random.default_rng(seed)
        self._images = self._rng.integers(
            0, 256, (num_samples,) + self.image_shape[1:] +
            (self.image_shape[0],), dtype=np.uint8)
        self._labels = self._rng.integers(0, num_classes, num_samples)

    def __getitem__(self, idx):
        img = self._images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([self._labels[idx]], np.int64)

    def __len__(self):
        return self.num_samples


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def _pil_loader(path):
    from PIL import Image
    with open(path, "rb") as f:
        img = Image.open(f)
        return img.convert("RGB")


def _extension_checker(extensions, is_valid_file):
    """One place to normalize the extension filter for both folder
    datasets. Returns (checker, normalized_extensions_or_None) — None
    when a custom is_valid_file decides (extensions never consulted).
    A lone string must NOT go through tuple(): tuple('.png') is
    ('.', 'p', 'n', 'g') and matches nearly everything."""
    if is_valid_file is not None:
        return is_valid_file, None
    if extensions is None:
        exts = IMG_EXTENSIONS
    elif isinstance(extensions, str):
        exts = (extensions,)
    else:
        exts = tuple(extensions)

    def check(p):
        return p.lower().endswith(exts)
    return check, exts


class DatasetFolder(Dataset):
    """Class-per-subdirectory image tree (reference vision/datasets/
    folder.py:65): root/class_x/xxx.png → (sample, class_index)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _pil_loader
        is_valid_file, exts = _extension_checker(extensions, is_valid_file)
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise RuntimeError(f"no class folders under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for sub, _, files in sorted(os.walk(cdir)):
                for fn in sorted(files):
                    p = os.path.join(sub, fn)
                    if is_valid_file(p):
                        self.samples.append((p, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(
                f"found 0 files in subfolders of {root}; "
                + (f"supported extensions: {exts}" if exts is not None
                   else "the custom is_valid_file accepted nothing"))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat/recursive unlabeled image folder (reference folder.py:222):
    yields [sample] per image."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _pil_loader
        is_valid_file, _ = _extension_checker(extensions, is_valid_file)
        self.samples = []
        for sub, _, files in sorted(os.walk(root)):
            for fn in sorted(files):
                p = os.path.join(sub, fn)
                if is_valid_file(p):
                    self.samples.append(p)
        if not self.samples:
            raise RuntimeError(f"found 0 images under {root}")

    def __getitem__(self, idx):
        sample = self.loader(self.samples[idx])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)


class Flowers(Dataset):
    """Oxford 102 Flowers (reference vision/datasets/flowers.py):
    102flowers.tgz image archive + imagelabels.mat + setid.mat; the
    split comes from setid's trnid/valid/tstid index lists (1-based)."""

    _SETID_KEY = {"train": "trnid", "valid": "valid", "test": "tstid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None):
        if None in (data_file, label_file, setid_file):
            _no_download("Flowers")
        if mode not in self._SETID_KEY:
            raise ValueError("mode must be train/valid/test")
        import scipy.io as sio
        self.transform = transform
        labels = sio.loadmat(label_file)["labels"].reshape(-1)
        indexes = sio.loadmat(setid_file)[
            self._SETID_KEY[mode]].reshape(-1)
        wanted = {f"jpg/image_{int(i):05d}.jpg": int(i) for i in indexes}
        # one sequential pass over the archive, keeping the COMPRESSED
        # jpeg bytes per sample: picklable for DataLoader workers, no
        # shared fd, no per-__getitem__ gzip rewind (a .tgz member seek
        # re-decompresses from the stream start)
        self.samples = []
        with tarfile.open(data_file) as tar:
            for m in tar:
                i = wanted.get(m.name)
                if i is not None:
                    self.samples.append((tar.extractfile(m).read(),
                                         int(labels[i - 1])))

    def __getitem__(self, idx):
        from PIL import Image
        import io as _io
        raw, label = self.samples[idx]
        img = Image.open(_io.BytesIO(raw)).convert("RGB")
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([label], np.int64)

    def __len__(self):
        return len(self.samples)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation pairs (reference vision/datasets/
    voc2012.py): the trainval archive's ImageSets/Segmentation lists
    select JPEGImages/x.jpg + SegmentationClass/x.png; yields
    (image HWC uint8 array, label mask HW uint8 array)."""

    _ROOT = "VOCdevkit/VOC2012"

    def __init__(self, data_file=None, mode="train", transform=None):
        if data_file is None:
            _no_download("VOC2012")
        if mode not in ("train", "val", "trainval"):
            raise ValueError("mode must be train/val/trainval")
        self.transform = transform
        with tarfile.open(data_file) as tar:
            listing = tar.extractfile(
                f"{self._ROOT}/ImageSets/Segmentation/{mode}.txt")
            names = [ln.strip() for ln in
                     listing.read().decode().splitlines() if ln.strip()]
            blobs = {}
            want = set()
            for n in names:
                want.add(f"{self._ROOT}/JPEGImages/{n}.jpg")
                want.add(f"{self._ROOT}/SegmentationClass/{n}.png")
            for m in tar:
                if m.name in want:
                    blobs[m.name] = tar.extractfile(m).read()
        # compressed bytes in memory (see Flowers): worker-safe + one pass
        self.samples = []
        for n in names:
            jpg = blobs.get(f"{self._ROOT}/JPEGImages/{n}.jpg")
            png = blobs.get(f"{self._ROOT}/SegmentationClass/{n}.png")
            if jpg is not None and png is not None:
                self.samples.append((jpg, png))

    def __getitem__(self, idx):
        from PIL import Image
        import io as _io
        jpg, png = self.samples[idx]
        image = np.asarray(Image.open(_io.BytesIO(jpg)).convert("RGB"))
        label = np.asarray(Image.open(_io.BytesIO(png)))
        if self.transform is not None:
            image = self.transform(image)
        return image, label

    def __len__(self):
        return len(self.samples)


__all__ += ["DatasetFolder", "ImageFolder", "Flowers", "VOC2012",
            "IMG_EXTENSIONS"]
