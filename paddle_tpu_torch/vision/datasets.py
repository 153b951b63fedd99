"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets.py``):
``Cifar10`` / ``Cifar100`` read the python-version tar.gz (pickled batches
of ``data`` ``[N, 3072]`` uint8 CHW rows and their labels), ``MNIST`` /
``FashionMNIST`` the idx-gzip files, ``DatasetFolder`` / ``ImageFolder`` a
directory of images (``.npy``, or any format PIL opens). Each reads local
files only: a missing file raises (``require_local_file``), whatever
``download`` says. Samples are numpy arrays (HWC images, int64 labels),
for the transforms and a DataLoader's workers.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["Cifar10", "Cifar100", "MNIST", "FashionMNIST", "DatasetFolder",
           "ImageFolder"]

_HOME = os.path.expanduser("~/.cache/paddle_tpu/dataset")


def require_local_file(path, name, arg="data_file"):
    """``path`` if it exists; else the error that downloading is not
    available."""
    if path is None or not os.path.exists(path):
        raise RuntimeError(
            f"{name}: {arg} {path!r} not found and downloading is "
            f"unavailable; place the data locally and pass {arg}=")
    return path


def _require(path, name):
    return require_local_file(path, name, arg="data_file")


class Cifar10(Dataset):
    """CIFAR-10 from the python-version tar.gz (batches of pickled dicts
    with 'data' (N,3072 uint8 row-major CHW) and 'labels')."""

    MODE_FLAG = "data_batch"
    TEST_FLAG = "test_batch"
    LABEL_KEY = "labels"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2"):
        assert mode in ("train", "test"), mode
        if data_file is None and download:
            cand = os.path.join(_HOME, "cifar-10-python.tar.gz")
            data_file = cand if os.path.exists(cand) else data_file
        self.data_file = _require(data_file, type(self).__name__)
        self.mode = mode
        self.transform = transform
        self.backend = backend
        self.data = []
        self._load_data()

    def _load_data(self):
        flag = self.MODE_FLAG if self.mode == "train" else self.TEST_FLAG
        with tarfile.open(self.data_file, mode="r") as f:
            names = [n for n in f.getnames() if flag in n]
            names.sort()
            for name in names:
                batch = pickle.load(f.extractfile(name), encoding="bytes")
                data = batch[b"data"]
                labels = batch.get(self.LABEL_KEY.encode())
                if labels is None:
                    labels = batch[b"fine_labels"]
                for x, y in zip(data, labels):
                    self.data.append((x, int(y)))

    def __getitem__(self, idx):
        image, label = self.data[idx]
        image = np.reshape(image, [3, 32, 32]).transpose(1, 2, 0)  # HWC
        if self.transform is not None:
            image = self.transform(image)
        return image, np.array(label).astype("int64")

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    MODE_FLAG = "train"
    TEST_FLAG = "test"
    LABEL_KEY = "fine_labels"


def _read_idx_images(path):
    with gzip.open(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad idx3 magic {magic}"
        buf = f.read(n * rows * cols)
    return np.frombuffer(buf, dtype=np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path):
    with gzip.open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad idx1 magic {magic}"
        buf = f.read(n)
    return np.frombuffer(buf, dtype=np.uint8).astype("int64")


class MNIST(Dataset):
    """MNIST/FashionMNIST from idx-gzip files (image_path/label_path)."""

    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="cv2"):
        assert mode in ("train", "test"), mode
        base = os.path.join(_HOME, self.NAME)
        stem = "train" if mode == "train" else "t10k"
        if image_path is None:
            image_path = os.path.join(base, f"{stem}-images-idx3-ubyte.gz")
        if label_path is None:
            label_path = os.path.join(base, f"{stem}-labels-idx1-ubyte.gz")
        self.image_path = _require(image_path, type(self).__name__)
        self.label_path = _require(label_path, type(self).__name__)
        self.mode = mode
        self.transform = transform
        self.backend = backend
        self.images = _read_idx_images(self.image_path)
        self.labels = _read_idx_labels(self.label_path)

    def __getitem__(self, idx):
        image = self.images[idx][..., None]  # HW1
        label = self.labels[idx]
        if self.transform is not None:
            image = self.transform(image)
        return image, np.array(label).astype("int64")

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"


_IMG_EXTENSIONS = (".npy", ".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".webp")


def _default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except ImportError as e:
        raise RuntimeError(
            f"loading {path} needs PIL; save images as .npy instead") from e


def has_valid_extension(filename, extensions):
    return filename.lower().endswith(tuple(extensions))


def make_dataset(directory, class_to_idx, extensions, is_valid_file=None):
    if is_valid_file is None:
        is_valid_file = lambda p: has_valid_extension(p, extensions)
    samples = []
    for target in sorted(class_to_idx):
        d = os.path.join(directory, target)
        if not os.path.isdir(d):
            continue
        for root, _, fnames in sorted(os.walk(d, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(root, fname)
                if is_valid_file(path):
                    samples.append((path, class_to_idx[target]))
    return samples


class DatasetFolder(Dataset):
    """root/class_x/xxx.ext layout (reference folder.py:DatasetFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        extensions = extensions or _IMG_EXTENSIONS
        classes = sorted(e.name for e in os.scandir(root) if e.is_dir())
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = make_dataset(root, self.class_to_idx, extensions,
                                    is_valid_file)
        if not self.samples:
            raise RuntimeError(f"found 0 files in subfolders of {root}")
        self.targets = [s[1] for s in self.samples]

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat folder of images, no labels (reference folder.py:ImageFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        extensions = extensions or _IMG_EXTENSIONS
        self.samples = []
        for r, _, fnames in sorted(os.walk(root, followlinks=True)):
            for fname in sorted(fnames):
                if has_valid_extension(fname, extensions):
                    self.samples.append(os.path.join(r, fname))
        if not self.samples:
            raise RuntimeError(f"found 0 files in {root}")

    def __getitem__(self, idx):
        sample = self.loader(self.samples[idx])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)
