"""The port's vision data path against the JAX package's, on the CPU:
``vision.transforms`` (functional and class transforms), the dataset
readers over files this test writes (CIFAR-10 / CIFAR-100 python-pickle
tar.gz, MNIST / FashionMNIST idx-gzip, image folders), and
``vision.ops`` (box utilities, ``nms``, ``read_file`` / ``decode_jpeg``,
also as registry ops with the ``vision_io.py`` ownership check).

The transforms are the reference's numpy code, so the same input (and,
for the random ones, the same ``random.seed`` / ``np.random.seed``) gives
the same pixels exactly; ``to_tensor`` / ``normalize`` on a ``Tensor``
within 1e-6. Samples read from the same files are equal. ``decode_jpeg``
needs PIL (its tests skip where PIL is missing).
"""

import gzip
import io
import os
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu.vision as jvision
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu_torch import vision as tvision
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.core.tensor import Tensor

JF, TF = jvision.transforms.functional, tvision.transforms.functional
JT, TT = jvision.transforms, tvision.transforms


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def image(h=20, w=24, c=3, seed=0, dtype=np.uint8):
    r = np.random.RandomState(seed)
    if dtype == np.uint8:
        return r.randint(0, 256, (h, w, c)).astype(np.uint8)
    return r.rand(h, w, c).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, JTensor):
        return np.asarray(x.numpy())
    return np.asarray(x)


# -- functional transforms ----------------------------------------------------

FUNCTIONAL = {
    "resize_short": ("resize", dict(size=16)),
    "resize_hw": ("resize", dict(size=(13, 31))),
    "resize_nearest": ("resize", dict(size=(9, 40), interpolation="nearest")),
    "pad_int": ("pad", dict(padding=3)),
    "pad_pair_fill": ("pad", dict(padding=(2, 5), fill=7)),
    "pad_reflect": ("pad", dict(padding=(1, 2, 3, 4),
                                padding_mode="reflect")),
    "pad_edge": ("pad", dict(padding=2, padding_mode="edge")),
    "pad_symmetric": ("pad", dict(padding=2, padding_mode="symmetric")),
    "crop": ("crop", dict(top=3, left=5, height=10, width=8)),
    "center_crop": ("center_crop", dict(output_size=11)),
    "hflip": ("hflip", {}),
    "vflip": ("vflip", {}),
    "brightness": ("adjust_brightness", dict(brightness_factor=1.4)),
    "contrast": ("adjust_contrast", dict(contrast_factor=0.6)),
    "saturation": ("adjust_saturation", dict(saturation_factor=1.7)),
    "hue": ("adjust_hue", dict(hue_factor=0.2)),
    "rotate": ("rotate", dict(angle=30)),
    "rotate_bilinear_expand": ("rotate", dict(angle=-47,
                                              interpolation="bilinear",
                                              expand=True, fill=3)),
    "grayscale": ("to_grayscale", {}),
    "grayscale3": ("to_grayscale", dict(num_output_channels=3)),
    "normalize": ("normalize", dict(mean=[120, 110, 100], std=[50, 60, 70],
                                    data_format="HWC")),
    "erase": ("erase", dict(i=2, j=3, h=5, w=6, v=0)),
}


@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "float32"])
@pytest.mark.parametrize("case", sorted(FUNCTIONAL))
def test_functional_transform_matches_reference(case, dtype):
    name, kw = FUNCTIONAL[case]
    img = image(dtype=dtype)
    got = getattr(TF, name)(img.copy(), **kw)
    want = getattr(JF, name)(img.copy(), **kw)
    assert _np(got).dtype == _np(want).dtype
    np.testing.assert_array_equal(_np(got), _np(want))


def test_to_tensor_and_tensor_normalize_match_reference():
    img = image()
    got = TF.to_tensor(img)
    want = JF.to_tensor(img)
    assert isinstance(got, Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
    mean, std = [0.5, 0.4, 0.3], [0.2, 0.25, 0.3]
    np.testing.assert_allclose(_np(TF.normalize(got, mean, std)),
                               _np(JF.normalize(want, mean, std)),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        _np(TF.erase(got, 1, 2, 3, 4, 0.5)), _np(JF.erase(want, 1, 2, 3, 4,
                                                          0.5)))
    assert float(got[0, 1, 2]) != 0.5            # erase leaves its input


# -- class transforms, seeded -------------------------------------------------

def _pipelines(T):
    return {
        "cifar": T.Compose([T.RandomCrop(32, padding=4),
                            T.RandomHorizontalFlip(),
                            T.Normalize(mean=[125.3, 123.0, 113.9],
                                        std=[63.0, 62.1, 66.7],
                                        data_format="HWC"),
                            T.Transpose()]),
        "imagenet": T.Compose([T.RandomResizedCrop(24),
                               T.RandomVerticalFlip(0.3),
                               T.ColorJitter(0.4, 0.4, 0.4, 0.1)]),
        "resize_center": T.Compose([T.Resize(40), T.CenterCrop(32),
                                    T.Pad((1, 2)), T.Grayscale(3)]),
        "rotation_erasing": T.Compose([T.RandomRotation(25),
                                       T.RandomErasing(prob=0.9,
                                                       value="random")]),
        "hue_contrast": T.Compose([T.HueTransform(0.3),
                                   T.ContrastTransform(0.5),
                                   T.SaturationTransform(0.5),
                                   T.BrightnessTransform(0.2)]),
    }


@pytest.mark.parametrize("name", sorted(_pipelines(TT)))
def test_seeded_pipeline_gives_the_references_pixels(name):
    img = image(32, 32)
    outs = []
    for T in (TT, JT):
        random.seed(11)
        np.random.seed(12)
        pipe = _pipelines(T)[name]
        outs.append([_np(pipe(img.copy())) for _ in range(4)])
    for got, want in zip(*outs):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_tuple_input_transforms_each_item():
    a, b = image(seed=1), image(seed=2)
    got = TT.Transpose()((a, b))
    assert isinstance(got, tuple)
    np.testing.assert_array_equal(got[1], b.transpose(2, 0, 1))


# -- datasets -----------------------------------------------------------------

def write_cifar(path, n_per_batch, batches, label_key="labels",
                flags=("data_batch", "test_batch"), classes=10, seed=0):
    """A CIFAR python-version tar.gz: ``batches`` training batches and one
    test batch of ``n_per_batch`` uint8 rows each."""
    r = np.random.RandomState(seed)
    with tarfile.open(path, "w:gz") as tar:
        names = [f"cifar/{flags[0]}_{i + 1}" for i in range(batches)] + \
            [f"cifar/{flags[1]}"]
        for name in names:
            batch = {b"data": r.randint(0, 256, (n_per_batch, 3072))
                     .astype(np.uint8),
                     label_key.encode(): list(
                         r.randint(0, classes, n_per_batch))}
            raw = pickle.dumps(batch)
            info = tarfile.TarInfo(name)
            info.size = len(raw)
            tar.addfile(info, io.BytesIO(raw))
    return path


def write_idx(dirname, n, seed=0):
    r = np.random.RandomState(seed)
    img = os.path.join(dirname, "images.gz")
    lab = os.path.join(dirname, "labels.gz")
    with gzip.open(img, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(r.randint(0, 256, (n, 28, 28)).astype(np.uint8).tobytes())
    with gzip.open(lab, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(r.randint(0, 10, n).astype(np.uint8).tobytes())
    return img, lab


def _same_samples(a, b, idx):
    assert len(a) == len(b)
    for i in idx:
        for x, y in zip(a[i], b[i]):
            np.testing.assert_array_equal(_np(x), _np(y))


@pytest.mark.parametrize("mode", ["train", "test"])
def test_cifar10_and_cifar100_read_as_the_reference(tmp_path, mode):
    p10 = write_cifar(str(tmp_path / "c10.tar.gz"), 7, 3)
    p100 = write_cifar(str(tmp_path / "c100.tar.gz"), 5, 1, "fine_labels",
                       ("train", "test"), classes=100, seed=1)
    norm = (TT.Normalize(127.5, 127.5, data_format="HWC"),
            JT.Normalize(127.5, 127.5, data_format="HWC"))
    for cls, path in (("Cifar10", p10), ("Cifar100", p100)):
        got = getattr(tvision.datasets, cls)(path, mode=mode,
                                             transform=norm[0])
        want = getattr(jvision.datasets, cls)(path, mode=mode,
                                              transform=norm[1])
        n_train = 21 if cls == "Cifar10" else 5       # 3 x 7, 1 x 5 rows
        n_test = 7 if cls == "Cifar10" else 5
        assert len(got) == (n_train if mode == "train" else n_test)
        _same_samples(got, want, range(len(got)))
        img, label = got[0]
        assert img.shape == (32, 32, 3) and label.dtype == np.int64


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_reads_as_the_reference(tmp_path, cls):
    img, lab = write_idx(str(tmp_path), 9)
    got = getattr(tvision.datasets, cls)(img, lab)
    want = getattr(jvision.datasets, cls)(img, lab)
    _same_samples(got, want, range(9))
    assert got[3][0].shape == (28, 28, 1)


def test_folders_read_as_the_reference(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image
    r = np.random.RandomState(3)
    for c in ("cat", "dog"):
        os.makedirs(tmp_path / c)
        for i in range(3):
            np.save(tmp_path / c / f"{i}.npy", r.rand(4, 5, 3)
                    .astype(np.float32))
        Image.fromarray(r.randint(0, 256, (6, 7, 3)).astype(np.uint8)) \
            .save(tmp_path / c / "x.png")
    (tmp_path / "cat" / "notes.txt").write_text("not an image")
    got = tvision.datasets.DatasetFolder(str(tmp_path))
    want = jvision.datasets.DatasetFolder(str(tmp_path))
    assert got.classes == want.classes == ["cat", "dog"]
    assert [s[1] for s in got.samples] == [s[1] for s in want.samples]
    _same_samples(got, want, range(len(got)))
    gi = tvision.datasets.ImageFolder(str(tmp_path))
    ji = jvision.datasets.ImageFolder(str(tmp_path))
    _same_samples(gi, ji, range(len(gi)))


def test_readers_never_download(tmp_path):
    missing = str(tmp_path / "nothing.tar.gz")
    for make in (lambda: tvision.datasets.Cifar10(missing, download=True),
                 lambda: tvision.datasets.MNIST(missing, missing)):
        with pytest.raises(RuntimeError, match="downloading is unavailable"):
            make()


def test_cifar_through_dataloader_workers(tmp_path):
    """``Cifar10`` with the chip run's transforms through two DataLoader
    worker processes: every image once, CHW float32."""
    from paddle_tpu_torch.io import DataLoader
    path = write_cifar(str(tmp_path / "c10.tar.gz"), 8, 2)
    ds = tvision.datasets.Cifar10(path, transform=_pipelines(TT)["cifar"])
    loader = DataLoader(ds, batch_size=4, shuffle=False, num_workers=2,
                        places="cpu")
    seen = [b for b in loader]
    assert len(seen) == 4
    assert tuple(seen[0][0].shape) == (4, 3, 32, 32)
    assert seen[0][0].dtype == torch.float32
    assert sorted(int(y) for b in seen for y in b[1]) == sorted(
        int(ds[i][1]) for i in range(16))


# -- vision.ops ---------------------------------------------------------------

def _boxes(n, seed=0):
    r = np.random.RandomState(seed)
    xy = r.uniform(0, 40, (n, 2))
    return np.concatenate([xy, xy + r.uniform(2, 20, (n, 2))], 1) \
        .astype(np.float32)


def test_box_area_and_iou_match_reference():
    a, b = _boxes(6), _boxes(4, seed=1)
    np.testing.assert_allclose(_np(tvision.ops.box_area(a)),
                               _np(jvision.ops.box_area(a)), rtol=1e-6)
    got = tvision.ops.box_iou(torch.from_numpy(a), torch.from_numpy(b))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(_np(got), _np(jvision.ops.box_iou(a, b)),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(top_k=5),
                                dict(category_idxs=True),
                                dict(category_idxs=True, categories=[2, 0])],
                         ids=["plain", "top_k", "categories", "some"])
def test_nms_matches_reference_with_stable_ties(kw):
    """Ties in score keep index order (a stable sort), per category too."""
    b = _boxes(30, seed=2)
    s = np.repeat(np.float32([0.9, 0.6, 0.3]), 10)
    kw = dict(kw)
    if kw.pop("category_idxs", None):
        kw["category_idxs"] = np.random.RandomState(3).randint(0, 3, 30)
    got = tvision.ops.nms(b, 0.3, scores=s, **kw)
    want = jvision.ops.nms(b, 0.3, scores=s, **kw)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert _np(got).dtype == np.int64


def test_read_file_and_decode_jpeg_match_reference(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image
    path = str(tmp_path / "x.jpg")
    Image.fromarray(image(16, 12)).save(path, quality=90)
    raw = tvision.ops.read_file(path)
    assert raw.dtype == torch.uint8 and raw.device.type == "cpu"
    np.testing.assert_array_equal(_np(raw), _np(jvision.ops.read_file(path)))
    for mode in ("unchanged", "gray", "rgb"):
        got = tvision.ops.decode_jpeg(raw, mode=mode)
        want = jvision.ops.decode_jpeg(jvision.ops.read_file(path),
                                       mode=mode)
        np.testing.assert_array_equal(_np(got), _np(want))
        assert got.shape[0] == (1 if mode == "gray" else 3)


@pytest.mark.parametrize("mode", ["unchanged", "gray", "rgb"])
def test_vision_io_ops_match_reference_through_the_registry(tmp_path, mode):
    """``read_file`` and ``decode_jpeg`` as registry ops
    (``tests/_torch_op_check.py``), and the module owns just these two."""
    pytest.importorskip("PIL")
    from PIL import Image
    from paddle_tpu_torch.ops import dispatcher as tdisp
    from paddle_tpu_torch.ops.kernels import vision_io
    from _torch_op_check import check_op
    owned = {n for n, k in tdisp.KERNELS.items()
             if k.__module__ == vision_io.__name__}
    assert owned == {"read_file", "decode_jpeg"}
    path = str(tmp_path / "x.jpg")
    Image.fromarray(image(10, 14)).save(path, quality=85)
    raw = check_op("read_file", [], dict(filename=path), atol=0, rtol=0)
    check_op("decode_jpeg", [raw.numpy()], dict(mode=mode), atol=0, rtol=0)


def test_deform_conv2d_raises_as_the_reference():
    with pytest.raises(NotImplementedError):
        tvision.ops.deform_conv2d()
