"""``paddle_tpu_torch.audio`` against ``paddle_tpu.audio``, on the CPU:
every registered window (periodic and symmetric, with parameters), the
mel scale, the filter bank, the DCT and ``power_to_db``; the four
feature layers on the same seeded waveforms; a wave ``save`` / ``load``
round trip; and ``ESC50`` and ``TESS`` over small files the test writes.

Tolerances: the windows within 1e-6 (the port computes the numpy ones in
float64, the reference some in float32); the filter bank 1e-5 (HTK's
``10 ** (m / 2595)`` in float32 differs by ulps that the ramps amplify),
the DCT 1e-6;
the spectra relative 1e-5 of their largest value; decibels 1e-3 dB where
the power exceeds 1e3 * amin (below it the log amplifies rounding);
MFCCs 1e-3.
"""

import csv
import os

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.core.tensor import Tensor as RTensor
from paddle_tpu_torch import audio
from paddle_tpu_torch.audio import functional as F
from paddle_tpu_torch.core.device import set_device
import paddle_tpu.audio.functional as RF

SR = 8000


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def _wave(b=2, t=4000, seed=0):
    r = np.random.RandomState(seed)
    tt = np.arange(t) / SR
    w = 0.5 * np.sin(2 * np.pi * r.uniform(100, 1000, (b, 1)) * tt) + \
        0.1 * r.randn(b, t)
    return w.astype(np.float32)


WINDOWS = [("hann",), ("hamming",), ("blackman",), ("rect",), ("bartlett",),
           ("kaiser",), ("kaiser", 5.0), ("gaussian",), ("gaussian", 3.0),
           ("general_gaussian",), ("general_gaussian", 1.5, 5.0),
           ("general_cosine",), ("general_cosine", (0.4, 0.4, 0.2)),
           ("general_hamming",), ("general_hamming", 0.6), ("triang",),
           ("bohman",), ("cosine",), ("tukey",), ("tukey", 0.0),
           ("tukey", 1.0), ("exponential",), ("exponential", None, 2.0),
           ("taylor",), ("taylor", 5, 40)]


def test_every_registered_window_is_covered():
    assert sorted(F._WINDOWS) == sorted(RF._WINDOWS)
    assert {w[0] for w in WINDOWS} == set(F._WINDOWS)
    assert len(F._WINDOWS) == 16


@pytest.mark.parametrize("spec", WINDOWS, ids=lambda s: "_".join(map(str, s)))
@pytest.mark.parametrize("n,fftbins", [(32, True), (33, False)])
def test_window(spec, n, fftbins):
    win = spec if len(spec) > 1 else spec[0]
    got = F.get_window(win, n, fftbins=fftbins)
    want = RF.get_window(win, n, fftbins=fftbins).numpy()
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_unknown_window_raises():
    with pytest.raises(ValueError):
        F.get_window("nope", 8)


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scale(htk):
    for f in (0.0, 440.0, 1000.0, 7999.0):
        assert abs(F.hz_to_mel(f, htk) - RF.hz_to_mel(f, htk)) < 1e-4
        m = F.hz_to_mel(f, htk)
        assert abs(F.mel_to_hz(m, htk) - RF.mel_to_hz(m, htk)) < 1e-2
    f = np.linspace(0, 8000, 17).astype(np.float32)
    np.testing.assert_allclose(
        F.hz_to_mel(torch.from_numpy(f), htk).numpy(),
        RF.hz_to_mel(RTensor(f), htk).numpy(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        F.mel_frequencies(10, 20.0, 4000.0, htk).numpy(),
        RF.mel_frequencies(10, 20.0, 4000.0, htk).numpy(), rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(htk=True, norm=None),
                                dict(f_min=50.0, f_max=3000.0)])
def test_fbank(kw):
    got = F.compute_fbank_matrix(SR, 256, 24, **kw)
    want = RF.compute_fbank_matrix(SR, 256, 24, **kw).numpy()
    assert got.shape == (24, 129)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("norm", ["ortho", None])
def test_dct(norm):
    np.testing.assert_allclose(F.create_dct(13, 24, norm).numpy(),
                               RF.create_dct(13, 24, norm).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("top_db", [None, 40.0])
def test_power_to_db(top_db):
    x = np.abs(np.random.RandomState(1).randn(3, 20)).astype(np.float32)
    x[0, :3] = 0.0
    got = F.power_to_db(torch.from_numpy(x), 2.0, 1e-6, top_db)
    want = RF.power_to_db(RTensor(x), 2.0, 1e-6, top_db).numpy()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def _layers(mod):
    kw = dict(n_fft=256, hop_length=64, n_mels=24, f_min=20.0)
    return {
        "spectrogram": mod.Spectrogram(n_fft=256, hop_length=64),
        "spectrogram_power1": mod.Spectrogram(n_fft=256, win_length=200,
                                              window="hamming", power=1.0),
        "melspectrogram": mod.MelSpectrogram(sr=SR, **kw),
        "logmelspectrogram": mod.LogMelSpectrogram(sr=SR, **kw),
        "logmel_top_db": mod.LogMelSpectrogram(sr=SR, top_db=60.0, **kw),
        "mfcc": mod.MFCC(sr=SR, n_mfcc=13, **kw),
    }


def _db_close(got, want, amin=1e-10):
    big = want > 10 * np.log10(1e3 * amin)
    np.testing.assert_allclose(got[big], want[big], atol=1e-3, rtol=0)


LAYERS = ("spectrogram", "spectrogram_power1", "melspectrogram",
          "logmelspectrogram", "logmel_top_db", "mfcc")


@pytest.mark.parametrize("name", LAYERS)
def test_feature_layer(name):
    x = _wave()
    got = _layers(audio.features)[name](torch.from_numpy(x)).numpy()
    want = _layers(paddle_tpu.audio.features)[name](RTensor(x)).numpy()
    assert got.shape == want.shape
    if name.startswith("log"):
        _db_close(got, want)
    elif name == "mfcc":
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_feature_layer_buffers_move_with_the_layer():
    layer = audio.MFCC(sr=SR, n_mfcc=13, n_fft=256, n_mels=24)
    names = {n for n, _ in layer.named_buffers()}
    assert {"dct", "log_mel.mel.fbank",
            "log_mel.mel.spectrogram.fft_window"} <= names
    layer = layer.to(torch.float64)
    assert layer.dct.dtype == torch.float64


def test_paddle_in_paddle_out():
    import paddle_tpu_torch as P
    out = audio.Spectrogram(n_fft=128)(P.to_tensor(_wave()))
    assert isinstance(out, P.Tensor)


def test_wave_round_trip(tmp_path):
    x = np.clip(_wave(2, 1000), -1, 1)
    path = str(tmp_path / "a.wav")
    audio.save(path, torch.from_numpy(x), SR)
    info = audio.info(path)
    assert (info.sample_rate, info.num_samples, info.num_channels,
            info.bits_per_sample) == (SR, 1000, 2, 16)
    y, sr = audio.load(path)
    assert sr == SR and y.shape == (2, 1000) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), x, atol=1.0 / 2 ** 15)
    ry, _ = paddle_tpu.audio.load(path)
    np.testing.assert_array_equal(y.numpy(), ry.numpy())
    seg, _ = audio.load(path, frame_offset=100, num_frames=50,
                        normalize=False, channels_first=False)
    np.testing.assert_array_equal(seg.numpy(),
                                  np.round(y.numpy().T[100:150] * 2 ** 15))
    assert audio.backends.get_current_backend() == "wave"
    assert audio.backends.list_available_backends() == \
        paddle_tpu.audio.backends.list_available_backends()


def _write_esc50(root, classes=5, folds=2, sr=SR, seconds=0.25):
    os.makedirs(os.path.join(root, "meta"))
    os.makedirs(os.path.join(root, "audio"))
    rows = [["filename", "fold", "target", "category", "esc10", "src_file",
             "take"]]
    r = np.random.RandomState(0)
    for c in range(classes):
        for f in range(1, folds + 1):
            name = f"{f}-{c}-A-{c}.wav"
            wave = (0.3 * r.randn(1, int(sr * seconds))).clip(-1, 1)
            audio.save(os.path.join(root, "audio", name),
                       torch.from_numpy(wave.astype(np.float32)), sr)
            rows.append([name, str(f), str(c), f"class{c}", "False",
                         str(c), "A"])
    with open(os.path.join(root, "meta", "esc50.csv"), "w",
              newline="") as fh:
        csv.writer(fh).writerows(rows)


@pytest.mark.parametrize("feat", ["raw", "logmelspectrogram", "mfcc"])
def test_esc50(tmp_path, feat):
    root = str(tmp_path / "ESC-50-master")
    _write_esc50(root)
    kw = {} if feat == "raw" else dict(n_fft=256, hop_length=64, n_mels=24)
    ds = audio.datasets.ESC50(mode="train", split=1, feat_type=feat,
                              data_dir=root, device="cpu", **kw)
    ref = paddle_tpu.audio.datasets.ESC50(mode="train", split=1,
                                          feat_type=feat, data_dir=root,
                                          **kw)
    assert len(ds) == len(ref) == 5
    assert ds.files == ref.files and ds.labels == ref.labels
    test = audio.datasets.ESC50(mode="dev", split=1, data_dir=root,
                                device="cpu")
    assert len(test) == 5
    for i in range(len(ds)):
        (got, lbl), (want, rlbl) = ds[i], ref[i]
        assert lbl == rlbl and got.shape == tuple(want.shape)
        if feat == "raw":
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        elif feat == "mfcc":
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)
        else:
            _db_close(got.numpy(), want.numpy())


def test_esc50_loader_batches_match_single_clips(tmp_path):
    from paddle_tpu_torch import io
    root = str(tmp_path / "ESC-50-master")
    _write_esc50(root)
    kw = dict(n_fft=256, hop_length=64, n_mels=24)
    ds = audio.datasets.ESC50(mode="train", split=2,
                              feat_type="logmelspectrogram", data_dir=root,
                              device="cpu", **kw)
    loader = io.DataLoader(ds, batch_size=2, shuffle=False, places="cpu")
    layer = audio.LogMelSpectrogram(sr=SR, **kw)
    i = 0
    for feats, labels in loader:
        for f, lbl in zip(feats, labels):
            wave, _ = audio.load(ds.files[i])
            np.testing.assert_allclose(f.numpy(), layer(wave)[0].numpy(),
                                       atol=1e-5)
            assert int(lbl) == ds.labels[i]
            i += 1
    assert i == len(ds)


def test_card_features_refuse_a_worker_process(tmp_path, monkeypatch):
    """A dataset computing features on the card raises in a DataLoader
    worker instead of moving the work to the CPU."""
    import multiprocessing as mp
    root = str(tmp_path / "ESC-50-master")
    _write_esc50(root, classes=1, folds=2)
    ds = audio.datasets.ESC50(mode="train", split=1, data_dir=root,
                              feat_type="mfcc", device="cpu")
    ds.device = torch.device("cuda")
    monkeypatch.setattr(mp, "parent_process", lambda: object())
    with pytest.raises(RuntimeError, match="worker process"):
        ds[0]
    raw = audio.datasets.ESC50(mode="train", split=1, data_dir=root,
                               device="cpu")
    assert raw[0][0].shape == (int(SR * 0.25),)


def test_tess(tmp_path):
    root = tmp_path / "TESS_Toronto_emotional_speech_set" / "OAF"
    root.mkdir(parents=True)
    r = np.random.RandomState(1)
    for i, emo in enumerate(["angry", "disgust", "fear", "happy", "neutral",
                             "ps", "sad", "angry", "sad", "calm"]):
        audio.save(str(root / f"OAF_w{i}_{emo}.wav"), torch.from_numpy(
            (0.2 * r.randn(1, 800)).astype(np.float32)), SR)
    for mode in ("train", "dev"):
        ds = audio.datasets.TESS(mode=mode, n_folds=3, split=2,
                                 data_dir=str(tmp_path), device="cpu",
                                 feat_type="melspectrogram", n_fft=128,
                                 n_mels=16)
        ref = paddle_tpu.audio.datasets.TESS(mode=mode, n_folds=3, split=2,
                                             data_dir=str(tmp_path),
                                             feat_type="melspectrogram",
                                             n_fft=128, n_mels=16)
        assert ds.labels == ref.labels and len(ds) == len(ref)
        got, want = ds[0][0].numpy(), ref[0][0].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError):
        audio.datasets.TESS(split=4, n_folds=3, data_dir=str(tmp_path))


def test_local_files_only():
    with pytest.raises(RuntimeError):
        audio.datasets.ESC50(data_dir=None)
