"""Audio classification datasets: ``AudioClassificationDataset``,
``ESC50`` and ``TESS``.

Counterpart of ``paddle_tpu/audio/datasets.py`` (Paddle's
``audio/datasets/``). Each reads an extracted local directory only
(``data_dir``): a missing one raises. ``feat_type`` selects the raw
waveform or a feature layer of ``features`` built for the file's sample
rate.

The features are computed on ``device`` (None: the port's current device,
the card unless the caller chose the CPU) and returned there. A feature
layer on the card cannot run in a DataLoader's worker process: such a
dataset raises there rather than move the work to the CPU, so give it
``num_workers=0``, or ``device="cpu"`` for workers.
"""

from __future__ import annotations

import collections
import csv
import multiprocessing as mp
import os
from typing import List, Optional, Tuple

import torch

from ..core.device import DeviceLike, get_device, resolve_device
from ..io import Dataset
from ..vision.datasets import require_local_file
from . import features
from .backends import load as _load_audio

__all__ = ["AudioClassificationDataset", "ESC50", "TESS"]

# feat_type -> feature layer (None: the raw waveform)
_FEAT_CLASSES = {
    "raw": None,
    "spectrogram": features.Spectrogram,
    "melspectrogram": features.MelSpectrogram,
    "logmelspectrogram": features.LogMelSpectrogram,
    "mfcc": features.MFCC,
}


class AudioClassificationDataset(Dataset):
    """``(files, labels)`` -> ``(feature, label)`` pairs: the mono waveform
    of each file through the ``feat_type`` layer (``feat_config`` its
    arguments), float32 ``[n, frames]`` on ``device``."""

    def __init__(self, files: List[str], labels: List[int],
                 feat_type: str = "raw", sample_rate: Optional[int] = None,
                 device: DeviceLike = None, **feat_config):
        super().__init__()
        if feat_type not in _FEAT_CLASSES:
            raise RuntimeError(f"Unknown feat_type: {feat_type}, must be one "
                               f"of {sorted(_FEAT_CLASSES)}")
        self.files = files
        self.labels = labels
        self.feat_type = feat_type
        self.sample_rate = sample_rate
        self.feat_config = feat_config
        self.device = resolve_device(device if device is not None
                                     else get_device())
        self._extractor = None  # built at the first file's sample rate

    def _get_extractor(self, sample_rate: int):
        feat_cls = _FEAT_CLASSES[self.feat_type]
        if feat_cls is None:
            return None
        if self._extractor is None or self.sample_rate != sample_rate:
            self.sample_rate = sample_rate
            kw = self.feat_config if self.feat_type == "spectrogram" else \
                dict(sr=sample_rate, **self.feat_config)
            self._extractor = feat_cls(**kw).to(self.device)
        return self._extractor

    def _convert_to_record(self, idx: int):
        if self.feat_type != "raw" and self.device.type == "cuda" and \
                mp.parent_process() is not None:
            raise RuntimeError(
                "audio features on the card cannot be computed in a "
                "DataLoader worker process: use num_workers=0, or "
                "device='cpu' for the dataset")
        waveform, sample_rate = _load_audio(self.files[idx])
        wave = waveform[0] if waveform.dim() == 2 else waveform
        extractor = self._get_extractor(sample_rate)
        if extractor is None:
            self.sample_rate = sample_rate
            return wave.to(self.device), self.labels[idx]
        with torch.no_grad():
            feat = extractor(wave[None, :].to(self.device))
        return feat[0], self.labels[idx]

    def __getitem__(self, idx):
        return self._convert_to_record(idx)

    def __len__(self):
        return len(self.files)


class ESC50(AudioClassificationDataset):
    """ESC-50 environmental sounds from an extracted ESC-50-master directory
    (``meta/esc50.csv`` and ``audio/``): 2000 5-second clips, 50 classes,
    5 folds; ``mode="train"`` takes the folds other than ``split``, any
    other mode the fold ``split``."""

    meta = os.path.join("meta", "esc50.csv")
    audio_dir = "audio"
    meta_info = collections.namedtuple(
        "META_INFO", ("filename", "fold", "target", "category",
                      "esc10", "src_file", "take"))

    def __init__(self, mode: str = "train", split: int = 1,
                 feat_type: str = "raw", data_dir: Optional[str] = None,
                 **kwargs):
        self.data_dir = require_local_file(data_dir, "ESC50", arg="data_dir")
        files, labels = self._get_data(mode, split)
        super().__init__(files=files, labels=labels, feat_type=feat_type,
                         **kwargs)

    def _get_meta_info(self) -> List["ESC50.meta_info"]:
        with open(os.path.join(self.data_dir, self.meta)) as rf:
            return [self.meta_info(*row) for row in csv.reader(rf)
                    if row and row[0] != "filename"]

    def _get_data(self, mode: str, split: int
                  ) -> Tuple[List[str], List[int]]:
        files, labels = [], []
        for sample in self._get_meta_info():
            filename, fold, target = sample[0], int(sample[1]), int(sample[2])
            if (mode == "train") != (fold == split):
                files.append(os.path.join(self.data_dir, self.audio_dir,
                                          filename))
                labels.append(target)
        return files, labels


class TESS(AudioClassificationDataset):
    """The Toronto emotional speech set from an extracted directory: 2800
    recordings, 7 emotions (the file name's last ``_`` field); the sorted
    files dealt into ``n_folds`` folds, ``split`` the held-out one."""

    n_class = 7
    label_list = ["angry", "disgust", "fear", "happy", "neutral", "ps",
                  "sad"]
    meta_info = collections.namedtuple("META_INFO",
                                       ("speaker", "word", "emotion"))
    audio_path = "TESS_Toronto_emotional_speech_set"

    def __init__(self, mode: str = "train", n_folds: int = 5, split: int = 1,
                 feat_type: str = "raw", data_dir: Optional[str] = None,
                 **kwargs):
        if not 1 <= split <= n_folds:
            raise ValueError(f"split {split} outside 1..{n_folds}")
        self.data_dir = require_local_file(data_dir, "TESS", arg="data_dir")
        files, labels = self._get_data(mode, n_folds, split)
        super().__init__(files=files, labels=labels, feat_type=feat_type,
                         **kwargs)

    def _get_meta_info(self, files) -> List["TESS.meta_info"]:
        return [self.meta_info(*os.path.basename(f)[:-len(".wav")]
                               .strip().split("_")) for f in files]

    def _get_data(self, mode: str, n_folds: int, split: int
                  ) -> Tuple[List[str], List[int]]:
        root = os.path.join(self.data_dir, self.audio_path)
        if not os.path.isdir(root):
            root = self.data_dir
        wav_files = sorted(
            os.path.join(dirpath, fname)
            for dirpath, _, filenames in os.walk(root)
            for fname in filenames if fname.lower().endswith(".wav"))
        files, labels = [], []
        for idx, (file, sample) in enumerate(
                zip(wav_files, self._get_meta_info(wav_files))):
            emotion = sample.emotion.lower()
            if emotion not in self.label_list:
                continue
            fold = idx % n_folds + 1
            if (mode == "train") != (fold == split):
                files.append(file)
                labels.append(self.label_list.index(emotion))
        return files, labels
