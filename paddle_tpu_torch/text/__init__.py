"""paddle.text: CRF Viterbi decoding, a vocabulary and the text datasets.

Counterpart of ``paddle_tpu/text/__init__.py``. ``viterbi_decode`` is the
forward max-product recursion over time with back-pointers, then the
backtrace: a Python loop of a few torch ops a step, with no host read, so
it runs on the potentials' device and ``jit.jit_step`` can capture it.
Paths are int64 (the reference's: int32). The datasets read local files
only (``UCIHousing``'s data file, ``Imdb``'s aclImdb tar.gz, and those of
``datasets.py``).
"""

from __future__ import annotations

import os
import re
import tarfile
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.tensor import paddle_call, unwrap
from ..io import Dataset
from ..nn.layer_base import Layer
from .datasets import Conll05st, Imikolov, Movielens, WMT14, WMT16  # noqa: F401

__all__ = ["viterbi_decode", "ViterbiDecoder", "UCIHousing", "Imdb",
           "Vocab", "Imikolov", "Movielens", "WMT14", "WMT16", "Conll05st"]


def _viterbi(pot, trans, lengths, include_bos_eos_tag):
    b, s, n = pot.shape
    lens = torch.full((b,), s, dtype=torch.int64, device=pot.device) \
        if lengths is None else lengths.to(pot.device, torch.int64)
    alpha = pot[:, 0] + trans[n - 2][None, :] if include_bos_eos_tag \
        else pot[:, 0]
    ident = torch.arange(n, device=pot.device)[None, :].expand(b, n)
    backptrs = []
    for t in range(1, s):
        # scores[b, i, j] = alpha[b, i] + trans[i, j]
        best, best_prev = (alpha[:, :, None] + trans[None]).max(dim=1)
        live = (t < lens)[:, None]
        alpha = torch.where(live, best + pot[:, t], alpha)
        backptrs.append(torch.where(live, best_prev, ident))
    if include_bos_eos_tag:
        alpha = alpha + trans[:, n - 1][None, :]
    scores, tag = alpha.max(dim=1)
    path = [tag]
    for bp in reversed(backptrs):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return scores, torch.stack(path[::-1], dim=1)


def viterbi_decode(potentials, transition, lengths=None,
                   include_bos_eos_tag: bool = True, name=None):
    """CRF Viterbi decoding: potentials ``[batch, seq, n_tags]``,
    transition ``[n_tags, n_tags]`` (``transition[i, j]`` scores i -> j),
    lengths ``[batch]`` (default: the whole sequence). With
    ``include_bos_eos_tag`` tag ``n - 2`` is BOS and ``n - 1`` EOS. Returns
    ``(scores [batch], paths [batch, seq] int64)``; past a row's length
    its path repeats the last tag."""
    return paddle_call(_viterbi, (potentials, transition, lengths,
                                  include_bos_eos_tag), {})


class ViterbiDecoder(Layer):
    """``viterbi_decode`` as a layer over a fixed transition matrix."""

    def __init__(self, transitions, include_bos_eos_tag: bool = True,
                 name=None):
        super().__init__()
        t = transitions if isinstance(transitions, torch.Tensor) else \
            torch.as_tensor(np.asarray(transitions))
        self.register_buffer("transitions", unwrap(t).detach().clone())
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths=None):
        return _viterbi(potentials, self.transitions.to(potentials.device),
                        lengths, self.include_bos_eos_tag)


class Vocab:
    """Token <-> id mapping: ``pad_token`` is id 0, ``unk_token`` id 1."""

    def __init__(self, tokens: Sequence[str], unk_token: str = "<unk>",
                 pad_token: str = "<pad>"):
        self.itos = [pad_token, unk_token] + [
            t for t in tokens if t not in (pad_token, unk_token)]
        self.stoi = {t: i for i, t in enumerate(self.itos)}
        self.unk_id = self.stoi[unk_token]
        self.pad_id = self.stoi[pad_token]

    def __len__(self):
        return len(self.itos)

    def to_indices(self, tokens: Sequence[str]) -> List[int]:
        return [self.stoi.get(t, self.unk_id) for t in tokens]

    def to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.itos[i] for i in ids]

    @staticmethod
    def build_from_corpus(corpus, max_size: Optional[int] = None,
                          min_freq: int = 1, **kw) -> "Vocab":
        counts = Counter(t for line in corpus for t in line)
        items = [t for t, c in counts.most_common(max_size)
                 if c >= min_freq]
        return Vocab(items, **kw)


class UCIHousing(Dataset):
    """Boston-housing regression from a local data file (13 features and
    the price a row): features scaled by their range, the first 80% of
    the rows for ``mode="train"``, the rest for test."""

    FEATURE_NUM = 14

    def __init__(self, data_file: str, mode: str = "train"):
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"UCIHousing: '{data_file}' not found; place the UCI "
                f"housing.data file locally (downloading is unavailable)")
        raw = np.loadtxt(data_file).reshape(-1, self.FEATURE_NUM)
        maxs, mins = raw.max(axis=0), raw.min(axis=0)
        feats = (raw[:, :-1] - mins[:-1]) / np.maximum(
            maxs[:-1] - mins[:-1], 1e-8)
        n_train = int(len(raw) * 0.8)
        rows = slice(None, n_train) if mode == "train" else \
            slice(n_train, None)
        self.data = feats[rows].astype(np.float32)
        self.label = raw[rows, -1:].astype(np.float32)

    def __getitem__(self, idx):
        return self.data[idx], self.label[idx]

    def __len__(self):
        return len(self.data)


class Imdb(Dataset):
    """IMDB sentiment from a local aclImdb tar.gz: lower-cased word ids
    (one dictionary over both splits, words seen at least ``cutoff``
    times, the rest one unknown id) and the label (0 neg, 1 pos)."""

    def __init__(self, data_file: str, mode: str = "train",
                 cutoff: int = 150):
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"Imdb: '{data_file}' not found; place aclImdb_v1.tar.gz "
                f"locally (downloading is unavailable)")
        pat = re.compile(r"aclImdb/(train|test)/(pos|neg)/.*\.txt$")
        texts: List[Tuple[List[str], int]] = []
        counts: Counter = Counter()
        with tarfile.open(data_file) as tar:
            for member in tar.getmembers():
                m = pat.match(member.name)
                if not m:
                    continue
                body = tar.extractfile(member).read().decode(
                    "utf-8", errors="ignore").lower()
                toks = re.findall(r"[a-z]+", body)
                counts.update(toks)
                if m.group(1) == mode:
                    texts.append((toks, 0 if m.group(2) == "neg" else 1))
        vocab = [w for w, c in counts.most_common() if c >= cutoff]
        self.word_idx = {w: i for i, w in enumerate(vocab)}
        unk = len(self.word_idx)
        self.docs = [[self.word_idx.get(t, unk) for t in toks]
                     for toks, _ in texts]
        self.labels = [label for _, label in texts]

    def __getitem__(self, idx):
        return np.asarray(self.docs[idx]), self.labels[idx]

    def __len__(self):
        return len(self.docs)
