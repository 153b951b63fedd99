"""Text dataset parsers: ``Imikolov``, ``Movielens``, ``WMT14``, ``WMT16``
and ``Conll05st``.

Counterpart of ``paddle_tpu/text/datasets.py`` (Paddle's
``python/paddle/text/datasets/``), the same parsers over the same archive
layouts. Each reads local files only: a missing file raises
(``require_local_file``), whatever ``download`` says. Samples are tuples
of numpy arrays, for a DataLoader's workers.
"""

from __future__ import annotations

import collections
import gzip
import re
import tarfile
import zipfile
from typing import Optional

import numpy as np

from ..io import Dataset
from ..vision.datasets import require_local_file as _require_file

__all__ = ["Imikolov", "Movielens", "WMT14", "WMT16", "Conll05st"]

_START, _END, _UNK = "<s>", "<e>", "<unk>"
_UNK_IDX = 2  # WMT convention: ids 0/1/2 = <s>/<e>/<unk>

_AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]


def _require(path, name):
    return _require_file(path, name, arg="data_file")


class Imikolov(Dataset):
    """PTB language-model set from the simple-examples tgz (reference
    text/datasets/imikolov.py). data_type 'NGRAM' yields window_size-grams;
    'SEQ' yields (src, trg) shifted sequences. The word dict is built over
    ptb.train + ptb.valid with min_word_freq cutoff, '<unk>' last."""

    def __init__(self, data_file: Optional[str] = None,
                 data_type: str = "NGRAM", window_size: int = -1,
                 mode: str = "train", min_word_freq: int = 50,
                 download: bool = True):
        data_type = data_type.upper()  # reference normalizes case
        mode = mode.lower()
        assert data_type in ("NGRAM", "SEQ"), data_type
        assert mode in ("train", "test"), mode
        self.data_file = _require(data_file, "Imikolov")
        self.data_type = data_type
        self.window_size = window_size
        self.mode = mode
        self.min_word_freq = min_word_freq
        self.word_idx = self._build_word_dict()
        self.data = self._load(mode)

    @staticmethod
    def _count(fd, freq):
        for line in fd:
            for w in line.strip().split():
                freq[w.decode() if isinstance(w, bytes) else w] += 1
            freq[_START] += 1
            freq[_END] += 1
        return freq

    def _build_word_dict(self):
        freq: collections.Counter = collections.Counter()
        with tarfile.open(self.data_file) as tf:
            self._count(tf.extractfile(
                "./simple-examples/data/ptb.train.txt"), freq)
            self._count(tf.extractfile(
                "./simple-examples/data/ptb.valid.txt"), freq)
        freq.pop(_UNK, None)
        kept = sorted(((w, c) for w, c in freq.items()
                       if c > self.min_word_freq),
                      key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx[_UNK] = len(word_idx)
        return word_idx

    def _load(self, mode):
        data = []
        unk = self.word_idx[_UNK]
        with tarfile.open(self.data_file) as tf:
            fd = tf.extractfile(f"./simple-examples/data/ptb.{mode}.txt")
            for line in fd:
                toks = line.decode().strip().split()
                if self.data_type == "NGRAM":
                    assert self.window_size > -1, "Invalid gram length"
                    seq = [_START] + toks + [_END]
                    if len(seq) >= self.window_size:
                        ids = [self.word_idx.get(w, unk) for w in seq]
                        for i in range(self.window_size, len(ids) + 1):
                            data.append(tuple(ids[i - self.window_size:i]))
                else:
                    ids = [self.word_idx.get(w, unk) for w in toks]
                    src = [self.word_idx[_START]] + ids
                    trg = ids + [self.word_idx[_END]]
                    if 0 < self.window_size < len(src):
                        continue
                    data.append((src, trg))
        return data

    def __getitem__(self, idx):
        return tuple(np.array(d) for d in self.data[idx])

    def __len__(self):
        return len(self.data)


class _MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self, categories_dict, title_dict):
        return [[self.index],
                [categories_dict[c] for c in self.categories],
                [title_dict[w.lower()] for w in self.title.split()]]


class _UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = _AGE_TABLE.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [[self.index], [0 if self.is_male else 1], [self.age],
                [self.job_id]]


class Movielens(Dataset):
    """MovieLens-1M ratings from the ml-1m.zip (reference
    text/datasets/movielens.py). Each record: user fields (id, gender,
    age-bucket, job), movie fields (id, category ids, title word ids), and
    the rating rescaled to [-5, 5] via r*2-5."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 test_ratio: float = 0.1, rand_seed: int = 0,
                 download: bool = True):
        assert mode in ("train", "test"), mode
        self.data_file = _require(data_file, "Movielens")
        self.mode = mode
        self.test_ratio = test_ratio
        rng = np.random.RandomState(rand_seed)
        self._load_meta()
        self._load_ratings(rng)

    def _load_meta(self):
        pattern = re.compile(r"^(.*)\((\d+)\)$")
        self.movie_info, self.user_info = {}, {}
        title_words, categories = set(), set()
        with zipfile.ZipFile(self.data_file) as zf:
            with zf.open("ml-1m/movies.dat") as f:
                for line in f:
                    mid, title, cats = line.decode("latin1").strip() \
                        .split("::")
                    cats = cats.split("|")
                    categories.update(cats)
                    title = pattern.match(title).group(1)
                    title_words.update(w.lower() for w in title.split())
                    self.movie_info[int(mid)] = _MovieInfo(mid, cats, title)
            with zf.open("ml-1m/users.dat") as f:
                for line in f:
                    uid, gender, age, job, _ = line.decode("latin1") \
                        .strip().split("::")
                    self.user_info[int(uid)] = _UserInfo(uid, gender, age,
                                                         job)
        self.movie_title_dict = {w: i for i, w in enumerate(title_words)}
        self.categories_dict = {c: i for i, c in enumerate(categories)}

    def _load_ratings(self, rng):
        self.data = []
        is_test = self.mode == "test"
        with zipfile.ZipFile(self.data_file) as zf:
            with zf.open("ml-1m/ratings.dat") as f:
                for line in f:
                    if (rng.random_sample() < self.test_ratio) != is_test:
                        continue
                    uid, mid, rating, _ = line.decode("latin1").strip() \
                        .split("::")
                    usr = self.user_info[int(uid)]
                    mov = self.movie_info[int(mid)]
                    self.data.append(
                        usr.value()
                        + mov.value(self.categories_dict,
                                    self.movie_title_dict)
                        + [[float(rating) * 2 - 5.0]])

    def __getitem__(self, idx):
        return tuple(np.array(d) for d in self.data[idx])

    def __len__(self):
        return len(self.data)


class WMT14(Dataset):
    """WMT'14 en→fr translation pairs from the preprocessed tgz (reference
    text/datasets/wmt14.py: src.dict/trg.dict member files + tab-separated
    '{mode}/{mode}' parallel text; sequences over 80 tokens dropped).
    Yields (src_ids, trg_ids, trg_ids_next)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 dict_size: int = -1, download: bool = True):
        assert mode in ("train", "test", "gen"), mode
        self.data_file = _require(data_file, "WMT14")
        self.mode = mode
        if dict_size == -1:
            dict_size = 2 ** 31 - 1
        self.dict_size = dict_size
        self._load()

    @staticmethod
    def _read_dict(fd, size):
        out = {}
        for i, line in enumerate(fd):
            if i >= size:
                break
            out[line.strip().decode()] = i
        return out

    def _load(self):
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file) as tf:
            names = [m.name for m in tf if m.name.endswith("src.dict")]
            assert len(names) == 1, names
            self.src_dict = self._read_dict(tf.extractfile(names[0]),
                                            self.dict_size)
            names = [m.name for m in tf if m.name.endswith("trg.dict")]
            assert len(names) == 1, names
            self.trg_dict = self._read_dict(tf.extractfile(names[0]),
                                            self.dict_size)
            suffix = f"{self.mode}/{self.mode}"
            for name in (m.name for m in tf if m.name.endswith(suffix)):
                for line in tf.extractfile(name):
                    parts = line.decode().strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src = [self.src_dict.get(w, _UNK_IDX)
                           for w in [_START] + parts[0].split() + [_END]]
                    trg = [self.trg_dict.get(w, _UNK_IDX)
                           for w in parts[1].split()]
                    if len(src) > 80 or len(trg) > 80:
                        continue
                    self.trg_ids_next.append(trg + [self.trg_dict[_END]])
                    self.trg_ids.append([self.trg_dict[_START]] + trg)
                    self.src_ids.append(src)

    def get_dict(self, reverse: bool = False):
        if reverse:
            return ({v: k for k, v in self.src_dict.items()},
                    {v: k for k, v in self.trg_dict.items()})
        return self.src_dict, self.trg_dict

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)


class WMT16(Dataset):
    """WMT'16 en↔de pairs from the preprocessed tgz holding tab-separated
    'wmt16/{mode}' files (reference text/datasets/wmt16.py). Dictionaries
    are built from the train corpus at construction (most-common
    src_dict_size/trg_dict_size words; ids 0/1/2 = <s>/<e>/<unk>).
    `lang` selects the source column."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 src_dict_size: int = -1, trg_dict_size: int = -1,
                 lang: str = "en", download: bool = True):
        assert mode in ("train", "test", "val"), mode
        assert lang in ("en", "de"), lang
        self.data_file = _require(data_file, "WMT16")
        self.mode = mode
        self.lang = lang
        if src_dict_size == -1:
            src_dict_size = 2 ** 31 - 1
        if trg_dict_size == -1:
            trg_dict_size = 2 ** 31 - 1
        self.src_dict, self.trg_dict = self._build_dicts(
            lang, src_dict_size, trg_dict_size)
        self._load()

    def _build_dicts(self, lang, src_dict_size, trg_dict_size):
        """One pass over the train corpus: en and de Counters together."""
        freqs = [collections.Counter(), collections.Counter()]  # en, de
        with tarfile.open(self.data_file) as tf:
            for line in tf.extractfile("wmt16/train"):
                parts = line.decode().strip().split("\t")
                if len(parts) != 2:
                    continue
                freqs[0].update(parts[0].split())
                freqs[1].update(parts[1].split())

        def to_dict(freq, size):
            words = [_START, _END, _UNK] + [
                w for w, _ in freq.most_common(max(size - 3, 0))]
            return {w: i for i, w in enumerate(words)}

        src_col = 0 if lang == "en" else 1
        return (to_dict(freqs[src_col], src_dict_size),
                to_dict(freqs[1 - src_col], trg_dict_size))

    def _load(self):
        start_id, end_id, unk_id = (self.src_dict[_START],
                                    self.src_dict[_END],
                                    self.src_dict[_UNK])
        src_col = 0 if self.lang == "en" else 1
        trg_col = 1 - src_col
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file) as tf:
            for line in tf.extractfile(f"wmt16/{self.mode}"):
                parts = line.decode().strip().split("\t")
                if len(parts) != 2:
                    continue
                src = ([start_id]
                       + [self.src_dict.get(w, unk_id)
                          for w in parts[src_col].split()]
                       + [end_id])
                trg = [self.trg_dict.get(w, unk_id)
                       for w in parts[trg_col].split()]
                self.trg_ids_next.append(trg + [end_id])
                self.trg_ids.append([start_id] + trg)
                self.src_ids.append(src)

    def get_dict(self, lang: str, reverse: bool = False):
        d = self.src_dict if lang == self.lang else self.trg_dict
        return {v: k for k, v in d.items()} if reverse else d

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)


class Conll05st(Dataset):
    """CoNLL-2005 SRL test split (reference text/datasets/conll05.py —
    the reference also only ships the WSJ test section). Parses the
    words/props gzip members, converts prop bracket tags to B/I/O, and
    yields the 9-field record (word_idx, 5 ctx windows, predicate mark,
    verb id, label ids)."""

    def __init__(self, data_file: Optional[str] = None,
                 word_dict_file: Optional[str] = None,
                 verb_dict_file: Optional[str] = None,
                 target_dict_file: Optional[str] = None,
                 emb_file: Optional[str] = None, download: bool = True):
        self.data_file = _require(data_file, "Conll05st")
        self.word_dict = self._load_dict(
            _require(word_dict_file, "Conll05st(word_dict_file)"))
        self.predicate_dict = self._load_dict(
            _require(verb_dict_file, "Conll05st(verb_dict_file)"))
        self.label_dict = self._load_label_dict(
            _require(target_dict_file, "Conll05st(target_dict_file)"))
        self.emb_file = emb_file
        self._load_anno()

    @staticmethod
    def _load_dict(filename):
        with open(filename) as f:
            return {line.strip(): i for i, line in enumerate(f)}

    @staticmethod
    def _load_label_dict(filename):
        tags = set()
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if line.startswith(("B-", "I-")):
                    tags.add(line[2:])
        d, idx = {}, 0
        for tag in tags:
            d["B-" + tag] = idx
            d["I-" + tag] = idx + 1
            idx += 2
        d["O"] = idx
        return d

    @staticmethod
    def _props_to_bio(lbl):
        """One predicate column of bracket tags → B/I/O sequence."""
        cur, in_bracket, seq = "O", False, []
        for tok in lbl:
            if tok == "*":
                seq.append("I-" + cur if in_bracket else "O")
            elif tok == "*)":
                seq.append("I-" + cur)
                in_bracket = False
            elif "(" in tok and ")" in tok:
                cur = tok[1:tok.find("*")]
                seq.append("B-" + cur)
                in_bracket = False
            elif "(" in tok:
                cur = tok[1:tok.find("*")]
                seq.append("B-" + cur)
                in_bracket = True
            else:
                raise RuntimeError(f"Unexpected prop label: {tok}")
        return seq

    def _load_anno(self):
        self.sentences, self.predicates, self.labels = [], [], []
        with tarfile.open(self.data_file) as tf:
            wf = tf.extractfile(
                "conll05st-release/test.wsj/words/test.wsj.words.gz")
            pf = tf.extractfile(
                "conll05st-release/test.wsj/props/test.wsj.props.gz")
            with gzip.GzipFile(fileobj=wf) as words, \
                    gzip.GzipFile(fileobj=pf) as props:
                sentence, columns = [], []
                for word, prop in zip(words, props):
                    word = word.strip().decode()
                    prop = prop.strip().decode().split()
                    if prop:
                        sentence.append(word)
                        columns.append(prop)
                        continue
                    # sentence boundary: transpose prop columns
                    if columns:
                        by_col = [[row[i] for row in columns]
                                  for i in range(len(columns[0]))]
                        verbs = [v for v in by_col[0] if v != "-"]
                        for i, lbl in enumerate(by_col[1:]):
                            self.sentences.append(sentence)
                            self.predicates.append(verbs[i])
                            self.labels.append(self._props_to_bio(lbl))
                    sentence, columns = [], []

    def __getitem__(self, idx):
        sentence, predicate, labels = (self.sentences[idx],
                                       self.predicates[idx],
                                       self.labels[idx])
        n = len(sentence)
        verb_index = labels.index("B-V")
        mark = [0] * n

        def ctx(offset, default):
            j = verb_index + offset
            if 0 <= j < n:
                mark[j] = 1
                return sentence[j]
            return default

        ctx_n2 = ctx(-2, "bos")
        ctx_n1 = ctx(-1, "bos")
        ctx_0 = ctx(0, sentence[verb_index])
        ctx_p1 = ctx(1, "eos")
        ctx_p2 = ctx(2, "eos")

        # conll dicts are plain line-number maps with no reserved ids;
        # the reference maps OOV to 0 (conll05.py UNK_IDX = 0)
        wd = self.word_dict
        word_idx = [wd.get(w, 0) for w in sentence]
        rec = [word_idx]
        for c in (ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2):
            rec.append([wd.get(c, 0)] * n)
        rec.append([self.predicate_dict.get(predicate)] * n)
        rec.append(mark)
        rec.append([self.label_dict.get(w) for w in labels])
        return tuple(np.array(r) for r in rec)

    def __len__(self):
        return len(self.sentences)

    def get_dict(self):
        return self.word_dict, self.predicate_dict, self.label_dict

    def get_embedding(self):
        return self.emb_file
