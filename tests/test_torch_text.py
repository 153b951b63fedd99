"""``paddle_tpu_torch.text`` against ``paddle_tpu.text``, on the CPU:
``viterbi_decode`` (the function, the registry op and ``ViterbiDecoder``)
in both ``include_bos_eos_tag`` modes, with and without lengths, scores
within 1e-5 and paths exactly (seeded random potentials: no ties);
``Vocab``; and every dataset over a small local file the test writes,
sample for sample against the reference's parser.
"""

import gzip
import io
import tarfile
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.core.tensor import Tensor as RTensor
from paddle_tpu_torch import text
from paddle_tpu_torch.core.device import set_device

from _torch_op_check import check_op


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def _crf(b=4, s=7, n=6, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(b, s, n).astype(np.float32),
            r.randn(n, n).astype(np.float32),
            r.randint(1, s + 1, b).astype(np.int64))


@pytest.mark.parametrize("bos_eos", [True, False])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_viterbi_decode(bos_eos, with_lengths):
    pot, trans, lens = _crf()
    lens = lens if with_lengths else None
    got_s, got_p = text.viterbi_decode(
        torch.from_numpy(pot), torch.from_numpy(trans),
        None if lens is None else torch.from_numpy(lens), bos_eos)
    want_s, want_p = paddle_tpu.text.viterbi_decode(
        RTensor(pot), RTensor(trans),
        None if lens is None else RTensor(lens), bos_eos)
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(got_p.numpy(), want_p.numpy())


@pytest.mark.parametrize("bos_eos", [True, False])
def test_viterbi_decode_op(bos_eos):
    pot, trans, lens = _crf(seed=1)
    check_op("viterbi_decode", [pot, trans, lens],
             dict(include_bos_eos_tag=bos_eos), atol=1e-5, rtol=1e-5)


def test_viterbi_decoder_layer():
    import paddle_tpu_torch as P
    pot, trans, lens = _crf(seed=2)
    layer = text.ViterbiDecoder(P.to_tensor(trans), include_bos_eos_tag=False)
    s, p = layer(P.to_tensor(pot), P.to_tensor(lens))
    assert isinstance(s, P.Tensor) and isinstance(p, P.Tensor)
    ref = paddle_tpu.text.ViterbiDecoder(RTensor(trans),
                                         include_bos_eos_tag=False)
    rs, rp = ref(RTensor(pot), RTensor(lens))
    np.testing.assert_allclose(s.numpy(), rs.numpy(), atol=1e-5)
    np.testing.assert_array_equal(p.numpy(), rp.numpy())
    assert "transitions" in dict(layer.named_buffers())


def test_viterbi_brute_force():
    """Paths and scores against an exhaustive search on a tiny case."""
    import itertools
    pot, trans, _ = _crf(b=2, s=4, n=3, seed=3)
    s, p = text.viterbi_decode(torch.from_numpy(pot),
                               torch.from_numpy(trans),
                               include_bos_eos_tag=False)
    for b in range(2):
        best = max(itertools.product(range(3), repeat=4), key=lambda seq: (
            sum(pot[b, t, seq[t]] for t in range(4))
            + sum(trans[seq[t], seq[t + 1]] for t in range(3))))
        assert tuple(p[b].tolist()) == best


def test_vocab():
    corpus = [["a", "b", "a"], ["c", "a", "b"], ["d"]]
    v = text.Vocab.build_from_corpus(corpus, min_freq=2)
    r = paddle_tpu.text.Vocab.build_from_corpus(corpus, min_freq=2)
    assert v.itos == r.itos and len(v) == len(r) == 4
    assert v.to_indices(["a", "z", "<pad>"]) == [2, 1, 0]
    assert v.to_tokens([2, 3]) == ["a", "b"]


# -- datasets over small local files ---------------------------------------------

def _add(tar, name, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def _same(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        x = x if isinstance(x, tuple) else (x,)
        y = y if isinstance(y, tuple) else (y,)
        assert len(x) == len(y)
        for u, w in zip(x, y):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(w))


def test_uci_housing(tmp_path):
    path = tmp_path / "housing.data"
    np.savetxt(path, np.random.RandomState(0).rand(20, 14) * 10)
    for mode in ("train", "test"):
        _same(text.UCIHousing(str(path), mode),
              paddle_tpu.text.UCIHousing(str(path), mode))


def test_imdb(tmp_path):
    path = str(tmp_path / "aclImdb_v1.tar.gz")
    with tarfile.open(path, "w:gz") as tar:
        for i, (split, lab, body) in enumerate([
                ("train", "pos", "a good good film"),
                ("train", "neg", "a bad film, bad!"),
                ("test", "pos", "good fun"), ("test", "neg", "bad")]):
            _add(tar, f"aclImdb/{split}/{lab}/{i}_1.txt", body.encode())
    for mode in ("train", "test"):
        _same(text.Imdb(path, mode, cutoff=2),
              paddle_tpu.text.Imdb(path, mode, cutoff=2))


def test_imikolov(tmp_path):
    path = str(tmp_path / "simple-examples.tgz")
    lines = {"train": b"the cat sat\nthe dog sat down\n",
             "valid": b"the cat ran\n", "test": b"a cat sat\n"}
    with tarfile.open(path, "w:gz") as tar:
        for k, v in lines.items():
            _add(tar, f"./simple-examples/data/ptb.{k}.txt", v)
    for kw in (dict(data_type="NGRAM", window_size=3),
               dict(data_type="SEQ", mode="test")):
        _same(text.Imikolov(path, min_word_freq=0, **kw),
              paddle_tpu.text.Imikolov(path, min_word_freq=0, **kw))


def test_movielens(tmp_path):
    path = str(tmp_path / "ml-1m.zip")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-1m/movies.dat",
                   "1::Toy Story (1995)::Animation|Comedy\n"
                   "2::Heat (1995)::Action\n")
        z.writestr("ml-1m/users.dat", "1::F::1::10::48067\n"
                   "2::M::56::16::70072\n")
        z.writestr("ml-1m/ratings.dat", "\n".join(
            f"{1 + i % 2}::{1 + i % 2}::{1 + i % 5}::97830{i}"
            for i in range(12)) + "\n")
    for mode in ("train", "test"):
        a = text.Movielens(path, mode, test_ratio=0.3)
        b = paddle_tpu.text.Movielens(path, mode, test_ratio=0.3)
        assert len(a) == len(b)
        for i in range(len(a)):
            assert [list(np.asarray(x)) for x in a[i]][:4] == \
                [list(np.asarray(x)) for x in b[i]][:4]


def test_wmt14(tmp_path):
    path = str(tmp_path / "wmt14.tgz")
    with tarfile.open(path, "w:gz") as tar:
        _add(tar, "wmt14/src.dict", b"<s>\n<e>\n<unk>\nhello\nworld\n")
        _add(tar, "wmt14/trg.dict", b"<s>\n<e>\n<unk>\nbonjour\nmonde\n")
        _add(tar, "wmt14/train/train",
             b"hello world\tbonjour monde\nhello\tbonjour\n")
    _same(text.WMT14(path, "train"), paddle_tpu.text.WMT14(path, "train"))


def test_wmt16(tmp_path):
    path = str(tmp_path / "wmt16.tgz")
    with tarfile.open(path, "w:gz") as tar:
        _add(tar, "wmt16/train", b"a b c\tx y\na c\tx z\n")
        _add(tar, "wmt16/test", b"a b\tx\n")
    for lang in ("en", "de"):
        _same(text.WMT16(path, "test", lang=lang),
              paddle_tpu.text.WMT16(path, "test", lang=lang))


def test_conll05st(tmp_path):
    path = str(tmp_path / "conll05st-tests.tar.gz")
    words = b"The\ncat\nsat\n\n"
    props = b"-\t(A0*\nsat\t*)\n-\t(V*)\n\n"

    def gz(b):
        buf = io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="wb") as f:
            f.write(b)
        return buf.getvalue()
    with tarfile.open(path, "w:gz") as tar:
        _add(tar, "conll05st-release/test.wsj/words/test.wsj.words.gz",
             gz(words))
        _add(tar, "conll05st-release/test.wsj/props/test.wsj.props.gz",
             gz(props))
    dicts = {}
    for name, body in (("word", "The\ncat\nsat\nbos\neos\n"),
                       ("verb", "sat\n"), ("target", "B-A0\nI-A0\nB-V\n")):
        p = tmp_path / f"{name}.dict"
        p.write_text(body)
        dicts[name] = str(p)
    args = (path, dicts["word"], dicts["verb"], dicts["target"])
    _same(text.Conll05st(*args), paddle_tpu.text.Conll05st(*args))


def test_datasets_need_local_files():
    with pytest.raises(RuntimeError):
        text.WMT14(None)
    with pytest.raises(FileNotFoundError):
        text.UCIHousing("/nonexistent/housing.data")


def test_names_match_the_reference():
    assert sorted(text.__all__) == sorted(paddle_tpu.text.__all__)
