"""The port's ``text.datasets`` against the JAX package's on the CPU.

The synthetic sample sets (``mode='synthetic'`` or no file) equal the
JAX package's arrays bit for bit: the same ``np.random.RandomState``
seeds, shapes and dtypes, item by item.  The file readers (UCIHousing,
Imdb, Imikolov) read tiny files this test writes in Paddle's on-disk
formats, in both packages, with equal results; where the JAX package
raises (Movielens, WMT14 and WMT16 from a file, a missing file) the
port raises the same error class.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
import io
import tarfile

import numpy as np
import pytest

import paddle_tpu.text as jtext

import paddle_tpu_torch.text as ttext

SYNTHETIC = {
    "UCIHousing-train": lambda t: t.UCIHousing(mode="train"),
    "UCIHousing-test": lambda t: t.UCIHousing(mode="test"),
    "Imdb": lambda t: t.Imdb(mode="synthetic", seq_len=16, vocab_size=300),
    "Imikolov": lambda t: t.Imikolov(mode="synthetic", window_size=4,
                                     vocab_size=500),
    "Movielens": lambda t: t.Movielens(mode="synthetic"),
    "WMT14": lambda t: t.WMT14(dict_size=1000, seq_len=12),
    "WMT16": lambda t: t.WMT16(src_dict_size=7709, trg_dict_size=5,
                               seq_len=50),
    "Conll05st": lambda t: t.Conll05st(seq_len=10),
}


def _items_equal(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("name", list(SYNTHETIC))
def test_synthetic_bit_for_bit(name):
    j, t = SYNTHETIC[name](jtext), SYNTHETIC[name](ttext)
    assert len(t) == len(j)
    for i in sorted({0, 1, len(j) // 2, len(j) - 1}):
        _items_equal(t[i], j[i])


def test_wmt16_target_ids_use_the_source_table():
    """As in the JAX package, WMT16 draws target ids below src_dict_size
    and ignores trg_dict_size."""
    d = ttext.WMT16(src_dict_size=7709, trg_dict_size=5, seq_len=50)
    _, trg, nxt = d[3]
    assert trg.max() >= 5 and trg.max() < 7709 and nxt[-1] == 1
    assert len(d) == 256 and trg[0] == 0


def _tar(path, files):
    with tarfile.open(path, "w:gz") as tf:
        for name, text in files.items():
            data = text.encode("latin-1")
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return str(path)


def test_file_readers_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    uci = tmp_path / "housing.data"
    uci.write_text("\n".join(" ".join(f"{v:.4f}" for v in row)
                             for row in rng.rand(20, 14) * 10))
    imdb = _tar(tmp_path / "imdb.tar.gz", {
        "aclImdb/train/pos/1.txt": "good good movie fine fine fine",
        "aclImdb/train/neg/2.txt": "bad movie bad bad fine",
        "aclImdb/test/pos/3.txt": "good fine"})
    ptb = _tar(tmp_path / "ptb.tar.gz", {
        "./simple-examples/data/ptb.train.txt":
            "the cat sat\nthe dog sat on the mat\n<unk> cat\n"})
    readers = [
        lambda t: t.UCIHousing(data_file=str(uci), mode="train"),
        lambda t: t.UCIHousing(data_file=str(uci), mode="test"),
        lambda t: t.Imdb(data_file=imdb, mode="train", cutoff=1,
                         seq_len=6),
        lambda t: t.Imikolov(data_file=ptb, mode="train", window_size=3,
                             min_word_freq=2),
    ]
    for build in readers:
        j, t = build(jtext), build(ttext)
        assert len(t) == len(j) > 0
        for i in range(len(j)):
            _items_equal(t[i], j[i])
        if hasattr(j, "word_idx"):
            assert t.word_idx == j.word_idx


@pytest.mark.parametrize("build", [
    lambda t, f: t.Movielens(data_file=f),
    lambda t, f: t.WMT14(data_file=f),
    lambda t, f: t.WMT16(data_file=f),
    lambda t, f: t.UCIHousing(data_file=f + ".missing"),
    lambda t, f: t.Imdb(data_file=f + ".missing"),
], ids=["movielens", "wmt14", "wmt16", "uci-missing", "imdb-missing"])
def test_unreadable_files_raise_as_jax(build, tmp_path):
    f = str(tmp_path / "x.tar.gz")
    open(f, "wb").close()
    with pytest.raises(Exception) as je:
        build(jtext, f)
    with pytest.raises(type(je.value)):
        build(ttext, f)
