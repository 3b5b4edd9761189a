"""The port's datasets and shuffled feed against the JAX package's.

Same seeds, same files: every array must be bit-equal (the port
normalises IDX pixels with the JAX loader's numpy arithmetic, and
shuffles with the same ``default_rng`` permutation).
"""

import gzip
import struct

import numpy as np
import pytest

from tpu_dist_nn.data import datasets as jax_datasets
from tpu_dist_nn.data.feed import batch_iterator as jax_batch_iterator
from tpu_dist_nn_torch.core.schema import load_examples
from tpu_dist_nn_torch.data import datasets
from tpu_dist_nn_torch.data.feed import batch_iterator


def _same(a, b):
    assert a.num_classes == b.num_classes
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("split", ["train", "test"])
def test_real_digits_match_jax(split):
    got = datasets.real_digits(split)
    _same(got, jax_datasets.real_digits(split))
    assert got.x.shape == ((1438, 64) if split == "train" else (359, 64))
    assert got.x.min() == 0.0 and got.x.max() == 1.0


def _write_idx(directory, prefix, images, labels, gz):
    n, rows, cols = images.shape
    img = struct.pack(">IIII", 0x0803, n, rows, cols) + images.tobytes()
    lab = struct.pack(">II", 0x0801, n) + labels.tobytes()
    for name, raw in ((f"{prefix}-images-idx3-ubyte", img), (f"{prefix}-labels-idx1-ubyte", lab)):
        if gz:
            (directory / (name + ".gz")).write_bytes(gzip.compress(raw))
        else:
            (directory / name).write_bytes(raw)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_load_mnist_idx_matches_jax(tmp_path, gz):
    rng = np.random.default_rng(0)
    for prefix, n in (("train", 11), ("t10k", 5)):
        _write_idx(tmp_path, prefix, rng.integers(0, 256, (n, 4, 3), dtype=np.uint8),
                   rng.integers(0, 10, n, dtype=np.uint8), gz)
    for split in ("train", "test"):
        got = datasets.load_mnist_idx(tmp_path, split)
        _same(got, jax_datasets.load_mnist_idx(tmp_path, split))
        assert got.x.shape[1] == 12 and got.x.dtype == np.float32
    np.testing.assert_array_equal(
        datasets.load_idx_images(tmp_path / "train-images-idx3-ubyte"),
        jax_datasets.load_idx_images(tmp_path / "train-images-idx3-ubyte"))


def test_missing_idx_files_raise_the_jax_message(tmp_path):
    with pytest.raises(FileNotFoundError) as want:
        jax_datasets.load_mnist_idx(tmp_path / "nowhere", "test")
    with pytest.raises(FileNotFoundError) as got:
        datasets.load_mnist_idx(tmp_path / "nowhere", "test")
    assert str(got.value) == str(want.value)
    assert "t10k-images-idx3-ubyte[.gz]" in str(got.value)


def test_bad_idx_magic_is_refused(tmp_path):
    (tmp_path / "train-images-idx3-ubyte").write_bytes(struct.pack(">IIII", 0x0801, 1, 1, 1) + b"\0")
    with pytest.raises(ValueError, match="bad IDX3 magic"):
        datasets.load_idx_images(tmp_path / "train-images-idx3-ubyte")
    (tmp_path / "l").write_bytes(struct.pack(">II", 0x0803, 1) + b"\0")
    with pytest.raises(ValueError, match="bad IDX1 magic"):
        datasets.load_idx_labels(tmp_path / "l")


@pytest.mark.parametrize("kind", ["mnist", "fashion"])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_data_matches_jax(kind, seed):
    name = "synthetic_mnist" if kind == "mnist" else "synthetic_fashion_mnist"
    kw = dict(num_examples=300, num_classes=7, dim=49, seed=seed)
    _same(getattr(datasets, name)(**kw), getattr(jax_datasets, name)(**kw))


def test_split_and_examples_json_match_jax(tmp_path):
    kw = dict(num_examples=101, num_classes=4, dim=12, seed=2)
    got = datasets.synthetic_mnist(**kw).split(0.9, seed=5)
    want = jax_datasets.synthetic_mnist(**kw).split(0.9, seed=5)
    for g, w in zip(got, want):
        _same(g, w)
    assert len(got[0]) == 90 and len(got[1]) == 11
    got[1].to_examples_json(tmp_path / "port.json")
    want[1].to_examples_json(tmp_path / "jax.json")
    for a, b in zip(load_examples(tmp_path / "port.json"), load_examples(tmp_path / "jax.json")):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(load_examples(tmp_path / "port.json")[0], got[1].x)
    with pytest.raises(ValueError, match="length mismatch"):
        datasets.Dataset(np.zeros((3, 2)), np.zeros(2), 2)


@pytest.mark.parametrize("drop_remainder", [False, True], ids=["keep", "drop"])
@pytest.mark.parametrize("with_y", [True, False], ids=["xy", "x"])
def test_shuffled_batch_iterator_matches_jax(drop_remainder, with_y):
    data = datasets.synthetic_mnist(203, num_classes=5, dim=16, seed=1)
    y = data.y if with_y else None
    kw = dict(batch_size=32, shuffle=True, seed=11, drop_remainder=drop_remainder)
    got = list(batch_iterator(data.x, y, **kw))
    want = list(jax_batch_iterator(data.x, y, **kw))
    assert len(got) == len(want) == (6 if drop_remainder else 7)
    for g, w in zip(got, want):
        for a, b in zip(g if with_y else (g,), w if with_y else (w,)):
            np.testing.assert_array_equal(a, b)
    rows = np.concatenate([g[0] if with_y else g for g in got])
    assert len(np.unique(rows, axis=0)) == len(rows)


def test_in_order_batch_iterator_is_unchanged():
    x = np.arange(20.0).reshape(10, 2)
    got = list(batch_iterator(x, batch_size=4))
    want = list(jax_batch_iterator(x, batch_size=4))
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert np.shares_memory(got[0], x)
