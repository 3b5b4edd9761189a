"""Datasets: synthetic MNIST-like data, the raw-IDX loader and the
vendored real digits.

Port of :mod:`tpu_dist_nn.data.datasets`, numpy only (nothing here
touches a device):

* :func:`synthetic_mnist` / :func:`synthetic_fashion_mnist` — seeded
  class-conditional data at MNIST's shapes (784 features, 10 classes,
  [0, 1]); the same seed gives the JAX package's arrays bit for bit.
* :func:`load_mnist_idx` — the standard IDX files, plain or gzipped, so
  real MNIST drops in when the files exist on disk.
* :func:`real_digits` — the vendored UCI handwritten digits (1,438
  train / 359 held-out real 8x8 scans), read by path from the JAX
  package's ``data/digits/`` directory: the repo's real-data accuracy
  anchor.

IDX pixels normalise as ``x.astype(np.float32) * np.float32(1/255)``,
the numpy branch of the JAX package's loader (bit-equal to its native
one). Every loader returns a :class:`Dataset`, which round-trips
through the reference's examples-JSON format.
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
from pathlib import Path

import numpy as np

from tpu_dist_nn_torch.core.schema import save_examples

#: The vendored digits' IDX files (in the JAX package's tree, read as data).
DIGITS_DIR = Path(__file__).resolve().parents[2] / "tpu_dist_nn" / "data" / "digits"


@dataclasses.dataclass
class Dataset:
    """A supervised dataset: float inputs (N, dim) in [0,1], int labels (N,)."""

    x: np.ndarray
    y: np.ndarray
    num_classes: int

    def __post_init__(self):
        if len(self.x) != len(self.y):
            raise ValueError(f"x/y length mismatch: {len(self.x)} vs {len(self.y)}")

    def __len__(self) -> int:
        return len(self.x)

    def split(self, fraction: float, seed: int = 0) -> tuple["Dataset", "Dataset"]:
        """Shuffled train/test split (the notebook uses 90/10, cell 8)."""
        idx = np.random.default_rng(seed).permutation(len(self))
        k = int(len(self) * fraction)
        a, b = idx[:k], idx[k:]
        return (
            Dataset(self.x[a], self.y[a], self.num_classes),
            Dataset(self.x[b], self.y[b], self.num_classes),
        )

    def to_examples_json(self, path) -> None:
        save_examples(self.x, self.y, path)


def synthetic_mnist(num_examples: int = 10000, num_classes: int = 10, dim: int = 784,
                    noise: float = 0.35, seed: int = 0) -> Dataset:
    """Deterministic MNIST-shaped classification data: each class owns
    two template patterns; an example is a random convex mixture of its
    class's two, squashed by tanh, plus noise, scaled into [0, 1]."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(0, 1.0, (num_classes, 2, dim))
    y = rng.integers(0, num_classes, num_examples).astype(np.int32)
    alpha = rng.uniform(0.2, 0.8, (num_examples, 1))
    base = alpha * templates[y, 0] + (1 - alpha) * templates[y, 1]
    x = np.tanh(base) + rng.normal(0, noise, (num_examples, dim))
    x = (x - x.min()) / (x.max() - x.min())
    return Dataset(x.astype(np.float32), y, num_classes)


def synthetic_fashion_mnist(num_examples: int = 10000, num_classes: int = 10,
                            dim: int = 784, noise: float = 0.25, seed: int = 1) -> Dataset:
    """Fashion-MNIST-shaped synthetic data (BASELINE configs[2]): class
    pairs share a base shape and differ by a band-limited texture (a sum
    of three sinusoids over the flattened 28x28 grid)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(dim))
    grid = np.arange(dim, dtype=np.float64)
    bases = rng.normal(0, 1.0, ((num_classes + 1) // 2, dim))
    freqs = rng.uniform(1.0, 6.0, (num_classes, 3))
    phases = rng.uniform(0, 2 * np.pi, (num_classes, 3))
    y = rng.integers(0, num_classes, num_examples).astype(np.int32)
    texture = np.zeros((num_examples, dim))
    for k in range(3):
        texture += np.sin(
            freqs[y, k, None] * 2 * np.pi * (grid % side) / side + phases[y, k, None]
        )
    amp = rng.uniform(0.5, 1.0, (num_examples, 1))
    x = np.tanh(bases[y // 2] + amp * texture) + rng.normal(0, noise, (num_examples, dim))
    x = (x - x.min()) / (x.max() - x.min())
    return Dataset(x.astype(np.float32), y, num_classes)


def load_idx_images(path) -> np.ndarray:
    """Parse an IDX3 image file -> (N, rows*cols) float32 in [0, 1]."""
    raw = _read_idx_bytes(path)
    magic, n, rows, cols = struct.unpack(">IIII", raw[:16])
    if magic != 0x0803:
        raise ValueError(f"{path}: bad IDX3 magic {magic:#x}")
    pixels = np.frombuffer(raw, dtype=np.uint8, offset=16).reshape(n, rows * cols)
    return pixels.astype(np.float32) * np.float32(1.0 / 255.0)


def _read_idx_bytes(path) -> bytes:
    """Read an IDX file, accepting the ``.gz`` the MNIST mirrors
    distribute (no pre-gunzip step needed)."""
    path = Path(path)
    if path.suffix == ".gz":
        if path.exists():
            return gzip.decompress(path.read_bytes())
        raise FileNotFoundError(str(path))
    if path.exists():
        return path.read_bytes()
    gz = path.with_name(path.name + ".gz")
    if gz.exists():
        return gzip.decompress(gz.read_bytes())
    raise FileNotFoundError(str(path))


def load_idx_labels(path) -> np.ndarray:
    """Parse an IDX1 label file -> (N,) int32."""
    raw = _read_idx_bytes(path)
    magic, n = struct.unpack(">II", raw[:8])
    if magic != 0x0801:
        raise ValueError(f"{path}: bad IDX1 magic {magic:#x}")
    return np.frombuffer(raw, dtype=np.uint8, offset=8).astype(np.int32)


def real_digits(split: str = "train") -> Dataset:
    """The vendored REAL handwritten digits: 1,797 8x8 grayscale scans
    by 43 writers (the UCI ML "Optical Recognition of Handwritten
    Digits" test set, a stratified 1438/359 split, gzipped IDX). Not
    MNIST: held-out accuracy here is a genuine generalisation number."""
    return load_mnist_idx(DIGITS_DIR, split)


def load_mnist_idx(directory, split: str = "train") -> Dataset:
    """Load real MNIST (or Fashion-MNIST: the same wire format) from IDX
    files, plain or gzipped (train/t10k pairs). Missing files are an
    explicit error, never a silent fall-back to synthetic data."""
    d = Path(directory)
    prefix = "train" if split == "train" else "t10k"
    try:
        x = load_idx_images(d / f"{prefix}-images-idx3-ubyte")
        y = load_idx_labels(d / f"{prefix}-labels-idx1-ubyte")
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"MNIST IDX files not found under {d} (looked for "
            f"{prefix}-images-idx3-ubyte[.gz] / {prefix}-labels-idx1-ubyte[.gz]).\n"
            "Real MNIST is not bundled (and this environment may have no "
            "network egress). To fetch it on a connected machine:\n"
            "  mkdir -p mnist && cd mnist && for f in "
            "train-images-idx3-ubyte train-labels-idx1-ubyte "
            "t10k-images-idx3-ubyte t10k-labels-idx1-ubyte; do "
            "curl -O https://storage.googleapis.com/cvdf-datasets/mnist/$f.gz; "
            "done\n"
            "then: tdn train --data idx:mnist  (gzipped files load as-is; "
            "see docs/MNIST.md)"
        ) from e
    return Dataset(x, y, num_classes=10)
