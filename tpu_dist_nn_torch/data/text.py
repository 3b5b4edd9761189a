"""Text corpus and LM batching for the byte-level Transformer.

The port's own copy of :mod:`tpu_dist_nn.data.text` (pure numpy), with
the same corpus lookup order in :func:`load_corpus`: an explicit path,
``$TDN_WIKITEXT_PATH``, the conventional WikiText-2 locations under the
home directory, the real corpora vendored in the repository
(``tpu_dist_nn/data/corpus/realtext_corpus.txt``, ~8 MB of real
English, then ``licenses_corpus.txt``), and last a deterministic
synthetic WikiText-like corpus. The vendored files are read by path from
the checkout: a data file, not an import of the JAX package.

Tokens are bytes (vocab 256).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator

import numpy as np

from tpu_dist_nn_torch.utils.errors import check_full_batch

VOCAB_SIZE = 256

_WIKITEXT_ENV = "TDN_WIKITEXT_PATH"
_DEFAULT_PATHS = (
    "~/data/wikitext-2/wiki.train.tokens",
    "~/data/wikitext-2-raw/wiki.train.raw",
)
_CORPUS_DIR = Path(__file__).resolve().parents[2] / "tpu_dist_nn" / "data" / "corpus"
_VENDORED_CORPUS = _CORPUS_DIR / "realtext_corpus.txt"
_VENDORED_CORPUS_R3 = _CORPUS_DIR / "licenses_corpus.txt"

# Word stems for the synthetic corpus; frequencies get a Zipf tail.
_STEMS = (
    "the of and in to a is was for on as by with at from it an be are "
    "this that were which or had its not also has have but one two first "
    "new time year city state war world part name known work made used "
    "century north south system group number station game song film album "
    "series team season league player club county town river road church "
    "school university company government president member history family"
).split()


def encode(text: str) -> np.ndarray:
    """UTF-8 bytes as int32 token ids."""
    return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)


def decode(tokens: np.ndarray) -> str:
    return bytes(np.asarray(tokens, dtype=np.uint8)).decode("utf-8", errors="replace")


def synthetic_wikitext(n_chars: int = 500_000, seed: int = 0) -> str:
    """Deterministic corpus with WikiText-like surface structure (the
    same text as the JAX package's for the same seed)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(_STEMS) + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    out: list[str] = []
    total = 0
    while total < n_chars:
        title = " ".join(
            w.capitalize() for w in rng.choice(_STEMS, size=rng.integers(1, 4), p=probs))
        out.append(f"\n = {title} = \n\n")
        for _ in range(int(rng.integers(2, 6))):  # sections
            if rng.random() < 0.5:
                sub = " ".join(rng.choice(_STEMS, size=2, p=probs))
                out.append(f" = = {sub} = = \n\n")
            for _ in range(int(rng.integers(1, 4))):  # paragraphs
                n_words = int(rng.integers(30, 120))
                words = rng.choice(_STEMS, size=n_words, p=probs).tolist()
                for i in range(0, n_words, int(rng.integers(8, 16))):
                    if i:
                        words[i] = words[i] + " ,"
                out.append(" ".join(words) + " . \n")
            out.append("\n")
        total = sum(len(s) for s in out)
    return "".join(out)[:n_chars]


def load_corpus(path: str | os.PathLike | None = None, *, synthetic_chars: int = 500_000,
                seed: int = 0, allow_synthetic: bool = True) -> tuple[str, str]:
    """-> ``(text, source)``: the first real corpus found (see the
    module docstring for the order), else the synthetic one, or
    ``ValueError`` with ``allow_synthetic=False``."""
    candidates = []
    if path is not None:
        candidates.append(Path(path))
    if os.environ.get(_WIKITEXT_ENV):
        candidates.append(Path(os.environ[_WIKITEXT_ENV]))
    candidates.extend(Path(p).expanduser() for p in _DEFAULT_PATHS)
    candidates.append(_VENDORED_CORPUS)
    candidates.append(_VENDORED_CORPUS_R3)
    for cand in candidates:
        if cand.is_file():
            return cand.read_text(encoding="utf-8", errors="replace"), str(cand)
    if not allow_synthetic:
        raise ValueError(
            "no real corpus found (checked explicit path, "
            f"${_WIKITEXT_ENV}, conventional WikiText locations, and the "
            f"vendored {_VENDORED_CORPUS}) and allow_synthetic=False")
    return synthetic_wikitext(synthetic_chars, seed), "synthetic"


def lm_sequences(tokens: np.ndarray, seq_len: int) -> np.ndarray:
    """Chunk a token stream into ``(N, seq_len + 1)`` training rows
    (inputs plus the last position's target); the tail is dropped."""
    row = seq_len + 1
    n = len(tokens) // row
    return tokens[: n * row].reshape(n, row)


def lm_batches(rows: np.ndarray, batch_size: int, *, seed: int = 0,
               epochs: int | None = 1) -> Iterator[np.ndarray]:
    """Shuffled ``(batch_size, seq_len + 1)`` batches, partial tails
    dropped; ``epochs=None`` cycles forever. The same batches as the JAX
    package's for the same seed."""
    check_full_batch(len(rows), batch_size)
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(rows))
        for i in range(0, len(rows) - batch_size + 1, batch_size):
            yield rows[order[i : i + batch_size]]
        epoch += 1
