"""Token-stream corpus for the port: a numpy copy of
``tpu_dist/data/tokens.py``, so token rows are bit-equal to the
reference's (the synthetic affine stream, ``synthetic_stream :78``, and the
stride-L (L+1)-token rows).

The reference's notes:

Token-stream corpus for the LM family (the LM analog of datasets.py C4).

The reference has no language-model pipeline at all (SURVEY.md §2c); this
gives the LM half of the framework the same data contract the image half
has, so ONE loop drives both:

* a corpus is a flat int token stream on the host — loaded from a binary
  token file (``.bin`` uint16/uint32, memmap'd — the standard nanoGPT-style
  format — or ``.npy``), or generated as the deterministic synthetic affine
  stream (x -> 5x+7 mod V with 5% noise) so training curves are meaningful
  in a zero-egress environment;
* training examples are overlapping (seq_len+1)-token ROWS cut at stride
  seq_len: row i = stream[i*L : i*L + L + 1], so consecutive rows share one
  boundary token and every next-token target exists. Rows are the unit the
  DistributedSampler shuffles/shards — giving the LM path the exact same
  N-process bit-exactness story as images (tpu_dist.data.sampler);
* train/val split is by STREAM PREFIX/SUFFIX (val = held-out tail), never
  by row shuffle — rows overlap, so a shuffled split would leak val tokens
  into train.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class TokenDataset:
    """Host-side token corpus view: rows of (seq_len+1) int32 tokens."""

    stream: np.ndarray          # (n_tokens,) int — possibly a memmap
    seq_len: int
    vocab_size: int
    name: str = "tokens"

    def __post_init__(self):
        if self.stream.ndim != 1:
            raise ValueError("token stream must be 1-D")
        if len(self.stream) < self.seq_len + 1:
            raise ValueError(
                f"corpus of {len(self.stream)} tokens is shorter than one "
                f"{self.seq_len + 1}-token row")

    def __len__(self) -> int:
        # stride-L rows needing L+1 tokens each
        return (len(self.stream) - 1) // self.seq_len

    @property
    def num_tokens(self) -> int:
        return len(self) * self.seq_len  # target tokens per epoch

    def get_rows(self, indices: np.ndarray) -> np.ndarray:
        """(n,) row indices -> (n, seq_len+1) int32 rows (vectorized gather;
        works on memmaps — only the touched pages are read)."""
        l = self.seq_len
        idx = np.asarray(indices, np.int64)
        pos = idx[:, None] * l + np.arange(l + 1)
        return np.asarray(self.stream[pos.ravel()], np.int32).reshape(
            len(idx), l + 1)

    def rows_array(self) -> np.ndarray:
        """ALL rows as one (n_rows, seq_len+1) int32 array (HBM-resident
        path). Materialized from the stream view; for CIFAR-scale synthetic
        corpora this is a few MB."""
        n, l = len(self), self.seq_len
        # stride trick: rows overlap by one token, so a strided view of the
        # stream IS the row matrix (no copy until ascontiguousarray)
        base = np.lib.stride_tricks.as_strided(
            self.stream[: n * l + 1], shape=(n, l + 1),
            strides=(self.stream.strides[0] * l, self.stream.strides[0]))
        return np.ascontiguousarray(base, np.int32)


def synthetic_stream(n_tokens: int, vocab_size: int, seed: int = 0,
                     noise: float = 0.05) -> np.ndarray:
    """Deterministic learnable stream: x_{t+1} = 5*x_t + 7 (mod V), with
    ``noise`` fraction of uniform re-draws — the affine rule the round-2 LM
    demo trained on, now as a corpus (vectorized generation)."""
    rng = np.random.default_rng(seed)
    # fully vectorized: noise re-draws cut the stream into segments, and
    # within a segment position t is the affine orbit of its segment's seed:
    # x_{s+d} = 5^d * x_s + c_d (mod V), with c_d = 7 * (5^d - 1) / 4
    flips = rng.random(n_tokens) < noise
    flips[0] = True
    draws = rng.integers(0, vocab_size, n_tokens).astype(np.int64)
    seg = np.cumsum(flips) - 1                      # segment id per position
    starts = np.flatnonzero(flips)                  # segment start positions
    d = np.arange(n_tokens) - starts[seg]           # steps since segment seed
    max_d = int(d.max()) + 1
    a = np.empty(max_d, np.int64)                   # 5^d mod V
    c = np.empty(max_d, np.int64)                   # additive orbit term
    a[0], c[0] = 1, 0
    for i in range(1, max_d):                       # loop over max segment
        a[i] = (a[i - 1] * 5) % vocab_size          # length (~100s), not N
        c[i] = (c[i - 1] * 5 + 7) % vocab_size
    seeds = draws[starts][seg]
    return ((a[d] * seeds + c[d]) % vocab_size).astype(np.int32)


def _load_stream(path: str) -> Tuple[np.ndarray, int]:
    """(stream, inferred_vocab) from a token file. ``.npy`` loads through
    numpy; ``.bin`` memmaps with the dtype named by TPU_DIST_TOKEN_DTYPE
    (default uint16, nanoGPT's format), after checking the file size is a
    whole number of items — a wrong dtype setting on a uint16 file would
    otherwise yield garbage token ids (ADVICE r3)."""
    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
    else:
        dtype = np.dtype(os.environ.get("TPU_DIST_TOKEN_DTYPE", "uint16"))
        size = os.path.getsize(path)
        if size % dtype.itemsize:
            raise ValueError(
                f"{path}: {size} bytes is not a whole number of "
                f"{dtype.name} tokens — set TPU_DIST_TOKEN_DTYPE to the "
                "dtype the file was written with")
        arr = np.memmap(path, dtype=dtype, mode="r")
    # FULL scan for the max id (chunked — sequential memmap reads run at
    # disk bandwidth): a sampled max would under-size the embedding table
    # and out-of-range ids clamp SILENTLY under jit
    vocab = 0
    for start in range(0, len(arr), 1 << 24):
        vocab = max(vocab, int(np.max(arr[start: start + (1 << 24)])))
    return arr, vocab + 1


def load_token_dataset(data: str, seq_len: int, vocab_size: int,
                       val_frac: float = 0.05,
                       synth_tokens: int = 2_000_000,
                       seed: int = 0,
                       val_data: str = "",
                       ) -> Tuple[TokenDataset, TokenDataset]:
    """Returns (train, val) TokenDatasets.

    ``data`` = path to a token file; empty/missing -> the synthetic affine
    corpus (``synth_tokens`` long). ``val_data`` names a separate val file;
    otherwise the last ``val_frac`` of the stream is held out (prefix/suffix
    split — rows overlap, so a shuffled split would leak).
    """
    if data and os.path.exists(data):
        stream, inferred = _load_stream(data)
        vocab = max(vocab_size, inferred)
        name = os.path.basename(data)
    else:
        if data:
            print(f"token file {data!r} not found — synthetic affine corpus",
                  flush=True)
        stream = synthetic_stream(synth_tokens, vocab_size, seed)
        vocab = vocab_size
        name = "synth-affine"
    if val_data and os.path.exists(val_data):
        val_stream, val_vocab = _load_stream(val_data)
        vocab = max(vocab, val_vocab)  # val ids must fit the embedding too
        train_stream = stream
    else:
        n_val = max(seq_len + 1, int(len(stream) * val_frac))
        if n_val >= len(stream):
            raise ValueError(f"val fraction {val_frac} leaves no train data")
        train_stream, val_stream = stream[:-n_val], stream[-n_val:]
    return (TokenDataset(train_stream, seq_len, vocab, f"{name}-train"),
            TokenDataset(val_stream, seq_len, vocab, f"{name}-val"))
