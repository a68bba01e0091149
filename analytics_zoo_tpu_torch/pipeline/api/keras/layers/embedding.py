"""Embedding layers: Embedding, SparseEmbedding and WordEmbedding.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/embedding.py``
with the same trees: a trainable table is the parameter ``embeddings``
(input_dim, output_dim); a frozen one (``trainable=False``, as
WordEmbedding is by default) lives in the layer's *state* under the same
name, so the optimizer never sees it.

The lookup is the reference's ``jnp.take(table, ids, axis=0)``, ids cast
to integers first: a negative id in [-n, 0) wraps to ``id + n``, and an id
outside [-n, n) gives a row of NaN.  Indexing a CUDA tensor out of range
fires a device-side assert that kills the context, so :func:`lookup`
clamps, gathers and masks instead, all on the device (no host sync: the
lookup stays capturable).  The gradient of a NaN row is zero, as that of
``jnp.take``'s filled rows.

The table's gradient must be bit-reproducible, or no captured step can be
held against its eager run.  ``F.embedding``'s gradient of more than 3,072
ids sorts them, and on the H100 that path is not reproducible where ids
repeat heavily (24,576 ids over a 100-row character table differ from run
to run; 24,576 over 1,000 rows and 64,000 over 20,000 reproduce:
``tools/embedding_grad_repro.py``).  So a lookup of more than 3,072 ids averaging more than 32 a
row gathers in chunks of 3,072, whose gradients PyTorch sums row by row
in order.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer


#: ``F.embedding``'s gradient of more ids than this takes the sorting path
CHUNK_IDS = 3072
#: ids a row above which the sorting path is not reproducible (see above)
REPEATS = 32


def lookup(table, ids):
    """``jnp.take(table, ids.astype(int32), axis=0)``: rows of ``table``
    for ``ids`` (any shape), negative ids wrapped once, out-of-range ids
    NaN rows."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    valid = (ids >= 0) & (ids < n)
    safe = ids.clamp(0, n - 1)
    m = safe.numel()
    if m > CHUNK_IDS and m > REPEATS * n:
        flat = safe.reshape(-1)
        rows = torch.cat([F.embedding(flat[i:i + CHUNK_IDS], table)
                          for i in range(0, m, CHUNK_IDS)])
        rows = rows.reshape(safe.shape + (table.shape[1],))
    else:
        rows = F.embedding(safe, table)
    return rows.masked_fill(~valid.unsqueeze(-1), float("nan"))


def _ints(tokens) -> bool:
    """Whether every token parses as a Python int."""
    try:
        for tok in tokens:
            int(tok)
    except ValueError:
        return False
    return True


class Embedding(Layer):
    """(batch, ...)[int] -> (batch, ..., output_dim); zero-based ids."""

    def __init__(self, input_dim, output_dim, init="uniform", weights=None,
                 trainable=True, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.init = init
        self.pretrained = weights
        self.trainable = trainable
        self._config = dict(input_dim=input_dim, output_dim=output_dim)

    def build(self, input_shape):
        if self.pretrained is not None:
            w = np.asarray(self.pretrained)
            if w.shape != (self.input_dim, self.output_dim):
                raise ValueError(
                    f"pretrained weights shape {w.shape} != "
                    f"{(self.input_dim, self.output_dim)}")
            init = _Pretrained(w)
        else:
            init = self.init
        self.add_weight("embeddings", (self.input_dim, self.output_dim),
                        init, trainable=self.trainable)

    def call(self, params, inputs, state=None, training=False, rng=None):
        table = params.get("embeddings")
        if table is None:  # frozen: the table lives in state
            return lookup(state["embeddings"], inputs), state
        return lookup(table, inputs)

    @property
    def stateful(self):
        return not self.trainable

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)


class _Pretrained:
    """Picklable initializer that returns fixed pretrained weights."""

    def __init__(self, w):
        self.w = np.asarray(w)

    def __call__(self, gen, shape, dtype):
        return torch.from_numpy(np.array(self.w)).to(dtype)


class SparseEmbedding(Embedding):
    """The reference's SparseEmbedding: an Embedding whose gradient touches
    only the looked-up rows.  ``F.embedding``'s backward already sums into
    those rows alone, so it is the Embedding under its own name."""


class WordEmbedding(Embedding):
    """Frozen pretrained word vectors from a GloVe-format text file,
    mapped through ``word_index`` (word -> id); row 0 is padding/unknown
    (zeros), as are words the file lacks.

    ``WordEmbedding(embedding_file, word_index, input_length)``.
    """

    # one parsed file, keyed by (path, mtime): get_word_index() followed by
    # the constructor reads a large file once
    _vector_cache: dict = {}
    _VECTOR_CACHE_SIZE = 1

    def __init__(self, embedding_file, word_index=None, trainable=False,
                 input_length=None, input_shape=None, name=None, **kwargs):
        vectors, dim = self._load_vectors(embedding_file)
        if word_index is None:
            word_index = {w: i + 1 for i, w in enumerate(sorted(vectors))}
        self.word_index = dict(word_index)
        vocab = max(self.word_index.values()) + 1
        table = np.zeros((vocab, dim), dtype=np.float32)
        hit = 0
        for word, idx in self.word_index.items():
            vec = vectors.get(word)
            if vec is not None and 0 <= idx < vocab:
                table[idx] = vec
                hit += 1
        if input_shape is None and input_length is not None:
            input_shape = (int(input_length),)
        super().__init__(vocab, dim, weights=table, trainable=trainable,
                         input_shape=input_shape, name=name, **kwargs)
        self.n_pretrained = hit

    @staticmethod
    def _load_vectors(path):
        """Parse GloVe/word2vec ``word v1 v2 ...`` text: a word2vec header
        line (``<count> <dim>``) is skipped, and a word with spaces in it
        (``. . .`` in glove.840B) keeps every token before the float
        suffix."""
        key = (path, os.stat(path).st_mtime_ns)
        cached = WordEmbedding._vector_cache.get(key)
        if cached is not None:
            return cached

        def float_suffix_len(parts):
            # float tokens counted from the right; the rest is the word
            n = 0
            for tok in reversed(parts[1:]):
                try:
                    float(tok)
                except ValueError:
                    break
                n += 1
            return n

        vectors, dim = {}, None
        pending = []  # (parts, n_float) until dim is decided

        def keep(rows):
            for p, n in rows:
                if n >= dim:
                    vectors[" ".join(p[:-dim])] = np.asarray(
                        p[-dim:], dtype=np.float32)

        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for lineno, line in enumerate(f):
                parts = line.rstrip().split(" ")
                if len(parts) < 2:
                    continue
                if lineno == 0 and len(parts) == 2 and _ints(parts):
                    continue  # word2vec header "<vocab> <dim>"
                n_float = float_suffix_len(parts)
                if n_float == 0:
                    continue
                if dim is not None:
                    keep([(parts, n_float)])
                    continue
                # a multi-token word whose tail parses as a float inflates
                # n_float, never deflates it: the least over a few lines
                # is the true dim
                pending.append((parts, n_float))
                if len(pending) == 10:
                    dim = min(n for _, n in pending)
                    keep(pending)
                    pending = []
        if dim is None and pending:  # fewer than 10 data lines
            dim = min(n for _, n in pending)
            keep(pending)
        if dim is None:
            raise ValueError(f"no vectors found in {path}")
        cache = WordEmbedding._vector_cache
        while len(cache) >= WordEmbedding._VECTOR_CACHE_SIZE:
            cache.pop(next(iter(cache)))
        cache[key] = (vectors, dim)
        return vectors, dim

    @staticmethod
    def get_word_index(embedding_file):
        """word -> id (1-based) for every word in the embedding file."""
        vectors, _ = WordEmbedding._load_vectors(embedding_file)
        return {w: i + 1 for i, w in enumerate(sorted(vectors))}
