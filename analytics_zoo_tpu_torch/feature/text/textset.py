"""TextSet — text dataset with the tokenize→normalize→word2idx→shape
pipeline and relation pairs/lists for ranking.

The port's own copy of ``analytics_zoo_tpu/feature/text/textset.py`` (the
reference module imports no JAX), with its semantics: the same tokens, the
same 1-based word index (0 for padding and unknown words), the same shaped
arrays and relation arrays, on the port's ``feature/dataset.py``.  The
parquet readers import pandas when called, as the reference's do.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from analytics_zoo_tpu_torch.feature.dataset import (
    ArrayFeatureSet,
    FeatureSet,
)

_TOKEN_RE = re.compile(r"[^a-zA-Z0-9]+")


@dataclass
class TextFeature:
    """One text record (reference TextFeature.scala): raw text + evolving
    fields as the pipeline runs."""

    text: str
    label: int | None = None
    tokens: list[str] | None = None
    indices: np.ndarray | None = None
    uri: str | None = None


@dataclass
class Relation:
    """Query-document relation (reference text/Relation)."""

    id1: str
    id2: str
    label: int


def read_relations_csv(path: str, sep: str = ",") -> list[Relation]:
    """id1,id2,label per line (reference Relations.read,
    feature/common/Relations.scala:43-76); a header line is skipped,
    malformed data lines raise (silent drops would shrink the training
    relation set unnoticed)."""
    out = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            stripped = line.rstrip("\n")
            if not stripped:
                continue
            parts = stripped.split(sep)
            if lineno == 1 and parts[-1] == "label":
                continue  # header
            if len(parts) != 3:
                raise ValueError(
                    f"{path}:{lineno}: expected id1{sep}id2{sep}label, "
                    f"got {stripped!r}")
            out.append(Relation(parts[0], parts[1], int(parts[2])))
    return out


def read_relations_parquet(path: str) -> list[Relation]:
    """Relations from a parquet file with schema "id1"(str), "id2"(str),
    "label"(int) — reference Relations.readParquet
    (feature/common/Relations.scala:78)."""
    import pandas as pd

    df = pd.read_parquet(path)
    return [Relation(str(a), str(b), int(c))
            for a, b, c in zip(df["id1"], df["id2"], df["label"])]


class TextSet:
    """Pipeline container (reference TextSet.scala).  All stages return a
    new TextSet; ``word_index`` is built by word2idx and reusable across
    train/test (``setWordIndex`` semantics)."""

    def __init__(self, features: Sequence[TextFeature],
                 word_index: dict[str, int] | None = None):
        self.features = list(features)
        self.word_index = word_index

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_texts(texts: Iterable[str], labels=None) -> "TextSet":
        labels = list(labels) if labels is not None else None
        return TextSet([
            TextFeature(t, None if labels is None else int(labels[i]))
            for i, t in enumerate(texts)
        ])

    @staticmethod
    def read_csv(path: str, sep: str = ",") -> "TextSet":
        """uri,text per line (reference TextSet.readCSV)."""
        feats = []
        with open(path) as f:
            for line in f:
                uri, text = line.rstrip("\n").split(sep, 1)
                feats.append(TextFeature(text, uri=uri))
        return TextSet(feats)

    @staticmethod
    def read_parquet(path: str) -> "TextSet":
        """Read texts with id from a parquet file with schema
        "id"(str), "text"(str) — reference TextSet.readParquet
        (TextSet.scala:372); pandas/pyarrow stands in for SQLContext."""
        import pandas as pd

        df = pd.read_parquet(path)
        return TextSet([
            TextFeature(str(text), uri=str(uri))
            for uri, text in zip(df["id"], df["text"])
        ])

    # -- pipeline stages ---------------------------------------------------
    def tokenize(self) -> "TextSet":
        """Reference TextSet.tokenize (:97)."""
        for f in self.features:
            f.tokens = [t for t in _TOKEN_RE.split(f.text) if t]
        return self

    def normalize(self) -> "TextSet":
        for f in self.features:
            assert f.tokens is not None, "tokenize first"
            f.tokens = [t.lower() for t in f.tokens]
        return self

    def word2idx(self, remove_topn: int = 0,
                 max_words_num: int = -1,
                 existing_map: dict[str, int] | None = None) -> "TextSet":
        """Build (or reuse) the word index; 1-based, 0 reserved for padding
        (reference TextSet.word2idx :147 semantics)."""
        if existing_map is None and self.word_index is None:
            freq: dict[str, int] = {}
            for f in self.features:
                for t in f.tokens:
                    freq[t] = freq.get(t, 0) + 1
            ordered = sorted(freq.items(), key=lambda kv: -kv[1])
            ordered = ordered[remove_topn:]
            if max_words_num > 0:
                ordered = ordered[:max_words_num]
            self.word_index = {w: i + 1 for i, (w, _) in enumerate(ordered)}
        elif existing_map is not None:
            self.word_index = dict(existing_map)
        for f in self.features:
            f.indices = np.asarray(
                [self.word_index.get(t, 0) for t in f.tokens], np.int32
            )
        return self

    def shape_sequence(self, length: int, mode: str = "pre") -> "TextSet":
        """Pad (with 0) / truncate to fixed length (reference
        SequenceShaper.scala; trunc_mode pre/post)."""
        for f in self.features:
            idx = f.indices
            if len(idx) >= length:
                f.indices = idx[-length:] if mode == "pre" else idx[:length]
            else:
                pad = np.zeros(length - len(idx), np.int32)
                f.indices = np.concatenate([pad, idx]) if mode == "pre" \
                    else np.concatenate([idx, pad])
        return self

    def generate_sample(self) -> "TextSet":
        return self  # indices already materialized; parity no-op

    # -- exports -----------------------------------------------------------
    def to_feature_set(self) -> FeatureSet:
        x = np.stack([f.indices for f in self.features])
        labels = [f.label for f in self.features]
        y = None if any(l is None for l in labels) \
            else np.asarray(labels, np.int32)
        return ArrayFeatureSet(x, y)

    def get_word_index(self) -> dict[str, int]:
        return dict(self.word_index or {})

    def set_word_index(self, vocab: dict[str, int]) -> "TextSet":
        """Assign a word index to use during word2idx (reference
        TextSet.setWordIndex, TextSet.scala:207)."""
        self.word_index = dict(vocab)
        return self

    def save_word_index(self, path: str) -> None:
        """Save the word index as "word id" lines for future inference
        (reference TextSet.saveWordIndex, TextSet.scala:222/687)."""
        if not self.word_index:
            raise ValueError(
                "wordIndex is None, nothing to save. Please transform "
                "from word to index first")
        with open(path, "w") as f:
            for word, idx in self.word_index.items():
                f.write(f"{word} {idx}\n")

    def load_word_index(self, path: str) -> "TextSet":
        """Load a saved "word id" index so word2idx reuses it exactly
        (reference TextSet.loadWordIndex, TextSet.scala:243/698)."""
        vocab = {}
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                word, idx = line.rsplit(" ", 1)
                vocab[word] = int(idx)
        return self.set_word_index(vocab)

    def __len__(self):
        return len(self.features)

    # -- relations (ranking) ----------------------------------------------
    @staticmethod
    def from_relation_pairs(relations: Sequence[Relation],
                            corpus1: "TextSet", corpus2: "TextSet",
                            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Build interleaved (pos, neg) pair arrays for RankHinge training
        (reference TextSet.fromRelationPairs :399): for each query, every
        (pos, neg) doc combination yields two consecutive rows."""
        t1 = {f.uri: f.indices for f in corpus1.features}
        t2 = {f.uri: f.indices for f in corpus2.features}
        by_query: dict[str, dict[int, list[str]]] = {}
        for r in relations:
            by_query.setdefault(r.id1, {}).setdefault(
                int(r.label > 0), []).append(r.id2)
        qs, ds, ys = [], [], []
        for q, groups in by_query.items():
            for pos in groups.get(1, []):
                for neg in groups.get(0, []):
                    qs += [t1[q], t1[q]]
                    ds += [t2[pos], t2[neg]]
                    ys += [1, 0]
        return (np.stack(qs), np.stack(ds),
                np.asarray(ys, np.float32)[:, None])

    @staticmethod
    def from_relation_lists(relations: Sequence[Relation],
                            corpus1: "TextSet", corpus2: "TextSet"):
        """Grouped candidate lists for NDCG/MAP evaluation (reference
        TextSet.fromRelationLists): per query → (q_array, d_array,
        labels)."""
        t1 = {f.uri: f.indices for f in corpus1.features}
        t2 = {f.uri: f.indices for f in corpus2.features}
        by_query: dict[str, list[Relation]] = {}
        for r in relations:
            by_query.setdefault(r.id1, []).append(r)
        out = []
        for q, rels in by_query.items():
            qa = np.stack([t1[q]] * len(rels))
            da = np.stack([t2[r.id2] for r in rels])
            labels = np.asarray([r.label for r in rels], np.float32)
            out.append((qa, da, labels))
        return out
