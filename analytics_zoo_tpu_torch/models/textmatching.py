"""Text matching — the KNRM kernel-pooling ranking model.

Counterpart of ``analytics_zoo_tpu/models/textmatching.py``, layer for
layer and name for name (``embedding``, the ``kernel_pool`` op, ``score``),
so a JAX model's parameters carry over with ``params_from_jax``: query and
document embeddings → the cosine translation matrix (``batch_dot`` with
``normalize=True``) → RBF kernel pooling over ``kernel_num`` kernels (mu
from 1.0 down in 2 / (kernel_num - 1) steps; sigma 0.1, and
``exact_sigma`` where mu > 1 - 1e-6, the exact-match kernel) → the log of
each query term's soft match count, summed over the query → a Dense score.
The kernel pooling is a ``LambdaOp`` whose body is torch: 21 elementwise
passes over the (B, Lq, Ld) matrix at the default width, left unfused.
Pairs with the ``rank_hinge`` loss and the ``Ranker`` NDCG/MAP metrics.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.common import Ranker, ZooModel
from analytics_zoo_tpu_torch.pipeline.api.autograd import (
    LambdaOp,
    batch_dot,
    clip_values,
)
from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Dense,
    Embedding,
)


def kernel_pool(sim, kernel_num, sigma, exact_sigma):
    """(B, Lq, Ld) cosines → (B, kernel_num) pooled features: for each
    kernel, ``exp(-(sim - mu)^2 / (2 s^2))`` summed over the document,
    clipped at 1e-10, logged, scaled by 0.01 and summed over the query."""
    feats = []
    for i in range(kernel_num):
        mu = 1.0 - i * (2.0 / (kernel_num - 1))
        s = exact_sigma if mu > 1.0 - 1e-6 else sigma
        k = torch.exp(-((sim - mu) ** 2) / (2.0 * s * s))
        kq = torch.log(clip_values(torch.sum(k, dim=2), 1e-10)) * 0.01
        feats.append(torch.sum(kq, dim=1))
    return torch.stack(feats, dim=1)


class KNRM(ZooModel, Ranker):
    """KNRM over (query ids (B, text1_length), document ids (B,
    text2_length)); ``target_mode="ranking"`` gives a linear score,
    anything else a sigmoid."""

    def __init__(self, text1_length, text2_length, vocab_size=20000,
                 embed_size=300, embed_weights=None, train_embed=True,
                 kernel_num=21, sigma=0.1, exact_sigma=0.001,
                 target_mode="ranking"):
        self.text1_length = int(text1_length)
        self.text2_length = int(text2_length)
        self.vocab_size = int(vocab_size)
        self.embed_size = int(embed_size)
        self.embed_weights = embed_weights
        self.train_embed = train_embed
        if int(kernel_num) < 2:
            raise ValueError("kernel_num must be >= 2 (kernel mus span "
                             "[1.0, -1.0] in 2/(kernel_num-1) steps)")
        self.kernel_num = int(kernel_num)
        self.sigma = float(sigma)
        self.exact_sigma = float(exact_sigma)
        self.target_mode = target_mode
        super().__init__()

    def build_model(self):
        q = Input(shape=(self.text1_length,), name="query")
        d = Input(shape=(self.text2_length,), name="doc")
        embed = Embedding(self.vocab_size, self.embed_size,
                          weights=self.embed_weights,
                          trainable=self.train_embed, name="embedding")
        qe = embed(q)
        de = embed(d)
        # cosine translation matrix (B, Lq, Ld)
        mm = batch_dot(qe, de, axes=(2, 2), normalize=True)
        kernel_num, sigma, exact_sigma = (
            self.kernel_num, self.sigma, self.exact_sigma
        )
        pooled = LambdaOp(
            lambda sim: kernel_pool(sim, kernel_num, sigma, exact_sigma),
            lambda s: (s[0], kernel_num), op_name="kernel_pool"
        )(mm)
        if self.target_mode == "ranking":
            out = Dense(1, name="score")(pooled)
        else:
            out = Dense(1, activation="sigmoid", name="score")(pooled)
        return Model([q, d], out, name="knrm")

    def _group_scores(self, grouped_qd, batch_size):
        return [
            np.asarray(self.predict([np.asarray(g[0]), np.asarray(g[1])],
                                    batch_size=batch_size)).reshape(-1)
            for g in grouped_qd
        ]

    def evaluate_ndcg(self, grouped_qd, grouped_labels, k=10,
                      batch_size=1024):
        """The reference's Ranker.evaluateNDCG over relation lists: one
        (queries, documents) pair of arrays a group."""
        return self.ndcg(grouped_labels,
                         self._group_scores(grouped_qd, batch_size), k)

    def evaluate_map(self, grouped_qd, grouped_labels, batch_size=1024):
        return self.mean_average_precision(
            grouped_labels, self._group_scores(grouped_qd, batch_size))
