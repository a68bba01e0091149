"""Recommendation models: NeuralCF, WideAndDeep and SessionRecommender,
with the ``Recommender`` scoring helpers.

Counterpart of ``analytics_zoo_tpu/models/recommendation.py``, layer for
layer and name for name, so a JAX model's parameters carry over with
``params_from_jax``.  Ids are zero-based; a NeuralCF record is a pair of
0-d ids (``Input(shape=())``).
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.pipeline.api.autograd import LambdaOp
from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    GRU,
    Activation,
    Dense,
    Embedding,
    Flatten,
    Merge,
)


class Recommender(ZooModel):
    """Base with the candidate-scoring helpers: ``recommendForUser`` and
    ``recommendForItem``."""

    def predict_user_item_pair(self, user_item_pairs, batch_size=1024):
        """Score (user, item) id pairs: the positive class's probability
        (the last column)."""
        pairs = np.asarray(user_item_pairs)
        probs = np.asarray(self.predict([pairs[:, 0], pairs[:, 1]],
                                        batch_size=batch_size))
        return probs[:, -1] if probs.ndim == 2 and probs.shape[1] > 1 \
            else probs.reshape(-1)

    def recommend_for_user(self, user_id, candidate_items, max_items=5,
                           batch_size=1024):
        items = np.asarray(candidate_items)
        pairs = np.stack([np.full_like(items, user_id), items], axis=1)
        scores = self.predict_user_item_pair(pairs, batch_size)
        order = np.argsort(-scores)[:max_items]
        return [(int(items[i]), float(scores[i])) for i in order]

    def recommend_for_item(self, item_id, candidate_users, max_users=5,
                           batch_size=1024):
        users = np.asarray(candidate_users)
        pairs = np.stack([users, np.full_like(users, item_id)], axis=1)
        scores = self.predict_user_item_pair(pairs, batch_size)
        order = np.argsort(-scores)[:max_users]
        return [(int(users[i]), float(scores[i])) for i in order]


class NeuralCF(Recommender):
    """Neural collaborative filtering: an MLP tower over the concatenated
    user and item embeddings, and with ``include_mf`` a GMF arm (their
    elementwise product) concatenated before the softmax head.  Inputs:
    ``[user_ids, item_ids]``."""

    def __init__(self, user_count, item_count, class_num=2, user_embed=20,
                 item_embed=20, hidden_layers=(40, 20, 10), include_mf=True,
                 mf_embed=20):
        self.user_count = int(user_count)
        self.item_count = int(item_count)
        self.class_num = int(class_num)
        self.user_embed = int(user_embed)
        self.item_embed = int(item_embed)
        self.hidden_layers = tuple(hidden_layers)
        self.include_mf = include_mf
        self.mf_embed = int(mf_embed)
        super().__init__()

    def build_model(self):
        user = Input(shape=(), name="user_input")
        item = Input(shape=(), name="item_input")
        mlp_u = Embedding(self.user_count, self.user_embed,
                          name="mlp_user_embed")(user)
        mlp_i = Embedding(self.item_count, self.item_embed,
                          name="mlp_item_embed")(item)
        h = Merge(mode="concat", concat_axis=-1)([mlp_u, mlp_i])
        for i, width in enumerate(self.hidden_layers):
            h = Dense(width, activation="relu", name=f"mlp_{i}")(h)
        if self.include_mf:
            mf_u = Embedding(self.user_count, self.mf_embed,
                             name="mf_user_embed")(user)
            mf_i = Embedding(self.item_count, self.mf_embed,
                             name="mf_item_embed")(item)
            mf = Merge(mode="mul")([mf_u, mf_i])
            h = Merge(mode="concat", concat_axis=-1)([h, mf])
        out = Dense(self.class_num, activation="softmax", name="head")(h)
        return Model([user, item], out, name="neural_cf")


class ColumnFeatureInfo:
    """Which columns feed the wide, indicator, embedding and continuous
    parts of WideAndDeep, and their sizes."""

    def __init__(self, wide_base_cols=(), wide_base_dims=(),
                 wide_cross_cols=(), wide_cross_dims=(),
                 indicator_cols=(), indicator_dims=(),
                 embed_cols=(), embed_in_dims=(), embed_out_dims=(),
                 continuous_cols=()):
        self.wide_base_cols = list(wide_base_cols)
        self.wide_base_dims = list(wide_base_dims)
        self.wide_cross_cols = list(wide_cross_cols)
        self.wide_cross_dims = list(wide_cross_dims)
        self.indicator_cols = list(indicator_cols)
        self.indicator_dims = list(indicator_dims)
        self.embed_cols = list(embed_cols)
        self.embed_in_dims = list(embed_in_dims)
        self.embed_out_dims = list(embed_out_dims)
        self.continuous_cols = list(continuous_cols)

    @property
    def wide_dim(self):
        return sum(self.wide_base_dims) + sum(self.wide_cross_dims)

    @property
    def indicator_dim(self):
        return sum(self.indicator_dims)


class WideAndDeep(Recommender):
    """Wide & Deep: a linear wide arm over the multi-hot wide columns and
    a deep MLP over the indicators, the embedded id columns and the
    continuous columns, summed before the softmax.  Inputs ``[wide,
    indicators, embed_ids, continuous]`` (those the columns use), from
    :func:`to_wide_deep_features`."""

    def __init__(self, model_type="wide_n_deep", class_num=2,
                 column_info: ColumnFeatureInfo | None = None,
                 hidden_layers=(40, 20, 10)):
        if model_type not in ("wide", "deep", "wide_n_deep"):
            raise ValueError(f"model_type {model_type!r}")
        self.model_type = model_type
        self.class_num = int(class_num)
        self.column_info = column_info or ColumnFeatureInfo()
        self.hidden_layers = tuple(hidden_layers)
        super().__init__()

    def build_model(self):
        info = self.column_info
        inputs, arms = [], []
        if self.model_type in ("wide", "wide_n_deep"):
            wide = Input(shape=(info.wide_dim,), name="wide_input")
            inputs.append(wide)
            arms.append(Dense(self.class_num, bias=False,
                              name="wide_linear")(wide))
        if self.model_type in ("deep", "wide_n_deep"):
            deep_parts = []
            if info.indicator_dim:
                ind = Input(shape=(info.indicator_dim,),
                            name="indicator_input")
                inputs.append(ind)
                deep_parts.append(ind)
            if info.embed_cols:
                ids = Input(shape=(len(info.embed_cols),),
                            name="embed_input")
                inputs.append(ids)
                for i, (col, in_dim, out_dim) in enumerate(zip(
                        info.embed_cols, info.embed_in_dims,
                        info.embed_out_dims)):
                    pick = LambdaOp(
                        (lambda idx: (lambda v: v[:, idx].to(
                            torch.int32)))(i),
                        (lambda s: (s[0],)), op_name=f"pick_{col}",
                    )(ids)
                    deep_parts.append(Embedding(in_dim + 1, out_dim,
                                                name=f"embed_{col}")(pick))
            if info.continuous_cols:
                cont = Input(shape=(len(info.continuous_cols),),
                             name="continuous_input")
                inputs.append(cont)
                deep_parts.append(cont)
            h = deep_parts[0] if len(deep_parts) == 1 else Merge(
                mode="concat", concat_axis=-1)(deep_parts)
            for i, width in enumerate(self.hidden_layers):
                h = Dense(width, activation="relu", name=f"deep_{i}")(h)
            arms.append(Dense(self.class_num, name="deep_head")(h))
        merged = arms[0] if len(arms) == 1 else Merge(mode="sum")(arms)
        out = Activation("softmax")(merged)
        return Model(inputs, out, name=self.model_type)

    def predict_user_item_pair(self, features, batch_size=1024):
        probs = np.asarray(self.predict(features, batch_size=batch_size))
        return probs[:, -1]

    def recommend_for_user(self, *args, **kwargs):
        raise NotImplementedError(
            "WideAndDeep scores feature rows, not raw (user, item) ids: "
            "build inputs with to_wide_deep_features and call "
            "predict_user_item_pair (as the reference, which joins "
            "features per candidate before scoring)")

    def recommend_for_item(self, *args, **kwargs):
        raise NotImplementedError(
            "WideAndDeep scores feature rows; see recommend_for_user")


def to_wide_deep_features(rows: dict, info: ColumnFeatureInfo):
    """WideAndDeep's input arrays from a columnar dict of arrays: the
    multi-hot wide block, the one-hot indicators, the id columns (as f32)
    and the continuous columns, those ``info`` declares, in that order."""
    n = len(next(iter(rows.values())))
    outs = []
    if info.wide_dim:
        wide = np.zeros((n, info.wide_dim), np.float32)
        offset = 0
        for col, dim in zip(info.wide_base_cols + info.wide_cross_cols,
                            info.wide_base_dims + info.wide_cross_dims):
            idx = np.asarray(rows[col]).astype(np.int64) % dim
            wide[np.arange(n), offset + idx] = 1.0
            offset += dim
        outs.append(wide)
    if info.indicator_dim:
        ind = np.zeros((n, info.indicator_dim), np.float32)
        offset = 0
        for col, dim in zip(info.indicator_cols, info.indicator_dims):
            idx = np.asarray(rows[col]).astype(np.int64) % dim
            ind[np.arange(n), offset + idx] = 1.0
            offset += dim
        outs.append(ind)
    if info.embed_cols:
        outs.append(np.stack([np.asarray(rows[c]) for c in info.embed_cols],
                             axis=1).astype(np.float32))
    if info.continuous_cols:
        outs.append(np.stack(
            [np.asarray(rows[c]) for c in info.continuous_cols],
            axis=1).astype(np.float32))
    return outs


class SessionRecommender(Recommender):
    """Session-based recommendation: the embedded session item sequence
    through a GRU stack, optionally beside an MLP over a longer purchase
    history, then a softmax over the items."""

    def __init__(self, item_count, item_embed=100, rnn_hidden_layers=(40, 20),
                 session_length=5, include_history=False,
                 mlp_hidden_layers=(40, 20), history_length=10):
        self.item_count = int(item_count)
        self.item_embed = int(item_embed)
        self.rnn_hidden_layers = tuple(rnn_hidden_layers)
        self.session_length = int(session_length)
        self.include_history = include_history
        self.mlp_hidden_layers = tuple(mlp_hidden_layers)
        self.history_length = int(history_length)
        super().__init__()

    def build_model(self):
        session = Input(shape=(self.session_length,), name="session_input")
        h = Embedding(self.item_count + 1, self.item_embed,
                      name="session_embed")(session)
        for i, width in enumerate(self.rnn_hidden_layers[:-1]):
            h = GRU(width, return_sequences=True, name=f"gru_{i}")(h)
        h = GRU(self.rnn_hidden_layers[-1], name="gru_last")(h)
        inputs = [session]
        if self.include_history:
            hist = Input(shape=(self.history_length,), name="history_input")
            inputs.append(hist)
            g = Embedding(self.item_count + 1, self.item_embed,
                          name="history_embed")(hist)
            g = Flatten()(g)
            for i, width in enumerate(self.mlp_hidden_layers):
                g = Dense(width, activation="relu", name=f"mlp_{i}")(g)
            h = Merge(mode="concat", concat_axis=-1)([h, g])
        out = Dense(self.item_count + 1, activation="softmax",
                    name="item_head")(h)
        return Model(inputs, out, name="session_recommender")

    def recommend_for_session(self, sessions, max_items=5, batch_size=1024):
        probs = np.asarray(self.predict(sessions, batch_size=batch_size))
        top = np.argsort(-probs, axis=1)[:, :max_items]
        return [[(int(i), float(p[i])) for i in row]
                for row, p in zip(top, probs)]
