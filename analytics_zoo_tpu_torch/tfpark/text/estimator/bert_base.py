"""BERT estimator base.

Counterpart of ``analytics_zoo_tpu/tfpark/text/estimator/bert_base.py``
(the reference's pyzoo/zoo/tfpark/text/estimator/bert_base.py:21-130).
The encoder is the port's own ``BERT`` layer (its attention through the
flash kernels on the card), and each estimator supplies a head over the
``[sequence_output, pooled_output]`` pair.

A warm-start archive holds the encoder's leaves as ``"{layer}/{i}"`` in
JAX's flatten order (dict keys sorted, lists by position), so an archive
written by either package warm-starts the other.
"""

from __future__ import annotations

import json
import logging

import numpy as np
import torch

from analytics_zoo_tpu_torch.convert import sorted_leaves
from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT
from analytics_zoo_tpu_torch.tfpark.estimator import TFEstimator

logger = logging.getLogger("analytics_zoo_tpu_torch")


def read_bert_config(bert_config_file: str | None) -> dict:
    """google-research bert_config.json -> BERT layer kwargs."""
    if bert_config_file is None:
        return {}
    with open(bert_config_file) as f:
        cfg = json.load(f)
    return dict(
        vocab=cfg.get("vocab_size", 30522),
        hidden_size=cfg.get("hidden_size", 768),
        n_block=cfg.get("num_hidden_layers", 12),
        n_head=cfg.get("num_attention_heads", 12),
        seq_len=cfg.get("max_position_embeddings", 512),
        intermediate_size=cfg.get("intermediate_size", 3072),
        hidden_p_drop=cfg.get("hidden_dropout_prob", 0.1),
        attn_p_drop=cfg.get("attention_probs_dropout_prob", 0.1),
        type_vocab=cfg.get("type_vocab_size", 2),
    )


def bert_input_fn(data, max_seq_length: int, batch_size: int = 32,
                  labels=None):
    """Build an input_fn from token arrays (reference bert_base.py:51-106
    takes an RDD of feature dicts).

    ``data``: dict with ``input_ids``, optional ``token_type_ids``,
    ``position_ids``, ``input_mask`` arrays of shape (N, max_seq_length),
    or just the input_ids array.
    """
    if not isinstance(data, dict):
        data = {"input_ids": np.asarray(data)}
    ids = np.asarray(data["input_ids"], np.int32)
    n, l = ids.shape
    assert l == max_seq_length, f"input_ids length {l} != {max_seq_length}"
    types = np.asarray(data.get("token_type_ids",
                                np.zeros_like(ids)), np.int32)
    positions = np.asarray(data.get(
        "position_ids", np.broadcast_to(np.arange(l, dtype=np.int32),
                                        (n, l))), np.int32)
    mask = np.asarray(data.get("input_mask", np.ones_like(ids)), np.int32)
    xs = [ids, types, positions, mask]
    y = data.get("labels", labels)

    def input_fn():
        return FeatureSet.of(xs, None if y is None else np.asarray(y))

    return input_fn


def replace_sorted(tree, leaves):
    """``tree`` with its leaves, in :func:`sorted_leaves` order, replaced
    by ``leaves`` (an iterator); the structure is kept."""
    if isinstance(tree, dict):
        out = {k: replace_sorted(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replace_sorted(v, leaves) for v in tree)
    return next(leaves)


class BERTBaseEstimator(TFEstimator):
    """Reference bert_base.py:108-130: TFEstimator whose model_fn runs the
    BERT encoder then a task head.

    ``head_fn(seq_output, pooled_output, labels, mode, params)`` returns a
    TFEstimatorSpec.
    """

    def __init__(self, head_fn, bert_config_file=None, init_checkpoint=None,
                 optimizer=None, model_dir=None, **bert_overrides):
        bert_kwargs = read_bert_config(bert_config_file)
        bert_kwargs.update(bert_overrides)
        self._bert_kwargs = bert_kwargs
        self._init_checkpoint = init_checkpoint
        self._head_fn = head_fn
        self.bert = None

        def model_fn(features, labels, mode, params):
            self.bert = BERT(**bert_kwargs)
            seq, pooled = self.bert(list(features))
            return head_fn(seq, pooled, labels, mode, params)

        super().__init__(model_fn, optimizer=optimizer, model_dir=model_dir)

    def _ensure_built(self, fs, mode):
        first = self._spec is None
        super()._ensure_built(fs, mode)
        if first and self._init_checkpoint:
            self._load_init_checkpoint()

    def _load_init_checkpoint(self):
        """Warm-start the encoder from saved weights (reference
        init_checkpoint: tf checkpoint restore); warns on a partial miss,
        raises on a total one."""
        net = self._train_net or self._pred_net
        params, _ = net.build_params()
        # plain-array archive (save_init_checkpoint writes arrays only);
        # allow_pickle stays False so a tampered file cannot smuggle a
        # pickle payload through an object array
        with np.load(self._init_checkpoint, allow_pickle=False) as data:
            saved = {k: data[k] for k in data.files}
        name = self.bert.name
        bert_params = params.get(name)
        if bert_params is None:
            raise ValueError(
                f"no parameter group {name!r} in the built net; cannot "
                "warm-start")
        flat = sorted_leaves(bert_params)
        restored, misses = [], 0
        for i, leaf in enumerate(flat):
            hit = saved.get(f"{name}/{i}")
            if hit is None or tuple(hit.shape) != tuple(leaf.shape):
                misses += 1
                restored.append(leaf)
            else:
                restored.append(torch.from_numpy(np.array(hit)).to(
                    leaf.device, leaf.dtype))
        if misses == len(flat):
            raise ValueError(
                f"init_checkpoint {self._init_checkpoint!r} matches none of "
                f"the {len(flat)} encoder leaves (saved under a different "
                "layer name or architecture)")
        if misses:
            logger.warning(
                "warm-start restored %d/%d encoder leaves; %d kept their "
                "fresh initialization (shape/name mismatch)",
                len(flat) - misses, len(flat), misses)
        params[name] = replace_sorted(bert_params, iter(restored))
        net.params = params
        net._predict_fn = None  # its captures read the old buffers

    def save_init_checkpoint(self, path: str):
        """Save the trained encoder for later warm-starts."""
        net = self._train_net or self._pred_net
        name = self.bert.name
        flat = sorted_leaves(net.params[name])
        np.savez(path, **{f"{name}/{i}": a.detach().cpu().numpy()
                          for i, a in enumerate(flat)})
