"""Seq2seq: an LSTM encoder and decoder over one shared embedding, with a
Bridge between their states.

Counterpart of ``analytics_zoo_tpu/models/seq2seq.py``: the stacked
encoder's final (h, c) per layer go through the bridge (``"pass"``, or
``"dense"``: tanh of a dense map of [h; c]) into the decoder; training is
teacher-forced; :meth:`Seq2seq.infer` generates greedily for a static
``max_len``.  Its own LSTM step uses ``sigmoid`` gates (the Keras layers'
default is ``hard_sigmoid``), gate order i, f, c, o.  The reference scans
time with ``lax.scan``; here the loops are Python loops over the steps.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    Layer,
    fold_in,
    get_initializer,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.embedding import (
    lookup,
)


def _lstm_step(params, h, c, x):
    z = x @ params["kernel"] + h @ params["recurrent_kernel"] \
        + params["bias"]
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def _init_lstm(gen, in_dim, units):
    return {
        "kernel": get_initializer("glorot_uniform")(
            fold_in(gen, 0), (in_dim, 4 * units), torch.float32),
        "recurrent_kernel": get_initializer("orthogonal")(
            fold_in(gen, 1), (units, 4 * units), torch.float32),
        "bias": torch.zeros(4 * units),
    }


class Seq2seq(Layer):
    """Encoder-decoder LSTM stack with an embedding and a Bridge.

    Inputs ``[encoder_tokens (B, Le), decoder_tokens (B, Ld)]`` (teacher
    forcing); output (B, Ld, vocab) softmax.
    """

    def __init__(self, vocab_size, embed_dim=64, hidden_sizes=(128,),
                 bridge="pass", name=None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.vocab_size = int(vocab_size)
        self.embed_dim = int(embed_dim)
        self.hidden_sizes = tuple(hidden_sizes)
        if bridge not in ("pass", "dense"):
            raise ValueError(f"bridge {bridge!r}")
        self.bridge = bridge

    def build(self, input_shape):
        pass

    def init_params(self, rng):
        glorot = get_initializer("glorot_uniform")
        params = {
            "embed": get_initializer("uniform")(
                fold_in(rng, 0), (self.vocab_size, self.embed_dim),
                torch.float32),
            "enc": [], "dec": [],
            "head_kernel": glorot(fold_in(rng, 1),
                                  (self.hidden_sizes[-1], self.vocab_size),
                                  torch.float32),
            "head_bias": torch.zeros(self.vocab_size),
        }
        in_dim = self.embed_dim
        for li, width in enumerate(self.hidden_sizes):
            params["enc"].append(
                _init_lstm(fold_in(rng, 2 + 2 * li), in_dim, width))
            params["dec"].append(
                _init_lstm(fold_in(rng, 3 + 2 * li), in_dim, width))
            in_dim = width
        if self.bridge == "dense":
            params["bridge"] = [
                {"kernel": glorot(fold_in(fold_in(rng, 1000), li),
                                  (2 * w, 2 * w), torch.float32),
                 "bias": torch.zeros(2 * w)}
                for li, w in enumerate(self.hidden_sizes)]
        return params

    def _encode(self, params, tokens):
        x = lookup(params["embed"], tokens)
        b = tokens.shape[0]
        states = []
        seq = list(x.unbind(1))
        for lp, width in zip(params["enc"], self.hidden_sizes):
            h = torch.zeros((b, width), dtype=x.dtype, device=x.device)
            c = torch.zeros_like(h)
            outs = []
            for x_t in seq:
                h, c = _lstm_step(lp, h, c, x_t)
                outs.append(h)
            states.append((h, c))
            seq = outs
        return states

    def _bridge(self, params, states):
        """Encoder final states -> decoder initial states: ``"pass"`` as
        they are, ``"dense"`` through tanh of a dense map of [h; c]."""
        if self.bridge == "pass":
            return states
        out = []
        for bp, (h, c) in zip(params["bridge"], states):
            hc = torch.tanh(torch.cat([h, c], dim=-1) @ bp["kernel"]
                            + bp["bias"])
            w = h.shape[-1]
            out.append((hc[:, :w], hc[:, w:]))
        return out

    def _decode_teacher(self, params, states, tokens):
        seq = list(lookup(params["embed"], tokens).unbind(1))
        for lp, (h, c) in zip(params["dec"], states):
            outs = []
            for x_t in seq:
                h, c = _lstm_step(lp, h, c, x_t)
                outs.append(h)
            seq = outs
        out = torch.stack(seq, 1)
        logits = out @ params["head_kernel"] + params["head_bias"]
        return torch.softmax(logits, dim=-1)

    def call(self, params, inputs, state=None, training=False, rng=None):
        enc_tokens, dec_tokens = inputs
        states = self._bridge(params, self._encode(params, enc_tokens))
        return self._decode_teacher(params, states, dec_tokens)

    def compute_output_shape(self, input_shape):
        enc, dec = input_shape
        return (dec[0], dec[1], self.vocab_size)

    def infer(self, params, enc_tokens, start_sign: int, max_len: int = 20,
              stop_sign: int | None = None):
        """Greedy generation of ``max_len`` tokens a row (numpy (B,
        max_len)); after a row's first ``stop_sign`` every token is
        ``stop_sign``."""
        device = params["embed"].device
        with torch.no_grad():
            enc = torch.as_tensor(np.asarray(enc_tokens), device=device)
            layer_states = self._bridge(params, self._encode(params, enc))
            tok = torch.full((enc.shape[0],), int(start_sign),
                             dtype=torch.int64, device=device)
            toks = []
            for _ in range(int(max_len)):
                x = lookup(params["embed"], tok)
                new_states = []
                for lp, (h, c) in zip(params["dec"], layer_states):
                    h, c = _lstm_step(lp, h, c, x)
                    new_states.append((h, c))
                    x = h
                layer_states = new_states
                logits = x @ params["head_kernel"] + params["head_bias"]
                tok = torch.argmax(logits, dim=-1)
                toks.append(tok)
            toks = torch.stack(toks, 1).cpu().numpy().astype(np.int32)
        if stop_sign is not None:
            for row in toks:
                stops = np.where(row == stop_sign)[0]
                if len(stops):
                    row[stops[0] + 1:] = stop_sign
        return toks
