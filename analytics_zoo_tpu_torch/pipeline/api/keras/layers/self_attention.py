"""Transformer layers — TransformerLayer (GPT-style stack) and BERT.

Counterpart of
``analytics_zoo_tpu/pipeline/api/keras/layers/self_attention.py``, with
the same parameter trees (fused (D, 3D) QKV kernel, ``"blocks"`` as a list
of dicts) and the same numerics: LayerNorm with eps 1e-5 over the
population variance, the tanh-approximate gelu, and BERT's additive mask
``(1 - mask) * finfo(dtype).min``.  Attention routes through
:func:`analytics_zoo_tpu_torch.ops.attention.dot_product_attention`, so
eligible shapes run the flash kernel.

Training mode: hidden and embedding dropout draw their masks from a child
of the layer's generator per site (salts 0, 1 and 2, as in the reference);
attention dropout gets one generator per block (``fold_in(block_rng, 3)``),
whose seed pair keys the flash kernel's dropout hash.

``moe_experts > 0`` swaps every block's dense feed-forward for a routed
mixture of experts (``ops.moe.routed_ffn``) behind the residual, with the
reference's leaves (``moe_gate``, ``moe_w1``, ``moe_b1``, ``moe_w2``,
``moe_b2``); the layer is then stateful, its state the blocks' mean
``moe_aux_loss``, the pre-weighted ``moe_aux_cost`` the estimator adds to
the training loss, and ``moe_drop_fraction``.  On one device the expert
dimension is not sharded (ROADMAP queue 1 item 14 is the expert-parallel
half).  ``remat`` (True/"full", "dots", "attn") rematerialises each block
through ``parallel.plan.apply_remat``.
"""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.ops.activations import get_activation
from analytics_zoo_tpu_torch.ops.attention import (
    dot_product_attention,
    merge_heads,
    split_heads,
)
from analytics_zoo_tpu_torch.ops.moe import routed_ffn
from analytics_zoo_tpu_torch.parallel.plan import (
    apply_remat,
    checkpoint_name,
    resolve_remat,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer, fold_in
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import dropout


def _dense_init(gen, shape, std):
    return std * torch.randn(shape, generator=gen)


class _TransformerCore(Layer):
    """Shared block stack for TransformerLayer and BERT."""

    def __init__(self, n_block, n_head, hidden_size, intermediate_size=None,
                 hidden_drop=0.1, attn_drop=0.1, initializer_range=0.02,
                 bidirectional=False, activation="gelu", remat=False,
                 moe_experts=0, moe_top_k=2, moe_capacity_factor=1.25,
                 moe_aux_weight=0.01, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.n_block = int(n_block)
        self.n_head = int(n_head)
        self.hidden_size = int(hidden_size)
        self.intermediate_size = int(intermediate_size or 4 * hidden_size)
        self.hidden_drop = float(hidden_drop)
        self.attn_drop = float(attn_drop)
        self.initializer_range = float(initializer_range)
        self.bidirectional = bool(bidirectional)
        self.moe_experts = int(moe_experts)
        self.moe_top_k = int(moe_top_k)
        self.moe_capacity_factor = float(moe_capacity_factor)
        self.moe_aux_weight = float(moe_aux_weight)
        if self.moe_experts and self.moe_top_k > self.moe_experts:
            raise ValueError(
                f"moe_top_k={moe_top_k} > moe_experts={moe_experts}")
        if remat in (False, None):
            self.remat = None
        elif remat in (True, "full"):
            self.remat = "full"
        elif remat in ("dots", "attn"):
            self.remat = str(remat)
        else:
            raise ValueError(
                f"remat must be bool, 'full', 'dots' or 'attn'; "
                f"got {remat!r}")
        self.act = get_activation(activation)

    def _block_params(self, gen):
        d, m = self.hidden_size, self.intermediate_size
        std = self.initializer_range
        p = {
            "qkv_kernel": _dense_init(fold_in(gen, 0), (d, 3 * d), std),
            "qkv_bias": torch.zeros(3 * d),
            "proj_kernel": _dense_init(fold_in(gen, 1), (d, d), std),
            "proj_bias": torch.zeros(d),
            "ln1_gamma": torch.ones(d), "ln1_beta": torch.zeros(d),
            "ln2_gamma": torch.ones(d), "ln2_beta": torch.zeros(d),
        }
        if self.moe_experts:
            e = self.moe_experts
            p.update({
                "moe_gate": _dense_init(fold_in(gen, 2), (d, e), std),
                "moe_w1": _dense_init(fold_in(gen, 3), (e, d, m), std),
                "moe_b1": torch.zeros(e, m),
                "moe_w2": _dense_init(fold_in(gen, 4), (e, m, d), std),
                "moe_b2": torch.zeros(d),
            })
        else:
            p.update({
                "fc_kernel": _dense_init(fold_in(gen, 2), (d, m), std),
                "fc_bias": torch.zeros(m),
                "out_kernel": _dense_init(fold_in(gen, 3), (m, d), std),
                "out_bias": torch.zeros(d),
            })
        return p

    @property
    def stateful(self):
        # an MoE stack reports its aux loss and drop fraction as state
        return self.moe_experts > 0

    def init_state(self):
        if not self.moe_experts:
            return {}
        return {"moe_aux_loss": torch.zeros(()),
                "moe_aux_cost": torch.zeros(()),
                "moe_drop_fraction": torch.zeros(())}

    def _moe_state(self, aux, drop):
        return {"moe_aux_loss": aux,
                "moe_aux_cost": self.moe_aux_weight * aux,
                "moe_drop_fraction": drop}

    def _per_block_param_count(self):
        d, m = self.hidden_size, self.intermediate_size
        attn = 3 * d * d + 3 * d + d * d + d + 4 * d  # qkv + proj + 2 LN
        if self.moe_experts:
            e = self.moe_experts
            return attn + d * e + e * (2 * d * m + m) + d
        return attn + 2 * d * m + m + d

    @staticmethod
    def _ln(x, gamma, beta, eps=1e-5):
        mean = x.mean(dim=-1, keepdim=True)
        # like jnp.var, the variance of a bf16 input is computed in f32
        xf = x.float()
        var = (xf - xf.mean(dim=-1, keepdim=True)).square().mean(
            dim=-1, keepdim=True).to(x.dtype)
        return (x - mean) * torch.reciprocal(torch.sqrt(var + eps)) * gamma \
            + beta

    def _drop(self, x, p, training, rng, salt):
        if not training or p <= 0.0 or rng is None:
            return x
        return dropout(x, p, fold_in(rng, salt))

    def _run_blocks_aux(self, blocks, h, mask, training, rng):
        """Run the stack, each block through ``apply_remat`` under the
        layer's policy; also return the mean aux loss and drop fraction
        over the MoE blocks (None for a dense stack)."""
        policy = resolve_remat(self.name or "blocks", default=self.remat)
        body = apply_remat(self._block_forward_aux, policy)
        aux = drop = None
        n_moe = 0
        for bi, bp in enumerate(blocks):
            brng = fold_in(rng, bi) if rng is not None else None
            h, a, dr = body(bp, h, mask, training, brng)
            if "moe_gate" in bp:
                n_moe += 1
                aux = a if aux is None else aux + a
                drop = dr if drop is None else drop + dr
        if n_moe:
            aux, drop = aux / n_moe, drop / n_moe
        return h, aux, drop

    def _block_forward_aux(self, bp, h, mask, training, brng):
        qkv = h @ bp["qkv_kernel"] + bp["qkv_bias"]
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        q = split_heads(q, self.n_head)
        k = split_heads(k, self.n_head)
        v = split_heads(v, self.n_head)
        a = dot_product_attention(
            q, k, v, mask=mask,
            dropout_p=self.attn_drop if training else 0.0,
            rng=fold_in(brng, 3) if brng is not None else None,
            causal=not self.bidirectional,
        )
        a = checkpoint_name(a, "attn_context")
        a = merge_heads(a) @ bp["proj_kernel"] + bp["proj_bias"]
        a = self._drop(a, self.hidden_drop, training, brng, 1)
        h = self._ln(h + a, bp["ln1_gamma"], bp["ln1_beta"])
        aux = drop = None
        if "moe_gate" in bp:
            # behind the residual: an over-capacity token's zero expert
            # output leaves it as it was
            f, aux, drop = routed_ffn(
                h, bp["moe_gate"], bp["moe_w1"], bp["moe_b1"],
                bp["moe_w2"], bp["moe_b2"], top_k=self.moe_top_k,
                capacity_factor=self.moe_capacity_factor,
                activation=self.act)
        else:
            f = self.act(h @ bp["fc_kernel"] + bp["fc_bias"])
            f = f @ bp["out_kernel"] + bp["out_bias"]
        f = self._drop(f, self.hidden_drop, training, brng, 2)
        return self._ln(h + f, bp["ln2_gamma"], bp["ln2_beta"]), aux, drop


class TransformerLayer(_TransformerCore):
    """GPT-style stack.  Inputs: ``[tokens, positions]`` int tensors of
    shape (B, L); output (B, L, D)."""

    def __init__(self, vocab, seq_len, n_block=12, n_head=12,
                 hidden_size=768, embedding_drop=0.1, **kwargs):
        super().__init__(n_block=n_block, n_head=n_head,
                         hidden_size=hidden_size, **kwargs)
        self.vocab = int(vocab)
        self.seq_len = int(seq_len)
        self.embedding_drop = float(embedding_drop)

    @classmethod
    def init_with_default_params(cls, vocab, seq_len, n_block=12, n_head=12,
                                 hidden_size=768, **kwargs):
        return cls(vocab, seq_len, n_block, n_head, hidden_size, **kwargs)

    def build(self, input_shape):
        pass  # params are nested; built in init_params

    def init_params(self, rng):
        std = self.initializer_range
        return {
            "tok_embed": _dense_init(fold_in(rng, 0),
                                     (self.vocab, self.hidden_size), std),
            "pos_embed": _dense_init(fold_in(rng, 1),
                                     (self.seq_len, self.hidden_size), std),
            "blocks": [self._block_params(fold_in(rng, 2 + i))
                       for i in range(self.n_block)],
        }

    def param_count(self):
        d, v = self.hidden_size, self.vocab
        per_block = self._per_block_param_count()
        return v * d + self.seq_len * d + self.n_block * per_block

    def call(self, params, inputs, state=None, training=False, rng=None):
        if isinstance(inputs, (list, tuple)):
            tokens, positions = inputs[0], inputs[1]
        else:
            tokens = inputs
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        h = params["tok_embed"][tokens.long()]
        h = h + params["pos_embed"][positions.long()]
        h = self._drop(h, self.embedding_drop, training, rng, 0)
        out, aux, drop = self._run_blocks_aux(params["blocks"], h, None,
                                              training, rng)
        if self.moe_experts:
            return out, self._moe_state(aux, drop)
        return out

    def compute_output_shape(self, input_shape):
        if isinstance(input_shape, list):
            input_shape = input_shape[0]
        return tuple(input_shape) + (self.hidden_size,)


class BERT(_TransformerCore):
    """BERT encoder.  Inputs: ``[token_ids, token_type_ids, position_ids,
    attention_mask]``; outputs ``[sequence_output, pooled_output]``."""

    def __init__(self, vocab=40990, hidden_size=768, n_block=12, n_head=12,
                 seq_len=512, intermediate_size=3072, hidden_p_drop=0.1,
                 attn_p_drop=0.1, type_vocab=2, **kwargs):
        super().__init__(n_block=n_block, n_head=n_head,
                         hidden_size=hidden_size,
                         intermediate_size=intermediate_size,
                         hidden_drop=hidden_p_drop, attn_drop=attn_p_drop,
                         bidirectional=True, **kwargs)
        self.vocab = int(vocab)
        self.seq_len = int(seq_len)
        self.type_vocab = int(type_vocab)

    def build(self, input_shape):
        pass

    def init_params(self, rng):
        std = self.initializer_range
        d = self.hidden_size
        return {
            "tok_embed": _dense_init(fold_in(rng, 0), (self.vocab, d), std),
            "pos_embed": _dense_init(fold_in(rng, 1), (self.seq_len, d), std),
            "type_embed": _dense_init(fold_in(rng, 2), (self.type_vocab, d),
                                      std),
            "embed_ln_gamma": torch.ones(d),
            "embed_ln_beta": torch.zeros(d),
            "pooler_kernel": _dense_init(fold_in(rng, 3), (d, d), std),
            "pooler_bias": torch.zeros(d),
            "blocks": [self._block_params(fold_in(rng, 4 + i))
                       for i in range(self.n_block)],
        }

    def param_count(self):
        d = self.hidden_size
        per_block = self._per_block_param_count()
        return ((self.vocab + self.seq_len + self.type_vocab) * d + 2 * d
                + d * d + d + self.n_block * per_block)

    def call(self, params, inputs, state=None, training=False, rng=None):
        tokens, token_types, positions, attn_mask = (
            list(inputs) + [None] * (4 - len(inputs))
            if isinstance(inputs, (list, tuple)) else [inputs, None, None,
                                                       None]
        )
        b, l = tokens.shape
        if positions is None:
            positions = torch.arange(l, device=tokens.device).expand(b, l)
        h = params["tok_embed"][tokens.long()]
        h = h + params["pos_embed"][positions.long()]
        if token_types is not None:
            h = h + params["type_embed"][token_types.long()]
        h = self._ln(h, params["embed_ln_gamma"], params["embed_ln_beta"])
        h = self._drop(h, self.hidden_drop, training, rng, 0)
        mask = None
        if attn_mask is not None:
            # additive mask: (B, L) 1/0 -> (B, 1, 1, L) 0/finfo.min, made in
            # the activation dtype as the reference makes it
            mask = (1.0 - attn_mask[:, None, None, :].to(h.dtype)) \
                * torch.finfo(h.dtype).min
        seq, aux, drop = self._run_blocks_aux(params["blocks"], h, mask,
                                              training, rng)
        pooled = torch.tanh(
            seq[:, 0] @ params["pooler_kernel"] + params["pooler_bias"]
        )
        if self.moe_experts:
            return [seq, pooled], self._moe_state(aux, drop)
        return [seq, pooled]

    def compute_output_shape(self, input_shape):
        shape = input_shape[0] if isinstance(input_shape, list) \
            else input_shape
        b, l = shape[0], shape[1]
        return [(b, l, self.hidden_size), (b, self.hidden_size)]
