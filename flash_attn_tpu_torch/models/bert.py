"""BERT (counterpart of `flash_attn_tpu/models/bert.py`: `BertEmbeddings:25`,
`BertModel:60`, `BertForPreTraining:133`, `remap_state_dict_hf_bert:166`).

A post-norm encoder of `modules.block.Block(prenorm=False)` over the same
`MHA` (non-causal) and `Mlp` as GPT, with the pooler and the pretraining
heads.  `BertModel.forward(unpad_varlen=True)` runs the unpadded pipeline:
`utils.padding.unpad_input`, every block on the packed (1, total, hidden)
stream with attention through `flash_attn_varlen_func` (the packed varlen
kernels for a batch of more than one sequence), then `pad_input`, whose
padded rows are exact zeros.  The default path keeps the padded batch and
gives the mask's lengths to the dense kernels as per-batch `seqused`.

`BertConfig` carries the attribute names of `transformers.BertConfig`, with
the defaults of `bert-base-uncased`'s config.json.  `hidden_act="gelu"` is
the tanh approximation, as the JAX package's `ACT2FN` maps it
(`modules/mlp.py:23-26`); Hugging Face's BERT uses the erf form.  Dropout is
not ported: the forward is the JAX `deterministic=True` path, and
`deterministic=False` with a dropout probability above 0 raises
NotImplementedError rather than run without the dropout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from flash_attn_tpu_torch.env import default_device
from flash_attn_tpu_torch.models.common import JaxParams, init_weights
from flash_attn_tpu_torch.modules.block import Block, _Norm
from flash_attn_tpu_torch.modules.mha import MHA
from flash_attn_tpu_torch.modules.mlp import ACT2FN, Mlp
from flash_attn_tpu_torch.ops.activations import gelu_approx
from flash_attn_tpu_torch.utils.padding import pad_input, unpad_input


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12


def _act(config):
    return ACT2FN.get(getattr(config, "hidden_act", "gelu"), gelu_approx)


def _check_deterministic(config, deterministic):
    """JAX's `deterministic=False` applies the configured dropout, which the
    port does not have yet: raise where it would change the result."""
    probs = (config.hidden_dropout_prob, config.attention_probs_dropout_prob)
    if not deterministic and max(probs) > 0:
        raise NotImplementedError(
            "BERT dropout (hidden_dropout_prob, attention_probs_dropout_prob "
            f"= {probs}) is not ported yet (dropout through the model, "
            "ROADMAP.md Queue 1.3): pass deterministic=True or set both "
            "probabilities to 0")


class BertEmbeddings(nn.Module):
    """Word, position and token type embeddings, summed, then a norm."""

    def __init__(self, config, *, device=None, dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        c = config
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size, **kw)
        self.norm = _Norm(c.hidden_size, c.layer_norm_eps, **kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.norm(x)


class BertModel(nn.Module):
    """Embeddings, post-norm encoder, pooler.  `device=None` means CUDA and
    raises RuntimeError when there is none."""

    def __init__(self, config, add_pooling_layer: bool = True, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        c = config
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.embeddings = BertEmbeddings(c, **kw)
        self.layers = nn.ModuleList(
            Block(c.hidden_size,
                  MHA(c.hidden_size, c.num_attention_heads, causal=False,
                      layer_idx=i, **kw),
                  Mlp(c.hidden_size, c.intermediate_size,
                      activation=_act(c), **kw),
                  prenorm=False, norm_eps=c.layer_norm_eps, **kw)
            for i in range(c.num_hidden_layers))
        self.pooler_dense = (nn.Linear(c.hidden_size, c.hidden_size, **kw)
                             if add_pooling_layer else None)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Random weights from `generator` (`models.common.init_weights`,
        std = initializer_range)."""
        return init_weights(self, generator, self.config.initializer_range)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, deterministic: bool = True,
                unpad_varlen: bool = False):
        """input_ids, attention_mask (1 = token), token_type_ids: (b, s).
        Returns (hidden (b, s, hidden), pooled (b, hidden) or None).  With
        `unpad_varlen` and a mask the encoder runs on the packed tokens and
        the padded rows of the output are 0.  `deterministic=False` raises
        NotImplementedError while a dropout probability is above 0."""
        _check_deterministic(self.config, deterministic)
        b, s = input_ids.shape
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        mask = attention_mask.bool() if attention_mask is not None else None
        if unpad_varlen and mask is not None:
            hp, indices, cu_seqlens, max_s, _ = unpad_input(h, mask)
            hp = hp[None]  # (1, total_nnz, hidden): the packed stream
            for layer in self.layers:
                hp, _ = layer(hp, cu_seqlens=cu_seqlens, max_seqlen=max_s)
            h = pad_input(hp[0], indices, b, s)
        else:
            for layer in self.layers:
                h, _ = layer(h, key_padding_mask=mask)
        pooled = None
        if self.pooler_dense is not None:
            pooled = torch.tanh(self.pooler_dense(h[:, 0]))
        return h, pooled


class BertForPreTraining(nn.Module):
    """BertModel with the MLM head (transform, then the decoder tied to the
    word embeddings, plus `decoder_bias`) and the NSP head."""

    def __init__(self, config, *, device=None, dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        c = config
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.bert = BertModel(c, **kw)
        self.transform_dense = nn.Linear(c.hidden_size, c.hidden_size, **kw)
        self.transform_norm = _Norm(c.hidden_size, c.layer_norm_eps, **kw)
        self.decoder_bias = nn.Parameter(torch.zeros(c.vocab_size, **kw))
        self.seq_relationship = nn.Linear(c.hidden_size, 2, **kw)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True):
        """Returns (MLM logits (b, s, vocab), NSP logits (b, 2))."""
        h, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                              deterministic=deterministic)
        t = self.transform_norm(_act(self.config)(self.transform_dense(h)))
        logits = t @ self.bert.embeddings.word_embeddings.weight.t() \
            + self.decoder_bias
        return logits, self.seq_relationship(pooled)


def bert_state_dict_from_jax_params(params, config):
    """The port's state_dict from the flax parameter tree of the JAX
    `BertModel` or `BertForPreTraining` (nested dicts of numpy arrays, with
    or without the top "params" key).  Dense kernels (in, out) become
    `nn.Linear.weight` (out, in).  Raises KeyError if an expected array is
    missing and ValueError if any is left unused."""
    p = JaxParams(params)
    pre = "bert/" if p.has("bert/embeddings/word_embeddings/embedding") else ""
    tp = pre.replace("/", ".")
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        p.take(f"{pre}embeddings/{name}/embedding",
               f"{tp}embeddings.{name}.weight")
    p.norm(f"{pre}embeddings/norm", f"{tp}embeddings.norm")
    for i in range(config.num_hidden_layers):
        jl, tl = f"{pre}layers_{i}", f"{tp}layers.{i}"
        p.dense(f"{jl}/mixer/Wqkv", f"{tl}.mixer.Wqkv")
        p.dense(f"{jl}/mixer/out_proj", f"{tl}.mixer.out_proj")
        p.norm(f"{jl}/norm1", f"{tl}.norm1")
        p.dense(f"{jl}/mlp/fc1", f"{tl}.mlp.fc1")
        p.dense(f"{jl}/mlp/fc2", f"{tl}.mlp.fc2")
        p.norm(f"{jl}/norm2", f"{tl}.norm2")
    if p.has(f"{pre}pooler_dense/kernel"):
        p.dense(f"{pre}pooler_dense", f"{tp}pooler_dense")
    if pre:
        p.dense("transform_dense", "transform_dense")
        p.norm("transform_norm", "transform_norm")
        p.take("decoder_bias", "decoder_bias")
        p.dense("seq_relationship", "seq_relationship")
    return p.state_dict()


def remap_state_dict_hf_bert(state_dict, config):
    """A Hugging Face `BertModel` state_dict (tensors or arrays; keys with
    or without the "bert." prefix) -> the port's `BertModel` state_dict.
    The q, k and v projections are concatenated into `Wqkv`.  Raises
    AssertionError if a key is left unmapped (`position_ids` aside)."""
    sd = {k.removeprefix("bert."): torch.as_tensor(np.asarray(v))
          for k, v in state_dict.items()}
    out = {}

    def move(hf, name):
        out[f"{name}.weight"] = sd.pop(f"{hf}.weight")
        out[f"{name}.bias"] = sd.pop(f"{hf}.bias")

    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"embeddings.{name}.weight"] = sd.pop(f"embeddings.{name}.weight")
    move("embeddings.LayerNorm", "embeddings.norm")
    for i in range(config.num_hidden_layers):
        hf, tl = f"encoder.layer.{i}", f"layers.{i}"
        att = f"{hf}.attention.self"
        for part in ("weight", "bias"):
            out[f"{tl}.mixer.Wqkv.{part}"] = torch.cat(
                [sd.pop(f"{att}.{x}.{part}") for x in ("query", "key",
                                                        "value")])
        move(f"{hf}.attention.output.dense", f"{tl}.mixer.out_proj")
        move(f"{hf}.attention.output.LayerNorm", f"{tl}.norm1")
        move(f"{hf}.intermediate.dense", f"{tl}.mlp.fc1")
        move(f"{hf}.output.dense", f"{tl}.mlp.fc2")
        move(f"{hf}.output.LayerNorm", f"{tl}.norm2")
    if "pooler.dense.weight" in sd:
        move("pooler.dense", "pooler_dense")
    leftover = [k for k in sd if "position_ids" not in k]
    assert not leftover, f"unmapped: {leftover[:8]}"
    return out
