"""GPT model family (counterpart of `flash_attn_tpu/models/gpt.py`:
`GPTModel:178`, `GPTLMHeadModel:274`, the factories `create_mixer_cls:41`,
`create_mlp_cls:81`, `create_block:120`, `remap_state_dict_hf_gpt2:370`).

`GPTConfig` carries the `transformers.GPT2Config` attribute names, plus the
extended ones, that the JAX model reads, so every family the JAX package
maps onto this one skeleton (LLaMA, Baichuan, GPT-NeoX, Falcon, BigCode:
`models/{llama,baichuan,gpt_neox,falcon,bigcode}.py`) maps onto the port's
the same way: rotary (full or partial, interleaved or rotate-half), grouped
and multi-query KV heads, RMSNorm, and parallel blocks with tied or untied
norms.  Post-norm and tensor parallelism raise `NotImplementedError`.

muP (`use_mup`, BTLM: `models/btlm.py`) follows JAX in its two places: the
softmax scale is head_dim ** -0.5 * `mup_attn_multiplier`
(`create_mixer_cls:58-62`) and the logits are multiplied by
`mup_output_multiplier` (`GPTLMHeadModel:309-312`; `training/loss.py`'s
head does the same).  `mup_embeddings_multiplier` is carried and, as in
JAX, applied nowhere.

Dropout follows JAX's `deterministic` argument (default True): with
`deterministic=False` each layer's attention dropout (`attn_pdrop`) runs in
the attention kernels, whose keep mask is a hash of position with seed 0,
the same in every layer and step as in JAX.  The residual and embedding
dropouts (`resid_pdrop`, `embd_pdrop`, drawn with `jax.random` in JAX) are
not ported: `deterministic=False` with either above 0 raises
`NotImplementedError`.

`remat_blocks` rematerialises each block in the backward (`create_block:
138-153`, `nn.remat`): `remat_policy="none"` recomputes the whole block
(`torch.utils.checkpoint`), "dots" and "dots_no_batch" keep the outputs of
the matrix products (`aten.mm` / `addmm`, and for "dots" `bmm`) and
recompute the rest (selective checkpointing).  The attention kernels are
recomputed under every policy, as the `pallas_call` is in JAX: they are not
products of the list.  It applies to training forwards only, never under
`torch.no_grad` or with a cache.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from flash_attn_tpu_torch.env import default_device
from flash_attn_tpu_torch.layers.rotary import RotaryEmbedding
from flash_attn_tpu_torch.models.common import (JaxParams, as_tensors,
                                                canonical_to_state_dict,
                                                init_weights)
from flash_attn_tpu_torch.modules.block import Block, ParallelBlock, _Norm
from flash_attn_tpu_torch.modules.embedding import GPT2Embeddings
from flash_attn_tpu_torch.modules.mha import (MHA, InferenceParams,
                                              rotary_factors)
from flash_attn_tpu_torch.modules.mlp import ACT2FN, GatedMlp, Mlp
from flash_attn_tpu_torch.ops.activations import gelu_approx, swiglu_fwd


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_head_kv: Optional[int] = None
    head_dim: Optional[int] = None
    n_inner: Optional[int] = None
    activation_function: str = "gelu_new"
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    lm_head_bias: bool = False
    qkv_proj_bias: bool = True
    out_proj_bias: bool = True
    mlp_fc1_bias: bool = True
    mlp_fc2_bias: bool = True
    residual_in_fp32: bool = False
    rms_norm: bool = False
    rotary_emb_fraction: float = 0.0
    rotary_emb_base: float = 10000.0
    rotary_emb_scale_base: Optional[float] = None
    rotary_emb_interleaved: bool = False
    parallel_block: bool = False
    parallel_block_tied_norm: bool = False
    window_size: tuple = (-1, -1)
    attn_softcap: float = 0.0
    use_alibi: bool = False
    no_abs_pos_emb: bool = False
    multiple_of: int = 128
    # dropout probabilities, under the Hugging Face names JAX reads
    # (`create_mixer_cls:57`, `create_block:125-130`)
    attn_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    embd_pdrop: float = 0.0
    remat_blocks: bool = False
    remat_policy: str = "none"  # "none" | "dots" | "dots_no_batch"
    # muP (see the module's note); the embeddings' multiplier is unused, as
    # in JAX
    use_mup: bool = False
    mup_attn_multiplier: float = 1.0
    mup_output_multiplier: float = 1.0
    mup_embeddings_multiplier: float = 1.0
    # Not ported: any other value raises NotImplementedError.
    prenorm: bool = True
    tensor_parallel: bool = False

    @property
    def hidden_size(self):
        return self.n_embd

    @property
    def num_attention_heads(self):
        return self.n_head

    @property
    def num_hidden_layers(self):
        return self.n_layer

    @property
    def max_position_embeddings(self):
        return self.n_positions

    def rotary_dim(self) -> int:
        """Rotated features of a head: the fraction of the head dim
        (`create_mixer_cls:41`)."""
        head_dim = self.head_dim or self.n_embd // self.n_head
        return int(self.rotary_emb_fraction * head_dim)

    def check_supported(self):
        unsupported = {
            "tensor_parallel": self.tensor_parallel,
            "prenorm": not self.prenorm,  # GPTModel's post-norm path
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                f"GPT features not ported yet: {', '.join(bad)}")
        if self.remat_policy not in REMAT_SAVED_OPS:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")


# The aten products whose outputs each remat policy keeps for the backward
# (jax.checkpoint_policies.dots_saveable and
# dots_with_no_batch_dims_saveable); everything else is recomputed.
_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMAT_SAVED_OPS = {
    "none": (),
    "dots": _MM + (torch.ops.aten.bmm.default,),
    "dots_no_batch": _MM,
}


def remat_block(block, policy: str, *args, **kwargs):
    """block(*args, **kwargs) under activation checkpointing with the
    policy's saved products.  No random state is kept: the blocks draw none
    (the attention dropout's keep mask is a hash of position, which the
    recompute reproduces)."""
    saved = REMAT_SAVED_OPS[policy]
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if saved:
        def keep(ctx, op, *a, **k):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, keep)
    return checkpoint(block, *args, **kw, **kwargs)


@dataclasses.dataclass
class CausalLMOutput:
    logits: Any
    inference_params: Optional[InferenceParams] = None


def create_mixer(config: GPTConfig, layer_idx: int, device, dtype,
                 rotary_emb: Optional[RotaryEmbedding] = None):
    head_dim = config.head_dim or config.n_embd // config.n_head
    scale = (head_dim ** -0.5 * config.mup_attn_multiplier
             if config.use_mup else None)
    return MHA(config.n_embd, config.n_head, num_heads_kv=config.n_head_kv,
               head_dim=config.head_dim, qkv_proj_bias=config.qkv_proj_bias,
               out_proj_bias=config.out_proj_bias, softmax_scale=scale,
               causal=True,
               layer_idx=layer_idx, rotary_emb_dim=config.rotary_dim(),
               rotary_emb_base=config.rotary_emb_base,
               rotary_emb_scale_base=config.rotary_emb_scale_base,
               rotary_emb_interleaved=config.rotary_emb_interleaved,
               window_size=config.window_size, softcap=config.attn_softcap,
               use_alibi=config.use_alibi, dropout=config.attn_pdrop,
               rotary_emb=rotary_emb, device=device, dtype=dtype)


def create_mlp(config: GPTConfig, device, dtype):
    act = config.activation_function
    inner = config.n_inner or 4 * config.n_embd
    kw = dict(bias1=config.mlp_fc1_bias, bias2=config.mlp_fc2_bias,
              device=device, dtype=dtype)
    if act in ("glu", "swiglu", "geglu"):
        activation = {"glu": torch.sigmoid, "swiglu": swiglu_fwd,
                      "geglu": gelu_approx}[act]
        return GatedMlp(config.n_embd, inner, activation=activation,
                        multiple_of=config.multiple_of, **kw)
    return Mlp(config.n_embd, inner, activation=ACT2FN.get(act, gelu_approx),
               **kw)


def create_block(config: GPTConfig, layer_idx: int, device, dtype,
                 rotary_emb: Optional[RotaryEmbedding] = None):
    mixer = create_mixer(config, layer_idx, device, dtype, rotary_emb)
    mlp = create_mlp(config, device, dtype)
    kw = dict(residual_in_fp32=config.residual_in_fp32,
              rms_norm=config.rms_norm, norm_eps=config.layer_norm_epsilon,
              device=device, dtype=dtype)
    if config.parallel_block:
        return ParallelBlock(config.n_embd, mixer, mlp,
                             tied_norm=config.parallel_block_tied_norm, **kw)
    return Block(config.n_embd, mixer, mlp, prenorm=config.prenorm, **kw)


class GPTModel(nn.Module):
    """Embeddings, N pre-norm (or parallel) blocks, final norm.
    `device=None` means CUDA and raises RuntimeError when there is none.

    Under rotary the layers share one `RotaryEmbedding` (tables built once,
    on the model's device, grown to the longest length asked for) and each
    forward computes its rotation factors once for all of them."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        config.check_supported()
        self.config = config
        self.dtype = dtype
        rotary = config.rotary_dim() > 0
        n_pos = (0 if rotary or config.use_alibi or config.no_abs_pos_emb
                 else config.n_positions)
        self.embeddings = GPT2Embeddings(config.n_embd, config.vocab_size,
                                         n_pos, device=device, dtype=dtype)
        self.rotary_emb = (RotaryEmbedding(
            config.rotary_dim(), base=config.rotary_emb_base,
            interleaved=config.rotary_emb_interleaved,
            scale_base=config.rotary_emb_scale_base, device=device)
            if rotary else None)
        self.layers = nn.ModuleList(
            create_block(config, i, device, dtype, self.rotary_emb)
            for i in range(config.n_layer))
        self.ln_f = _Norm(config.n_embd, config.layer_norm_epsilon,
                          is_rms=config.rms_norm, device=device, dtype=dtype)

    def forward(self, input_ids, position_ids=None, inference_params=None,
                deterministic: bool = True):
        """`deterministic=False` runs the attention dropout (a cache never
        does) and raises `NotImplementedError` while `resid_pdrop` or
        `embd_pdrop` is above 0."""
        c = self.config
        if not deterministic and max(c.resid_pdrop, c.embd_pdrop) > 0:
            raise NotImplementedError(
                f"GPT residual / embedding dropout (resid_pdrop "
                f"{c.resid_pdrop}, embd_pdrop {c.embd_pdrop}) is not ported "
                "yet: only attn_pdrop runs with deterministic=False")
        s = input_ids.shape[1]
        if position_ids is None and inference_params is not None:
            lengths = inference_params.lengths_per_sample
            position_ids = lengths[:, None] + torch.arange(
                s, device=input_ids.device, dtype=lengths.dtype)[None, :]
        hidden_states = self.embeddings(input_ids, position_ids)
        kw = dict(deterministic=deterministic)
        if self.rotary_emb is not None:
            kw["rotary"] = rotary_factors(self.rotary_emb, s, inference_params)
        parallel = self.config.parallel_block
        residual = hidden_states2 = None
        remat = (self.config.remat_blocks and inference_params is None
                 and torch.is_grad_enabled())
        for layer in self.layers:
            if remat:
                layer = functools.partial(remat_block, layer,
                                          self.config.remat_policy)
            if parallel:
                hidden_states, hidden_states2, residual = layer(
                    hidden_states, hidden_states2, residual,
                    inference_params=inference_params, **kw)
            else:
                hidden_states, residual = layer(
                    hidden_states, residual,
                    inference_params=inference_params, **kw)
        res_dtype = (torch.float32 if self.config.residual_in_fp32
                     else hidden_states.dtype)
        acc = hidden_states.to(res_dtype)
        if hidden_states2 is not None:
            acc = acc + hidden_states2.to(res_dtype)
        residual = acc if residual is None else acc + residual
        hidden_states = self.ln_f(residual.to(self.dtype))
        if inference_params is not None:
            # once per forward, not per layer (gpt.py:265-269)
            inference_params.lengths_per_sample = (
                inference_params.lengths_per_sample + s)
        return hidden_states


class GPTLMHeadModel(nn.Module):
    """GPTModel plus the (by default tied) LM head.  `device=None` means
    CUDA and raises RuntimeError when there is none."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self.config = config
        self.transformer = GPTModel(config, device=device, dtype=dtype)
        self.lm_head = (None if config.tie_word_embeddings
                        else nn.Linear(config.n_embd, config.vocab_size,
                                       bias=config.lm_head_bias,
                                       device=device, dtype=dtype))

    @property
    def device(self):
        return self.transformer.embeddings.wte.weight.device

    def init_weights(self, generator: Optional[torch.Generator] = None,
                     std: float = 0.02):
        """Matrices and embeddings ~ N(0, std) drawn from `generator` (on the
        CPU, so a seed gives the same weights on every device); biases 0,
        norm weights 1."""
        return init_weights(self, generator, std)

    def forward(self, input_ids, position_ids=None, inference_params=None,
                num_last_tokens: int = 0, deterministic: bool = True):
        hidden_states = self.transformer(input_ids, position_ids,
                                         inference_params=inference_params,
                                         deterministic=deterministic)
        if num_last_tokens > 0:
            hidden_states = hidden_states[:, -num_last_tokens:]
        if self.lm_head is None:
            logits = self.transformer.embeddings.attend(hidden_states)
        else:
            logits = self.lm_head(hidden_states)
        mult = self.config.mup_output_multiplier if self.config.use_mup else 1.0
        if mult != 1.0:
            logits = logits * mult
        return CausalLMOutput(logits=logits, inference_params=inference_params)


def state_dict_from_jax_params(params, config: GPTConfig):
    """The port's state_dict from the JAX model's flax parameter tree
    (nested dicts of numpy arrays, with or without the top "params" key).

    Dense kernels (in, out) are transposed to `nn.Linear.weight` (out, in).
    RMS norms have no bias, a tied parallel block no norm2.  Raises KeyError
    if an expected array is missing and ValueError if any array of the
    tree is left unused."""
    p = JaxParams(params)
    tr = "transformer"
    p.take(f"{tr}/embeddings/wte/embedding",
           "transformer.embeddings.wte.weight")
    if p.has(f"{tr}/embeddings/wpe/embedding"):
        p.take(f"{tr}/embeddings/wpe/embedding",
               "transformer.embeddings.wpe.weight")
    tied = config.parallel_block and config.parallel_block_tied_norm
    for i in range(config.n_layer):
        jp, tp = f"{tr}/layers_{i}", f"transformer.layers.{i}"
        p.norm(f"{jp}/norm1", f"{tp}.norm1")
        if not tied:
            p.norm(f"{jp}/norm2", f"{tp}.norm2")
        p.dense(f"{jp}/mixer/Wqkv", f"{tp}.mixer.Wqkv")
        p.dense(f"{jp}/mixer/out_proj", f"{tp}.mixer.out_proj")
        p.dense(f"{jp}/mlp/fc1", f"{tp}.mlp.fc1")
        p.dense(f"{jp}/mlp/fc2", f"{tp}.mlp.fc2")
    p.norm(f"{tr}/ln_f", "transformer.ln_f")
    if not config.tie_word_embeddings:
        p.dense("lm_head", "lm_head")
    return p.state_dict()


def remap_state_dict_hf_gpt2(state_dict, config: GPTConfig):
    """A Hugging Face GPT-2 state dict (`GPT2LMHeadModel`, tensors or numpy
    arrays) as the port's state_dict (`remap_state_dict_hf_gpt2:370`).
    GPT-2's `Conv1D` weights are (in, out) and are transposed to
    `nn.Linear`'s (out, in).  Raises ValueError on an unused key."""
    sd = as_tensors(state_dict)
    sd.pop("lm_head.weight", None)  # tied to wte
    cd = {"transformer.embeddings.word_embeddings.weight":
          sd.pop("transformer.wte.weight")}
    if "transformer.wpe.weight" in sd:
        cd["transformer.embeddings.position_embeddings.weight"] = sd.pop(
            "transformer.wpe.weight")
    for n in ("weight", "bias"):
        cd[f"transformer.ln_f.{n}"] = sd.pop(f"transformer.ln_f.{n}")
    for i in range(config.n_layer):
        hf, our = f"transformer.h.{i}.", f"transformer.layers.{i}."
        for src, dst in (("ln_1", "norm1"), ("ln_2", "norm2")):
            for n in ("weight", "bias"):
                cd[f"{our}{dst}.{n}"] = sd.pop(f"{hf}{src}.{n}")
        for src, dst in (("attn.c_attn", "mixer.Wqkv"),
                         ("attn.c_proj", "mixer.out_proj"),
                         ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
            cd[f"{our}{dst}.weight"] = sd.pop(f"{hf}{src}.weight").t()
            cd[f"{our}{dst}.bias"] = sd.pop(f"{hf}{src}.bias")
    return canonical_to_state_dict({**cd, **sd}, config)
