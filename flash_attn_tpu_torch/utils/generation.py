"""Generation: sampling filters and the KV-cache decode loop (counterpart of
`flash_attn_tpu/utils/generation.py`: `modify_logits_*:34-60`, `sample:63`,
`allocate_inference_cache:77`, `decode:87`).

The JAX package compiles prefill and the whole token loop into one program;
here the loop runs eagerly, one model call per token.  Replaying it as a CUDA
graph is later work.  Speculative decoding is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from flash_attn_tpu_torch.env import default_device
from flash_attn_tpu_torch.modules.mha import InferenceParams


@dataclasses.dataclass
class GenerationOutput:
    sequences: Any  # (b, prompt + generated)
    scores: Any = None  # (steps, b, vocab) when requested


def modify_logits_for_top_k_filtering(logits, top_k):
    """Everything below the k-th largest logit becomes -inf."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, -torch.inf)


def modify_logits_for_top_p_filtering(logits, top_p):
    """Nucleus filtering: keep the smallest top set with mass >= top_p."""
    if top_p <= 0.0 or top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1).values  # ascending
    cumprobs = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    cut = sorted_logits.masked_fill(~(cumprobs <= 1.0 - top_p), -torch.inf)
    thresholds = cut.amax(dim=-1, keepdim=True)
    return logits.masked_fill(logits <= thresholds, -torch.inf)


def modify_logits_for_min_p_filtering(logits, min_p):
    """Drop tokens whose probability is below min_p times the largest."""
    if min_p <= 0.0 or min_p >= 1.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    max_prob = probs.amax(dim=-1, keepdim=True)
    return logits.masked_fill(probs < min_p * max_prob, -torch.inf)


def sample(logits, generator: Optional[torch.Generator] = None, top_k=1,
           top_p=0.0, min_p=0.0, temperature=1.0):
    """Next token (b,) int32 from logits (b, vocab): greedy for top_k == 1
    with no top_p / min_p, else a draw from the filtered distribution."""
    if top_k == 1 and top_p == 0.0 and min_p == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / max(temperature, 1e-6)
    if top_k > 0:
        logits = modify_logits_for_top_k_filtering(logits, top_k)
    if min_p > 0.0:
        logits = modify_logits_for_min_p_filtering(logits, min_p)
    if top_p > 0.0:
        logits = modify_logits_for_top_p_filtering(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def allocate_inference_cache(max_batch_size, max_seqlen, batch_size=None,
                             device=None):
    """Empty cache container; each layer allocates its cache at first use.
    `device=None` means CUDA and raises RuntimeError when there is none."""
    b = batch_size or max_batch_size
    return InferenceParams(
        max_seqlen=max_seqlen, max_batch_size=max_batch_size,
        lengths_per_sample=torch.zeros((b,), dtype=torch.int32,
                                       device=default_device(device)))


@torch.no_grad()
def decode(input_ids, model, max_length: int, *, top_k: int = 1,
           top_p: float = 0.0, min_p: float = 0.0, temperature: float = 1.0,
           eos_token_id: Optional[int] = None, teacher_outputs=None,
           generator: Optional[torch.Generator] = None,
           return_scores: bool = False):
    """Greedy or sampling decode with a KV cache.

    model(input_ids, inference_params=ip) -> object with `.logits`
    (b, s, vocab).  input_ids (b, prompt) lies on the model's device."""
    b, prompt_len = input_ids.shape
    steps = max_length - prompt_len
    if steps <= 0:
        raise ValueError("max_length must exceed the prompt length")
    device = input_ids.device
    teacher = (None if teacher_outputs is None else
               torch.as_tensor(teacher_outputs, dtype=torch.int32,
                               device=device))
    ip = allocate_inference_cache(b, max_length, b, device=device)
    logits = model(input_ids, inference_params=ip).logits[:, -1].float()
    if teacher is not None and teacher.shape[1] > prompt_len:
        tok = teacher[:, prompt_len]
    else:
        tok = sample(logits, generator, top_k, top_p, min_p, temperature)
    finished = (tok == eos_token_id if eos_token_id is not None
                else torch.zeros((b,), dtype=torch.bool, device=device))
    toks, scores = [tok], [logits]
    for i in range(steps - 1):
        logits = model(tok[:, None], inference_params=ip).logits[:, -1].float()
        t = prompt_len + 1 + i
        if teacher is not None and t < teacher.shape[1]:
            nxt = teacher[:, t]
        else:
            nxt = sample(logits, generator, top_k, top_p, min_p, temperature)
        if eos_token_id is not None:
            nxt = torch.where(finished, eos_token_id, nxt)
            finished = finished | (nxt == eos_token_id)
        tok = nxt
        toks.append(tok)
        scores.append(logits)
    seq = torch.cat([input_ids.to(torch.int32), torch.stack(toks, dim=1)],
                    dim=1)
    return GenerationOutput(
        sequences=seq, scores=torch.stack(scores) if return_scores else None)
