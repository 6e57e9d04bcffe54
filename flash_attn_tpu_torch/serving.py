"""Continuous-batching serving engine (counterpart of
`flash_attn_tpu/serving.py::ServingEngine:60`).

Same scheduling as the JAX engine:
* a fixed decode batch of `max_batch` slots, each a row of every layer's KV
  cache; inactive slots still step, masked;
* admission in waves: the prompts of one wave are right-padded to a shared
  power-of-two bucket and prefilled in one model call, with the wave padded
  to a power of two by dummy rows of length 1 (`:200-234`); each row's cache
  is copied into its slot and its first token comes from the logit at its
  real last position (`:260-299`);
* `chunk_steps` decode steps between host syncs, per-slot greedy or top-k /
  temperature sampling (`:334-400`);
* retirement with EOS truncation (`:507-525`).

The padded prompt tail leaves pad-token K/V in the cache past the prompt
length L; the slot's length is set to L, both kernels mask by it, and the
first decode steps overwrite those rows.

The engine takes the model object (PyTorch's idiom) instead of
`apply_fn, params`.  Mesh-sharded and speculative serving raise
NotImplementedError and are queued.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from flash_attn_tpu_torch.modules.mha import InferenceParams
from flash_attn_tpu_torch.utils.generation import sample


@dataclasses.dataclass
class Request:
    prompt: Any  # list[int] / np.ndarray
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    top_k: int = 1
    temperature: float = 1.0
    # filled by the engine
    uid: int = -1
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    admitted: int = 0
    finished: int = 0
    decode_steps: int = 0
    prefill_tokens: int = 0
    generated_tokens: int = 0
    prefill_waves: int = 0


class ServingEngine:
    """Continuous batcher over a cached-decode model:
    model(input_ids, inference_params=ip) -> object with `.logits`."""

    def __init__(self, model, *, max_batch: int = 8, max_seqlen: int = 2048,
                 chunk_steps: int = 8,
                 prefill_buckets=(64, 128, 256, 512, 1024),
                 generator: Optional[torch.Generator] = None, mesh=None,
                 model_draft=None):
        if mesh is not None:
            raise NotImplementedError("mesh-sharded serving is not ported yet")
        if model_draft is not None:
            raise NotImplementedError("speculative serving is not ported yet")
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
        self.max_seqlen = max_seqlen
        self.chunk_steps = chunk_steps
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.generator = generator

        self.pending: list[Request] = []
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.stats = EngineStats()
        self._uid = 0
        # Every layer's cache at max_batch rows; allocated at the first
        # prefill, which reveals the per-layer shapes.
        self.cache: Optional[InferenceParams] = None
        self.lengths = torch.zeros((max_batch,), dtype=torch.int32,
                                   device=self.device)
        self.last_tokens = torch.zeros((max_batch,), dtype=torch.int32,
                                       device=self.device)
        self.active = np.zeros((max_batch,), bool)
        self._top_k = np.ones((max_batch,), np.int64)
        self._temp = np.ones((max_batch,), np.float32)

    # ------------------------------------------------------------------ API

    def submit(self, prompt, max_new_tokens=64, eos_token_id=None, top_k=1,
               temperature=1.0) -> int:
        req = Request(np.asarray(prompt, np.int64), max_new_tokens,
                      eos_token_id, top_k, temperature, uid=self._uid)
        self._uid += 1
        self.pending.append(req)
        return req.uid

    @torch.no_grad()
    def run(self):
        """Drive until every submitted request finishes; returns
        {uid: generated token list}."""
        results = {}
        while self.pending or any(s is not None for s in self.slots):
            self._admit()
            self._decode_chunk()
            for req in self._retire():
                results[req.uid] = req.output
        return results

    # ------------------------------------------------------------ internals

    def _bucket(self, n):
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest prefill bucket "
                         f"{self.prefill_buckets[-1]}")

    def _admit(self):
        wave = []
        for i in range(self.max_batch):
            if self.slots[i] is not None or not self.pending:
                continue
            req = self.pending.pop(0)
            if len(req.prompt) + req.max_new_tokens + self.chunk_steps \
                    >= self.max_seqlen:
                raise ValueError("request cannot fit max_seqlen")
            self.slots[i] = req
            wave.append((i, req))
        if not wave:
            return
        self._prefill_wave(wave)
        for i, req in wave:
            self.active[i] = True
            self._top_k[i] = req.top_k
            self._temp[i] = req.temperature
            self.stats.admitted += 1
            self.stats.prefill_tokens += len(req.prompt)

    def _prefill_wave(self, wave):
        lens = [len(req.prompt) for _, req in wave]
        bucket = self._bucket(max(lens))
        n = 1
        while n < len(wave):
            n *= 2
        tokens = np.zeros((n, bucket), np.int64)
        for r, (_, req) in enumerate(wave):
            tokens[r, :lens[r]] = req.prompt
        last = torch.as_tensor(np.asarray(lens + [1] * (n - len(wave))) - 1,
                               device=self.device)
        ip = InferenceParams(
            max_seqlen=self.max_seqlen, max_batch_size=n,
            lengths_per_sample=torch.zeros((n,), dtype=torch.int32,
                                           device=self.device))
        out = self.model(torch.as_tensor(tokens, device=self.device),
                         inference_params=ip)
        logits = out.logits[torch.arange(n, device=self.device), last]
        self.stats.prefill_waves += 1
        for r, (slot, req) in enumerate(wave):
            self._finish_prefill(slot, req, ip.key_value_memory_dict, r,
                                 logits[r:r + 1])

    def _finish_prefill(self, slot, req, kv_rows, r, logits):
        if self.cache is None:
            kv_big = {
                li: tuple(torch.zeros((self.max_batch,) + x.shape[1:],
                                      dtype=x.dtype, device=x.device)
                          for x in kv)
                for li, kv in kv_rows.items()
            }
            self.cache = InferenceParams(
                max_seqlen=self.max_seqlen, max_batch_size=self.max_batch,
                lengths_per_sample=self.lengths, key_value_memory_dict=kv_big)
        for li, (k_small, v_small) in kv_rows.items():
            k_big, v_big = self.cache.key_value_memory_dict[li]
            k_big[slot].copy_(k_small[r])
            v_big[slot].copy_(v_small[r])
        self.lengths[slot] = len(req.prompt)
        tok0 = sample(logits.float(), self.generator, req.top_k,
                      temperature=req.temperature)[0]
        self.last_tokens[slot] = tok0
        req.output.append(int(tok0))
        self.stats.generated_tokens += 1

    def _decode_chunk(self):
        if not self.active.any():
            return
        active = torch.as_tensor(self.active, device=self.device)
        step_len = active.to(torch.int32)
        sampling = bool((self._top_k[self.active] != 1).any())
        if sampling:
            top_k = torch.as_tensor(self._top_k, device=self.device)
            temp = torch.as_tensor(self._temp, device=self.device)
        last, lengths = self.last_tokens, self.lengths
        toks = []
        for _ in range(self.chunk_steps):
            self.cache.lengths_per_sample = lengths
            out = self.model(last[:, None], inference_params=self.cache)
            logits = out.logits[:, -1].float()
            nxt = logits.argmax(dim=-1).to(torch.int32)
            if sampling:
                filtered = _filter_topk_rows(logits / temp[:, None], top_k)
                drawn = torch.multinomial(torch.softmax(filtered, dim=-1), 1,
                                          generator=self.generator)[:, 0]
                nxt = torch.where(top_k == 1, nxt, drawn.to(torch.int32))
            nxt = torch.where(active, nxt, last)
            lengths = lengths + step_len
            last = nxt
            toks.append(nxt)
        self.last_tokens, self.lengths = last, lengths
        self.cache.lengths_per_sample = lengths
        self.stats.decode_steps += self.chunk_steps

        toks_host = torch.stack(toks).cpu().numpy()  # the one sync per chunk
        for i in range(self.max_batch):
            req = self.slots[i]
            if req is None or not self.active[i]:
                continue
            for t in toks_host[:, i]:
                req.output.append(int(t))
                self.stats.generated_tokens += 1
                if ((req.eos_token_id is not None
                     and int(t) == req.eos_token_id)
                        or len(req.output) >= req.max_new_tokens):
                    req.done = True
                    break

    def _retire(self):
        retired = []
        for i in range(self.max_batch):
            req = self.slots[i]
            if req is None:
                continue
            if req.done or len(req.output) >= req.max_new_tokens:
                # drop anything generated past EOS / max inside the chunk
                if req.eos_token_id is not None \
                        and req.eos_token_id in req.output:
                    req.output = req.output[
                        :req.output.index(req.eos_token_id) + 1]
                req.output = req.output[:req.max_new_tokens]
                req.done = True
                retired.append(req)
                self.slots[i] = None
                self.active[i] = False
                self.stats.finished += 1
        return retired


def _filter_topk_rows(logits, top_k):
    """Per-row top-k filtering with a row-specific k (`serving.py:528`)."""
    vocab = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = top_k.clamp(1, vocab).to(torch.int64)
    kth = sorted_desc.gather(-1, (k - 1)[:, None])
    return logits.masked_fill(logits < kth, -torch.inf)
