"""Token data with fault-tolerant resume (counterpart of
`flash_attn_tpu/training/data.py:20-135`).

Plain numpy, as in the JAX package, so the batches are bit-identical for the
same seed: `synthetic_tokens`, `LMDataset` ((seq_len + 1)-token examples from
a flat token array), `LoaderState` and `FaultTolerantLoader` (the epoch's
permutation is a function of (seed, epoch), and the state records the
position inside the epoch, so a restored state resumes the exact stream).
`make_loader` reads synthetic data, `.npy` and `.bin` token files, and
local text files through `hf_data` (`:97-113`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def synthetic_tokens(vocab_size: int, n_tokens: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab_size, n_tokens, dtype=np.int32)


class LMDataset:
    """Flat token array -> (seq_len + 1)-token examples; input and shifted
    target share the example."""

    def __init__(self, tokens: np.ndarray, seq_len: int):
        self.tokens = tokens
        self.seq_len = seq_len
        self.n_examples = (len(tokens) - 1) // seq_len

    def __len__(self):
        return self.n_examples

    def __getitem__(self, idx):
        s = idx * self.seq_len
        return self.tokens[s: s + self.seq_len + 1]


@dataclasses.dataclass
class LoaderState:
    epoch: int = 0
    batches_served: int = 0
    seed: int = 0

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class FaultTolerantLoader:
    """Deterministic, resumable iterator of (batch_size, seq_len + 1)
    numpy batches."""

    def __init__(self, dataset: LMDataset, batch_size: int, seed: int = 0,
                 state: Optional[LoaderState] = None, shuffle: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.state = state or LoaderState(seed=seed)
        self.batches_per_epoch = len(dataset) // batch_size

    def _epoch_perm(self, epoch):
        if not self.shuffle:
            return np.arange(len(self.dataset))
        rng = np.random.default_rng((self.state.seed, epoch))
        return rng.permutation(len(self.dataset))

    def __iter__(self):
        return self

    def __next__(self):
        st = self.state
        if self.batches_per_epoch == 0:
            raise StopIteration
        if st.batches_served >= self.batches_per_epoch:
            st.epoch += 1
            st.batches_served = 0
        perm = self._epoch_perm(st.epoch)
        i = st.batches_served * self.batch_size
        idx = perm[i: i + self.batch_size]
        batch = np.stack([self.dataset[j] for j in idx])
        st.batches_served += 1
        return batch


def make_loader(cfg, vocab_size: int) -> FaultTolerantLoader:
    if getattr(cfg, "hf_dataset", None) or getattr(cfg, "text_files", None):
        from flash_attn_tpu_torch.training.hf_data import (HFDataConfig,
                                                           make_hf_loader)

        hf_cfg = HFDataConfig(
            dataset_name=cfg.hf_dataset, dataset_config=cfg.hf_config,
            text_files=cfg.text_files, tokenizer=cfg.tokenizer,
            detokenizer=cfg.detokenizer, cache_dir=cfg.cache_dir,
            max_examples=cfg.max_examples)
        return make_hf_loader(hf_cfg, cfg.seq_len, cfg.batch_size,
                              seed=cfg.seed)
    if cfg.dataset == "synthetic":
        tokens = synthetic_tokens(
            vocab_size, cfg.batch_size * cfg.seq_len * 64 + 1, cfg.seed)
    elif str(cfg.dataset).endswith(".bin"):
        tokens = load_memmap_tokens(cfg.dataset)
    else:
        tokens = np.load(cfg.dataset, mmap_mode="r")
    ds = LMDataset(np.asarray(tokens), cfg.seq_len)
    return FaultTolerantLoader(ds, cfg.batch_size, seed=cfg.seed)


def load_memmap_tokens(path, dtype=np.uint16):
    """Memory-map a flat binary token shard (read-only numpy view)."""
    return np.memmap(path, dtype=dtype, mode="r")


def lm_dataset_from_bin(path, seq_len, dtype=np.uint16):
    """`LMDataset` over a memory-mapped .bin token shard."""
    return LMDataset(load_memmap_tokens(path, dtype), seq_len)
