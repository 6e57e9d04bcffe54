"""Language-modelling data from local text files (counterpart of
`flash_attn_tpu/training/hf_data.py`, offline part: `wikitext_detokenize:25`,
`ByteTokenizer:48`, `HFDataConfig:69`, `_iter_texts:81`,
`tokenize_to_array:112`, `make_hf_loader:141`).

Texts from local `.txt` (one per non-empty line) or `.jsonl` (the
`text_key` of each record) files are detokenized, tokenized with the
dependency-free byte tokenizer (vocab 256 bytes + eos), concatenated into
one flat int32 array, cached on disk as `.npy` keyed by the config, and
served by `FaultTolerantLoader`.  Hub datasets and pretrained tokenizers
need the network and `transformers`: they raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np


def wikitext_detokenize(text: str) -> str:
    """Undo wikitext's moses-style tokenization artifacts."""
    rules = [
        (" @-@ ", "-"), (" @,@ ", ","), (" @.@ ", "."),
        (" .", "."), (" ,", ","), (" !", "!"), (" ?", "?"),
        (" ;", ";"), (" :", ":"), (" '", "'"),
        (" n't", "n't"), (" 's", "'s"), (" 'm", "'m"), (" 're", "'re"),
        ("( ", "("), (" )", ")"), ("`` ", '"'), (" ''", '"'),
    ]
    for a, b in rules:
        text = text.replace(a, b)
    return text


DETOKENIZERS = {
    "wikitext": wikitext_detokenize,
    None: lambda t: t,
    "none": lambda t: t,
}


class ByteTokenizer:
    """Byte-level tokenizer: vocab = 256 bytes + eos."""

    vocab_size = 257
    eos_token_id = 256

    def encode(self, text: str):
        return list(text.encode("utf-8", errors="replace"))


def make_tokenizer(name: str):
    if name in ("bytes", "byte"):
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer {name!r}: only tokenizer='bytes' over local .txt / "
        ".jsonl files is ported (pretrained tokenizers need transformers)")


@dataclasses.dataclass
class HFDataConfig:
    dataset_name: Optional[str] = None      # hub dataset: not ported
    dataset_config: Optional[str] = None
    text_files: Optional[list] = None       # local .txt / .jsonl files
    text_key: str = "text"
    tokenizer: str = "gpt2"                 # only "bytes" is ported
    detokenizer: Optional[str] = None
    cache_dir: str = ".hf_token_cache"
    append_eos: bool = True
    max_examples: int = 0                   # 0 = all


def _iter_texts(cfg: HFDataConfig, split: str):
    if cfg.dataset_name is not None:
        raise NotImplementedError(
            f"hub dataset {cfg.dataset_name!r}: only tokenizer='bytes' over "
            "local .txt / .jsonl files is ported")
    if not cfg.text_files:
        raise ValueError("need text_files")
    count = 0
    for path in cfg.text_files:
        path = Path(path)
        with path.open() as f:
            for line in f:
                if cfg.max_examples and count >= cfg.max_examples:
                    return
                if path.suffix == ".jsonl":
                    yield json.loads(line)[cfg.text_key]
                elif line.strip():
                    yield line.rstrip("\n")
                else:
                    continue
                count += 1


def tokenize_to_array(cfg: HFDataConfig, split: str = "train") -> np.ndarray:
    """Tokenize and concatenate a split into one flat int32 token array,
    cached on disk as `<cache_dir>/<key>.npy` keyed by the config."""
    cache_dir = Path(cfg.cache_dir)
    key = (f"{cfg.dataset_name or 'files'}-{cfg.dataset_config or ''}-"
           f"{cfg.tokenizer.replace('/', '_')}-{split}-{cfg.max_examples}")
    cache = cache_dir / f"{key}.npy"
    if cache.exists():
        return np.load(cache, mmap_mode="r")
    tok = make_tokenizer(cfg.tokenizer)
    detok = DETOKENIZERS.get(cfg.detokenizer, DETOKENIZERS[None])
    eos = tok.eos_token_id
    chunks = []
    for text in _iter_texts(cfg, split):
        ids = tok.encode(detok(text))
        if cfg.append_eos:
            ids = ids + [eos]
        chunks.append(np.asarray(ids, np.int32))
    tokens = np.concatenate(chunks) if chunks else np.zeros(0, np.int32)
    cache_dir.mkdir(parents=True, exist_ok=True)
    np.save(cache, tokens)
    return tokens


def make_hf_loader(cfg: HFDataConfig, seq_len: int, batch_size: int,
                   split: str = "train", seed: int = 0):
    """`FaultTolerantLoader` over the tokenized text."""
    from flash_attn_tpu_torch.training.data import (FaultTolerantLoader,
                                                    LMDataset)

    tokens = tokenize_to_array(cfg, split)
    return FaultTolerantLoader(LMDataset(np.asarray(tokens), seq_len),
                               batch_size, seed=seed)
