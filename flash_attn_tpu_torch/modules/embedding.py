"""GPT-2 embeddings (counterpart of
`flash_attn_tpu/modules/embedding.py::GPT2Embeddings:19-64`): word plus
learned position embeddings, and `attend` for the tied LM head."""

from __future__ import annotations

import torch
from torch import nn

from flash_attn_tpu_torch.env import default_device


class GPT2Embeddings(nn.Module):
    def __init__(self, embed_dim: int, vocab_size: int,
                 max_position_embeddings: int = 0, *, device=None,
                 dtype=torch.float32):
        """max_position_embeddings = 0 means no position embeddings."""
        super().__init__()
        device = default_device(device)
        self.wte = nn.Embedding(vocab_size, embed_dim, device=device,
                                dtype=dtype)
        self.wpe = (nn.Embedding(max_position_embeddings, embed_dim,
                                 device=device, dtype=dtype)
                    if max_position_embeddings > 0 else None)

    def forward(self, input_ids, position_ids=None):
        x = self.wte(input_ids)
        if self.wpe is not None:
            if position_ids is None:
                position_ids = torch.arange(input_ids.shape[1],
                                            device=input_ids.device)[None, :]
            x = x + self.wpe(position_ids)
        return x

    def attend(self, hidden_states):
        """Tied LM head: token logits from the word embedding table."""
        return hidden_states @ self.wte.weight.t()
