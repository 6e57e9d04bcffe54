"""PyTorch/CUDA port of `flash_attn_tpu` (the JAX package stays the reference).

Ported so far: the GPT-2 serving path (`serving.ServingEngine` ->
`models.gpt.GPTLMHeadModel` -> `modules.mha.MHA` -> `csrc/flash_fwd.cu`,
`csrc/flash_decode_ref.cu`), the GPT-2 training step
(`training.trainer.Trainer` -> `interface.flash_attn_func` ->
`csrc/flash_bwd.cu`), and the paged KV-cache API (`flash_attn_with_kvcache`,
`flash_attn_varlen_func` with `block_table=` -> `csrc/flash_decode_ref.cu`),
and packed varlen attention with the BERT encoder
(`models.bert.BertModel(unpad_varlen=True)` -> `flash_attn_varlen_func` ->
`kernels.varlen` -> the varlen modes of `csrc/flash_fwd.cu` and
`csrc/flash_bwd.cu`), and programmable attention (`flex_attention`,
`create_block_mask`, `blocksparse.flash_blocksparse_attn_func`,
`flash_attn_varlen_packed_func` -> `kernels.flex` -> `csrc/flex.cu`).

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
GPU present `device=None` raises `RuntimeError`.  On CPU tensors each kernel
wrapper runs its plain PyTorch version; on CUDA tensors it launches the
kernel or raises.
"""

from flash_attn_tpu_torch.env import default_device
from flash_attn_tpu_torch.interface import (
    flash_attn_combine, flash_attn_func, flash_attn_kvpacked_func,
    flash_attn_qkvpacked_func, flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func, flash_attn_varlen_qkvpacked_func,
    flash_attn_with_kvcache, fuse_kv_cache, get_scheduler_metadata,
    split_kv_cache)
from flash_attn_tpu_torch.kernels.flex import (BlockMask, create_block_mask,
                                               flex_attention)
from flash_attn_tpu_torch.kernels.varlen_packed import \
    flash_attn_varlen_packed_func

__all__ = ["BlockMask", "create_block_mask", "default_device",
           "flash_attn_combine", "flash_attn_func", "flash_attn_kvpacked_func",
           "flash_attn_qkvpacked_func", "flash_attn_varlen_func",
           "flash_attn_varlen_kvpacked_func", "flash_attn_varlen_packed_func",
           "flash_attn_varlen_qkvpacked_func", "flash_attn_with_kvcache",
           "flex_attention", "fuse_kv_cache", "get_scheduler_metadata",
           "split_kv_cache"]
