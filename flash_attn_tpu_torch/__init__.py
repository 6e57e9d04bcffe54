"""PyTorch/CUDA port of `flash_attn_tpu` (the JAX package stays the reference).

This slice covers the GPT-2 serving path: `serving.ServingEngine` ->
`models.gpt.GPTLMHeadModel` -> `modules.mha.MHA` -> the two hand-written
Hopper kernels in `csrc/` (prefill `flash_fwd.cu`, decode `flash_decode.cu`).

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
GPU present `device=None` raises `RuntimeError`.  On CPU tensors each kernel
wrapper runs its plain PyTorch version; on CUDA tensors it launches the
kernel or raises.
"""

from flash_attn_tpu_torch.env import default_device

__all__ = ["default_device"]
