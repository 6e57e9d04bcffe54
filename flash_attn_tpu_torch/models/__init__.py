"""The port's models (counterpart of `flash_attn_tpu/models/__init__.py`,
less what is not ported: OPT and the tensor-parallel helpers)."""

from flash_attn_tpu_torch.models.gpt import (  # noqa: F401
    GPTConfig,
    GPTLMHeadModel,
    GPTModel,
    remap_state_dict_hf_gpt2,
)
from flash_attn_tpu_torch.models.llama import (  # noqa: F401
    llama_config_to_gpt2_config,
    remap_state_dict_hf_llama,
    remap_state_dict_meta_llama,
)
from flash_attn_tpu_torch.models.gptj import (  # noqa: F401
    gptj_config_to_gpt2_config,
    remap_state_dict_hf_gptj,
)
from flash_attn_tpu_torch.models.gpt_neox import (  # noqa: F401
    gpt_neox_config_to_gpt2_config,
    remap_state_dict_hf_gpt_neox,
)
from flash_attn_tpu_torch.models.falcon import (  # noqa: F401
    falcon_config_to_gpt2_config,
    remap_state_dict_hf_falcon,
)
from flash_attn_tpu_torch.models.bigcode import (  # noqa: F401
    bigcode_config_to_gpt2_config,
    remap_state_dict_hf_bigcode,
)
from flash_attn_tpu_torch.models.baichuan import (  # noqa: F401
    baichuan_config_to_gpt2_config,
    remap_state_dict_hf_baichuan,
)
from flash_attn_tpu_torch.models.btlm import (  # noqa: F401
    btlm_config_to_gpt2_config,
    remap_state_dict_hf_btlm,
)
