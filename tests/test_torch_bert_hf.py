"""`flash_attn_tpu_torch.models.bert.remap_state_dict_hf_bert` against the
JAX package's remap of the same Hugging Face `BertModel` weights (through
`bert_state_dict_from_jax_params`), and the port with those weights against
Hugging Face's forward, at the size of `test_torch_bert.py`.  Needs
`transformers`; skips without it."""

import dataclasses

import pytest
import torch

from flash_attn_tpu.models import bert as jax_bert
from flash_attn_tpu_torch.models import bert
from test_torch_bert import CFG, batch, t


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_remap_state_dict_hf_bert(monkeypatch):
    # transformers imports TensorFlow where it is installed, which takes
    # seconds and is not needed here
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(**dataclasses.asdict(CFG))
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg).eval()
    sd = bert.remap_state_dict_hf_bert(hf.state_dict(), CFG)
    jax_tree = jax_bert.remap_state_dict_hf_bert(hf.state_dict(), hf_cfg)
    ref = bert.bert_state_dict_from_jax_params(jax_tree, CFG)
    assert sd.keys() == ref.keys()
    for name in sd:
        torch.testing.assert_close(sd[name], ref[name], atol=0, rtol=0)
    model = bert.BertModel(CFG, device="cpu")
    model.load_state_dict(sd)
    ids, types, mask = batch(7)
    with torch.no_grad():
        want = hf(t(ids).long(), attention_mask=t(mask).long(),
                  token_type_ids=t(types).long()).last_hidden_state
        got, _ = model(t(ids), t(mask), t(types), unpad_varlen=True)
    # the port (like the JAX model) maps "gelu" to the tanh approximation,
    # Hugging Face to erf: 2e-3 as in tests/models/test_bert.py
    valid = t(mask)
    torch.testing.assert_close(got[valid], want[valid], atol=2e-3, rtol=0)
