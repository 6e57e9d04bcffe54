"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points never fall back to the CPU by themselves."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "flash_attn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "transformers", "flash_attn_tpu")
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    for name in imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import flash_attn_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules "
        "if m.startswith('flash_attn_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 15


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_default_device_raises_without_cuda(no_cuda):
    from flash_attn_tpu_torch import default_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


def test_model_raises_without_cuda(no_cuda):
    from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel

    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTLMHeadModel(GPTConfig(n_embd=64, n_head=2, n_layer=1,
                                 vocab_size=17, n_positions=32))


def _entry_points():
    from flash_attn_tpu_torch.blocksparse import convert_blockmask
    from flash_attn_tpu_torch.kernels.flex import BlockMask, create_block_mask
    from flash_attn_tpu_torch.layers.patch_embed import PatchEmbed
    from flash_attn_tpu_torch.layers.rotary import RotaryEmbedding
    from flash_attn_tpu_torch.models.bert import (BertConfig,
                                                  BertForPreTraining,
                                                  BertModel)
    from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTModel
    from flash_attn_tpu_torch.models.vit import VisionTransformer
    from flash_attn_tpu_torch.modules.block import Block, _Norm
    from flash_attn_tpu_torch.modules.embedding import GPT2Embeddings
    from flash_attn_tpu_torch.modules.mha import MHA
    from flash_attn_tpu_torch.modules.mlp import GatedMlp, Mlp
    from flash_attn_tpu_torch.training.config import TrainConfig
    from flash_attn_tpu_torch.training.trainer import Trainer
    from flash_attn_tpu_torch.utils.generation import allocate_inference_cache

    tiny = TrainConfig()
    tiny.model.n_embd, tiny.model.n_head, tiny.model.n_layer = 64, 2, 1
    tiny.model.vocab_size, tiny.data.seq_len = 17, 8
    stub = torch.nn.Identity()
    bert = BertConfig(vocab_size=17, hidden_size=64, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=128,
                      max_position_embeddings=32)
    return {
        "BertModel": lambda: BertModel(bert),
        "BertForPreTraining": lambda: BertForPreTraining(bert),
        "Block_postnorm": lambda: Block(64, stub, stub, prenorm=False),
        "GPTModel": lambda: GPTModel(GPTConfig(n_embd=64, n_head=2, n_layer=1,
                                               vocab_size=17, n_positions=32)),
        "MHA": lambda: MHA(64, 2),
        "Mlp": lambda: Mlp(64, 128),
        "GatedMlp": lambda: GatedMlp(64, 128),
        "_Norm": lambda: _Norm(64),
        "Block": lambda: Block(64, stub, stub),
        "GPT2Embeddings": lambda: GPT2Embeddings(64, 17, 32),
        "allocate_inference_cache": lambda: allocate_inference_cache(2, 32),
        "Trainer": lambda: Trainer(tiny),
        "RotaryEmbedding": lambda: RotaryEmbedding(128, base=500000.0),
        "create_block_mask": lambda: create_block_mask(
            lambda b, h, q, k: q >= k, 1, 1, 64, 64, block_q=64, block_k=64),
        "BlockMask.from_numpy": lambda: BlockMask.from_numpy(
            64, 64, 64, 64, **{n: [[[0]]] for n in ("kv_num", "full_kv_num",
                                                    "q_num", "full_q_num")},
            **{n: [[[[0]]]] for n in ("kv_idx", "full_kv_idx", "q_idx",
                                      "full_q_idx")}),
        "convert_blockmask": lambda: convert_blockmask(
            [[True]], 1, 1, 64, 64, block_q=64, block_k=64),
        "PatchEmbed": lambda: PatchEmbed(32, 8, 64),
        "VisionTransformer": lambda: VisionTransformer(
            img_size=32, patch_size=8, embed_dim=64, depth=1, num_heads=2),
    }


@pytest.mark.parametrize("name", ["GPTModel", "MHA", "Mlp", "GatedMlp",
                                  "_Norm", "Block", "GPT2Embeddings",
                                  "allocate_inference_cache", "Trainer",
                                  "RotaryEmbedding", "BertModel",
                                  "BertForPreTraining", "Block_postnorm",
                                  "create_block_mask",
                                  "BlockMask.from_numpy",
                                  "convert_blockmask", "PatchEmbed",
                                  "VisionTransformer"])
def test_entry_point_raises_without_cuda(no_cuda, name):
    """Every public constructor resolves device=None to CUDA, so none of
    them builds on the CPU unless asked to."""
    make = _entry_points()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


@pytest.mark.parametrize("fn", ["flash_attn_fwd_bhsd", "decode_attn_bhsd",
                                "flash_attn_bwd_bhsd", "flash_attn_func",
                                "decode_attn_ref_layout",
                                "flash_attn_with_kvcache", "varlen_attn_fwd",
                                "varlen_attn_bwd", "flash_attn_varlen_func",
                                "flex_attn_fwd", "flex_attn_bwd",
                                "flex_attention",
                                "flash_blocksparse_attn_func",
                                "flash_attn_varlen_packed_func"])
def test_wrappers_run_no_plain_version_off_cpu(fn):
    """A tensor that is not on the CPU never reaches the plain version."""
    from flash_attn_tpu_torch.blocksparse import flash_blocksparse_attn_func
    from flash_attn_tpu_torch.interface import (flash_attn_func,
                                                flash_attn_varlen_func)
    from flash_attn_tpu_torch.kernels import (flash_bwd, flash_decode,
                                              flash_fwd, flex, varlen,
                                              varlen_packed)

    q = torch.empty(1, 2, 4, 64, device="meta")
    k = torch.empty(1, 2, 8, 64, device="meta")
    lens = torch.empty(1, dtype=torch.int32, device="meta")
    packed = torch.empty(8, 2, 64, device="meta")
    cu = torch.empty(3, dtype=torch.int32, device="meta")
    bshd = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        if fn == "flex_attn_fwd":
            flex.flex_attn_fwd(bshd, bshd, bshd, None, None, None, 0.125)
        elif fn == "flex_attn_bwd":
            flex.flex_attn_bwd(bshd, bshd, bshd, bshd, bshd, lens, None, None,
                               None, 0.125)
        elif fn == "flex_attention":
            flex.flex_attention(bshd, bshd, bshd,
                                mask_mod=lambda b, h, q, k: q >= k)
        elif fn == "flash_blocksparse_attn_func":
            flash_blocksparse_attn_func(
                torch.empty(1, 64, 3, 2, 64, device="meta"),
                torch.ones(1, 1, dtype=torch.bool), block_q=64, block_k=64)
        elif fn == "flash_attn_varlen_packed_func":
            varlen_packed.flash_attn_varlen_packed_func(packed, packed, packed,
                                                        cu, cu, 4, 4)
        elif fn == "varlen_attn_fwd":
            varlen.varlen_attn_fwd(packed, packed, packed, cu, cu, 4, 4,
                                   softmax_scale=0.125)
        elif fn == "varlen_attn_bwd":
            lse = torch.empty(2, 8, device="meta")
            varlen.varlen_attn_bwd(packed, packed, packed, packed, packed,
                                   lse, cu, cu, 4, 4, softmax_scale=0.125)
        elif fn == "flash_attn_varlen_func":
            flash_attn_varlen_func(packed, packed, packed, cu, cu, 4, 4)
        elif fn == "flash_attn_fwd_bhsd":
            flash_fwd.flash_attn_fwd_bhsd(q, k, k, lens, lens,
                                          softmax_scale=0.125)
        elif fn == "decode_attn_bhsd":
            flash_decode.decode_attn_bhsd(q, k, k, lens, softmax_scale=0.125)
        elif fn == "flash_attn_bwd_bhsd":
            lse = torch.empty(1, 2, 4, device="meta")
            flash_bwd.flash_attn_bwd_bhsd(q, q, k, k, q, lse, lens, lens,
                                          softmax_scale=0.125)
        elif fn == "decode_attn_ref_layout":
            flash_decode.decode_attn_ref_layout(q, k, k, lens,
                                                softmax_scale=0.125)
        elif fn == "flash_attn_with_kvcache":
            flash_decode.flash_attn_with_kvcache(q, k, k, cache_seqlens=lens)
        else:
            flash_attn_func(q, k, k, causal=True)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from flash_attn_tpu_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_kernel_depends_on_its_source_and_headers_only(monkeypatch,
                                                       tmp_path):
    """A kernel is rebuilt when `csrc/<name>.cu` (a derived library: its
    source's) or a shared header changes, not when another source sharing
    its prefix does."""
    from flash_attn_tpu_torch.kernels import _build

    names = {p.name for p in _build.sources("flash_decode_ref")}
    assert names == {"flash_decode_ref.cu", "fa_common.cuh", "hopper.cuh"}
    assert _build.sources("flash_decode_ref_wide") == _build.sources(
        "flash_decode_ref")
    assert all(_build.sources(n)[0].exists() for n in _build.KERNELS)
    for f in ("k.cu", "k_other.cu", "shared.cuh"):
        (tmp_path / f).write_text("")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    assert {p.name for p in _build.sources("k")} == {"k.cu", "shared.cuh"}


@pytest.mark.parametrize("fn", ["dma_stream", "decode_ladder", "launch",
                                "launch2", "launch3", "launch4",
                                "launch_empty_ctas"])
def test_probe_kernels_take_cuda_tensors_only(fn):
    """The diagnostic probes' kernel entry points raise on CPU tensors: only
    their plain twins (`*_ref`) run there."""
    from flash_attn_tpu_torch.diag import dma_stream, int8_decode
    from flash_attn_tpu_torch.diag import varlen_overhead_bisect as vb

    t = torch.zeros(4, dtype=torch.int32)
    x = torch.zeros(2, 128, 128, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="takes CUDA tensors"):
        if fn == "dma_stream":
            dma_stream.dma_stream(torch.zeros(4, 8, 1024,
                                              dtype=torch.bfloat16), t,
                                  bundle=1, fused=False)
        elif fn == "decode_ladder":
            q = torch.zeros(1, 1, 8, 128, dtype=torch.int8)
            kv = torch.zeros(1, 128, 128, dtype=torch.int8)
            int8_decode.decode_ladder("full", q, kv, kv, bk=64)
        elif fn == "launch":
            vb.launch(4, t, t, t, x, x, x, t, t)
        elif fn == "launch2":
            vb.launch2(t, t, t, x, x, x, t, t, lse_lanes=True)
        elif fn == "launch3":
            vb.launch3(t, t, t, t, x, x, x, t, t)
        elif fn == "launch4":
            vb.launch4(2, 2, t, t, t, x, x, x)
        else:
            vb.launch_empty_ctas(t, t, t, x, x, x)
