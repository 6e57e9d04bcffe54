"""Tests of the port that need the card: each CUDA kernel against its plain
PyTorch version, and the GPT serving path and a training step on CUDA
against the plain CPU path.

Marked `gpu`; they skip where torch sees no CUDA device.  Run them on a GPU
machine with `python -m pytest tests/test_torch_gpu.py -m gpu -q` (add
`--noconftest` where JAX is not installed: `tests/conftest.py` imports it).
Tolerance: the repo's rule, |kernel - fp32 plain| <= 2 |bf16 plain - fp32
plain| + 1e-5 on valid rows.
"""

import numpy as np
import pytest
import torch

from flash_attn_tpu_torch.kernels import flash_bwd, flash_decode, flash_fwd
from flash_attn_tpu_torch.utils.testing import check_close

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,h,hk,causal,window,softcap,alibi", [
    (64, 4, 4, True, (-1, -1), 0.0, False),
    (128, 8, 2, True, (-1, -1), 0.0, False),
    (64, 4, 2, False, (32, 8), 30.0, True),
    (128, 4, 4, False, (-1, -1), 0.0, False),
    # head dims run in the tile of d rounded up to 64; 100 through the
    # wrapper's copy padded to 104
    (32, 4, 2, True, (-1, -1), 0.0, False),
    (80, 8, 2, True, (-1, -1), 0.0, False),
    (96, 4, 4, False, (32, 8), 30.0, True),
    (100, 4, 2, True, (-1, -1), 0.0, False),
    (160, 4, 4, False, (-1, -1), 0.0, False),
    (192, 8, 2, True, (-1, -1), 0.0, False),
    (224, 4, 2, False, (32, 8), 30.0, True),
    (256, 8, 2, True, (-1, -1), 0.0, False),
    (256, 4, 4, False, (32, 8), 30.0, True),
])
def test_fwd_kernel_matches_plain(cuda, dtype, d, h, hk, causal, window,
                                  softcap, alibi):
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, sq, sk = 3, 150, 300
    q = torch.randn(b, h, sq, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, hk, sk, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, hk, sk, d, generator=gen, device=cuda).to(dtype)
    # batch 1: seqused_k < seqused_q, so its first causal rows see no key
    squ = torch.tensor([150, 140, 150], dtype=torch.int32, device=cuda)
    sku = torch.tensor([300, 97, 0], dtype=torch.int32, device=cuda)
    slopes = torch.rand(b, h, generator=gen, device=cuda) if alibi else None
    kw = dict(softmax_scale=d ** -0.5, causal=causal, window_size=window,
              softcap=softcap, alibi_slopes=slopes)
    before = flash_fwd.launches
    o, lse = flash_fwd.flash_attn_fwd_bhsd(q, k, v, squ, sku, **kw)
    assert flash_fwd.launches == before + 1
    o_ref, lse_ref = flash_fwd.flash_attn_fwd_bhsd_ref(
        q.float(), k.float(), v.float(), squ, sku, **kw)
    o_pt, lse_pt = flash_fwd.flash_attn_fwd_bhsd_ref(q, k, v, squ, sku, **kw)
    rows = (torch.arange(sq, device=cuda)[None, None, :]
            < squ[:, None, None]).expand(b, h, sq)
    check_close(o[rows], o_ref[rows], o_pt[rows])
    assert torch.equal(torch.isinf(lse[rows]), torch.isinf(lse_ref[rows]))
    fin = rows & torch.isfinite(lse_ref)
    check_close(lse[fin], lse_ref[fin], lse_pt[fin])
    assert torch.all(o[2] == 0) and torch.all(torch.isposinf(lse[2]))


@pytest.mark.parametrize("splits", ["explicit", "auto"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,h,hk,sq,num_splits,window,softcap,alibi", [
    (64, 12, 12, 1, 1, (-1, -1), 0.0, False),
    (128, 32, 8, 1, 1, (-1, -1), 0.0, False),
    (64, 8, 4, 4, 1, (-1, -1), 0.0, False),
    (64, 12, 12, 1, 3, (-1, -1), 0.0, False),
    (128, 8, 1, 16, 2, (-1, -1), 0.0, False),
    (64, 16, 2, 20, 1, (-1, -1), 0.0, False),  # 160 packed rows: 3 tiles
    (64, 8, 2, 4, 3, (100, 0), 30.0, True),
    (32, 8, 2, 4, 3, (100, 0), 30.0, True),
    (80, 12, 12, 1, 1, (-1, -1), 0.0, False),
    (96, 8, 4, 4, 1, (-1, -1), 0.0, False),
    (100, 8, 2, 1, 2, (-1, -1), 0.0, False),
    (160, 16, 2, 20, 1, (-1, -1), 0.0, False),
    (192, 8, 1, 16, 2, (-1, -1), 0.0, False),
    (256, 16, 16, 1, 1, (-1, -1), 0.0, False),
    (256, 16, 2, 20, 3, (100, 0), 30.0, True),
])
def test_decode_kernel_matches_plain(cuda, dtype, d, h, hk, sq, num_splits,
                                     window, softcap, alibi, splits):
    """Heads-first decode against its plain version, at the case's split
    count and at num_splits = 0 (the kernel's own split, merged in the
    kernel)."""
    if splits == "auto":
        num_splits = 0
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, smax = 4, 600
    q = torch.randn(b, h, sq, d, generator=gen, device=cuda).to(dtype)
    kc = torch.randn(b + 1, hk, smax, d, generator=gen, device=cuda).to(dtype)
    vc = torch.randn(b + 1, hk, smax, d, generator=gen, device=cuda).to(dtype)
    lens = torch.tensor([600, 17, 0, 333], dtype=torch.int32, device=cuda)
    cbi = torch.tensor([4, 0, 1, 2], dtype=torch.int32, device=cuda)
    slopes = torch.rand(b, h, generator=gen, device=cuda) if alibi else None
    kw = dict(softmax_scale=d ** -0.5, causal=True, num_splits=num_splits,
              block_k=128, cache_batch_idx=cbi, window_size=window,
              softcap=softcap, alibi_slopes=slopes)
    before = flash_decode.launches
    o, lse = flash_decode.decode_attn_bhsd(q, kc, vc, lens, **kw)
    assert flash_decode.launches == before + 1
    if splits == "auto":  # 4 * hk blocks leave SMs idle: the keys are split
        assert flash_decode.last_num_splits > 1
    o_ref, lse_ref = flash_decode.decode_attn_bhsd_ref(
        q.float(), kc.float(), vc.float(), lens, **kw)
    o_pt, lse_pt = flash_decode.decode_attn_bhsd_ref(q, kc, vc, lens, **kw)
    check_close(o, o_ref, o_pt)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    fin = torch.isfinite(lse_ref)
    check_close(lse[fin], lse_ref[fin], lse_pt[fin])


def test_serving_on_cuda_matches_cpu_plain_path(cuda):
    from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
    from flash_attn_tpu_torch.serving import ServingEngine

    cfg = GPTConfig(n_embd=256, n_head=4, n_layer=2, vocab_size=1000,
                    n_positions=512)
    gpu = GPTLMHeadModel(cfg, device=cuda, dtype=torch.float16)
    gpu.init_weights(torch.Generator().manual_seed(0))
    cpu = GPTLMHeadModel(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1000, n) for n in (20, 70, 5, 130)]
    eng = ServingEngine(gpu, max_batch=2, max_seqlen=256, chunk_steps=4,
                        prefill_buckets=(32, 64, 128, 256))
    fwd0, dec0 = flash_fwd.launches, flash_decode.launches
    uids = [eng.submit(p, max_new_tokens=12) for p in prompts]
    results = eng.run()
    assert flash_fwd.launches - fwd0 == eng.stats.prefill_waves * 2
    assert flash_decode.launches - dec0 == eng.stats.decode_steps * 2
    for uid, p in zip(uids, prompts):
        toks = results[uid]
        seq = torch.as_tensor(np.concatenate([p, toks[:-1]]))[None]
        with torch.no_grad():
            logits = cpu(seq).logits[0, len(p) - 1:]
        picked = logits[torch.arange(len(toks)), torch.as_tensor(toks)]
        assert float((logits.max(-1).values - picked).max()) < 0.05


def test_llama_cached_path_on_cuda_matches_cpu_plain_path(cuda):
    """A tiny Llama (d = 128, GQA 4 over 2, RMSNorm, interleaved rotary,
    SwiGLU, untied head) in bf16: a cached prefill of 40 tokens (the
    prefill kernel) and 4 decode steps (the decode kernel) on CUDA, each
    step's logits held by the tolerance rule to float32 on the CPU, with
    bf16 on the CPU as the yardstick; one launch a layer and step."""
    from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
    from flash_attn_tpu_torch.modules.mha import InferenceParams

    cfg = GPTConfig(n_embd=512, n_head=4, n_head_kv=2, n_layer=2,
                    vocab_size=1000, n_positions=0, n_inner=1024,
                    activation_function="swiglu", rms_norm=True,
                    rotary_emb_fraction=1.0, rotary_emb_interleaved=True,
                    rotary_emb_base=500000.0, tie_word_embeddings=False,
                    qkv_proj_bias=False, out_proj_bias=False,
                    mlp_fc1_bias=False, mlp_fc2_bias=False)
    models = [GPTLMHeadModel(cfg, device=dev, dtype=dt).init_weights(
        torch.Generator().manual_seed(0)).eval()
        for dev, dt in ((cuda, torch.bfloat16), ("cpu", torch.float32),
                        ("cpu", torch.bfloat16))]
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 1000, (2, 44)))
    ips = [InferenceParams(max_seqlen=64, max_batch_size=2,
                           lengths_per_sample=torch.zeros(
                               2, dtype=torch.int32, device=dev))
           for dev in (cuda, "cpu", "cpu")]
    counts = flash_fwd.launches, flash_decode.launches
    for step, x in enumerate([ids[:, :40]] + [ids[:, 40 + i:41 + i]
                                              for i in range(4)]):
        with torch.no_grad():
            out = [m(x.to(ip.lengths_per_sample.device),
                     inference_params=ip).logits.float().cpu()
                   for m, ip in zip(models, ips)]
        check_close(out[0], out[1], out[2], label=f"step {step}")
    assert (flash_fwd.launches - counts[0],
            flash_decode.launches - counts[1]) == (2, 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 80, 96, 100, 128, 160, 192, 224,
                               256])
@pytest.mark.parametrize("case", ["causal", "gqa", "window_softcap_alibi",
                                  "ragged"])
def test_bwd_kernel_matches_plain(cuda, dtype, d, case):
    """dq (rows < seqused_q), dk and dv against the plain version, and two
    runs bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    b, sq, sk = 3, 150, 300
    h, hk = (8, 2) if case == "gqa" else (4, 4)
    squ = [150, 150, 150]
    sku = [300, 300, 300]
    kw = dict(softmax_scale=d ** -0.5, causal=case != "window_softcap_alibi")
    if case == "window_softcap_alibi":
        kw.update(window_size=(32, 8), softcap=30.0,
                  alibi_slopes=torch.rand(b, h, generator=gen, device=cuda))
    if case == "ragged":  # batch 2 has no key at all
        squ, sku = [150, 100, 150], [300, 97, 0]
    q = torch.randn(b, h, sq, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, hk, sk, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, hk, sk, d, generator=gen, device=cuda).to(dtype)
    squ = torch.tensor(squ, dtype=torch.int32, device=cuda)
    sku = torch.tensor(sku, dtype=torch.int32, device=cuda)
    rows = (torch.arange(sq, device=cuda)[None, None, :]
            < squ[:, None, None]).expand(b, h, sq)
    do = (torch.randn(b, h, sq, d, generator=gen, device=cuda)
          * rows[..., None]).to(dtype)
    o, lse = flash_fwd.flash_attn_fwd_bhsd(q, k, v, squ, sku, **kw)
    before = flash_bwd.launches_dq, flash_bwd.launches_dkv
    dq, dk, dv = flash_bwd.flash_attn_bwd_bhsd(do, q, k, v, o, lse, squ, sku,
                                               **kw)
    assert (flash_bwd.launches_dq, flash_bwd.launches_dkv) == (
        before[0] + 1, before[1] + 1)
    ref = flash_bwd.flash_attn_bwd_bhsd_ref(
        do.float(), q.float(), k.float(), v.float(), o.float(), lse, squ, sku,
        **kw)
    pt = flash_bwd.flash_attn_bwd_bhsd_ref(do, q, k, v, o, lse, squ, sku, **kw)
    check_close(dq[rows], ref[0][rows], pt[0][rows], label="dq")
    check_close(dk, ref[1], pt[1], label="dk")
    check_close(dv, ref[2], pt[2], label="dv")
    if case == "ragged":
        assert not dq[2].any() and not dk[2].any() and not dv[2].any()
        assert not dk[1, :, 97:].any() and not dv[1, :, 97:].any()
    again = flash_bwd.flash_attn_bwd_bhsd(do, q, k, v, o, lse, squ, sku, **kw)
    for x, y in zip((dq, dk, dv), again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("which,d", [("fwd", 288), ("fwd_varlen", 288),
                                     ("decode", 288), ("bwd", 288),
                                     ("bwd_varlen", 288)])
def test_head_dim_beyond_the_kernels_raises_on_cuda(cuda, which, d):
    """The forward, backward and decode kernels take head dims up to 256:
    beyond that a CUDA call raises NotImplementedError, launches nothing
    and runs no plain version."""
    from flash_attn_tpu_torch.kernels import varlen

    x = torch.randn(1, 2, 64, d, device=cuda, dtype=torch.bfloat16)
    lens = torch.tensor([64], dtype=torch.int32, device=cuda)
    cu = torch.tensor([0, 64], dtype=torch.int32, device=cuda)
    packed = x[0].transpose(0, 1).contiguous()
    lse = torch.zeros(1, 2, 64, device=cuda)
    calls = {
        "fwd": lambda: flash_fwd.flash_attn_fwd_bhsd(x, x, x, lens, lens,
                                                     softmax_scale=0.1),
        "fwd_varlen": lambda: varlen.varlen_attn_fwd(
            packed, packed, packed, cu, cu, 64, 64, softmax_scale=0.1),
        "decode": lambda: flash_decode.decode_attn_bhsd(x, x, x, lens,
                                                        softmax_scale=0.1),
        "bwd": lambda: flash_bwd.flash_attn_bwd_bhsd(
            x, x, x, x, x, lse, lens, lens, softmax_scale=0.1),
        "bwd_varlen": lambda: varlen.varlen_attn_bwd(
            packed, packed, packed, packed, packed, lse[0], cu, cu, 64, 64,
            softmax_scale=0.1),
    }
    counts = (flash_fwd.launches, flash_bwd.launches_dq, flash_decode.launches,
              varlen.launches_fwd, varlen.launches_dq)
    with pytest.raises(NotImplementedError, match="head dim"):
        calls[which]()
    assert counts == (flash_fwd.launches, flash_bwd.launches_dq,
                      flash_decode.launches, varlen.launches_fwd,
                      varlen.launches_dq)


def test_cuda_train_step_matches_cpu_plain_path(cuda, tmp_path):
    """One batch through the Trainer's loss and backward: CUDA (kernels,
    bf16 autocast) against float32 on the CPU (plain path), same weights.
    Loss within 0.02, cosine of the whole gradient >= 0.999; then one
    train_step launches each kernel once per layer."""
    from flash_attn_tpu_torch.training.config import TrainConfig
    from flash_attn_tpu_torch.training.trainer import Trainer

    def config(dtype):
        cfg = TrainConfig()
        cfg.model.n_embd, cfg.model.n_head, cfg.model.n_layer = 256, 4, 2
        cfg.model.vocab_size, cfg.model.dtype = 1000, dtype
        cfg.data.seq_len, cfg.data.batch_size = 256, 2
        cfg.trainer.checkpoint_dir = str(tmp_path)
        return cfg

    gpu = Trainer(config("bfloat16"), device=cuda)
    cpu = Trainer(config("float32"), device="cpu")
    batch = next(cpu.loader)
    losses, grads = [], []
    for t in (gpu, cpu):
        loss = t.loss(batch)
        loss.backward()
        losses.append(loss.item())
        grads.append(torch.cat([p.grad.float().flatten().cpu()
                                for p in t.model.parameters()]))
        t.optimizer.zero_grad(set_to_none=True)
    assert abs(losses[0] - losses[1]) <= 0.02, losses
    g0, g1 = grads[0].double(), grads[1].double()
    cos = float(g0 @ g1 / (g0.norm() * g1.norm()))
    assert cos >= 0.999, cos
    counts = (flash_fwd.launches, flash_bwd.launches_dq,
              flash_bwd.launches_dkv)
    loss, gnorm = gpu.train_step(batch)
    assert torch.isfinite(loss) and torch.isfinite(gnorm)
    assert (flash_fwd.launches - counts[0], flash_bwd.launches_dq - counts[1],
            flash_bwd.launches_dkv - counts[2]) == (2, 2, 2)


@pytest.mark.parametrize("policy", ["none", "dots", "dots_no_batch"])
def test_remat_on_cuda_equals_no_remat(cuda, policy):
    """A tiny Llama's loss and gradients on the card under each remat
    policy equal those without remat bit for bit (deterministic kernels),
    and the forward kernel runs twice a layer (recomputed under every
    policy)."""
    from flash_attn_tpu_torch.training.config import TrainConfig
    from flash_attn_tpu_torch.training.trainer import Trainer

    cfg = TrainConfig()
    m = cfg.model
    m.n_embd, m.n_layer, m.n_head, m.n_head_kv = 256, 2, 4, 2
    m.vocab_size, m.rms_norm, m.rotary_emb_fraction = 1000, True, 1.0
    m.activation_function, m.tie_word_embeddings = "swiglu", False
    cfg.data.seq_len, cfg.data.batch_size = 256, 2
    t = Trainer(cfg, device=cuda)
    batch = next(t.loader)
    out = []
    for remat in (False, True):
        t.model.config.remat_blocks = remat
        t.model.config.remat_policy = policy
        before = flash_fwd.launches
        loss = t.loss(batch)
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in
                                    t.model.parameters()],
                    flash_fwd.launches - before))
        t.optimizer.zero_grad(set_to_none=True)
    (l0, g0, n0), (l1, g1, n1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert (n0, n1) == (2, 4)


def test_vit_on_cuda_matches_cpu_plain_path(cuda):
    """One batch of a 2-layer ViT (d = 64, 197 tokens) through the
    Trainer's image loss and backward: CUDA (kernels, bf16 autocast)
    against float32 on the CPU (plain path), same weights and draws: loss
    within 0.02, gradient cosine >= 0.999; 2 + 2 + 2 launches."""
    from flash_attn_tpu_torch.training.config import load_config
    from flash_attn_tpu_torch.training.trainer import Trainer

    def config(dtype):
        return load_config(overrides={
            "model": {"task": "image", "n_embd": 384, "n_layer": 2,
                      "n_head": 6, "num_classes": 100, "image_size": 224,
                      "patch_size": 16, "dtype": dtype},
            "data": {"batch_size": 4, "max_examples": 8}})

    gpu = Trainer(config("bfloat16"), device=cuda)
    cpu = Trainer(config("float32"), device="cpu")
    gpu.model.load_state_dict(cpu.model.state_dict())
    batch = next(cpu.loader)
    counts = (flash_fwd.launches, flash_bwd.launches_dq,
              flash_bwd.launches_dkv)
    losses, grads = [], []
    for t in (gpu, cpu):
        loss = t.loss(batch)
        loss.backward()
        losses.append(loss.item())
        grads.append(torch.cat([p.grad.float().flatten().cpu()
                                for p in t.model.parameters()]))
    assert (flash_fwd.launches - counts[0], flash_bwd.launches_dq - counts[1],
            flash_bwd.launches_dkv - counts[2]) == (2, 2, 2)
    assert abs(losses[0] - losses[1]) <= 0.02, losses
    g0, g1 = grads[0].double(), grads[1].double()
    assert float(g0 @ g1 / (g0.norm() * g1.norm())) >= 0.999


def _ref_layout_inputs(case, dtype, gen, dev, d=128):
    """q, caches and keyword arguments of one decode_attn_ref_layout call,
    and the dequantised float32 caches of its oracle."""
    b, h, hk, sq, page, pps = 3, 8, 2, 1, 64, 6
    if case == "d64_window_chunk_alibi":
        d, sq = 64, 4
    if case == "rows_gt_64":
        sq = 40  # 160 packed rows: three row tiles
    paged = case in ("paged", "fused", "int8_paged", "int8_fused",
                     "rows_gt_64")
    quant = {"int8_paged": torch.int8, "int8_fused": torch.int8,
             "fp8_contiguous": torch.float8_e4m3fn}.get(case)
    if paged:
        npages = b * pps + 5
        table = torch.randperm(npages, generator=gen, device=dev)[
            :b * pps].view(b, pps).int()
        shape = (npages, page, hk, d)
        cap = page * pps
    else:
        table, shape, cap = None, (b + 1, 500, hk, d), 500
    kc = torch.randn(shape, generator=gen, device=dev)
    vc = torch.randn(shape, generator=gen, device=dev)
    kw = dict(causal=True, block_table=table)
    kd = vd = None
    if quant == torch.int8:
        kc = (kc * 40).round().clamp(-127, 127).to(torch.int8)
        vc = (vc * 40).round().clamp(-127, 127).to(torch.int8)
    elif quant is not None:
        kc, vc = (kc * 60).to(quant), (vc * 60).to(quant)
    else:
        kc, vc = kc.to(dtype), vc.to(dtype)
    if quant is not None:
        kd = torch.rand(b, hk, generator=gen, device=dev) * 0.02 + 0.01
        vd = torch.rand(b, hk, generator=gen, device=dev) * 0.02 + 0.01
        kw.update(k_descale=kd, v_descale=vd)
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    lens = torch.tensor([cap, 77, 0], dtype=torch.int32, device=dev)
    if case == "fp8_contiguous":
        kw.update(cache_batch_idx=torch.tensor([3, 0, 2], device=dev),
                  cache_leftpad=torch.tensor([0, 9, 0], device=dev),
                  num_splits=4, block_k=128)
        lens = torch.tensor([cap, 301, 0], dtype=torch.int32, device=dev)
    if case == "d64_window_chunk_alibi":
        kw.update(window_size=(100, 0), attention_chunk=128, softcap=20.0,
                  alibi_slopes=torch.rand(b, h, generator=gen, device=dev))
    if case == "rows_gt_64":
        lens = torch.tensor([cap, 200, 39], dtype=torch.int32, device=dev)
    deq = {}
    if quant is not None:
        deq = dict(block_table=table, cache_batch_idx=kw.get("cache_batch_idx"))
    fused = case in ("fused", "int8_fused")
    if fused:
        kc, vc = torch.stack([kc, vc], dim=1), None
    return q, kc, vc, lens, kw, deq, fused


@pytest.mark.parametrize("splits", ["explicit", "auto"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", ["paged", "fused", "int8_paged", "int8_fused",
                                  "fp8_contiguous", "rows_gt_64",
                                  "d64_window_chunk_alibi"])
def test_decode_ref_layout_kernel_matches_plain(cuda, dtype, case, splits):
    """The reference-layout kernel against its plain version: the fp32
    oracle on the dequantised cache, the plain version in the cache's own
    precision as the low-precision yardstick, both at the split count the
    kernel launched (the case's own, or num_splits = 0's)."""
    _check_ref_layout(cuda, dtype, case, splits)


@pytest.mark.parametrize("d", [32, 80, 100, 192, 256])
@pytest.mark.parametrize("case", ["paged", "int8_paged", "fp8_contiguous",
                                  "rows_gt_64"])
def test_decode_ref_layout_head_dims_match_plain(cuda, case, d):
    """The reference-layout kernel at head dims other than 64 and 128
    (bf16 q): d runs in the tile of d rounded up to 64; an 8-bit cache row
    must be whole 16-byte chunks, so d = 80 runs as it is and d = 100 (as
    104 for bf16, 112 for int8 / fp8) through the wrapper's padded
    copies."""
    before = flash_fwd.pad_copies
    _check_ref_layout(cuda, torch.bfloat16, case, "auto", d)
    assert flash_fwd.pad_copies - before == (d == 100)


def _check_ref_layout(cuda, dtype, case, splits, d=128):
    from flash_attn_tpu_torch.utils.testing import dequantise_cache

    gen = torch.Generator(device=cuda).manual_seed(3)
    q, kc, vc, lens, kw, deq, fused = _ref_layout_inputs(case, dtype, gen,
                                                         cuda, d)
    d = q.shape[-1]
    kw["softmax_scale"] = d ** -0.5
    kw.setdefault("num_splits", 1)
    if splits == "auto":
        kw["num_splits"] = 0
    before = flash_decode.launches
    o, lse = flash_decode.decode_attn_ref_layout(q, kc, vc, lens, **kw)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    kw["num_splits"] = flash_decode.last_num_splits
    o_pt, lse_pt = flash_decode.decode_attn_ref_layout_ref(q, kc, vc, lens,
                                                           **kw)
    ref_kw = {k: v for k, v in kw.items()
              if k not in ("k_descale", "v_descale")}
    if deq:
        if fused:
            kf = dequantise_cache(kc[:, 0], kw["k_descale"], **deq)
            vf = dequantise_cache(kc[:, 1], kw["v_descale"], **deq)
            kf, vf = torch.stack([kf, vf], dim=1), None
        else:
            kf = dequantise_cache(kc, kw["k_descale"], **deq)
            vf = dequantise_cache(vc, kw["v_descale"], **deq)
    else:
        kf, vf = kc.float(), None if fused else vc.float()
    o_ref, lse_ref = flash_decode.decode_attn_ref_layout_ref(
        q.float(), kf, vf, lens, **ref_kw)
    check_close(o, o_ref, o_pt)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    fin = torch.isfinite(lse_ref)
    check_close(lse[fin], lse_ref[fin], lse_pt[fin])
    assert torch.all(o[2] == 0) or case == "rows_gt_64"


# The int8 kernel and the plain int8 version on 64-row pages (the kernel's
# own 64-key tiles) at the same split count quantise the same p against the
# same running maximum and differ only in float32 summation order: their
# bf16 outputs are equal or one step apart (<= 2^-7 |o|, and 1e-6 near 0),
# their lse far within 1e-4 (the rule of chip_smoke.py's int8_tiled_check).
@pytest.mark.parametrize("num_splits", [1, 0], ids=["one_split", "auto"])
def test_decode_int8_matches_plain_on_its_tiles(cuda, num_splits):
    gen = torch.Generator(device=cuda).manual_seed(4)
    b, h, hk, d, page, pps = 2, 32, 8, 128, 64, 128
    npages = b * pps + 3
    table = torch.randperm(npages, generator=gen, device=cuda)[
        :b * pps].view(b, pps).int()
    shape = (npages, page, hk, d)
    kc = torch.randint(-127, 128, shape, generator=gen, device=cuda,
                       dtype=torch.int8)
    vc = torch.randint(-127, 128, shape, generator=gen, device=cuda,
                       dtype=torch.int8)
    q = torch.randn(b, 1, h, d, generator=gen, device=cuda).bfloat16()
    lens = torch.tensor([page * pps, 5000], dtype=torch.int32, device=cuda)
    kw = dict(softmax_scale=d ** -0.5, causal=True, block_table=table,
              num_splits=num_splits,
              k_descale=torch.rand(b, hk, generator=gen, device=cuda) * 0.01
              + 0.01,
              v_descale=torch.rand(b, hk, generator=gen, device=cuda) * 0.01
              + 0.01)
    o, lse = flash_decode.decode_attn_ref_layout(q, kc, vc, lens, **kw)
    ns = flash_decode.last_num_splits
    assert ns == (4 if num_splits == 0 else 1)  # 8192 keys, 2048-key units
    o_pt, lse_pt = flash_decode.decode_attn_ref_layout_ref(
        q, kc, vc, lens, **dict(kw, num_splits=ns))
    o, o_pt = o.float(), o_pt.float()
    assert torch.all((o - o_pt).abs() <= 2.0 ** -7 * o_pt.abs() + 1e-6)
    assert float((lse - lse_pt).abs().max()) <= 1e-4


def test_serving_decode_auto_split(cuda):
    """The serving decode's shape (GPT-2: 12 heads, one row a kv head, d 64,
    a 1024-row heads-first cache, batch 8): 96 blocks leave SMs idle, so
    num_splits = 0 splits the keys; the result matches the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, h, d, smax = 8, 12, 64, 1024
    q = torch.randn(b, h, 1, d, generator=gen, device=cuda).bfloat16()
    kc = torch.randn(b, h, smax, d, generator=gen, device=cuda).bfloat16()
    vc = torch.randn(b, h, smax, d, generator=gen, device=cuda).bfloat16()
    lens = torch.randint(1, smax + 1, (b,), generator=gen, device=cuda,
                         dtype=torch.int32)
    kw = dict(softmax_scale=d ** -0.5, causal=True)
    o, lse = flash_decode.decode_attn_bhsd(q, kc, vc, lens, **kw)
    want = flash_decode.decode_num_splits(
        b, h, 1, smax, flash_decode.AUTO_BLOCK_K,
        flash_decode.sm_count(cuda))
    assert flash_decode.last_num_splits == want > 1
    o_ref, lse_ref = flash_decode.decode_attn_bhsd_ref(
        q.float(), kc.float(), vc.float(), lens, **kw)
    o_pt, lse_pt = flash_decode.decode_attn_bhsd_ref(q, kc, vc, lens, **kw)
    check_close(o, o_ref, o_pt)
    check_close(lse, lse_ref, lse_pt)


def test_decode_auto_split_is_one_when_the_grid_fills_the_card(cuda):
    """b * hk = 136 blocks fill an H100's 132 SMs: num_splits = 0 launches
    one split, and the result matches the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    b, h, hk, d, smax = 34, 8, 4, 128, 700
    q = torch.randn(b, 1, h, d, generator=gen, device=cuda).bfloat16()
    kc = torch.randn(b, smax, hk, d, generator=gen, device=cuda).bfloat16()
    vc = torch.randn(b, smax, hk, d, generator=gen, device=cuda).bfloat16()
    lens = torch.randint(1, smax + 1, (b,), generator=gen, device=cuda,
                         dtype=torch.int32)
    kw = dict(softmax_scale=d ** -0.5, causal=True)
    o, lse = flash_decode.decode_attn_ref_layout(q, kc, vc, lens, **kw)
    assert flash_decode.sm_count(cuda) > b * hk or \
        flash_decode.last_num_splits == 1
    o_ref, lse_ref = flash_decode.decode_attn_ref_layout_ref(
        q.float(), kc.float(), vc.float(), lens, **kw)
    o_pt, lse_pt = flash_decode.decode_attn_ref_layout_ref(q, kc, vc, lens,
                                                           **kw)
    check_close(o, o_ref, o_pt)
    check_close(lse, lse_ref, lse_pt)


@pytest.mark.parametrize("option,match", [("head_dim_288", "head dim"),
                                          ("qv", "qv"),
                                          ("float32_q", "q dtype")])
def test_decode_ref_layout_unsupported_raises_on_cuda(cuda, option, match):
    """Options the kernel does not take raise on a CUDA tensor instead of
    running the plain version: head dim 288 (above 256), qv (dv != d), a
    float32 q.  `flash_attn_with_kvcache` raises before it appends, so the
    caches are as they were and a retry appends once."""
    from flash_attn_tpu_torch.interface import flash_attn_with_kvcache

    d = 288 if option == "head_dim_288" else 64
    dtype = torch.float32 if option == "float32_q" else torch.bfloat16
    q = torch.randn(2, 1, 4, d, device=cuda).to(dtype)
    kc = torch.randn(2, 64, 2, d, device=cuda).to(dtype)
    vc = torch.randn(2, 64, 2, d, device=cuda).to(dtype)
    k = torch.randn(2, 1, 2, d, device=cuda).to(dtype)
    v = torch.randn(2, 1, 2, d, device=cuda).to(dtype)
    lens = torch.tensor([10, 40], dtype=torch.int32, device=cuda)
    kc0, vc0 = kc.clone(), vc.clone()
    qv = torch.randn_like(q) if option == "qv" else None
    before = flash_decode.launches
    if qv is None:
        with pytest.raises(NotImplementedError, match=match):
            flash_decode.decode_attn_ref_layout(q, kc, vc, lens,
                                                softmax_scale=0.1)
    with pytest.raises(NotImplementedError, match=match):
        flash_attn_with_kvcache(q, kc, vc, k=k, v=v, cache_seqlens=lens,
                                qv=qv)
    assert torch.equal(kc, kc0) and torch.equal(vc, vc0)
    assert flash_decode.launches == before


def _varlen_inputs(case, dtype, d, gen, dev):
    """Packed q, k, v, cu_seqlens, max lengths and keyword arguments of one
    varlen case: BERT-like non-causal, causal GQA with an empty q sequence
    and an empty k sequence (cross lengths), window + softcap + ALiBi."""
    lens_q, lens_k, h, hk = [150, 64, 1, 200], None, 4, 4
    kw = dict(softmax_scale=d ** -0.5, causal=case != "bert")
    if case == "gqa_cross_empty":
        lens_q, lens_k, h, hk = [130, 0, 70, 5], [200, 40, 0, 260], 8, 2
    if case == "window_softcap_alibi":
        kw.update(window_size=(40, 0), softcap=30.0,
                  alibi_slopes=torch.rand(h, generator=gen, device=dev))
    lens_k = lens_k or lens_q

    def stream(lens, heads):
        return torch.randn(sum(lens) + 3, heads, d, generator=gen,
                           device=dev).to(dtype)

    def cu(lens):
        return torch.tensor([0] + lens, device=dev).cumsum(0).int()

    q, k, v = stream(lens_q, h), stream(lens_k, hk), stream(lens_k, hk)
    return q, k, v, cu(lens_q), cu(lens_k), max(lens_q), max(lens_k), kw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 80, 100, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("case", ["bert", "gqa_cross_empty",
                                  "window_softcap_alibi"])
def test_varlen_kernels_match_plain(cuda, dtype, d, case):
    """The packed varlen forward and backward against their plain versions
    (fp32 oracle, low-precision yardstick); rows with no key and tokens past
    the last sequence are o = 0, lse = +inf; the backward is bitwise
    deterministic."""
    from flash_attn_tpu_torch.kernels import varlen

    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, cu_q, cu_k, mq, mk, kw = _varlen_inputs(case, dtype, d, gen,
                                                     cuda)
    args = (cu_q, cu_k, mq, mk)
    before = varlen.launches_fwd, varlen.launches_dq, varlen.launches_dkv
    o, lse = varlen.varlen_attn_fwd(q, k, v, *args, **kw)
    o_ref, lse_ref = varlen.varlen_attn_fwd_ref(q.float(), k.float(),
                                                v.float(), *args, **kw)
    o_pt, lse_pt = varlen.varlen_attn_fwd_ref(q, k, v, *args, **kw)
    check_close(o, o_ref, o_pt, label="o")
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    fin = torch.isfinite(lse_ref)
    check_close(lse[fin], lse_ref[fin], lse_pt[fin], label="lse")
    assert not o[-3:].any() and torch.isposinf(lse[:, -3:]).all()
    do = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    dq, dk, dv = varlen.varlen_attn_bwd(do, q, k, v, o, lse, *args, **kw)
    assert (varlen.launches_fwd, varlen.launches_dq, varlen.launches_dkv) \
        == (before[0] + 1, before[1] + 1, before[2] + 1)
    ref = varlen.varlen_attn_bwd_ref(do.float(), q.float(), k.float(),
                                     v.float(), o.float(), lse, *args, **kw)
    pt = varlen.varlen_attn_bwd_ref(do, q, k, v, o, lse, *args, **kw)
    for name, x, r, y in zip(("dq", "dk", "dv"), (dq, dk, dv), ref, pt):
        check_close(x, r, y, label=name)
    again = varlen.varlen_attn_bwd(do, q, k, v, o, lse, *args, **kw)
    for x, y in zip((dq, dk, dv), again):
        assert torch.equal(x, y)
    if case == "gqa_cross_empty":  # sequence 1 has no query, 2 no key
        assert not dk[200:240].any() and not dv[200:240].any()
        assert not dq[130:200].any()


_BWD_TILE_CASES = (
    [f"{sq}x{sk}_{'causal' if c else 'full'}"
     for sq, sk in ((1, 1), (63, 63), (127, 127), (129, 129), (1000, 1500))
     for c in (True, False)]
    + ["window_left", "seqused_k0", "gqa4", "dlse", "softcap_alibi",
       "two_items_causal", "two_items_full", "vit_197"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("case", _BWD_TILE_CASES)
def test_bwd_tiles_match_plain(cuda, case, d, dtype):
    """The dense backward's tiles (128-row dQ blocks, 128-key dK/dV blocks,
    64-row and 64-key stages; at d 192 and 256 64-row dQ blocks and 64-key
    dK/dV blocks) at lengths on and off their edges, causal and
    not, a one-sided window, seqused_k = 0 on one batch, GQA with g = 4, a
    dlse cotangent (folded into delta by the dQ kernel), the softcap +
    ALiBi instantiation, and a grid large enough for dQ blocks of two q
    tiles at d = 64 (`flash_bwd.dq_items`; 9 tiles a head, so one block
    owns one): dq (rows < seqused_q), dk and dv against the plain version
    (fp32 oracle, low-precision yardstick); a second call bitwise equal;
    keys past seqused_k give exactly 0."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    b, h, hk, sq, sk = 2, 4, 4, 300, 300
    kw = dict(softmax_scale=d ** -0.5, causal=True)
    if case.startswith("two_items"):
        b, h, hk, sq, sk = 8, 8, 8, 1100, 1100
        kw["causal"] = case.endswith("causal")
    elif case == "vit_197":  # ViT-B/16's 197 tokens: ragged at every edge
        b, h, hk, sq, sk = 4, 12, 12, 197, 197
        kw["causal"] = False
    elif "x" in case:
        size, mask = case.split("_")
        sq, sk = (int(n) for n in size.split("x"))
        kw["causal"] = mask == "causal"
    elif case == "window_left":
        kw.update(causal=False, window_size=(100, -1))
    elif case == "gqa4":
        h, hk = 8, 2
    elif case == "softcap_alibi":
        kw.update(softcap=30.0,
                  alibi_slopes=torch.rand(b, h, generator=gen, device=cuda))
    sku = [sk, 0] if case == "seqused_k0" else [sk] * b
    q = torch.randn(b, h, sq, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, hk, sk, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, hk, sk, d, generator=gen, device=cuda).to(dtype)
    do = torch.randn(b, h, sq, d, generator=gen, device=cuda).to(dtype)
    squ = torch.tensor([sq] * b, dtype=torch.int32, device=cuda)
    sku = torch.tensor(sku, dtype=torch.int32, device=cuda)
    o, lse = flash_fwd.flash_attn_fwd_bhsd(q, k, v, squ, sku, **kw)
    if case == "dlse":
        kw["dlse"] = torch.randn(b, h, sq, generator=gen, device=cuda)
    before = flash_bwd.launches_dq, flash_bwd.launches_dkv
    grads = flash_bwd.flash_attn_bwd_bhsd(do, q, k, v, o, lse, squ, sku, **kw)
    torch.cuda.synchronize()
    assert (flash_bwd.launches_dq, flash_bwd.launches_dkv) == (
        before[0] + 1, before[1] + 1)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert flash_bwd.last_dq_items == flash_bwd.dq_items(
        d, -(-sq // flash_bwd.dq_rows(d)), h, b, sms)
    if case.startswith("two_items") and d == 64:
        assert flash_bwd.last_dq_items == 2, f"{sms} SMs"
    ref = flash_bwd.flash_attn_bwd_bhsd_ref(
        do.float(), q.float(), k.float(), v.float(), o.float(), lse, squ, sku,
        **kw)
    pt = flash_bwd.flash_attn_bwd_bhsd_ref(do, q, k, v, o, lse, squ, sku, **kw)
    for name, x, r, y in zip(("dq", "dk", "dv"), grads, ref, pt):
        check_close(x, r, y, label=name)
    again = flash_bwd.flash_attn_bwd_bhsd(do, q, k, v, o, lse, squ, sku, **kw)
    for x, y in zip(grads, again):
        assert torch.equal(x, y)
    if case == "seqused_k0":
        assert not grads[0][1].any()
        assert not grads[1][1].any() and not grads[2][1].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("case", ["full", "causal", "gqa_causal",
                                  "two_items"])
def test_varlen_bwd_tiles_match_plain(cuda, case, d, dtype):
    """The packed varlen backward over sequences of 1-300 tokens, lengths
    on and off the tiles' edges, one with no query and one with no key, so
    that tiles run past their sequence into the next one's rows (with
    `two_items`, 64 seeded sequences of 0-300 tokens, enough for dQ blocks
    of two q tiles at d = 64): dq, dk, dv against the plain version; a
    second call bitwise equal; keys no query sees, rows with no key and
    tokens outside every sequence give 0."""
    from flash_attn_tpu_torch.kernels import varlen

    gen = torch.Generator(device=cuda).manual_seed(14)
    lens_q = [1, 300, 0, 77, 128, 129, 255, 64]
    lens_k = [1, 300, 50, 0, 128, 129, 200, 300]
    if case == "two_items":
        rng = np.random.default_rng(14)
        lens_q += rng.integers(0, 301, 56).tolist()
        lens_k += rng.integers(0, 301, 56).tolist()
    h, hk = (8, 2) if case in ("gqa_causal", "two_items") else (4, 4)
    kw = dict(softmax_scale=d ** -0.5, causal=case != "full")

    def stream(lens, heads):  # 3 rows past the last sequence
        return torch.randn(sum(lens) + 3, heads, d, generator=gen,
                           device=cuda).to(dtype)

    def cu(lens):
        return torch.tensor([0] + lens, device=cuda).cumsum(0).int()

    q, k, v = stream(lens_q, h), stream(lens_k, hk), stream(lens_k, hk)
    args = (cu(lens_q), cu(lens_k), max(lens_q), max(lens_k))
    o, lse = varlen.varlen_attn_fwd(q, k, v, *args, **kw)
    do = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    before = varlen.launches_dq, varlen.launches_dkv
    grads = varlen.varlen_attn_bwd(do, q, k, v, o, lse, *args, **kw)
    torch.cuda.synchronize()
    assert (varlen.launches_dq, varlen.launches_dkv) == (before[0] + 1,
                                                         before[1] + 1)
    if case == "two_items" and d == 64:
        assert flash_bwd.last_dq_items == 2
    ref = varlen.varlen_attn_bwd_ref(do.float(), q.float(), k.float(),
                                     v.float(), o.float(), lse, *args, **kw)
    pt = varlen.varlen_attn_bwd_ref(do, q, k, v, o, lse, *args, **kw)
    for name, x, r, y in zip(("dq", "dk", "dv"), grads, ref, pt):
        check_close(x, r, y, label=name)
    again = varlen.varlen_attn_bwd(do, q, k, v, o, lse, *args, **kw)
    for x, y in zip(grads, again):
        assert torch.equal(x, y)
    dq, dk, dv = grads
    kq, kk = sum(lens_q[:3]), sum(lens_k[:2])  # sequence 2: keys, no query
    assert not dk[kk:kk + 50].any() and not dv[kk:kk + 50].any()
    assert not dq[kq:kq + 77].any()  # sequence 3: no key
    assert not dq[-3:].any() and not dk[-3:].any() and not dv[-3:].any()


_FWD_TILE_CASES = (
    [f"{sq}x{sk}_{'causal' if c else 'full'}"
     for sq, sk in ((1, 1), (63, 63), (127, 127), (129, 129), (1000, 1500))
     for c in (True, False)]
    + ["sq_gt_sk_causal", "window_left", "window_0_0", "seqused_k0", "gqa4",
       "softcap_alibi", "heavy_grid", "vit_197"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", _FWD_TILE_CASES)
def test_fwd_tiles_match_plain(cuda, case, d, dtype):
    """The dense forward's tiles (64-row blocks at d = 64, 128-row at d =
    128, 128-key stages) at lengths on and off their edges, causal and not; sq > sk causal, where the first
    rows see no key; a one-sided window and window (0, 0); seqused_k = 0 on
    one batch; GQA with g = 4; the softcap + ALiBi instantiation; and a
    grid of many causal tiles, run heaviest first: o and lse against the
    plain version (fp32 oracle, low-precision yardstick), identical +inf
    lse rows, o = 0 exactly on rows with no key, a second call bitwise
    equal."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    b, h, hk, sq, sk = 2, 4, 4, 300, 300
    kw = dict(softmax_scale=d ** -0.5, causal=True)
    if case == "heavy_grid":
        b, h, hk, sq, sk = 8, 8, 8, 1100, 1100
    elif case == "vit_197":  # ViT-B/16's 197 tokens: ragged at every edge
        b, h, hk, sq, sk = 4, 12, 12, 197, 197
        kw["causal"] = False
    elif "x" in case:
        size, mask = case.split("_")
        sq, sk = (int(n) for n in size.split("x"))
        kw["causal"] = mask == "causal"
    elif case == "sq_gt_sk_causal":
        sq, sk = 300, 100
    elif case == "window_left":
        kw.update(causal=False, window_size=(100, -1))
    elif case == "window_0_0":
        kw.update(causal=False, window_size=(0, 0))
    elif case == "gqa4":
        h, hk = 8, 2
    elif case == "softcap_alibi":
        kw.update(softcap=30.0,
                  alibi_slopes=torch.rand(b, h, generator=gen, device=cuda))
    sku = [sk, 0] if case == "seqused_k0" else [sk] * b
    q = torch.randn(b, h, sq, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, hk, sk, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, hk, sk, d, generator=gen, device=cuda).to(dtype)
    squ = torch.tensor([sq] * b, dtype=torch.int32, device=cuda)
    sku = torch.tensor(sku, dtype=torch.int32, device=cuda)
    before = flash_fwd.launches
    o, lse = flash_fwd.flash_attn_fwd_bhsd(q, k, v, squ, sku, **kw)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    o_ref, lse_ref = flash_fwd.flash_attn_fwd_bhsd_ref(
        q.float(), k.float(), v.float(), squ, sku, **kw)
    o_pt, lse_pt = flash_fwd.flash_attn_fwd_bhsd_ref(q, k, v, squ, sku, **kw)
    check_close(o, o_ref, o_pt, label="o")
    empty = torch.isinf(lse_ref)
    assert torch.equal(torch.isinf(lse), empty)
    assert torch.isposinf(lse[empty]).all() and not o[empty].any()
    check_close(lse[~empty], lse_ref[~empty], lse_pt[~empty], label="lse")
    if case in ("sq_gt_sk_causal", "seqused_k0"):
        assert empty.any()
    again = flash_fwd.flash_attn_fwd_bhsd(q, k, v, squ, sku, **kw)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["full", "causal", "gqa_causal",
                                  "window_softcap_alibi"])
def test_varlen_fwd_tiles_match_plain(cuda, case, d, dtype):
    """The packed varlen forward at both row tiles (64 rows at d = 64, 128
    at d = 128: `flash_fwd.fwd_rows`), over sequences of 1-130 tokens
    around the 64- and 128-row edges, with an empty q sequence and an empty
    k sequence, so that tiles run past their sequence into the next one's
    rows: o and lse against the plain version on every token (fp32 oracle,
    low-precision yardstick), identical +inf lse rows, o = 0 exactly on rows
    with no key, the rows past the last sequence untouched (0, +inf), a
    second call bitwise equal."""
    from flash_attn_tpu_torch.kernels import varlen

    gen = torch.Generator(device=cuda).manual_seed(16)
    lens_q = [1, 63, 64, 65, 0, 127, 128, 129, 130, 77]
    lens_k = [1, 63, 64, 65, 40, 0, 128, 129, 130, 100]
    h, hk = (8, 2) if case == "gqa_causal" else (4, 4)
    kw = dict(softmax_scale=d ** -0.5, causal=case != "full")
    if case == "window_softcap_alibi":
        kw.update(window_size=(40, 0), softcap=30.0,
                  alibi_slopes=torch.rand(h, generator=gen, device=cuda))

    def stream(lens, heads):  # 3 rows past the last sequence
        return torch.randn(sum(lens) + 3, heads, d, generator=gen,
                           device=cuda).to(dtype)

    def cu(lens):
        return torch.tensor([0] + lens, device=cuda).cumsum(0).int()

    q, k, v = stream(lens_q, h), stream(lens_k, hk), stream(lens_k, hk)
    args = (cu(lens_q), cu(lens_k), max(lens_q), max(lens_k))
    before = varlen.launches_fwd
    o, lse = varlen.varlen_attn_fwd(q, k, v, *args, **kw)
    torch.cuda.synchronize()
    assert varlen.launches_fwd == before + 1
    o_ref, lse_ref = varlen.varlen_attn_fwd_ref(q.float(), k.float(),
                                                v.float(), *args, **kw)
    o_pt, lse_pt = varlen.varlen_attn_fwd_ref(q, k, v, *args, **kw)
    check_close(o, o_ref, o_pt, label="o")
    empty = torch.isinf(lse_ref)
    assert torch.equal(torch.isinf(lse), empty)
    assert torch.isposinf(lse[empty]).all()
    assert not o[empty.transpose(0, 1)].any()
    check_close(lse[~empty], lse_ref[~empty], lse_pt[~empty], label="lse")
    kq = sum(lens_q[:5])  # sequence 5: no key
    assert empty[:, kq:kq + 127].all()
    assert not o[-3:].any() and torch.isposinf(lse[:, -3:]).all()
    again = varlen.varlen_attn_fwd(q, k, v, *args, **kw)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


def test_varlen_func_gradient_on_cuda(cuda):
    """flash_attn_varlen_func's packed route on CUDA launches the varlen
    kernels and its gradient the varlen backward; float32 q and head dim 288
    (above 256) raise NotImplementedError."""
    from flash_attn_tpu_torch.interface import flash_attn_varlen_func
    from flash_attn_tpu_torch.kernels import varlen

    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, cu_q, cu_k, mq, mk, kw = _varlen_inputs(
        "gqa_cross_empty", torch.bfloat16, 64, gen, cuda)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = varlen.launches_fwd, varlen.launches_dq
    o = flash_attn_varlen_func(q, k, v, cu_q, cu_k, mq, mk, causal=True)
    o.float().sum().backward()
    assert (varlen.launches_fwd, varlen.launches_dq) == (before[0] + 1,
                                                         before[1] + 1)
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    wide = torch.zeros(*q.shape[:-1], 288, dtype=q.dtype, device=cuda)
    for bad in (q.detach().float(), wide):
        with pytest.raises(NotImplementedError):
            flash_attn_varlen_func(bad, bad, bad, cu_q, cu_q, mq, mq)


def test_bert_on_cuda_matches_cpu_plain_path(cuda):
    """BERT at a small size, unpadded and padded on CUDA in bf16, against
    float32 on the CPU: the varlen path launches only varlen kernels, one a
    layer, and the padded rows are exactly 0."""
    from flash_attn_tpu_torch.kernels import varlen
    from flash_attn_tpu_torch.models.bert import BertConfig, BertModel

    cfg = BertConfig(vocab_size=1000, hidden_size=256, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=1024)
    gpu = BertModel(cfg, device=cuda, dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(0))
    cpu = BertModel(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    lens = [200, 17, 64, 130]
    ids = torch.as_tensor(rng.integers(0, 1000, (4, 200)))
    mask = torch.arange(200)[None, :] < torch.tensor(lens)[:, None]
    with torch.no_grad():
        want, _ = cpu(ids, mask, unpad_varlen=True)
        before = varlen.launches_fwd, flash_fwd.launches
        got, _ = gpu(ids.to(cuda), mask.to(cuda), unpad_varlen=True)
        assert (varlen.launches_fwd - before[0],
                flash_fwd.launches - before[1]) == (2, 0)
        padded, _ = gpu(ids.to(cuda), mask.to(cuda))
    got, padded = got.float().cpu(), padded.float().cpu()
    assert not got[~mask].any()
    assert (got[mask] - want[mask]).abs().max() < 0.1
    assert (got[mask] - padded[mask]).abs().max() < 0.1


def _flex_inputs(case, dtype, d, gen, dev):
    """(q, k, v, block mask, bits, score mod, bias, sq) of one flex case."""
    from flash_attn_tpu_torch.kernels import flex

    b, h, hk, sq, sk, bq, bk = 2, 4, 2, 300, 300, 64, 64
    smod = bias = aux = None
    inv = False

    def mask(b_, h_, qi, ki):
        return qi >= ki

    if case == "doc_aux":
        bq, bk, hk = 128, 64, 4
        aux = (torch.rand(b, sk, generator=gen, device=dev) < 0.02).cumsum(
            1).int()

        def mask(b_, h_, qi, ki, qa, ka):
            return (qa == ka) & (qi >= ki)
    elif case == "softcap":
        smod = flex.softcap(30.0)
    elif case == "relpos_head_invariant":
        smod = flex.relative_position(0.02 * torch.arange(1, h + 1))
        inv = True
    elif case == "bias":
        bias = torch.randn(1, h, sq, sk, generator=gen, device=dev) * 0.5
    elif case == "ragged_empty":
        sq, sk, bk = 100, 250, 128

        def mask(b_, h_, qi, ki):
            return (qi >= 40) & (ki <= qi + 130)
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, sk, hk, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, sk, hk, d, generator=gen, device=dev).to(dtype)
    auxes = (aux, aux)
    bm = flex.create_block_mask(mask, b, h, sq, sk, block_q=bq, block_k=bk,
                                q_aux=aux, kv_aux=aux, head_invariant=inv,
                                device=dev)
    bits = flex.partial_block_bits(bm, mask, *auxes, sk)
    return q, k, v, bm, bits, smod, bias, auxes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["causal_gqa", "doc_aux", "softcap",
                                  "relpos_head_invariant", "bias",
                                  "ragged_empty"])
def test_flex_kernels_match_plain(cuda, dtype, d, case):
    """The flex forward, dQ and dK/dV kernels against their plain versions
    (fp32 oracle, low-precision yardstick), dbias included; empty rows give
    o = 0 and lse = +inf; the backward is bitwise deterministic."""
    from flash_attn_tpu_torch.kernels import flex

    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, bm, bits, smod, bias, aux = _flex_inputs(case, dtype, d, gen,
                                                      cuda)
    scale = d ** -0.5
    before = flex.launches_fwd, flex.launches_dq, flex.launches_dkv
    o, lse = flex.flex_attn_fwd(q, k, v, bm, bits, smod, scale, *aux, bias)
    f32 = [x.float() for x in (q, k, v)]
    o_ref, lse_ref = flex.flex_attn_fwd_ref(*f32, bm, bits, smod, scale,
                                            *aux, bias)
    o_pt, lse_pt = flex.flex_attn_fwd_ref(q, k, v, bm, bits, smod, scale,
                                          *aux, bias)
    check_close(o, o_ref, o_pt, label="o")
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    fin = torch.isfinite(lse_ref)
    check_close(lse[fin], lse_ref[fin], lse_pt[fin], label="lse")
    if case == "ragged_empty":
        assert not o[:, :40].any() and torch.isposinf(lse[..., :40]).all()
    do = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    grads = flex.flex_attn_bwd(do, q, k, v, o, lse, bm, bits, smod, scale,
                               *aux, bias)
    assert (flex.launches_fwd, flex.launches_dq, flex.launches_dkv) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    ref = flex.flex_attn_bwd_ref(do.float(), *f32, o.float(), lse, bm, bits,
                                 smod, scale, *aux, bias)
    pt = flex.flex_attn_bwd_ref(do, q, k, v, o, lse, bm, bits, smod, scale,
                                *aux, bias)
    for name, x, r, y in zip(("dq", "dk", "dv", "dbias"), grads, ref, pt):
        if x is not None:
            check_close(x, r, y, label=name)
    again = flex.flex_attn_bwd(do, q, k, v, o, lse, bm, bits, smod, scale,
                               *aux, bias)
    for x, y in zip(grads, again):
        assert x is None or torch.equal(x, y)


_TILE_CASES = {
    # case: (b, h, hk, sq, sk, block_q, block_k)
    "bq128_bk64": (2, 4, 2, 384, 384, 128, 64),
    "bq64": (2, 4, 2, 320, 320, 64, 64),
    "bq512_bk512": (1, 4, 4, 1100, 1100, 512, 512),
    "bq192": (2, 4, 2, 500, 500, 192, 192),
    "ragged_empty": (2, 4, 2, 1000, 1500, 128, 128),
    "packed_qkv": (2, 4, 4, 384, 384, 128, 128),
    "transposed_kv": (2, 4, 2, 384, 384, 64, 128),
    "gqa_head_invariant": (1, 8, 2, 640, 640, 128, 128),
}


def _flex_tile_inputs(case, dtype, d, mods, gen, dev, hole=False):
    """(q, k, v, block mask, bits, score mod, bias, aux) of one tile case: a
    causal mask (rows < 200 empty and keys <= row + 500 for
    `ragged_empty`, causal documents through aux for `gqa_head_invariant`);
    q, k, v strided views of one (b, s, 3, h, d) tensor for `packed_qkv`, k
    and v transposed (b, h, s, d) tensors for `transposed_kv`; with `mods`,
    softcap 20 and a (1, h, sq, sk) bias; with `hole`, keys 64-127 masked
    for every row (no query sees them)."""
    from flash_attn_tpu_torch.kernels import flex

    b, h, hk, sq, sk, bq, bk = _TILE_CASES[case]
    aux = None

    def mask(b_, h_, qi, ki):
        return qi >= ki

    if case == "ragged_empty":
        def mask(b_, h_, qi, ki):
            return (qi >= 200) & (ki <= qi + 500)
    elif case == "gqa_head_invariant":
        aux = (torch.rand(b, sk, generator=gen, device=dev) < 0.01).cumsum(
            1).int()

        def mask(b_, h_, qi, ki, qa, ka):
            return (qa == ka) & (qi >= ki)
    if hole:
        case_mask = mask

        def mask(*args):
            ki = args[3]
            return case_mask(*args) & ((ki < 64) | (ki >= 128))

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    if case == "packed_qkv":
        q, k, v = randn(b, sq, 3, h, d).unbind(2)
    elif case == "transposed_kv":
        q = randn(b, sq, h, d)
        k, v = (randn(b, hk, sk, d).transpose(1, 2) for _ in range(2))
    else:
        q, k, v = randn(b, sq, h, d), randn(b, sk, hk, d), randn(b, sk, hk, d)
    bm = flex.create_block_mask(mask, b, h, sq, sk, block_q=bq, block_k=bk,
                                q_aux=aux, kv_aux=aux,
                                head_invariant=case != "bq128_bk64",
                                device=dev)
    bits = flex.partial_block_bits(bm, mask, aux, aux, sk)
    smod = flex.softcap(20.0) if mods else None
    bias = (torch.randn(1, h, sq, sk, generator=gen, device=dev) * 0.5
            if mods else None)
    return q, k, v, bm, bits, smod, bias, aux


@pytest.mark.parametrize("mods", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", list(_TILE_CASES))
def test_flex_fwd_tiles_match_plain(cuda, case, d, dtype, mods):
    """Each tile instantiation of the forward (`flex.fwd_tile`: 128 or 64
    q rows, 128 or 64 keys), q, k, v read in place through their strides,
    ragged lengths and GQA against the plain version (fp32 oracle,
    low-precision yardstick); empty rows give o = 0 and lse = +inf; one
    launch a call."""
    from flash_attn_tpu_torch.kernels import flex

    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, bm, bits, smod, bias, aux = _flex_tile_inputs(case, dtype, d,
                                                           mods, gen, cuda)
    scale = d ** -0.5
    before = flex.launches_fwd
    o, lse = flex.flex_attn_fwd(q, k, v, bm, bits, smod, scale, aux, aux,
                                bias)
    torch.cuda.synchronize()
    assert flex.launches_fwd == before + 1
    f32 = [x.float() for x in (q, k, v)]
    o_ref, lse_ref = flex.flex_attn_fwd_ref(*f32, bm, bits, smod, scale, aux,
                                            aux, bias)
    o_pt, lse_pt = flex.flex_attn_fwd_ref(q, k, v, bm, bits, smod, scale, aux,
                                          aux, bias)
    check_close(o, o_ref, o_pt, label="o")
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    fin = torch.isfinite(lse_ref)
    check_close(lse[fin], lse_ref[fin], lse_pt[fin], label="lse")
    empty = torch.isposinf(lse_ref).transpose(1, 2)
    assert not o[empty].any()
    if case == "ragged_empty":
        assert empty[:, :200].all() and not empty[:, 200:].any()


@pytest.mark.parametrize("mods", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", list(_TILE_CASES))
def test_flex_bwd_tiles_match_plain(cuda, case, d, dtype, mods):
    """Each block instantiation of the backward (`flex.bwd_tile`: dQ 128 or
    64 q rows, dK/dV 128 or 64 keys), inputs read in place through their
    strides, ragged lengths and GQA: dq, dk, dv and dbias against the plain
    version (fp32 oracle, low-precision yardstick); one launch of each
    kernel a call; a second call bitwise equal; keys no query sees (64-127,
    a whole kv block at block_k 64, part of a partial one above) give
    exactly 0."""
    from flash_attn_tpu_torch.kernels import flex

    gen = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, bm, bits, smod, bias, aux = _flex_tile_inputs(
        case, dtype, d, mods, gen, cuda, hole=True)
    kw = (bm, bits, smod, d ** -0.5, aux, aux, bias)
    o, lse = flex.flex_attn_fwd(q, k, v, *kw)
    do = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    before = flex.launches_dq, flex.launches_dkv
    grads = flex.flex_attn_bwd(do, q, k, v, o, lse, *kw)
    torch.cuda.synchronize()
    assert (flex.launches_dq, flex.launches_dkv) == (before[0] + 1,
                                                     before[1] + 1)
    f32 = [x.float() for x in (do, q, k, v, o)]
    ref = flex.flex_attn_bwd_ref(*f32, lse, *kw)
    pt = flex.flex_attn_bwd_ref(do, q, k, v, o, lse, *kw)
    for name, x, r, y in zip(("dq", "dk", "dv", "dbias"), grads, ref, pt):
        if x is not None:
            check_close(x, r, y, label=name)
    again = flex.flex_attn_bwd(do, q, k, v, o, lse, *kw)
    for x, y in zip(grads, again):
        assert x is None or torch.equal(x, y)
    dk, dv = grads[1:3]
    assert not dk[:, 64:128].any() and not dv[:, 64:128].any()
    assert dk[:, :64].any() and dv[:, 128:].any()


@pytest.mark.parametrize("scale", [-0.1, 0.0])
def test_flex_fwd_nonpositive_scale_matches_plain(cuda, scale):
    """A softmax scale <= 0 (which the forward without a mod cannot fold
    into its exponent: it takes row maxima of raw scores) goes to the
    kernel compiled with mods, and still matches the plain version."""
    from flash_attn_tpu_torch.kernels import flex

    gen = torch.Generator(device=cuda).manual_seed(10)
    q, k, v, bm, bits = _flex_tile_inputs("bq128_bk64", torch.bfloat16, 64,
                                          False, gen, cuda)[:5]
    o, lse = flex.flex_attn_fwd(q, k, v, bm, bits, None, scale)
    f32 = [x.float() for x in (q, k, v)]
    o_ref, lse_ref = flex.flex_attn_fwd_ref(*f32, bm, bits, None, scale)
    o_pt, lse_pt = flex.flex_attn_fwd_ref(q, k, v, bm, bits, None, scale)
    check_close(o, o_ref, o_pt, label="o")
    check_close(lse, lse_ref, lse_pt, label="lse")


@pytest.mark.parametrize("option,match", [
    ("score_mod_callable", "descriptor"), ("block_96", "multiples of 64"),
    ("float32", "dtype"), ("head_dim_96", "head dim")])
def test_flex_unsupported_raises_on_cuda(cuda, option, match):
    """What the flex kernels do not take raises NotImplementedError on
    CUDA; nothing runs the plain version instead."""
    from flash_attn_tpu_torch.kernels import flex

    d = 96 if option == "head_dim_96" else 64
    dtype = torch.float32 if option == "float32" else torch.bfloat16
    q = torch.randn(1, 192, 2, d, device=cuda).to(dtype)
    kw = dict(mask_mod=lambda b, h, qi, ki: qi >= ki, block_q=64, block_k=64)
    if option == "score_mod_callable":
        kw["score_mod"] = lambda s, b, h, qi, ki: s * 0.5
    elif option == "block_96":
        kw["block_q"] = 96
    before = flex.launches_fwd
    with pytest.raises(NotImplementedError, match=match):
        flex.flex_attention(q, q, q, **kw)
    assert flex.launches_fwd == before


def test_flex_attention_gradient_on_cuda(cuda):
    """flex_attention and flash_attn_varlen_packed_func on CUDA launch the
    flex kernels, forward and backward, and agree with the CPU float32
    plain path."""
    from flash_attn_tpu_torch.kernels import flex, varlen_packed

    gen = torch.Generator().manual_seed(7)
    lens = [90, 0, 200, 33]
    total = sum(lens)
    cu = torch.tensor([0] + lens).cumsum(0).int()
    q, k, v, do = (torch.randn(total, h, 64, generator=gen)
                   for h in (4, 2, 2, 4))
    outs = []
    for dev, dtype in ((cuda, torch.bfloat16), ("cpu", torch.float32)):
        ins = [x.to(dev, dtype).requires_grad_() for x in (q, k, v)]
        before = flex.launches_fwd, flex.launches_dq
        o = varlen_packed.flash_attn_varlen_packed_func(
            *ins, cu.to(dev), cu.to(dev), 200, 200, causal=True,
            window_size=(64, 0), block_q=64, block_k=128)
        o.backward(do.to(dev, dtype))
        if dev == cuda:
            assert (flex.launches_fwd, flex.launches_dq) == (before[0] + 1,
                                                             before[1] + 1)
        outs.append([x.detach().float().cpu()
                     for x in (o, *(i.grad for i in ins))])
    for got, want in zip(*outs):
        assert (got - want).abs().max() < 0.05


# ---------------------------------------------------------------------------
# the diagnostic probes (`flash_attn_tpu_torch.diag`): each kernel against
# its plain twin on the card.  Sums are held to 1e-5 of their magnitude
# (summation order only), plus, for `pquant`, one bf16 rounding of a block
# sum (bf16) or one step of round(127 p) (int8), where exp2f and the twin's
# exp2 differ by an ulp at a rounding boundary, or P is quantised against
# another max; attention-like outputs by the 2x rule against the float64
# reference (the bisect's twin run in float64; the ladder's oracle).


def _sum_close(got, ref, extra=0.0):
    got, ref = got.double().cpu(), ref.double().cpu()
    tol = 1e-5 * ref.abs().max().item() + extra
    err = (got - ref).abs().max().item()
    assert err <= tol, f"sum err {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("stage", ["dma", "qk", "cast", "soft", "pquant",
                                   "full"])
def test_decode_ladder_matches_twin(cuda, stage, splits, d, int8):
    """Each rung against its 64-key twin (`max_every=64`, the kernel's own
    function: the running max moved once per tile) and its bk twin (JAX's);
    `full` by the 2x rule against the float64 oracle with either twin as
    the yardstick."""
    from flash_attn_tpu_torch.diag import int8_decode

    b, hk, smax, bk = 2, 3, 2048, 256
    q, kc, vc = int8_decode.make_inputs(int8, b, hk, smax, d, seed=1)
    before = int8_decode.launches
    got = int8_decode.decode_ladder(stage, q, kc, vc, bk=bk, splits=splits)
    assert int8_decode.launches == before + 1
    twins = [int8_decode.decode_ladder_ref(stage, q, kc, vc, bk=bk,
                                           splits=splits, max_every=every)
             for every in (64, bk)]
    assert got.shape == twins[0].shape == (b, 1, hk, 8, d)
    if stage != "full":
        assert not got[..., 1:].any()
        for ref in twins:
            extra = 0.0
            if stage == "pquant":
                extra = 1.0 if int8 else 2.0 ** -8 * ref.abs().max().item()
            _sum_close(got, ref, extra)
        return
    kf = kc.double().view(b, smax, hk, d).transpose(1, 2)
    vf = vc.double().view(b, smax, hk, d).transpose(1, 2)
    s = q.double() @ kf.transpose(-1, -2)
    if int8:
        s = s.float().double()
    s = s * float(torch.tensor(int8_decode.SCALE, dtype=torch.float32))
    oracle = torch.exp(s - s.amax(-1, keepdim=True)) @ vf
    if int8:
        oracle = oracle * int8_decode.SCALE
    for ref in twins:
        check_close(got, oracle[:, None].float(), ref)


def test_diag_kernels_do_not_spill(cuda, tmp_path):
    """ptxas's report of every instantiation of the two probe kernels
    redesigned on the decode body and on staged tables: no spills."""
    import re
    import subprocess

    from flash_attn_tpu_torch.kernels import _build

    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
         str(tmp_path / f"lib{name}.so"), str(_build.CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("diag_int8_decode", "diag_varlen_bisect")}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", out)
        assert spills, f"{name}: no ptxas report"
        assert all(a == "0" and b == "0" for a, b in spills), out


@pytest.mark.parametrize("fused,R,bundle,shuffled", [
    (fused, R, bundle, shuffled)
    for fused in (False, True) for R in (256, 512, 1024)
    for bundle in ((1, 2, 4) if not fused else (1, 2))
    for shuffled in (False, True)])
def test_dma_stream_matches_twin(cuda, fused, R, bundle, shuffled):
    from flash_attn_tpu_torch.diag import dma_stream

    gen = torch.Generator(device=cuda).manual_seed(2)
    n = 24
    shape = (n, 2, R, 1024) if fused else (n, R, 1024)
    arr = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    order = torch.randperm(n, generator=gen, device=cuda) if shuffled \
        else torch.arange(n, device=cuda)
    table = order[: n - 1].int().contiguous()  # a ragged tail
    before = dma_stream.launches
    got = dma_stream.dma_stream(arr, table, bundle=bundle, fused=fused)
    assert dma_stream.launches == before + 1
    _sum_close(got, dma_stream.dma_stream_ref(arr, table, bundle=bundle,
                                              fused=fused))


def test_dma_stream_repeat_is_bitwise(cuda):
    from flash_attn_tpu_torch.diag import dma_stream

    gen = torch.Generator(device=cuda).manual_seed(3)
    arr = torch.randn(64, 512, 1024, generator=gen, device=cuda).bfloat16()
    table = torch.randperm(64, generator=gen, device=cuda).int()
    runs = [dma_stream.dma_stream(arr, table, bundle=2, fused=False)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


_BISECT_SMALL = dict(H=4, BQ=128, BK=128, BH=2, TOTAL_P=512)


@pytest.mark.parametrize("variant,n_bodies,bh", [
    ("K3", 0, 2), ("K4", 0, 2), ("K5", 0, 2), ("K6", 0, 2), ("K7", 0, 2),
    ("K8", 0, 2), ("K9", 0, 2), ("K10", 1, 2), ("K10", 2, 4), ("K10", 3, 2),
    ("K10", 4, 4)])
def test_varlen_bisect_matches_twin(cuda, monkeypatch, variant, n_bodies,
                                    bh):
    """The bisect levels that write o, on live tables whose boundary ticks
    mask by nonzero aux (documents of 300 tokens)."""
    from flash_attn_tpu_torch.diag import varlen_overhead_bisect as vb

    for name, value in _BISECT_SMALL.items():
        monkeypatch.setattr(vb, name, value)
    kind = {"K9": "code", "K10": "k10"}.get(variant, "init")
    tables = [torch.tensor(x, dtype=torch.int32, device=cuda)
              for x in vb.live_tables(kind, n_bodies=max(n_bodies, 1))]
    qi, ki, fl, code = tables
    monkeypatch.setattr(vb, "T", len(fl))
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(4, 512, 128, generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    qa, ka = (x.to(cuda) for x in vb.make_aux(512, 128))
    lse_lanes = variant in ("K7", "K8")

    def run(fn_kernel, q, k, v):
        if variant in ("K3", "K4"):
            return fn_kernel[0](int(variant[1]), qi, ki, fl, q, k, v, qa, ka), None
        if variant == "K9":
            return fn_kernel[2](qi, ki, fl, code, q, k, v, qa, ka), None
        if variant == "K10":
            return fn_kernel[3](n_bodies, bh, qi, ki, fl, q, k, v), None
        res = fn_kernel[1](qi, ki, fl, q, k, v, qa, ka, cost=variant == "K5",
                           lse_lanes=lse_lanes,
                           four_variants=variant in ("K6", "K8"))
        return res[0], (res[1] if lse_lanes else None)

    kernel = (vb.launch, vb.launch2, vb.launch3, vb.launch4)
    twin = (vb.launch_ref, vb.launch2_ref, vb.launch3_ref, vb.launch4_ref)
    before = vb.launches
    o, lse = run(kernel, q, k, v)
    torch.cuda.synchronize()
    assert vb.launches == before + 1
    o_pt, lse_pt = run(twin, q, k, v)
    o_ref, lse_ref = run(twin, q.double(), k.double(), v.double())
    rows = vb.finalized_rows(qi.cpu(), fl.cpu()).to(cuda)
    assert rows.sum() == 256
    assert (o_ref[:, rows].abs().amax(-1) > 0).all()  # every row sees keys
    check_close(o[:, rows], o_ref[:, rows], o_pt[:, rows])
    if lse_lanes:
        check_close(lse[:, rows], lse_ref[:, rows], lse_pt[:, rows])


def test_varlen_bisect_empty_levels_launch(cuda):
    """Every level, and the one-CTA-per-tick K0, launches and finishes at
    the script's shapes on an all-empty table, whose ticks read one aux
    copy and run no body."""
    from flash_attn_tpu_torch.diag import varlen_overhead_bisect as vb

    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(vb.H, vb.TOTAL_P, vb.D, generator=gen,
                    device=cuda).bfloat16()
    qa = torch.zeros(vb.TOTAL_P, 8, dtype=torch.int32, device=cuda)
    ka = torch.zeros(vb.TOTAL_P // vb.BK, 8, vb.BK, dtype=torch.int32,
                     device=cuda)
    qi = torch.zeros(vb.T, dtype=torch.int32, device=cuda)
    fl = torch.full((vb.T,), 8, dtype=torch.int32, device=cuda)
    code = torch.full((vb.T,), 7, dtype=torch.int32, device=cuda)
    fl10 = torch.full((vb.T,), 8 | (15 << 4), dtype=torch.int32, device=cuda)
    before = vb.launches
    for level in range(5):
        vb.launch(level, qi, qi, fl, q, q, q, qa, ka)
    for kw in (dict(cost=True), dict(four_variants=True),
               dict(lse_lanes=True), dict(four_variants=True, lse_lanes=True)):
        vb.launch2(qi, qi, fl, q, q, q, qa, ka, **kw)
    vb.launch3(qi, qi, fl, code, q, q, q, qa, ka)
    for n_bodies, bh in ((2, 4), (4, 2)):
        vb.launch4(n_bodies, bh, qi, qi, fl10, q, q, q)
    vb.launch_empty_ctas(qi, qi, fl, q, q, q)
    torch.cuda.synchronize()
    assert vb.launches == before + 13


DROPOUT_P, DROPOUT_SEED = 0.1, 1234567


@pytest.mark.parametrize("layout", ["dense", "varlen"])
def test_dropout_kernels_keep_mask_is_dropout_keep(cuda, layout):
    """The kernels' own keep masks (the forward's through o, the dK/dV
    kernel's through dV; `utils.testing.dropout_probe_*`) equal the plain
    `dropout_keep` bit for bit, the varlen probe at packed coordinates
    past 2^15; the kept share is 1 - p within 0.005."""
    from flash_attn_tpu_torch.utils import testing

    if layout == "dense":
        fwd, dkv, want = testing.dropout_probe_dense(
            4, 12, 64, DROPOUT_P, DROPOUT_SEED, cuda)
    else:
        fwd, dkv, want = testing.dropout_probe_varlen(
            [20000, 20000], 12, 64, DROPOUT_P, DROPOUT_SEED, cuda)
    assert torch.equal(fwd, want)
    assert torch.equal(dkv, want)
    assert abs(want.float().mean().item() - (1 - DROPOUT_P)) < 0.005


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("case", ["causal_gqa", "window_softcap_alibi"])
def test_dropout_kernels_match_plain(cuda, dtype, d, case):
    """The dropout forward and (dq, dk, dv) against the plain version with
    the same keep mask; the dropout instantiations launched (and counted
    apart); the backward bitwise repeatable."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, sq, sk = 2, 200, 300
    h, hk = (8, 2) if case == "causal_gqa" else (4, 4)
    kw = dict(softmax_scale=d ** -0.5, causal=case == "causal_gqa",
              dropout_p=0.17, dropout_seed=-3)
    if case == "window_softcap_alibi":
        kw.update(window_size=(48, 8), softcap=30.0,
                  alibi_slopes=torch.rand(b, h, generator=gen, device=cuda))
    q = torch.randn(b, h, sq, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, hk, sk, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, hk, sk, d, generator=gen, device=cuda).to(dtype)
    do = torch.randn(b, h, sq, d, generator=gen, device=cuda).to(dtype)
    lq = torch.full((b,), sq, dtype=torch.int32, device=cuda)
    lk = torch.full((b,), sk, dtype=torch.int32, device=cuda)
    before = (flash_fwd.launches_dropout, flash_bwd.launches_dq_dropout,
              flash_bwd.launches_dkv_dropout)
    o, lse = flash_fwd.flash_attn_fwd_bhsd(q, k, v, lq, lk, **kw)
    grads = flash_bwd.flash_attn_bwd_bhsd(do, q, k, v, o, lse, lq, lk, **kw)
    assert (flash_fwd.launches_dropout, flash_bwd.launches_dq_dropout,
            flash_bwd.launches_dkv_dropout) == tuple(x + 1 for x in before)
    o_ref, lse_ref = flash_fwd.flash_attn_fwd_bhsd_ref(
        q.float(), k.float(), v.float(), lq, lk, **kw)
    o_pt, lse_pt = flash_fwd.flash_attn_fwd_bhsd_ref(q, k, v, lq, lk, **kw)
    check_close(o, o_ref, o_pt, label="o")
    check_close(lse, lse_ref, lse_pt, label="lse")
    ref = flash_bwd.flash_attn_bwd_bhsd_ref(
        do.float(), q.float(), k.float(), v.float(), o.float(), lse, lq, lk,
        **kw)
    pt = flash_bwd.flash_attn_bwd_bhsd_ref(do, q, k, v, o, lse, lq, lk, **kw)
    for name, x, r, y in zip(("dq", "dk", "dv"), grads, ref, pt):
        check_close(x, r, y, label=name)
    again = flash_bwd.flash_attn_bwd_bhsd(do, q, k, v, o, lse, lq, lk, **kw)
    for x, y in zip(grads, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_varlen_dropout_kernels_match_plain(cuda, d):
    """The packed varlen dropout kernels against their plain versions at
    packed-stream coordinates (causal GQA, cross lengths), the backward
    bitwise repeatable."""
    from flash_attn_tpu_torch.kernels import varlen

    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, cu_q, cu_k, mq, mk, kw = _varlen_inputs("gqa_cross_empty",
                                                     torch.bfloat16, d, gen,
                                                     cuda)
    kw.update(dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    args = (cu_q, cu_k, mq, mk)
    before = varlen.launches_fwd_dropout, varlen.launches_dq_dropout
    o, lse = varlen.varlen_attn_fwd(q, k, v, *args, **kw)
    o_ref, _ = varlen.varlen_attn_fwd_ref(q.float(), k.float(), v.float(),
                                          *args, **kw)
    o_pt, _ = varlen.varlen_attn_fwd_ref(q, k, v, *args, **kw)
    check_close(o, o_ref, o_pt, label="o")
    do = torch.randn(q.shape, generator=gen, device=cuda).bfloat16()
    grads = varlen.varlen_attn_bwd(do, q, k, v, o, lse, *args, **kw)
    assert (varlen.launches_fwd_dropout, varlen.launches_dq_dropout) == (
        before[0] + 1, before[1] + 1)
    ref = varlen.varlen_attn_bwd_ref(do.float(), q.float(), k.float(),
                                     v.float(), o.float(), lse, *args, **kw)
    pt = varlen.varlen_attn_bwd_ref(do, q, k, v, o, lse, *args, **kw)
    for name, x, r, y in zip(("dq", "dk", "dv"), grads, ref, pt):
        check_close(x, r, y, label=name)
    again = varlen.varlen_attn_bwd(do, q, k, v, o, lse, *args, **kw)
    for x, y in zip(grads, again):
        assert torch.equal(x, y)


def test_no_dropout_launches_the_kernels_without_dropout(cuda):
    """dropout_p = 0 (the default, and a deterministic model) launches the
    instantiations without dropout, counted in `launches` and not in
    `launches_dropout`; dropout_p > 0 the dropout ones."""
    from flash_attn_tpu_torch.interface import flash_attn_func

    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=gen, device=cuda)
               .bfloat16().requires_grad_() for _ in range(3))
    counts = lambda: (flash_fwd.launches, flash_fwd.launches_dropout,  # noqa
                      flash_bwd.launches_dq, flash_bwd.launches_dq_dropout)
    before = counts()
    flash_attn_func(q, k, v, causal=True).sum().backward()
    assert counts() == (before[0] + 1, before[1], before[2] + 1, before[3])
    flash_attn_func(q, k, v, dropout_p=0.0, causal=True).sum().backward()
    flash_attn_func(q, k, v, dropout_p=DROPOUT_P,
                    causal=True).sum().backward()
    assert counts() == (before[0] + 3, before[1] + 1, before[2] + 3,
                        before[3] + 1)
