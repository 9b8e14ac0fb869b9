"""The port's hand-written kernels on an NVIDIA GPU, each against its plain
PyTorch version on the same inputs. A CUDA kernel has no CPU mode, so every
test here carries the ``cuda`` marker and skips without a card. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Tolerances: K1 (paged attention, bf16 q and out, bf16 or int8 K/V, float32
inside) within one bf16 ulp + 1e-5 of the plain version run on float32
copies of the same inputs (an int8 pool dequantized in float32) — the
kernel rounds its float32 result once; K2 (fused residual + RMSNorm, bf16)
``y`` bit-equal and ``o`` within one bf16 ulp; K4 (int8 GEMM, float32
accumulation) within 1e-5 * (|x| @ |q * scale|) elementwise of the plain
version, the reach of float32 summation order, plus one bf16 ulp for bf16
output."""

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.models.transformer import (NULL_PAGE, PAD_POS, RESERVED_PAGES,
                                                      quantize_kv)
from seldon_core_tpu_torch.ops import fused_norm, int8_matmul, paged_attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA/Triton kernels have no CPU mode")
    return torch.device("cuda")


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _ref32(q, cache, bt, qpos):
    """The plain version on float32 copies of the bf16 inputs (an int8 pool
    dequantizes in q's dtype, float32 here)."""
    if len(cache) == 3:
        k, v, pos = cache
        cache = (k.float(), v.float(), pos)
    return paged_attention.paged_attention_ref(q.float(), cache, bt, qpos)


def _assert_within_ulp(out, ref32):
    ref = ref32.cpu().numpy()
    assert np.all(np.abs(out.float().cpu().numpy() - ref) <= _bf16_ulp(ref) + 1e-5)


def _int8_pool(cache):
    """A bf16 (k, v, pos) pool as the int8 write path stores it."""
    k, v, pos = cache
    return (*quantize_kv(k), *quantize_kv(v), pos)


@pytest.mark.parametrize("h,kvh,hd", [(8, 8, 128), (8, 2, 64), (4, 4, 32)])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_attention_kernel_matches_plain(dev, h, kvh, hd, kv):
    b, ps, n_pages = 4, 16, 5
    g = torch.Generator(device=dev).manual_seed(h + kvh + hd)
    pool = b * n_pages + RESERVED_PAGES
    k = torch.randn((pool, ps, kvh, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((pool, ps, kvh, hd), generator=g, device=dev).to(torch.bfloat16)
    k[:RESERVED_PAGES] = 0
    v[:RESERVED_PAGES] = 0
    pos = torch.full((pool, ps), PAD_POS, dtype=torch.int32, device=dev)
    bt = torch.full((b, n_pages), NULL_PAGE, dtype=torch.int32, device=dev)
    ctx = [70, 33, 1, 0]  # row 3 all NULL_PAGE
    perm = torch.randperm(pool - RESERVED_PAGES, generator=g, device=dev) + RESERVED_PAGES
    for i, n in enumerate(ctx):
        used = -(-n // ps)
        pages = perm[i * n_pages:i * n_pages + used]
        bt[i, :used] = pages.to(torch.int32)
        for j in range(used):
            m = min(ps, n - j * ps)
            pos[int(pages[j]), :m] = torch.arange(j * ps, j * ps + m, device=dev,
                                                  dtype=torch.int32)
    qpos = torch.tensor([[max(n - 1, 0)] for n in ctx], dtype=torch.int32, device=dev)
    q = torch.randn((b, 1, h, hd), generator=g, device=dev).to(torch.bfloat16)
    cache = (k, v, pos) if kv == "bf16" else _int8_pool((k, v, pos))
    counter = "launches" if kv == "bf16" else "launches_int8"
    before = getattr(paged_attention.paged_attention, counter)
    out = paged_attention.paged_attention(q, cache, bt, qpos)
    torch.cuda.synchronize()
    assert getattr(paged_attention.paged_attention, counter) == before + 1
    assert torch.isfinite(out.float()).all()  # the all-NULL row included
    _assert_within_ulp(out, _ref32(q, cache, bt, qpos))


def test_paged_attention_kernel_walks_to_the_query_page(dev):
    """The kernel's precondition, pinned: it walks a row's table only up to
    the query position's page. A page past it that holds EARLIER positions
    (which the batcher never builds: it resets a page's positions when it
    hands the page out) is attended by the plain version, not the kernel."""
    ps, hd, n_pages = 16, 64, 4
    g = torch.Generator(device=dev).manual_seed(5)
    k = torch.randn((RESERVED_PAGES + 3, ps, 2, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((RESERVED_PAGES + 3, ps, 2, hd), generator=g, device=dev).to(torch.bfloat16)
    pos = torch.full((RESERVED_PAGES + 3, ps), PAD_POS, dtype=torch.int32, device=dev)
    pos[2] = torch.arange(ps, device=dev, dtype=torch.int32)
    pos[3, :4] = torch.arange(ps, ps + 4, device=dev, dtype=torch.int32)
    pos[4] = torch.arange(ps, device=dev, dtype=torch.int32)   # stale: a previous owner's
    bt = torch.tensor([[2, 3, 4, NULL_PAGE]], dtype=torch.int32, device=dev)
    qpos = torch.tensor([[ps + 3]], dtype=torch.int32, device=dev)
    q = torch.randn((1, 1, 4, hd), generator=g, device=dev).to(torch.bfloat16)
    cache = (k, v, pos)
    out = paged_attention.paged_attention(q, cache, bt, qpos)
    _assert_within_ulp(out, _ref32(q, cache, bt[:, :2], qpos))
    full = _ref32(q, cache, bt, qpos)
    assert (out.float() - full).abs().max().item() > 1e-2


def test_paged_attention_kernel_rejects_what_it_does_not_take(dev):
    def case(hd, dtype=torch.bfloat16):
        q = torch.zeros((1, 1, 4, hd), dtype=dtype, device=dev)
        cache = (torch.zeros((3, 8, 4, hd), dtype=torch.bfloat16, device=dev),) * 2 + (
            torch.zeros((3, 8), dtype=torch.int32, device=dev),)
        bt = torch.full((1, 1), 2, dtype=torch.int32, device=dev)
        return q, cache, bt, torch.zeros((1, 1), dtype=torch.int32, device=dev)

    with pytest.raises(ValueError, match="head_dim"):
        paged_attention.paged_attention(*case(48))
    with pytest.raises(TypeError):
        paged_attention.paged_attention(*case(32, torch.float32))
    q, cache, bt, qpos = case(32)
    int8 = _int8_pool(cache)
    with pytest.raises(TypeError):  # int8 values with bf16 scales
        paged_attention.paged_attention(q, (int8[0], int8[1].bfloat16(), *int8[2:]), bt, qpos)
    with pytest.raises(ValueError):  # scales of the wrong shape
        paged_attention.paged_attention(q, (int8[0], int8[1][:, :4], *int8[2:]), bt, qpos)


@pytest.mark.parametrize("rows,d", [(8, 4096), (5, 200), (256, 4096)])
def test_fused_norm_kernel_matches_plain(dev, rows, d):
    g = torch.Generator(device=dev).manual_seed(rows + d)
    x = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
    h = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((d,), generator=g, device=dev)
    before = fused_norm.fused_residual_rmsnorm.launches
    y, o = fused_norm.fused_residual_rmsnorm(x, h, w, 1e-5)
    torch.cuda.synchronize()
    assert fused_norm.fused_residual_rmsnorm.launches == before + 1
    y_ref, o_ref = fused_norm.residual_rmsnorm_ref(x, h, w, 1e-5)
    assert torch.equal(y, y_ref)
    o_ref32 = o_ref.float().cpu().numpy()
    assert np.all(np.abs(o.float().cpu().numpy() - o_ref32) <= _bf16_ulp(o_ref32))


def test_batcher_on_card_runs_both_kernels(dev):
    """A small bf16 model (head_dim 32) through the paged batcher on the
    card: both kernels launch, every request returns its token budget, and
    every served token is the top logit of a teacher-forced forward over
    its prompt and the tokens before it, up to a bf16 near-tie (0.02, about
    a tenth of this model's logit spread of ~0.22)."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    kw = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256,
              max_seq_len=128, dtype="bfloat16", fused_norm=True)
    s = LLMServer(model="transformer", model_kwargs=kw, init_random=True, param_dtype="auto",
                  max_new_tokens=6, eos_id=-1, len_buckets=(16,), device="cuda")
    s.load()
    k1, k2 = paged_attention.paged_attention.launches, fused_norm.fused_residual_rmsnorm.launches
    b = ContinuousBatcher(s, max_slots=2, page_size=8, device="cuda")
    try:
        outs = [f.result(120) for f in [b.submit(p) for p in ("hi", "hello there", "a")]]
    finally:
        b.close()
    assert [len(o) for o in outs] == [6, 6, 6]
    for p, o in zip(("hi", "hello there", "a"), outs):
        ids = s._tokenizer.encode(p) + o
        with torch.no_grad():
            logits, _ = s._module(torch.tensor([ids], device=dev))
        rows = logits[0, len(ids) - len(o) - 1:len(ids) - 1].float()
        picked = rows.gather(1, torch.tensor(o, device=dev)[:, None])[:, 0]
        assert (rows.max(-1).values - picked).max().item() <= 0.02
    assert paged_attention.paged_attention.launches > k1
    assert fused_norm.fused_residual_rmsnorm.launches > k2
    assert b.page_stats()["kv_pages_in_use"] == 0


def _k4_case(dev, m, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    scale = (torch.rand((n,), generator=g, device=dev) + 0.5) / 127
    return x, q, scale


def _assert_k4_close(out, x, q, scale):
    """Within 1e-5 * (|x| @ |q * scale|) elementwise of the plain version
    (float32 summation order), plus one bf16 ulp for a bf16 output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = int8_matmul.int8_matmul_ref(x, q, scale, torch.float32)
    reach = x.float().abs() @ (q.float() * scale).abs()
    tol = 1e-5 * reach
    if out.dtype == torch.bfloat16:
        tol = tol + torch.from_numpy(_bf16_ulp(ref.cpu().numpy())).to(ref.device)
    err = (out.float() - ref).abs()
    assert torch.all(err <= tol), f"max err {err.max().item()} over tolerance"


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096),
                                   (37, 1000, 200), (256, 4096, 1000), (8, 40, 33),
                                   (3, 13, 17)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_kernel_matches_plain(dev, m, k, n, out_dtype):
    """Ragged M, N not a multiple of the 32-wide tile, K not a multiple of
    the 128-deep step, the scalar-load path (N % 16 or K % 8 not 0) and the
    split-K path (small grids) included."""
    x, q, scale = _k4_case(dev, m, k, n, m + k + n)
    before = int8_matmul.int8_matmul.launches
    out = int8_matmul.int8_matmul(x, q, scale, out_dtype)
    torch.cuda.synchronize()
    assert int8_matmul.int8_matmul.launches == before + 1
    assert out.dtype == out_dtype and out.shape == (m, n)
    _assert_k4_close(out, x, q, scale)


def test_int8_matmul_kernel_rejects_what_it_does_not_take(dev):
    x, q, scale = _k4_case(dev, 2, 32, 16, 0)
    with pytest.raises(TypeError):
        int8_matmul.int8_matmul(x.float(), q, scale)
    with pytest.raises(TypeError):
        int8_matmul.int8_matmul(x, q, scale, torch.float16)
    with pytest.raises(ValueError):
        int8_matmul.int8_matmul(x, q.t(), scale)


def test_tied_int8_head_raises_on_card(dev):
    from seldon_core_tpu_torch.models import get_model

    m = get_model("llama-tiny", device="cuda", dtype="bfloat16", param_dtype="auto")
    m.init_params(torch.Generator(device=dev).manual_seed(0))
    m.quantize_()
    with pytest.raises(NotImplementedError, match="tied"):
        m(torch.zeros((1, 2), dtype=torch.int64, device=dev))


def test_int8_batcher_on_card_runs_every_kernel(dev):
    """An untied small bf16 model with quantize='int8' and
    kv_cache_dtype='int8' through the paged batcher on the card: K1's int8
    branch, K2 and K4 launch, every request returns its budget, and every
    served token is the top logit, up to a near-tie, of a teacher-forced
    prefill through the same int8 numerics (an int8 dense cache)."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    kw = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256,
              max_seq_len=128, dtype="bfloat16", fused_norm=True)
    s = LLMServer(model="transformer", model_kwargs=kw, init_random=True, param_dtype="auto",
                  quantize="int8", kv_cache_dtype="int8", max_new_tokens=6, eos_id=-1,
                  len_buckets=(16,), device="cuda")
    s.load()
    k1 = paged_attention.paged_attention.launches_int8
    k2 = fused_norm.fused_residual_rmsnorm.launches
    k4 = int8_matmul.int8_matmul.launches
    prompts = ("hi", "hello there", "a")
    b = ContinuousBatcher(s, max_slots=2, page_size=8, device="cuda")
    try:
        outs = [f.result(120) for f in [b.submit(p) for p in prompts]]
    finally:
        b.close()
    assert [len(o) for o in outs] == [6, 6, 6]
    for p, o in zip(prompts, outs):
        ids = s._tokenizer.encode(p) + o
        with torch.no_grad():
            logits, _ = s._prefill(torch.tensor([ids], device=dev),
                                   torch.arange(len(ids), device=dev)[None], len(ids))
        rows = logits[0, len(ids) - len(o) - 1:len(ids) - 1].float()
        picked = rows.gather(1, torch.tensor(o, device=dev)[:, None])[:, 0]
        assert (rows.max(-1).values - picked).max().item() <= 0.02
    assert paged_attention.paged_attention.launches_int8 > k1
    assert fused_norm.fused_residual_rmsnorm.launches > k2
    assert int8_matmul.int8_matmul.launches > k4
    assert b.page_stats()["kv_pages_in_use"] == 0
