"""The port's hand-written kernels on an NVIDIA GPU, each against its plain
PyTorch version on the same inputs. A CUDA kernel has no CPU mode, so every
test here carries the ``cuda`` marker and skips without a card. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Tolerances: K1 (paged attention, bf16 in and out, float32 inside) within
one bf16 ulp + 1e-5 of the plain version run on float32 copies of the same
inputs — the kernel rounds its float32 result once; K2 (fused residual +
RMSNorm, bf16) ``y`` bit-equal and ``o`` within one bf16 ulp."""

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.models.transformer import NULL_PAGE, PAD_POS, RESERVED_PAGES
from seldon_core_tpu_torch.ops import fused_norm, paged_attention

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
    """The plain version on float32 copies of the bf16 inputs."""
    k, v, pos = cache
    return paged_attention.paged_attention_ref(q.float(), (k.float(), v.float(), pos), bt, qpos)


def _assert_within_ulp(out, ref32):
    ref = ref32.cpu().numpy()
    assert np.all(np.abs(out.float().cpu().numpy() - ref) <= _bf16_ulp(ref) + 1e-5)


@pytest.mark.parametrize("h,kvh,hd", [(8, 8, 128), (8, 2, 64), (4, 4, 32)])
def test_paged_attention_kernel_matches_plain(dev, h, kvh, hd):
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
    cache = (k, v, pos)
    before = paged_attention.paged_attention.launches
    out = paged_attention.paged_attention(q, cache, bt, qpos)
    torch.cuda.synchronize()
    assert paged_attention.paged_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
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
