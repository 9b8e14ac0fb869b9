"""The port's hand-written kernels on an NVIDIA GPU, each against its plain
PyTorch version on the same inputs. A CUDA kernel has no CPU mode, so every
test here carries the ``cuda`` marker and skips without a card. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Tolerances: K1 (paged attention, bf16 q and out, bf16 or int8 K/V, float32
inside) within one bf16 ulp + 1e-5 of the plain version run on float32
copies of the same inputs (an int8 pool dequantized in float32) — the
kernel rounds its float32 result once; its partial mode's float32 state,
merged over the 'seq' ranks and rounded once to bf16, within the same; K2 (fused residual + RMSNorm, bf16,
f16 or float32) ``y`` bit-equal and ``o`` within one ulp of its dtype
(float32: 1e-6 + 1e-6 * |o|), and under autograd its explicit backward
within 1e-5 * max|g| (float32) or two bf16 ulps of max|g| (bf16) of
autograd through the plain version; K4 (int8 GEMM, float32
accumulation; its decode and its prefill kernel alike, split K included)
within 1e-5 * (|x| @ |q * scale|) elementwise of the plain version, the
reach of float32 summation order, plus one bf16 ulp for bf16 output; K3
(folded-BN identity bottleneck chain, bf16 hand-offs, float32 sums) within
n_blocks bf16 ulps of max|plain| elementwise — the plain version sums the
same bf16 products in float32 in another order, so a hand-off may round to
the neighbouring bf16, once per block."""

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.models.transformer import (NULL_PAGE, PAD_POS, RESERVED_PAGES,
                                                      TRASH_PAGE, quantize_kv)
from seldon_core_tpu_torch.ops import fused_norm, fused_resnet, int8_matmul, paged_attention
from seldon_core_tpu_torch.ops._build import sm_count

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
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


def _k1_case(dev, b, h, kvh, hd, ps, n_pages, ctx, kv, seed):
    """A pool with shuffled pages, each row's positions written up to its
    context (0 = an all-NULL_PAGE row), NULL tails in the tables, query
    positions at the last written position."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = b * n_pages + RESERVED_PAGES
    k = torch.randn((pool, ps, kvh, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((pool, ps, kvh, hd), generator=g, device=dev).to(torch.bfloat16)
    k[:RESERVED_PAGES] = 0
    v[:RESERVED_PAGES] = 0
    pos = torch.full((pool, ps), PAD_POS, dtype=torch.int32, device=dev)
    bt = torch.full((b, n_pages), NULL_PAGE, dtype=torch.int32, device=dev)
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
    return q, cache, bt, qpos


@pytest.mark.parametrize("h,kvh,hd", [(8, 8, 128), (8, 2, 128), (16, 2, 128), (8, 2, 64),
                                      (16, 2, 64), (4, 4, 32), (16, 2, 32), (12, 4, 64),
                                      (24, 2, 32)])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_attention_kernel_every_split(dev, h, kvh, hd, kv):
    """The kernel at every forced S, 1 .. the chunks of the table (10 here:
    5 pages of 32 keys, chunks of 16), against the plain version: G = 1, 4,
    8 (and 3, 12: a head tile with idle heads, two head tiles), hd 32, 64,
    128, a context that is not a multiple of the chunk, one of 1 key, a
    full table, and an all-NULL row (every split empty or fully masked).
    Each call is one launch and leaves the arrival counters at zero."""
    b, ps, n_pages = 5, 32, 5
    q, cache, bt, qpos = _k1_case(dev, b, h, kvh, hd, ps, n_pages, [70, 1, 0, 160, 33], kv,
                                  seed=h + kvh + hd)
    ref32 = _ref32(q, cache, bt, qpos)
    counter = "launches" if kv == "bf16" else "launches_int8"
    n_chunks = n_pages * ps // paged_attention._chunk_keys(ps)
    assert n_chunks == 10
    for splits in range(1, n_chunks + 1):
        before = getattr(paged_attention.paged_attention, counter)
        out = paged_attention.paged_attention(q, cache, bt, qpos, _splits=splits)
        torch.cuda.synchronize()
        assert getattr(paged_attention.paged_attention, counter) == before + 1
        assert torch.isfinite(out.float()).all(), f"S={splits}"
        _assert_within_ulp(out, ref32)
    for buf in paged_attention._counters.values():
        assert not buf.any()
    with pytest.raises(ValueError, match="_splits"):
        paged_attention.paged_attention(q, cache, bt, qpos, _splits=n_chunks + 1)


def _node_list(g):
    """(node handle, cuGraphNodeGetType: 0 is a kernel) of every node of
    ``g``, a torch.cuda.CUDAGraph captured with keep_graph=True."""
    import ctypes

    libcuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert libcuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    assert libcuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    out = []
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        assert libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0
        out.append((node, t.value))
    return out


def _kernel_names(g):
    """The function name (mangled) of every kernel node of ``g`` (as
    ``_node_list``), from cuGraphKernelNodeGetParams and cuFuncGetName, or
    cuKernelGetName where the node holds a library kernel."""
    import ctypes

    libcuda = ctypes.CDLL("libcuda.so.1")

    class Params(ctypes.Structure):   # CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)
        _fields_ = ([("func", ctypes.c_void_p)]
                    + [(f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz", "smem")]
                    + [(f, ctypes.c_void_p) for f in ("params", "extra", "kern", "ctx")])

    names = []
    for node, kind in _node_list(g):
        if kind != 0:
            continue
        p = Params()
        assert libcuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                     ctypes.byref(p)) == 0
        name = ctypes.c_char_p()
        if p.func:
            assert libcuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)) == 0
        else:
            assert libcuda.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)) == 0
        names.append(name.value.decode())
    return names


def _graph_nodes(fn):
    """The types of the nodes of a CUDA graph of one call of ``fn``
    (``_node_list``): every operation the call puts on its stream. A
    warm-up call on the capture stream keeps lazy set-up out of the graph.
    Returns (node types, the output of one replay)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=stream):
        out = fn()
    types = [kind for _, kind in _node_list(g)]
    g.replay()
    torch.cuda.synchronize()
    return types, out.clone()


def test_paged_attention_kernel_is_one_launch_and_counters_grow(dev):
    """One call is one kernel on its stream (the nodes of a CUDA graph of
    the call), split or not, and the graph's replay agrees with the plain
    version; the counter buffer is zero after a call, and a larger b * kvh
    makes a new, larger zeroed buffer."""
    q, cache, bt, qpos = _k1_case(dev, 2, 4, 4, 128, 64, 4, [200, 90], "bf16", seed=1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for splits in (1, 3):
        paged_attention.paged_attention(q, cache, bt, qpos, _splits=splits)
        torch.cuda.synchronize()
        before = paged_attention.paged_attention.launches
        nodes, out = _graph_nodes(
            lambda: paged_attention.paged_attention(q, cache, bt, qpos, _splits=splits))
        assert nodes == [0], nodes
        assert paged_attention.paged_attention.launches == before + 2
        _assert_within_ulp(out, _ref32(q, cache, bt, qpos))
    small = paged_attention._counters[(q.device.index, stream)]
    assert small.numel() >= 2 * 4 and not small.any()
    q, cache, bt, qpos = _k1_case(dev, 2 * small.numel(), 4, 4, 64, 16, 2,
                                  [20] * (2 * small.numel()), "int8", seed=2)
    out = paged_attention.paged_attention(q, cache, bt, qpos, _splits=2)
    torch.cuda.synchronize()
    grown = paged_attention._counters[(q.device.index, stream)]
    assert grown is not small and grown.numel() >= q.shape[0] * 4 and not grown.any()
    _assert_within_ulp(out, _ref32(q, cache, bt, qpos))


def test_paged_attention_kernel_rejects_unaligned_pool(dev):
    """A pool view whose base is not 16-byte aligned raises (rows are read
    as 16-byte vectors)."""
    q, (k, v, pos), bt, qpos = _k1_case(dev, 1, 4, 4, 32, 8, 2, [10], "bf16", seed=3)
    flat = torch.empty(k.numel() + 4, dtype=torch.bfloat16, device=dev)
    shifted = flat[4:].view(k.shape)   # contiguous, 8 bytes off
    shifted.copy_(k)
    with pytest.raises(ValueError, match="16-byte"):
        paged_attention.paged_attention(q, (shifted, v, pos), bt, qpos)


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


def _k2_inputs(dev, rows, d, x_dtype, w_dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, d), generator=g, device=dev).to(x_dtype)
    h = torch.randn((rows, d), generator=g, device=dev).to(x_dtype)
    w = (1.0 + 0.5 * torch.randn((d,), generator=g, device=dev)).to(w_dtype)
    return x, h, w


def _assert_k2_close(y, o, x, h, w):
    """``y`` bit-equal to the plain version; ``o`` within one ulp of the
    model dtype for bf16 and f16, and within 1e-6 + 1e-6 * |o| for float32
    (rsqrtf is within 2 float32 ulps, and the mean's order moves o by ~2)."""
    y_ref, o_ref = fused_norm.residual_rmsnorm_ref(x, h, w, 1e-5)
    assert y.dtype == o.dtype == x.dtype and y.shape == o.shape == x.shape
    assert torch.equal(y, y_ref)
    ref = o_ref.float()
    err = (o.float() - ref).abs()
    if x.dtype == torch.float32:
        tol = 1e-6 + 1e-6 * ref.abs()
    else:
        mant = 7 if x.dtype == torch.bfloat16 else 10
        tiny = torch.finfo(x.dtype).tiny
        tol = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(tiny))) - mant)
    assert torch.isfinite(o.float()).all() and torch.all(err <= tol), \
        f"max err {err.max().item()} over tolerance"


@pytest.mark.parametrize("rows", [1, 5, 8, 17, 128, 256])
@pytest.mark.parametrize("d", [4096, 5120, 8192, 200, 130, 32768])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_fused_norm_kernel_matches_plain(dev, rows, d, x_dtype, w_dtype):
    """At the plan's pick: 16-byte loads where d fills whole vectors, the
    scalar instantiation where it does not (d = 200 of float32, 130), and a
    row wider than one CTA holds walked in chunks (d = 32768; 8192 of
    float32 fits one)."""
    x, h, w = _k2_inputs(dev, rows, d, x_dtype, w_dtype, rows + d)
    before = fused_norm.fused_residual_rmsnorm.launches
    y, o = fused_norm.fused_residual_rmsnorm(x, h, w, 1e-5)
    torch.cuda.synchronize()
    assert fused_norm.fused_residual_rmsnorm.launches == before + 1
    _assert_k2_close(y, o, x, h, w)


K2_PLANS = [(32, 1), (64, 4), (128, 2), (256, 1), (256, 2), (512, 1), (512, 4)]


@pytest.mark.parametrize("rows,d", [(1, 4096), (8, 4096), (17, 5120), (128, 4096),
                                    (256, 4096), (5, 200), (3, 130)])
@pytest.mark.parametrize("plan", K2_PLANS)
def test_fused_norm_kernel_every_plan(dev, rows, d, plan):
    """Every (threads, slots) the kernel takes, bf16 and float32
    activations: rows in one chunk and in many (32 threads x 1 slot at
    d = 4096 is 16 chunks), slots and warps past the row's end."""
    for x_dtype in (torch.bfloat16, torch.float32):
        x, h, w = _k2_inputs(dev, rows, d, x_dtype, torch.bfloat16, rows + d + plan[0])
        out = torch.empty((2, rows, d), dtype=x_dtype, device=dev)
        fused_norm._kernel(x, h, w, out[0], out[1], 1e-5, plan)
        torch.cuda.synchronize()
        _assert_k2_close(out[0], out[1], x, h, w)


@pytest.mark.parametrize("d,offset", [(130, 130), (4096, 1), (4096, 0)])
def test_fused_norm_kernel_misaligned_views(dev, d, offset):
    """A contiguous view whose base is not 16-byte aligned (``x[1:]`` of a
    ragged d; a flat offset of one element) takes the scalar path of the
    same kernel, in one chunk and in several."""
    for plan in (None, (32, 1)):
        x, h, w = _k2_inputs(dev, 9, d, torch.bfloat16, torch.float32, d)
        x, h = _offset(x, offset), _offset(h, offset)
        out = torch.empty((2, 9, d), dtype=x.dtype, device=dev)
        fused_norm._kernel(x, h, w, out[0], out[1], 1e-5, plan)
        torch.cuda.synchronize()
        _assert_k2_close(out[0], out[1], x, h, w)
    base = _k2_inputs(dev, 9, 130, torch.bfloat16, torch.float32, 1)
    x, h = base[0][1:], base[1][1:]
    y, o = fused_norm.fused_residual_rmsnorm(x, h, base[2], 1e-5)
    torch.cuda.synchronize()
    _assert_k2_close(y, o, x, h, base[2])


@pytest.mark.parametrize("rows", [1, 8, 128, 256])
def test_fused_norm_is_one_launch_and_bit_stable(dev, rows):
    """At the served width: one call puts one kernel and nothing else on its
    stream (the nodes of a CUDA graph of the call), the graph's replay
    equals the eager call bit for bit, and two calls give the same bits
    (a fixed order of sums, no atomics)."""
    x, h, w = _k2_inputs(dev, rows, 4096, torch.bfloat16, torch.bfloat16, rows)
    y1, o1 = fused_norm.fused_residual_rmsnorm(x, h, w, 1e-5)
    y2, o2 = fused_norm.fused_residual_rmsnorm(x, h, w, 1e-5)
    torch.cuda.synchronize()
    _assert_k2_close(y1, o1, x, h, w)
    assert torch.equal(y1, y2) and torch.equal(o1, o2)
    nodes, replay = _graph_nodes(lambda: fused_norm.fused_residual_rmsnorm(x, h, w, 1e-5)[0]._base)
    assert nodes == [0], nodes
    assert torch.equal(replay[0], y1) and torch.equal(replay[1], o1)


def test_launch_enqueues_on_the_current_stream(dev):
    """``_build.launch`` takes the stream from PyTorch's C bindings: under
    ``torch.cuda.stream`` the kernel runs on that side stream (ordered
    after work queued there, before an event recorded there), and under
    ``torch.cuda.graph`` on the capture stream (it is captured, and the
    replay writes the graph's output)."""
    x, h, w = _k2_inputs(dev, 8, 4096, torch.bfloat16, torch.bfloat16, 3)
    y_ref, o_ref = fused_norm.residual_rmsnorm_ref(x, h, w, 1e-5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    out = torch.empty((2, 8, 4096), dtype=x.dtype, device=dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)   # a late kernel on the side stream
        hs = h.clone()                  # h written on the side stream, behind it
        fused_norm._kernel(x, hs, w, out[0], out[1], 1e-5)
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    _assert_k2_close(out[0], out[1], x, h, w)
    captured = torch.zeros((2, 8, 4096), dtype=x.dtype, device=dev)
    g = torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(g, stream=side):
        fused_norm._kernel(x, h, w, captured[0], captured[1], 1e-5)
    torch.cuda.synchronize()
    assert not captured.any()           # captured, not run
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured[0], y_ref)
    _assert_k2_close(captured[0], captured[1], x, h, w)


def test_fused_norm_rejects_what_it_does_not_take(dev):
    x = torch.zeros((2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fused_norm.fused_residual_rmsnorm(x, x.float(), torch.ones(64, device=dev), 1e-5)
    with pytest.raises(TypeError):
        fused_norm.fused_residual_rmsnorm(x.to(torch.int32), x.to(torch.int32),
                                          torch.ones(64, device=dev), 1e-5)
    with pytest.raises(ValueError):
        fused_norm.fused_residual_rmsnorm(x.t().contiguous().t(), x, torch.ones(64, device=dev),
                                          1e-5)
    with pytest.raises(ValueError):
        fused_norm.fused_residual_rmsnorm(x, x, torch.ones(64), 1e-5)


@pytest.mark.parametrize("rows,d", [(8, 4096), (300, 4096), (17, 200)])
@pytest.mark.parametrize("x_dtype,w_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.float32)])
def test_fused_norm_function_grads_equal_plain_autograd(dev, rows, d, x_dtype, w_dtype):
    """K2 under autograd: the forward is one launch of the kernel (``y``
    bit-equal to the plain version, ``o`` within its ulp) carrying a
    ``grad_fn``; the explicit float32 backward equals autograd through the
    plain version on the same tensors: float32 within 1e-5 * max|g|, bf16
    within two bf16 ulps of max|g| (autograd rounds the norm's cotangent to
    bf16 before it adds the residual's; the formula adds in float32)."""
    x, h, w = _k2_inputs(dev, rows, d, x_dtype, w_dtype, seed=rows + d)
    g = torch.Generator(device=dev).manual_seed(7)
    d_y = torch.randn((rows, d), generator=g, device=dev).to(x_dtype)
    d_o = torch.randn((rows, d), generator=g, device=dev).to(x_dtype)
    leaves = [t.clone().requires_grad_() for t in (x, h, w)]
    before = fused_norm.fused_residual_rmsnorm.launches
    y, o = fused_norm.fused_residual_rmsnorm(*leaves, 1e-5)
    assert fused_norm.fused_residual_rmsnorm.launches == before + 1
    assert y.grad_fn is not None and o.grad_fn is not None
    _assert_k2_close(y.detach(), o.detach(), x, h, w)
    got = torch.autograd.grad((y, o), leaves, (d_y, d_o))
    ref_leaves = [t.clone().requires_grad_() for t in (x, h, w)]
    want = torch.autograd.grad(fused_norm.residual_rmsnorm_ref(*ref_leaves, 1e-5), ref_leaves,
                               (d_y, d_o))
    for a, b, t in zip(got, want, (x, h, w)):
        assert a.dtype == t.dtype and torch.isfinite(a.float()).all()
        scale = b.float().abs().max().item()
        tol = 1e-5 * scale if x_dtype == torch.float32 else 2 * 2.0 ** -8 * scale
        assert (a.float() - b.float()).abs().max().item() <= tol


def test_two_trainable_blocks_get_every_gradient_on_card(dev):
    """A float32 two-layer model with ``fused_norm=True`` trains through K2
    on the card: one launch a layer in the forward, every parameter's
    gradient finite and non-zero, and within 1e-4 * max|g| + 1e-6 of the
    same step with the plain add + RMSNorm (``fused_norm=False``, the same
    weights)."""
    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.parallel import train

    kw = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512,
              max_seq_len=128, dtype="float32")
    fused = get_model("transformer", device=dev, fused_norm=True, **kw)
    fused.init_params(torch.Generator(device=dev).manual_seed(0))
    plain = get_model("transformer", device=dev, **kw)
    plain.load_state_dict(fused.state_dict())
    tokens = torch.randint(0, 256, (2, 64), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    grads = []
    for model in (fused, plain):
        model.requires_grad_(True)
        before = fused_norm.fused_residual_rmsnorm.launches
        loss = train.next_token_loss(model, tokens)
        grads.append(dict(zip([n for n, _ in model.named_parameters()],
                              torch.autograd.grad(loss, list(model.parameters())))))
        launched = fused_norm.fused_residual_rmsnorm.launches - before
        assert launched == (kw["n_layers"] if model is fused else 0)
    for name, g in grads[0].items():
        ref = grads[1][name]
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        assert (g - ref).abs().max() <= 1e-4 * ref.abs().max() + 1e-6, name


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
                                   (3, 13, 17), (64, 4096, 4096), (128, 4096, 11008),
                                   (128, 11008, 4096), (256, 4096, 32000), (200, 4104, 1040),
                                   (300, 4096, 1000)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_kernel_matches_plain(dev, m, k, n, out_dtype):
    """Ragged M, N not a multiple of the decode kernel's strip, K not a
    multiple of its stage, the scalar-load path (N % 16 or K % 8 not 0) and
    split K (a cluster of CTAs) included. M >= 64 with K % 8 == 0 and
    N % 16 == 0 takes the prefill kernel (TMA + wgmma: its counter moves
    too), ragged M, N and K included; the rest the decode kernel."""
    x, q, scale = _k4_case(dev, m, k, n, m + k + n)
    before = int8_matmul.int8_matmul.launches
    before_wgmma = int8_matmul.int8_matmul.launches_wgmma
    out = int8_matmul.int8_matmul(x, q, scale, out_dtype)
    torch.cuda.synchronize()
    assert int8_matmul.int8_matmul.launches == before + 1
    prefill = m >= 64 and k % 8 == 0 and n % 16 == 0
    assert int8_matmul.int8_matmul.launches_wgmma == before_wgmma + prefill
    assert out.dtype == out_dtype and out.shape == (m, n)
    _assert_k4_close(out, x, q, scale)


@pytest.mark.parametrize("m", [8, 32, 128, 256])
@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096), (4096, 1024)])
def test_int8_matmul_moe_shapes_match_plain(dev, m, k, n):
    """K4 at the products of a Mixtral-8x7B-wide model (an expert's w1 /
    w3 and w2, GQA's wk / wv), its weight an expert's [K, N] view of a
    contiguous [e, K, N] buffer as ``MoEFFN`` passes it, against the plain
    version within K4's tolerance."""
    x, q, scale = _k4_case(dev, m, k, n, m + k + n)
    experts = torch.stack([torch.zeros_like(q), q])
    out = int8_matmul.int8_matmul(x, experts[1], scale)
    torch.cuda.synchronize()
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    _assert_k4_close(out, x, q, scale)


def _offset(t, elems):
    """A contiguous copy of ``t`` whose base sits ``elems`` elements past an
    allocation's (16-byte aligned) start."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = buf[elems:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("m", [1, 8, 16, 17, 63])
@pytest.mark.parametrize("bn,splits", [(bn, s) for bn in int8_matmul.DEC_WIDTHS
                                       for s in range(1, int8_matmul.DEC_MAX_SPLITS + 1)])
def test_int8_matmul_decode_kernel_every_plan(dev, m, bn, splits):
    """The decode kernel at every strip width and cluster size that
    ``_decode_plan`` can return, at one and two 16-row tiles, both output
    dtypes: 16-byte copies (K = 7080, N = 1040: ragged strip and stage),
    masked scalar loads (K % 8 and N % 16 not 0), and unaligned bases. K
    has 56 stages of 128 rows and 111 of 64, which every split count from
    1 to 8 cuts without an empty split."""
    for k, n, x_off, q_off in ((7080, 1040, 0, 0), (7084, 1001, 0, 0), (7080, 1040, 1, 4)):
        x, q, scale = _k4_case(dev, m, k, n, m + bn + splits)
        x, q = _offset(x, x_off), _offset(q, q_off)
        steps = -(-k // (int8_matmul.DEC_STAGE_BYTES // bn))
        per = -(-steps // splits)
        assert -(-steps // per) == splits
        for out_dtype in (torch.bfloat16, torch.float32):
            out = int8_matmul._decode_kernel(x, q, scale,
                                             torch.empty((m, n), dtype=out_dtype, device=dev),
                                             (bn, splits, per))
            torch.cuda.synchronize()
            _assert_k4_close(out, x, q, scale)


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)])
def test_int8_matmul_decode_is_one_launch_and_bit_stable(dev, k, n):
    """At each decode shape of the int8 7B model (8 serving slots; the
    lm_head writes float32): one call puts one kernel and nothing else on
    its stream (the nodes of a CUDA graph of the call), the graph's replay
    equals the eager call bit for bit, and two calls give the same bits
    (the splits merge in rank order, no atomics)."""
    out_dtype = torch.float32 if n == 32000 else torch.bfloat16
    x, q, scale = _k4_case(dev, 8, k, n, k + n)
    first = int8_matmul.int8_matmul(x, q, scale, out_dtype)
    second = int8_matmul.int8_matmul(x, q, scale, out_dtype)
    torch.cuda.synchronize()
    _assert_k4_close(first, x, q, scale)
    assert torch.equal(first, second)
    nodes, replay = _graph_nodes(lambda: int8_matmul.int8_matmul(x, q, scale, out_dtype))
    assert nodes == [0], nodes
    assert torch.equal(replay, first)


@pytest.mark.parametrize("bn,splits", [(128, 1), (128, 3), (256, 1), (256, 3)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_prefill_kernel_tiles_and_splits(dev, bn, splits, out_dtype):
    """The prefill kernel at each tile width, in one split and in several,
    whichever the wrapper would pick: M, N and K off every tile."""
    m, k, n = 272, 4104, 1040
    x, q, scale = _k4_case(dev, m, k, n, bn + splits)
    per = -(-(-(-k // int8_matmul.WG_BK)) // splits)
    out = int8_matmul._wgmma_kernel(x, q, scale, torch.empty((m, n), dtype=out_dtype, device=dev),
                                    (bn, splits, per))
    torch.cuda.synchronize()
    _assert_k4_close(out, x, q, scale)


@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("splits", [1, 3])
def test_int8_matmul_prefill_kernel_in_a_cuda_graph(dev, m, splits):
    """K4's prefill route inside a CUDA graph, at the served chunk lengths
    (M = 128, 256) and the 7B model's [4096, 11008] product, in one split
    and in several: the graph holds the kernel, plus the split-K reduce
    when it splits (its float32 partial comes from the graph's pool), and
    its replay equals the eager call bit for bit. The wrapper's own plan
    takes the same route in a graph."""
    k, n = 4096, 11008
    x, q, scale = _k4_case(dev, m, k, n, m + splits)
    per = -(-(-(-k // int8_matmul.WG_BK)) // splits)
    plan = (int8_matmul.WG_BNS[0], splits, per)

    def call():
        out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        return int8_matmul._wgmma_kernel(x, q, scale, out, plan)

    eager = call()
    torch.cuda.synchronize()
    _assert_k4_close(eager, x, q, scale)
    nodes, replay = _graph_nodes(call)
    assert nodes == [0] * (1 + (splits > 1)), nodes
    assert torch.equal(replay, eager)
    wrapped = int8_matmul.int8_matmul(x, q, scale)
    before = int8_matmul.int8_matmul.launches_wgmma
    nodes, replay = _graph_nodes(lambda: int8_matmul.int8_matmul(x, q, scale))
    assert int8_matmul.int8_matmul.launches_wgmma == before + 2   # warm-up and capture
    wplan = int8_matmul._wgmma_plan(m, n, k, sm_count(dev.index))
    assert nodes == [0] * (1 + (wplan[1] > 1)), (nodes, wplan)
    assert torch.equal(replay, wrapped)


def test_int8_matmul_kernel_rejects_what_it_does_not_take(dev):
    x, q, scale = _k4_case(dev, 2, 32, 16, 0)
    with pytest.raises(TypeError):
        int8_matmul.int8_matmul(x.float(), q, scale)
    with pytest.raises(TypeError):
        int8_matmul.int8_matmul(x, q, scale, torch.float16)
    with pytest.raises(ValueError):
        int8_matmul.int8_matmul(x, q.t(), scale)


@pytest.mark.parametrize("cfg", ["llama-tiny", "7b-wide"])
def test_tied_int8_head_through_k4_on_card(dev, cfg):
    """A tied head over int8 embeddings serves on the card through K4 (the
    transposed int8 copy ``prepare_head_`` makes, the K scale folded into
    the activations as a bf16 head and remainder), within K4's tolerance of
    the plain ``x.float() @ dequantize(emb).float().t()``; at llama-tiny and
    at a tied model of Llama-2-7B's width and vocabulary."""
    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.models.transformer import tied_int8_logits_ref

    kw = (dict(vocab_size=32000, dim=4096, n_layers=1, n_heads=32, n_kv_heads=32,
               ffn_dim=256, tie_embeddings=True, dtype="bfloat16") if cfg == "7b-wide"
          else dict(dtype="bfloat16"))
    name = "transformer" if cfg == "7b-wide" else "llama-tiny"
    m = get_model(name, device="meta", **kw).quantize_().to_empty(device=dev)
    m.init_params(torch.Generator(device=dev).manual_seed(0))
    with pytest.raises(RuntimeError, match="prepare_head_"):
        m._logits(torch.zeros((1, 1, m.cfg.dim), dtype=m.cfg.dtype, device=dev))
    m.prepare_head_()
    emb = m.tok_embeddings
    before = int8_matmul.int8_matmul.launches
    for rows in (1, 8, 130):
        x = torch.randn((rows, 1, m.cfg.dim), generator=torch.Generator(device=dev).manual_seed(
            rows), device=dev).to(torch.bfloat16)
        got = m._logits(x)
        torch.cuda.synchronize()
        want = tied_int8_logits_ref(x, emb)
        tol = 1e-5 * (x.float().abs() @ (emb.q.float() * emb.scale).abs().t())
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert ((got - want).abs() <= tol).all(), (got - want).abs().max().item()
    assert int8_matmul.int8_matmul.launches == before + 3
    tokens = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    assert torch.isfinite(m(tokens)[0]).all()


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
            logits, _ = s._prefill_fresh(torch.tensor([ids], device=dev),
                                         torch.arange(len(ids), device=dev)[None], len(ids))
        rows = logits[0, len(ids) - len(o) - 1:len(ids) - 1].float()
        picked = rows.gather(1, torch.tensor(o, device=dev)[:, None])[:, 0]
        assert (rows.max(-1).values - picked).max().item() <= 0.02
    assert paged_attention.paged_attention.launches_int8 > k1
    assert fused_norm.fused_residual_rmsnorm.launches > k2
    assert int8_matmul.int8_matmul.launches > k4
    assert b.page_stats()["kv_pages_in_use"] == 0


SMALL_LLM = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256,
                 max_seq_len=128, dtype="bfloat16", fused_norm=True)
INT8_KNOBS = {"bf16": {}, "int8": dict(quantize="int8", kv_cache_dtype="int8")}


def _graph_batcher(dev, kv, **kw):
    """A small GQA model (head_dim 32, 2 kv heads: K1 splits each pair over
    several CTAs) and a 3-slot paged batcher on the card with K = 4, built
    (its decode graphs captured) under ``set_sync_debug_mode("error")``:
    any host sync in the warm-up or the capture raises."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    s = LLMServer(model="transformer", model_kwargs=kw.pop("model_kwargs", SMALL_LLM),
                  init_random=True, param_dtype="auto", max_new_tokens=12, eos_id=-1,
                  len_buckets=(16,), temperature=kw.pop("temperature", 0.0), device="cuda",
                  **INT8_KNOBS[kv])
    s.load()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = ContinuousBatcher(s, max_slots=3, page_size=8, fuse_steps=4, device="cuda", **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return s, b


def _admit(b, prompts):
    """Admit ``prompts`` into the batcher's slots on this thread (its loop
    never starts), prefill them, and grow each slot's pages 16 positions
    ahead: live tables and state for direct steps."""
    from concurrent.futures import Future

    from seldon_core_tpu_torch.runtime.scheduler import PendingRequest

    for p in prompts:
        assert b._admit_begin(PendingRequest(ids=list(p), max_new=12, fut=Future()))
        while b._prefill is not None:
            b._prefill_step()
    for i, slot in enumerate(b._slots):
        if slot.active:
            assert b._ensure_slot_pages(i, slot.dispatched_pos() + 16)


def _state_copy(b):
    return ([tuple(t.clone() for t in layer) for layer in b._caches], b._last_tok.clone(),
            b._next_pos.clone(), b._keys.clone())


def _assert_state_equal(b, copy):
    pools, last_tok, next_pos, keys = copy
    assert torch.equal(b._last_tok, last_tok) and torch.equal(b._next_pos, next_pos)
    assert torch.equal(b._keys, keys)
    for la, lb in zip(b._caches, pools):
        for x, y in zip(la, lb):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_graph_replay_bit_equals_eager(dev, kv):
    """From identical copies of pools and state (two live slots, one free
    slot riding along on the TRASH page), one replay of each captured
    program (K = 1 and K = 4) and one eager call of the same program give
    bit-equal tokens, pools and state; K1's arrival counters read zero
    after every replay; each replay adds to the launch counters exactly
    what its capture counted (per step: one K1 and one K2 a layer, and in
    the int8 model one K4 decode launch a product)."""
    from seldon_core_tpu_torch.ops.paged_attention import _counters
    from seldon_core_tpu_torch.servers.step_graph import launch_counts

    s, b = _graph_batcher(dev, kv, temperature=0.7)
    assert sorted(b._graphs) == [1, 4]
    # made by the warm-up, outside the capture
    assert (torch.cuda.current_device(), s._graph_stream().cuda_stream) in _counters
    _admit(b, ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60], [7, 7, 1]))
    n_layers = SMALL_LLM["n_layers"]
    for k in (1, 4, 1):
        copy = _state_copy(b)
        before = launch_counts()
        toks = b._graphs[k].replay().clone()
        after = launch_counts()
        eager = s._get_decode_step_paged(b.S, b.n_pages, k)(*copy, b._temp, b._block_tables)
        torch.cuda.synchronize()
        assert torch.equal(toks, eager) and toks.shape == (3, k)
        _assert_state_equal(b, copy)
        for buf in _counters.values():
            assert not buf.any()
        delta = {key: n - before[key] for key, n in after.items() if n != before[key]}
        assert delta == dict(b._graphs[k].counts)
        k1 = paged_attention.paged_attention
        assert delta[(k1, "launches_int8" if kv == "int8" else "launches")] == n_layers * k
        assert delta[(fused_norm.fused_residual_rmsnorm, "launches")] == n_layers * k
        k4 = delta.get((int8_matmul.int8_matmul, "launches"), 0)
        assert k4 == ((7 * n_layers + 1) * k if kv == "int8" else 0)


SMALL_MOE = dict(SMALL_LLM, n_experts=4, n_experts_per_token=2)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_moe_decode_graph_replay_bit_equals_eager(dev, kv):
    """The MoE model's decode step (4 experts, top 2; int8: the experts'
    products one K4 launch each) captured as CUDA graphs of K = 1 and 4
    under ``set_sync_debug_mode("error")``: each replay bit-equal to the
    eager program from identical copies of pools and state, and adding to
    the counters what its capture counted."""
    from seldon_core_tpu_torch.servers.step_graph import launch_counts

    s, b = _graph_batcher(dev, kv, model_kwargs=SMALL_MOE)
    assert sorted(b._graphs) == [1, 4]
    _admit(b, ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60], [7, 7, 1]))
    n_layers, e = SMALL_MOE["n_layers"], SMALL_MOE["n_experts"]
    for k in (1, 4):
        copy = _state_copy(b)
        before = launch_counts()
        toks = b._graphs[k].replay().clone()
        after = launch_counts()
        eager = s._get_decode_step_paged(b.S, b.n_pages, k)(*copy, b._temp, b._block_tables)
        torch.cuda.synchronize()
        assert torch.equal(toks, eager) and toks.shape == (3, k)
        _assert_state_equal(b, copy)
        delta = {key: n - before[key] for key, n in after.items() if n != before[key]}
        assert delta == dict(b._graphs[k].counts)
        k4 = delta.get((int8_matmul.int8_matmul, "launches"), 0)
        assert k4 == ((n_layers * (4 + 3 * e) + 1) * k if kv == "int8" else 0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_moe_decode_step_has_no_host_sync(dev, kv):
    """The eager MoE decode step (routing, the experts, the combine) run
    under ``set_sync_debug_mode("error")`` on live state: no host sync."""
    s, b = _graph_batcher(dev, kv, model_kwargs=SMALL_MOE)
    _admit(b, ([5, 9, 17, 2, 40, 3], [11, 60, 2]))
    prog = s._get_decode_step_paged(b.S, b.n_pages, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = prog(b._caches, b._last_tok, b._next_pos, b._keys, b._temp, b._block_tables)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert toks.shape == (3, 1)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_graph_replay_reads_new_block_table(dev, kv):
    """A block-table write between replays (slot 0's row pointed at slot
    1's pages, in place) is what the next replay reads: it equals the eager
    program on the new table, and differs from the eager program on the old
    one."""
    s, b = _graph_batcher(dev, kv)
    _admit(b, ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60], [7, 7, 1]))
    prog = s._get_decode_step_paged(b.S, b.n_pages, 4)
    old_table = b._block_tables.clone()
    b._block_tables[0].copy_(b._block_tables[1])
    new_copy, old_copy = _state_copy(b), _state_copy(b)
    toks = b._graphs[4].replay().clone()
    on_new = prog(*new_copy, b._temp, b._block_tables)
    on_old = prog(*old_copy, b._temp, old_table)
    torch.cuda.synchronize()
    assert torch.equal(toks, on_new)
    _assert_state_equal(b, new_copy)
    assert not all(torch.equal(x, y) for la, lb in zip(new_copy[0], old_copy[0])
                   for x, y in zip(la, lb))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_batcher_through_graphs_equals_eager_batcher(dev, kv):
    """The same requests served through the graphs (K = 4, depth 2) and
    through the eager programs (the private ``_eager`` switch): the same
    tokens, since every program has fixed shapes (slots x one token) and
    the kernels give the same bits for the same inputs."""
    s, b = _graph_batcher(dev, kv, pipeline_depth=2)
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher

    prompts = ("hi", "hello there", "a", "four requests on three slots")
    outs = {}
    for name, batcher in (("graph", b), ("eager", ContinuousBatcher(
            s, max_slots=3, page_size=8, fuse_steps=4, pipeline_depth=2, device="cuda",
            _eager=True))):
        assert bool(batcher._graphs) == (name == "graph")
        try:
            outs[name] = [f.result(120) for f in [batcher.submit(p) for p in prompts]]
        finally:
            batcher.close()
        assert batcher.page_stats()["kv_pages_in_use"] == 0
    assert [len(o) for o in outs["graph"]] == [12] * 4
    assert outs["graph"] == outs["eager"]
    assert max(s._decode_host_lag) > 4


def _spec_batcher(dev, kv, mode, **kw):
    """The small model and a 3-slot paged spec batcher (K = 4) on the card,
    built (its spec graph captured) under ``set_sync_debug_mode("error")``;
    in draft mode the draft is configured like the target (a copy)."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    draft = dict(draft_model="transformer", draft_model_kwargs=SMALL_LLM) if mode == "draft" \
        else {}
    s = LLMServer(model="transformer", model_kwargs=SMALL_LLM, init_random=True,
                  param_dtype="auto", max_new_tokens=12, eos_id=-1, len_buckets=(16,),
                  temperature=kw.pop("temperature", 0.0), spec_mode=mode, spec_k=4,
                  device="cuda", **draft, **INT8_KNOBS[kv])
    s.load()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = ContinuousBatcher(s, max_slots=3, page_size=8, device="cuda", **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return s, b


def _spec_copy(b):
    draft = None if b._draft_caches is None else [tuple(t.clone() for t in layer)
                                                  for layer in b._draft_caches]
    return (*_state_copy(b), b._hist.clone(), draft)


@pytest.mark.parametrize("mode,kv", [("ngram", "bf16"), ("ngram", "int8"), ("draft", "bf16")])
def test_spec_graph_replay_bit_equals_eager(dev, mode, kv):
    """Three live slots: from identical copies of the pools, slot state,
    history and draft caches, one replay of the captured spec step and one
    eager call of the same program, at three sets of caps written into the
    fixed cap buffer, give bit-equal tokens and advance, state, history,
    draft caches and pools (every page but TRASH, where the columns past a
    cap land in no set order); each replay adds exactly what its capture
    counted: per verify one K1 launch a layer (the K+1 columns folded into
    rows), one K2 a layer (and one a layer of each of the K+1 draft
    forwards), and in the int8 model one K4 decode launch a product (M =
    15 rows). No decode graph is captured in spec mode."""
    from seldon_core_tpu_torch.models.transformer import TRASH_PAGE
    from seldon_core_tpu_torch.servers.step_graph import launch_counts

    s, b = _spec_batcher(dev, kv, mode)
    assert b._spec_graph is not None and not b._graphs
    _admit(b, ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60], [7, 7, 1, 7, 7, 1], [3, 3, 3, 3]))
    assert all(slot.active for slot in b._slots)
    n_layers = SMALL_LLM["n_layers"]
    prog = s._get_spec_step(b.S, 4, b.hist_len, mode=mode, n_pages=b.n_pages)
    for caps in ((4, 4, 4), (1, 0, 3), (4, 2, 4)):
        b._draft_cap.copy_(torch.tensor(caps, dtype=torch.int32))
        copy = _spec_copy(b)
        before = launch_counts()
        out = b._spec_graph.replay().clone()
        after = launch_counts()
        eager = prog(*copy[:4], b._temp, b._block_tables, copy[4], b._draft_cap, copy[5])
        torch.cuda.synchronize()
        assert out.shape == (3, 6) and torch.equal(out, eager)
        adv = out[:, 5].cpu()
        assert bool((adv >= 1).all()) and bool((adv <= torch.tensor(caps) + 1).all())
        assert torch.equal(b._last_tok, copy[1]) and torch.equal(b._next_pos, copy[2])
        assert torch.equal(b._keys, copy[3]) and torch.equal(b._hist, copy[4])
        for la, lb in zip(b._caches, copy[0]):
            for x, y in zip(la, lb):
                keep = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
                keep[TRASH_PAGE] = False
                assert torch.equal(x[keep], y[keep])
        if mode == "draft":
            for la, lb in zip(b._draft_caches, copy[5]):
                for x, y in zip(la, lb):
                    assert torch.equal(x, y)
        delta = {key: n - before[key] for key, n in after.items() if n != before[key]}
        assert delta == dict(b._spec_graph.counts)
        k1 = paged_attention.paged_attention
        assert delta[(k1, "launches_int8" if kv == "int8" else "launches")] == n_layers
        drafts = 5 * n_layers if mode == "draft" else 0
        assert delta[(fused_norm.fused_residual_rmsnorm, "launches")] == n_layers + drafts
        k4 = delta.get((int8_matmul.int8_matmul, "launches"), 0)
        assert k4 == (7 * n_layers + 1 if kv == "int8" else 0)


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_spec_batcher_through_graph_equals_eager_batcher(dev, mode):
    """The same requests through the spec graph and through the eager spec
    program (the private ``_eager`` switch): the same tokens; every verify
    dispatch of the graph batcher is a replay."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher

    s, b = _spec_batcher(dev, "bf16", mode, pipeline_depth=2)
    prompts = ("hi", "hello there", "a", "four requests on three slots")
    outs = {}
    for name, batcher in (("graph", b), ("eager", ContinuousBatcher(
            s, max_slots=3, page_size=8, pipeline_depth=2, device="cuda", _eager=True))):
        s._decode_replays = s._decode_eager = 0
        try:
            outs[name] = [f.result(120) for f in [batcher.submit(p) for p in prompts]]
        finally:
            batcher.close()
        assert batcher.page_stats()["kv_pages_in_use"] == 0
        replays, eager = s._decode_replays, s._decode_eager
        assert (replays > 0 and eager == 0) if name == "graph" else (replays == 0 and eager > 0)
    assert [len(o) for o in outs["graph"]] == [12] * 4
    assert outs["graph"] == outs["eager"]


def _dense_admit(b, prompts):
    """One-shot admissions into a dense batcher's slots on this thread (its
    loop never starts): live slot rows and state for direct steps."""
    from concurrent.futures import Future

    from seldon_core_tpu_torch.runtime.scheduler import PendingRequest

    for p in prompts:
        assert b._admit(PendingRequest(ids=list(p), max_new=12, fut=Future()))


def _slot_pool_copy(b):
    """Copies of a dense batcher's slot pool (a ``SlotCaches``), slot
    state, history and draft caches."""
    from seldon_core_tpu_torch.models.transformer import SlotCaches

    pools = SlotCaches([tuple(t.clone() for t in layer) for layer in b._caches], b.max_len)
    draft = None if b._draft_caches is None else [tuple(t.clone() for t in layer)
                                                  for layer in b._draft_caches]
    hist = None if b._hist is None else b._hist.clone()
    return pools, b._last_tok.clone(), b._next_pos.clone(), b._keys.clone(), hist, draft


def _assert_dense_equal(b, copy):
    """Slot state, history, draft caches and every slot row but the trash
    column (where dropped writes land in no set order) equal ``copy``."""
    pools, last_tok, next_pos, keys, hist, draft = copy
    assert torch.equal(b._last_tok, last_tok) and torch.equal(b._next_pos, next_pos)
    assert torch.equal(b._keys, keys)
    assert hist is None or torch.equal(b._hist, hist)
    for la, lb in zip(b._caches, pools):
        for x, y in zip(la, lb):
            assert torch.equal(x[:, :-1], y[:, :-1])
    for la, lb in zip(b._draft_caches or (), draft or ()):
        for x, y in zip(la, lb):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_dense_decode_graph_replay_bit_equals_eager(dev, kv):
    """The dense layout's decode step (``_get_decode_step``) captured at K
    = 1 and 4 under ``set_sync_debug_mode("error")``: from identical copies
    of the slot pool and state (two live slots, one free slot stepping on
    in its own row), one replay and one eager call give bit-equal tokens,
    state and every slot row but the trash column; each replay adds what
    its capture counted: one K2 a layer a step, in the int8 model one K4
    decode launch a product, no K1 (the dense read is the masked einsum)."""
    from seldon_core_tpu_torch.servers.step_graph import launch_counts

    s, b = _graph_batcher(dev, kv, temperature=0.7, layout="dense")
    assert sorted(b._graphs) == [1, 4] and not b._prefill_graphs and b._block_tables is None
    _dense_admit(b, ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60], [7, 7, 1]))
    n_layers = SMALL_LLM["n_layers"]
    for k in (1, 4, 1):
        copy = _slot_pool_copy(b)
        before = launch_counts()
        toks = b._graphs[k].replay().clone()
        after = launch_counts()
        eager = s._get_decode_step(b.S, b.max_len, k)(*copy[:4], b._temp)
        torch.cuda.synchronize()
        assert torch.equal(toks, eager) and toks.shape == (3, k)
        _assert_dense_equal(b, copy)
        delta = {key: n - before[key] for key, n in after.items() if n != before[key]}
        assert delta == dict(b._graphs[k].counts)
        k1 = paged_attention.paged_attention
        assert not delta.get((k1, "launches"), 0) and not delta.get((k1, "launches_int8"), 0)
        assert delta[(fused_norm.fused_residual_rmsnorm, "launches")] == n_layers * k
        k4 = delta.get((int8_matmul.int8_matmul, "launches"), 0)
        assert k4 == ((7 * n_layers + 1) * k if kv == "int8" else 0)


@pytest.mark.parametrize("mode,kv", [("ngram", "bf16"), ("ngram", "int8"), ("draft", "bf16")])
def test_dense_spec_graph_replay_bit_equals_eager(dev, mode, kv):
    """The dense spec step (a K+1-column verify over the slot pool, the
    rejected columns' positions reset) captured under
    ``set_sync_debug_mode("error")``: at three sets of caps, one replay and
    one eager call from identical copies give bit-equal tokens and advance,
    state, history, draft caches and every slot row but the trash column;
    each replay adds what its capture counted: one K2 a layer (and one a
    layer of each of the K+1 draft forwards), in the int8 model one K4
    decode launch a product, no K1."""
    from seldon_core_tpu_torch.servers.step_graph import launch_counts

    s, b = _spec_batcher(dev, kv, mode, layout="dense")
    assert b._spec_graph is not None and not b._graphs
    _dense_admit(b, ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60], [7, 7, 1, 7, 7, 1], [3, 3, 3, 3]))
    assert all(slot.active for slot in b._slots)
    n_layers = SMALL_LLM["n_layers"]
    prog = s._get_spec_step(b.S, 4, b.hist_len, mode=mode, layout="dense")
    for caps in ((4, 4, 4), (1, 0, 3), (4, 2, 4)):
        b._draft_cap.copy_(torch.tensor(caps, dtype=torch.int32))
        copy = _slot_pool_copy(b)
        before = launch_counts()
        out = b._spec_graph.replay().clone()
        after = launch_counts()
        eager = prog(*copy[:4], b._temp, None, copy[4], b._draft_cap, copy[5])
        torch.cuda.synchronize()
        assert out.shape == (3, 6) and torch.equal(out, eager)
        adv = out[:, 5].cpu()
        assert bool((adv >= 1).all()) and bool((adv <= torch.tensor(caps) + 1).all())
        _assert_dense_equal(b, copy)
        delta = {key: n - before[key] for key, n in after.items() if n != before[key]}
        assert delta == dict(b._spec_graph.counts)
        k1 = paged_attention.paged_attention
        assert not delta.get((k1, "launches"), 0) and not delta.get((k1, "launches_int8"), 0)
        drafts = 5 * n_layers if mode == "draft" else 0
        assert delta[(fused_norm.fused_residual_rmsnorm, "launches")] == n_layers + drafts
        k4 = delta.get((int8_matmul.int8_matmul, "launches"), 0)
        assert k4 == (7 * n_layers + 1 if kv == "int8" else 0)


@pytest.mark.parametrize("mode", ["plain", "ngram"])
def test_dense_batcher_through_graphs_equals_eager_batcher(dev, mode):
    """The same requests, one after another and four at once, through the
    dense graphs and the eager dense programs (the private ``_eager``
    switch), rows of 24 positions: the same tokens, every dispatch of the
    graph batcher a replay; the free slots step past their rows on the
    card without a device-side error (their writes go to the trash
    column)."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher

    kw = dict(layout="dense", max_len=24, pipeline_depth=2)
    s, b = (_spec_batcher(dev, "bf16", "ngram", **kw) if mode == "ngram"
            else _graph_batcher(dev, "bf16", **kw))
    prompts = ("hi", "hello there", "a", "four requests")
    outs = {}
    for name, batcher in (("graph", b), ("eager", ContinuousBatcher(
            s, max_slots=3, fuse_steps=0 if mode == "ngram" else 4, device="cuda",
            _eager=True, **kw))):
        s._decode_replays = s._decode_eager = 0
        try:
            outs[name] = [batcher.submit(p, 10).result(120) for p in prompts]
            outs[name] += [f.result(120) for f in [batcher.submit(p, 10) for p in prompts]]
            torch.cuda.synchronize()
        finally:
            batcher.close()
        assert int(batcher._next_pos.max()) > 24 and batcher.crashed is None
        replays, eager = s._decode_replays, s._decode_eager
        assert (replays > 0 and eager == 0) if name == "graph" else (replays == 0 and eager > 0)
    assert [len(o) for o in outs["graph"]] == [10] * 8
    assert outs["graph"] == outs["eager"]


def test_sse_stream_through_graph_batcher(dev):
    """A stream over REST through the graph batcher (K = 4, 3 slots): each
    stream's token events equal its ``done`` tokens and its greedy tokens
    equal the eager batcher's; every prefill chunk and every decode dispatch
    was a graph replay."""
    import http.client
    import json

    from seldon_core_tpu_torch.runtime.batcher import BatcherService, ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import LLMServer
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    s = LLMServer(model="transformer", model_kwargs=SMALL_LLM, init_random=True,
                  param_dtype="auto", max_new_tokens=12, eos_id=-1, len_buckets=(16,),
                  continuous_batching=3, decode_fuse_steps=4, device="cuda")
    s.load()
    s._batcher_service = BatcherService(s, max_slots=3)
    httpd, _ = start(make_component_app(s, device="cuda"))
    prompts = ("hi", [5, 9, 17, 2, 40, 3, 22], "hello there")
    streams = []
    try:
        for p in prompts:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
            conn.request("POST", "/v1/generate", json.dumps({"prompt": p, "stream": True}))
            streams.append(conn.getresponse())
        events = [[json.loads(line[6:]) for line in (raw.decode().strip() for raw in r)
                   if line.startswith("data: ")] for r in streams]
    finally:
        httpd.shutdown()
        httpd.server_close()
        s._batcher_service.close()
    assert s._prefill_replays == len(prompts) and s._prefill_eager == 0
    assert s._decode_replays > 0 and s._decode_eager == 0
    eager = ContinuousBatcher(s, max_slots=3, fuse_steps=4, device="cuda", _eager=True)
    try:
        want = [f.result(120) for f in [eager.submit(p) for p in prompts]]
    finally:
        eager.close()
    for ev, toks in zip(events, want):
        assert ev[-1]["done"] is True and ev[-1]["tokens"] == toks
        assert [e["token"] for e in ev[:-1]] == toks


def test_capture_while_another_thread_generates(dev):
    """Graphs are captured thread-locally: batchers built while another
    thread runs the private ``generate()`` path eagerly (its private
    ``_eager`` switch: eager launches, its own allocations and host syncs)
    capture their prefill and decode graphs,
    a replay of each is bit-equal to the eager program, and the other
    thread's tokens equal a solo run's."""
    import threading
    import time

    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    s = LLMServer(model="transformer", model_kwargs=SMALL_LLM, init_random=True,
                  param_dtype="auto", max_new_tokens=12, eos_id=-1, len_buckets=(16,),
                  device="cuda")
    s.load()
    solo = s.generate(["hello there"], max_new_tokens=8, _eager=True)["tokens"][0]
    stop, outs, errors = threading.Event(), [], []

    def spin():
        try:
            while not stop.is_set():
                outs.append(s.generate(["hello there"], max_new_tokens=8,
                                       _eager=True)["tokens"][0])
        except Exception as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=spin)
    t.start()
    try:
        deadline = time.monotonic() + 60
        while not outs and not errors and time.monotonic() < deadline:
            time.sleep(0.01)
        batchers = [ContinuousBatcher(s, max_slots=3, page_size=8, fuse_steps=4,
                                      device="cuda") for _ in range(3)]
        seen = len(outs)
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive() and not errors, errors
    assert seen >= 1 and len(outs) > seen and all(o == solo for o in outs)
    b = batchers[-1]
    _admit(b, ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60], [7, 7, 1]))
    row, chunks = _chunk_job(b, 16, 0)
    got, want, pools, _ = _replay_vs_eager(s, b, 16, row, *chunks[0])
    assert torch.equal(got, want)
    _assert_pools_equal(b, pools)
    del pools
    for k in (1, 4):
        copy = _state_copy(b)
        toks = b._graphs[k].replay().clone()
        eager = s._get_decode_step_paged(b.S, b.n_pages, k)(*copy, b._temp, b._block_tables)
        torch.cuda.synchronize()
        assert torch.equal(toks, eager)
        _assert_state_equal(b, copy)


# a context of 512 and buckets 32 / 128 / 512 with chunks of 256: admissions
# produce chunks of 32, 128 and 256, as the 7B server's defaults do
PREFILL_LLM = dict(SMALL_LLM, max_seq_len=512)
PREFILL_BATCH = dict(max_slots=3, page_size=8, max_len=600, len_buckets=(32, 128, 512),
                     prefill_chunk=256)


def _prefill_batcher(dev, kv, _eager=False):
    """The small GQA model at a context of 512 and a 3-slot batcher whose
    admissions produce chunks of 32, 128 and 256, built (every graph warmed
    up and captured) under ``set_sync_debug_mode("error")``."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    s = LLMServer(model="transformer", model_kwargs=PREFILL_LLM, init_random=True,
                  param_dtype="auto", max_new_tokens=12, eos_id=-1, device="cuda",
                  **INT8_KNOBS[kv])
    s.load()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = ContinuousBatcher(s, device="cuda", _eager=_eager, **PREFILL_BATCH)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return s, b


def _chunk_job(b, C, seed):
    """Fresh pages for two chunks of C, and their inputs: the first chunk
    full (positions 0..C-1), the second of C - 3 tokens (padded), attending
    over the first through the pool. Returns (row, [(tokens, positions)] x 2)
    as host arrays."""
    pages = b._allocator.alloc(-(-2 * C // b.page_size))
    b._reset_pages(pages)
    row = np.full((1, b.n_pages), NULL_PAGE, np.int32)
    row[0, :len(pages)] = pages
    ids = np.random.default_rng(seed).integers(1, 256, 2 * C - 3)
    chunks = []
    for start in (0, C):
        part = ids[start:start + C]
        toks = np.zeros((1, C), np.int64)
        pos = np.full((1, C), PAD_POS, np.int32)
        toks[0, :len(part)] = part
        pos[0, :len(part)] = np.arange(start, start + len(part))
        chunks.append((toks, pos))
    return row, chunks


def _replay_vs_eager(s, b, C, row, toks, pos):
    """One replay of chunk C's graph on the staged inputs, and the eager
    program on identical copies of the pools: returns (replay logits,
    eager logits, the eager pools, the launch counts the replay added)."""
    from seldon_core_tpu_torch.servers.step_graph import launch_counts

    b._row.copy_(b._to_device(row))
    b._chunk_tokens[:, :C].copy_(b._to_device(toks))
    b._chunk_pos[:, :C].copy_(b._to_device(pos))
    pools = [tuple(t.clone() for t in layer) for layer in b._caches]
    before = launch_counts()
    got = b._prefill_graphs[C].replay().clone()
    after = launch_counts()
    want = s._get_prefill_chunk(C, b.n_pages)(pools, b._row, b._chunk_tokens[:, :C],
                                              b._chunk_pos[:, :C])
    torch.cuda.synchronize()
    return got, want, pools, {key: n - before[key] for key, n in after.items()
                              if n != before[key]}


def _assert_pools_equal(b, pools):
    for la, lb in zip(b._caches, pools):
        for x, y in zip(la, lb):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefill_graph_replay_bit_equals_eager(dev, kv):
    """The batcher holds one prefill graph per chunk length its admissions
    produce (32, 128, 256), captured without a host sync. On live pools
    (two prompts admitted through the graphs), each chunk length's first
    and later chunk, replayed out of capture order (capture runs 256, 128,
    32), gives logits and pools bit-equal to the eager program from
    identical copies; each replay adds the launch counts its capture saw:
    one K2 a layer and, in the int8 model, one K4 a product, on the prefill
    route (``launches_wgmma``) for M >= 64; and each graph holds those
    kernels as nodes, read back by function name, and no K1."""
    s, b = _prefill_batcher(dev, kv)
    assert sorted(b._prefill_graphs) == [32, 128, 256] == list(b._chunks)
    replays = s._prefill_replays
    _admit(b, ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60] * 14, [7, 7, 1]))
    assert s._prefill_replays == replays + 1 + 1 and s._prefill_eager == 0
    n_layers, k4 = PREFILL_LLM["n_layers"], 7 * PREFILL_LLM["n_layers"] + 1
    for C in (32, 256, 128, 32):
        row, chunks = _chunk_job(b, C, C)
        for toks, pos in chunks:
            got, want, pools, delta = _replay_vs_eager(s, b, C, row, toks, pos)
            assert got.shape == (1, C, PREFILL_LLM["vocab_size"])
            assert torch.isfinite(got).all() and torch.equal(got, want)
            _assert_pools_equal(b, pools)
            assert delta == dict(b._prefill_graphs[C].counts)
            assert delta[(fused_norm.fused_residual_rmsnorm, "launches")] == n_layers
            assert delta.get((int8_matmul.int8_matmul, "launches"), 0) == (
                k4 if kv == "int8" else 0)
            assert delta.get((int8_matmul.int8_matmul, "launches_wgmma"), 0) == (
                k4 if kv == "int8" and C >= 64 else 0)
            assert not any(fn is paged_attention.paged_attention for fn, _ in delta)
            del pools
        names = _kernel_names(b._prefill_graphs[C].graph)
        wgmma = k4 if kv == "int8" and C >= 64 else 0
        assert [sum(key in n for n in names) for key in (
            "fused_residual_rmsnorm_kernel", "int8_matmul_wgmma_kernel",
            "int8_matmul_decode_kernel", "paged_attention_decode_kernel")] == [
                n_layers, wgmma, (k4 if kv == "int8" else 0) - wgmma, 0]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefill_graph_replay_reads_new_inputs(dev, kv):
    """Two jobs on different pages with different tokens, one after the
    other through the same chunk graph: each replay equals the eager
    program on its own row, tokens and positions, and the two replays'
    logits differ."""
    s, b = _prefill_batcher(dev, kv)
    logits = []
    for seed in (1, 2):
        row, chunks = _chunk_job(b, 128, seed)
        got, want, pools, _ = _replay_vs_eager(s, b, 128, row, *chunks[0])
        assert torch.equal(got, want)
        _assert_pools_equal(b, pools)
        logits.append(got)
        del pools
    assert not torch.equal(logits[0], logits[1])


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_batcher_through_prefill_graphs_equals_eager_batcher(dev, kv):
    """Prompts of 1, 1, 2 and 2 chunks of 32, 128 and 256 tokens, served
    through the graphs and through the eager programs (the private
    ``_eager`` switch): the same tokens; every chunk of the first was a
    replay, every chunk of the second an eager run."""
    prompts = ("hi", "a prompt of more than thirty-two bytes, so its bucket is 128",
               "x" * 300, [3, 4, 5] * 130)
    outs = {}
    for eager in (False, True):
        s, b = _prefill_batcher(dev, kv, _eager=eager)
        assert bool(b._prefill_graphs) == (not eager)
        try:
            outs[eager] = [f.result(120) for f in [b.submit(p) for p in prompts]]
        finally:
            b.close()
        assert (s._prefill_replays, s._prefill_eager) == ((0, 6) if eager else (6, 0))
        assert b.page_stats()["kv_pages_in_use"] == 0
    assert [len(o) for o in outs[False]] == [12] * 4
    assert outs[False] == outs[True]


# ---------------------------------------------------------------------------
# generate()'s dense decode step as a CUDA graph per (batch bucket, max_len)
# ---------------------------------------------------------------------------
def _gen_server(kv, **kw):
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    s = LLMServer(model="transformer", model_kwargs=SMALL_LLM, init_random=True,
                  param_dtype="auto", max_new_tokens=8, eos_id=-1, len_buckets=(16,),
                  device="cuda", **INT8_KNOBS[kv], **kw)
    s.load()
    return s


GEN_PROMPTS = ["hello there", [5, 9, 17, 2, 40, 3, 22, 8, 11, 60], "a", "four", "tokens x",
               [7, 7, 1], "the dense path", "b"]


def _dense_copy(s, b, max_len):
    d = s._dense
    return ([tuple(t.clone() for t in layer) for layer in d.caches(b, max_len)],
            *(t.clone() for t in d.state(b)))


def _replay_vs_eager_step(s, b, max_len):
    """One replay of the (b, max_len) generate graph on the dense buffer's
    live state, and one eager step of the same program on identical copies:
    tokens, caches and state bit-equal; the replay adds to the launch
    counters what its capture counted. Returns that delta."""
    from seldon_core_tpu_torch.servers.step_graph import launch_counts

    d = s._dense
    # the next write lands inside max_len: back every row off by one step
    d.pos[:b].sub_(1)
    copy = _dense_copy(s, b, max_len)
    graph = s._generate_graphs[(b, max_len)]
    before = launch_counts()
    got = graph.replay().clone()
    after = launch_counts()
    want = s._get_decode(b, max_len)(*copy, d.temperature)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and got.shape == (b,)
    for la, lb in zip(d.caches(b, max_len), copy[0]):
        for x, y in zip(la, lb):
            assert torch.equal(x, y)
    for x, y in zip(d.state(b), copy[1:]):
        assert torch.equal(x, y)
    delta = {key: n - before[key] for key, n in after.items() if n != before[key]}
    assert delta == dict(graph.counts)
    return delta


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_generate_graph_replay_bit_equals_eager(dev, kv):
    """generate() through its decode graphs equals the private eager switch
    (sampled, seeded) at two keys and after a growth of the dense buffer;
    every decode step is a replay; one replay on live state is bit-equal to
    the eager program on copies (tokens, caches, state) and adds one K2 a
    layer (and in int8 one K4 a product), no K1."""
    s = _gen_server(kv, temperature=0.7)
    n_layers = SMALL_LLM["n_layers"]
    k2 = (fused_norm.fused_residual_rmsnorm, "launches")
    k4 = (int8_matmul.int8_matmul, "launches")
    k1 = paged_attention.paged_attention
    for prompts, max_new, key, growths in ((GEN_PROMPTS[:3], 8, (4, 24), 0),
                                           (GEN_PROMPTS[:1], 4, (1, 20), 0),
                                           (GEN_PROMPTS, 12, (8, 28), 1),
                                           (GEN_PROMPTS[:3], 8, (4, 24), 1)):
        replays, eager = s._generate_replays, s._generate_eager
        got = s.generate(prompts, max_new_tokens=max_new, seed=5)
        assert (s._generate_replays - replays, s._generate_eager - eager) == (max_new - 1, 0)
        want = s.generate(prompts, max_new_tokens=max_new, seed=5, _eager=True)
        assert s._generate_eager - eager == max_new - 1
        assert got == want and [len(t) for t in got["tokens"]] == [max_new] * len(prompts)
        assert s._dense_growths == growths and key in s._generate_graphs
        delta = _replay_vs_eager_step(s, *key)
        assert delta[k2] == n_layers
        assert delta.get(k4, 0) == (7 * n_layers + 1 if kv == "int8" else 0)
        assert (k1, "launches") not in delta and (k1, "launches_int8") not in delta
    # the growth dropped the first graphs: (4, 24) was captured again
    assert sorted(s._generate_graphs) == [(4, 24), (8, 28)]


def test_sample_tokens_temperature_forms_on_card(dev):
    """On CUDA logits, the temperature as generate() passes it (its dense
    buffer's 0-dim tensor) and as the batcher holds it give the same tokens
    and keys; a float is made into the same tensor. Dividing by a Python
    float instead is a multiply by its reciprocal on the card (the trap
    these forms avoid): the scores it gives are not the tensor division's."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import sample_tokens, seed_key

    s = _gen_server("bf16", temperature=0.7)
    s.generate(["hi"], max_new_tokens=2)
    b = ContinuousBatcher(s, max_slots=2, page_size=8, device="cuda", _eager=True)
    b.close()
    g = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((64, 32000), generator=g, device=dev) * 3
    keys = torch.tensor([seed_key(i) for i in range(64)], dtype=torch.int64, device=dev)
    forms = (s._dense.temperature, b._temp, 0.7)
    outs = [sample_tokens(keys, logits, t, s.top_k) for t in forms]
    for k, t in outs[1:]:
        assert torch.equal(k, outs[0][0]) and torch.equal(t, outs[0][1])
    topv = torch.topk(logits, s.top_k, dim=-1).values
    assert not torch.equal(topv / 0.7, topv / s._dense.temperature)


def _could_draw(s, ids, key, temperature, tok, tol):
    """Whether the sampled draw under the draw key ``key`` could pick
    ``tok`` at the end of ``ids`` from logits within ``tol`` of a
    teacher-forced fresh prefill's. The draw adds Gumbel noise by rank in
    the top-k (``sample_tokens``), so a logit that moves by ``tol`` may take
    any rank whose value lies within 2 ``tol`` of its own, and the noise of
    that rank: ``tok`` could win if its best score over its ranks reaches
    every other token's worst (a token that may fall out of the top-k has
    none)."""
    from seldon_core_tpu_torch.servers.llmserver import _GOLDEN, _M32, _mix32

    dev = torch.device("cuda")
    with torch.no_grad():
        logits, _ = s._prefill_fresh(torch.tensor([ids], device=dev),
                                     torch.arange(len(ids), device=dev)[None], len(ids))
    v, order = torch.sort(logits[0, -1].float(), descending=True)
    j = torch.arange(s.top_k, device=dev, dtype=torch.int64)
    bits = _mix32((torch.tensor(key, device=dev) + j * _GOLDEN) & _M32)
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    noise = torch.full_like(v, float("-inf"))
    noise[:s.top_k] = -torch.log(-torch.log(u))
    near = (v[:, None] - v[None, :]).abs() <= 2 * tol          # [rank, rank it may take]
    best = torch.where(near, noise[None, :], float("-inf")).max(dim=1).values
    worst = torch.where(near, noise[None, :], float("inf")).min(dim=1).values
    r = order.tolist().index(tok)
    rivals = torch.cat([(v / temperature + worst)[:r], (v / temperature + worst)[r + 1:]])
    return bool(v[r] / temperature + best[r] + 2 * tol / temperature >= rivals.max())


def test_seeded_generate_graph_equals_graph_batcher_submit(dev):
    """The same seed through generate()'s decode graph (row 0) and through
    the graph batcher's submit(seed=) gives the same sampled tokens, up to
    a teacher-forced near-tie: where they first differ, the draw could
    give either token from logits within 0.02 of a teacher-forced prefill's
    (``_could_draw``: the paged and the dense path compute the logits
    through different kernels, and the noise goes by rank in the top-k)."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import seed_key, split_keys

    s = _gen_server("bf16", temperature=0.7)
    b = ContinuousBatcher(s, max_slots=3, page_size=8, device="cuda")
    try:
        assert b._graphs and b._prefill_graphs
        for prompt, seed in (("hello there", 5), ([5, 9, 17, 2, 40, 3], 11), ("a", 12)):
            served = b.submit(prompt, 8, seed=seed).result(120)
            replays = s._generate_replays
            private = s.generate([prompt], max_new_tokens=8, seed=seed)["tokens"][0]
            assert s._generate_replays - replays == 7
            t = next((i for i, (x, y) in enumerate(zip(served, private)) if x != y), None)
            if t is None:
                continue
            key = seed_key(seed)
            for _ in range(t + 1):
                key, sub = split_keys(key)
            ids = (s._tokenizer.encode(prompt) if isinstance(prompt, str) else prompt)
            for tok in (served[t], private[t]):
                assert _could_draw(s, ids + served[:t], sub, 0.7, tok, 0.02), (t, tok)
    finally:
        b.close()


def test_generate_capture_while_a_batcher_captures(dev):
    """generate() captures its decode graphs (on its own stream, in its own
    pool) while another thread builds batchers (their prefill and decode
    graphs captured on the server's batcher stream, their warm-ups
    launching meanwhile): each generate() call equals the eager switch's
    solo tokens; every graph of either thread counts its own kernel nodes,
    by name, and nothing the other thread launched; and the last batcher's
    decode replay is bit-equal to its eager program."""
    import threading

    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher

    s = _gen_server("bf16")
    solo = {m: s.generate(GEN_PROMPTS[:3], max_new_tokens=m, _eager=True)
            for m in range(2, 12)}
    batchers, errors = [], []

    def build():
        try:
            for _ in range(3):
                batchers.append(ContinuousBatcher(s, max_slots=3, page_size=8, fuse_steps=4,
                                                  device="cuda"))
        except Exception as e:   # reported below
            errors.append(e)

    t = threading.Thread(target=build)
    t.start()
    seen = {}
    try:
        m = 2
        while t.is_alive() or m < 4:
            seen[m] = s.generate(GEN_PROMPTS[:3], max_new_tokens=m)
            m = m + 1 if m < 11 else 2
    finally:
        t.join(120)
    assert not t.is_alive() and not errors, errors
    assert len(batchers) == 3
    for m, out in seen.items():
        assert out == solo[m]
    assert all((4, 16 + m) in s._generate_graphs for m in seen)
    k2 = (fused_norm.fused_residual_rmsnorm, "launches")
    k1 = (paged_attention.paged_attention, "launches")
    graphs = [*s._generate_graphs.values()]
    for b in batchers:
        graphs += [*b._graphs.values(), *b._prefill_graphs.values()]
    for g in graphs:
        names = _kernel_names(g.graph)
        by_name = {k2: sum("fused_residual_rmsnorm_kernel" in n for n in names),
                   k1: sum("paged_attention_decode_kernel" in n for n in names)}
        assert g.counts == {key: n for key, n in by_name.items() if n}
        assert g.counts[k2] % SMALL_LLM["n_layers"] == 0
    b = batchers[-1]
    _admit(b, ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60], [7, 7, 1]))
    for k in (1, 4):
        copy = _state_copy(b)
        toks = b._graphs[k].replay().clone()
        eager = s._get_decode_step_paged(b.S, b.n_pages, k)(*copy, b._temp, b._block_tables)
        torch.cuda.synchronize()
        assert torch.equal(toks, eager)
        _assert_state_equal(b, copy)


def _k3_case(dev, b, h, w, c, f, n_blocks, seed):
    """bf16 activations (relu of a normal draw) and live folded blocks:
    weights at 1/sqrt(fan_in), b1 > 0 so the 3x3 conv's zero padding
    differs from relu(b1), every w3 non-zero."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    x = torch.relu(rnd(b, h, w, c)).to(torch.bfloat16)
    blocks = []
    for _ in range(n_blocks):
        blk = dict(w1=rnd(c, f, scale=c ** -0.5).to(torch.bfloat16),
                   b1=0.1 + 0.3 * torch.rand((f,), generator=g, device=dev),
                   w2=rnd(3, 3, f, f, scale=(9 * f) ** -0.5).to(torch.bfloat16),
                   b2=rnd(f, scale=0.1),
                   w3=rnd(f, c, scale=f ** -0.5).to(torch.bfloat16),
                   b3=rnd(c, scale=0.1))
        assert blk["w3"].abs().max().item() > 0
        blocks.append(blk)
    return x, blocks


def _k3_within(out, ref, n_blocks):
    """n_blocks bf16 ulps of max|ref|, elementwise."""
    tol = n_blocks * float(_bf16_ulp(np.array(ref.float().abs().max().item())))
    return (out.float() - ref.float()).abs().max().item() <= tol


def _k3_run(x, blocks, plan=None):
    """One chain call, through the wrapper under its plan, or with ``plan``
    (three (tile width, splits, steps per split)) forced on every block;
    ``launches`` must grow by exactly ``expected_launches`` or, forced, by
    the plan's count."""
    b, h, w, c = x.shape
    f = blocks[0]["w1"].shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    before = fused_resnet.fused_identity_chain.launches
    if plan is None:
        out = fused_resnet.fused_identity_chain(x, blocks)
        want = fused_resnet.expected_launches(b, h, w, c, f, len(blocks), sms)
    else:
        params = fused_resnet._block_param_list(blocks)
        out = fused_resnet._gemm_chain(x, params, [plan] * len(blocks))
        want = len(blocks) * sum(1 + (splits > 1) for _, splits, _ in plan)
    torch.cuda.synchronize()
    assert fused_resnet.fused_identity_chain.launches - before == want
    return out


@pytest.mark.parametrize("b,h,w,c,f,n_blocks", [
    (2, 56, 56, 256, 64, 2), (2, 28, 28, 512, 128, 1), (2, 14, 14, 1024, 256, 1),
    (3, 7, 7, 2048, 512, 2),   # tiles across image seams, the last one ragged
    (2, 10, 40, 128, 64, 1),   # rows of 40: a tile holds 3.2 image rows
    (1, 5, 9, 64, 128, 3),     # the whole image in one ragged tile
    (1, 7, 7, 2048, 512, 1), (8, 7, 7, 2048, 512, 2),        # served batches: split K
    (1, 14, 14, 1024, 256, 1), (8, 14, 14, 1024, 256, 2),
])
def test_fused_resnet_kernel_matches_plain(dev, b, h, w, c, f, n_blocks):
    x, blocks = _k3_case(dev, b, h, w, c, f, n_blocks, seed=h + c + f)
    out = _k3_run(x, blocks)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert torch.isfinite(out.float()).all()
    ref = fused_resnet.identity_chain_ref(x, blocks)
    assert _k3_within(out, ref, n_blocks)
    # each block alone, on the plain chain's input: within one ulp
    xi = x
    for blk in blocks:
        want = fused_resnet.identity_chain_ref(xi, [blk])
        assert _k3_within(fused_resnet.fused_identity_chain(xi, [blk]), want, 1)
        xi = want


@pytest.mark.parametrize("bn", [64, 128, 256])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_fused_resnet_gemm_every_width_and_split(dev, bn, splits):
    """The kernel at every tile width and split the plan can pick
    (splits capped at each conv's K steps), on a ragged odd-width batch:
    198 pixels, two tiles, rows of 11."""
    x, blocks = _k3_case(dev, 2, 9, 11, 512, 256, 2, seed=bn + splits)
    plan = []
    for _, _, steps in fused_resnet._conv_dims(512, 256):
        per = -(-steps // min(splits, steps))
        plan.append((bn, -(-steps // per), per))
    out = _k3_run(x, blocks, plan=tuple(plan))
    assert _k3_within(out, fused_resnet.identity_chain_ref(x, blocks), 2)


@pytest.mark.parametrize("b,h,w,c,f", [(2, 14, 14, 256, 64), (8, 7, 7, 2048, 512)])
def test_fused_resnet_chain_graph_holds_expected_launches(dev, b, h, w, c, f):
    """One chain call captured in a CUDA graph holds exactly the expected
    launches as kernel nodes and nothing else (its workspaces come from the
    graph's pool), and the replay agrees with the plain version."""
    x, blocks = _k3_case(dev, b, h, w, c, f, 2, seed=b)
    nodes, out = _graph_nodes(lambda: fused_resnet.fused_identity_chain(x, blocks))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert nodes == [0] * fused_resnet.expected_launches(b, h, w, c, f, 2, sms), nodes
    assert _k3_within(out, fused_resnet.identity_chain_ref(x, blocks), 2)


def test_fused_resnet_concurrent_threads_with_different_rings(dev):
    """Two host threads launch the same convs at once under plans of
    different ring depths (one K step per split: a one-stage ring; the
    whole K range in one split: the deepest), as concurrent requests of a
    served ResNet do at 56x56 and 28x28, each after a PyTorch op of its own
    (a request's stem). The shared-memory limit is the kernel function's,
    shared by the threads: every launch is taken, and each thread's answers
    are bit-equal to its first, within one ulp of the plain chain."""
    import threading

    x, blocks = _k3_case(dev, 1, 14, 14, 256, 64, 1, seed=5)
    params = fused_resnet._block_param_list(blocks)
    ref = fused_resnet.identity_chain_ref(x, blocks)
    plans = {"deep": ((64, 1, 4), (64, 1, 9), (64, 1, 1)),
             "shallow": ((64, 4, 1), (64, 9, 1), (64, 1, 1))}
    outs, errors = {}, []
    start = threading.Barrier(len(plans))

    def run(name):
        try:
            (x.float() + 1).sum().item()
            start.wait()
            outs[name] = [fused_resnet._gemm_chain(x, params, [plans[name]])
                          for _ in range(1000)]
        except Exception as exc:   # noqa: BLE001 - reported below
            errors.append(f"{name}: {exc}")

    threads = [threading.Thread(target=run, args=(name,)) for name in plans]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    for name, got in outs.items():
        assert _k3_within(got[0], ref, 1), name
        assert all(torch.equal(o, got[0]) for o in got), name


def test_tma_kernels_from_a_thread_with_no_cuda_call(dev):
    """K3 and K4's prefill route (both encode TMA tensor maps on the host)
    called from a new host thread whose only CUDA work is theirs: its
    workspaces come from PyTorch's cache, warmed by the same call on this
    thread, so nothing has made a context current there. Both launch, and
    give this thread's answers bit for bit."""
    import threading

    x, blocks = _k3_case(dev, 1, 14, 14, 256, 64, 1, seed=6)
    m, k, n = 128, 4096, 1024
    xq, q, scale = _k4_case(dev, m, k, n, 6)
    plan = (128, 1, -(-k // int8_matmul.WG_BK))

    def calls():
        return (fused_resnet.fused_identity_chain(x, blocks),
                int8_matmul._wgmma_kernel(xq, q, scale, out_k4, plan))

    out_k4 = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    want = [t.clone() for t in calls()]
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            got.extend(calls())
        except Exception as exc:   # noqa: BLE001 - reported below
            errors.append(str(exc))

    t = threading.Thread(target=run)
    t.start()
    t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_fused_resnet_kernel_tolerance_catches_faults(dev):
    """The kernel run on a tap-swapped w2 (a kernel that read two taps in
    each other's place) lands outside the tolerance, and so does the plain
    chain with y1's halo filled with relu(b1) instead of zero, while the
    kernel on the true weights stays inside."""
    x, blocks = _k3_case(dev, 2, 14, 14, 256, 64, 1, seed=3)
    ref = fused_resnet.identity_chain_ref(x, blocks)
    assert _k3_within(_k3_run(x, blocks), ref, 1)
    taps = blocks[0]["w2"].reshape(9, 64, 64)
    swapped = dict(blocks[0], w2=taps[[1, 0, 2, 3, 4, 5, 6, 7, 8]].reshape(3, 3, 64, 64))
    assert not _k3_within(_k3_run(x, [swapped]), ref, 1)
    blk = blocks[0]
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    y1 = torch.relu(xp @ blk["w1"].float() + blk["b1"]).to(torch.bfloat16).float()
    taps = [y1[:, i:i + 14, j:j + 14] for i in range(3) for j in range(3)]
    y2 = torch.relu(torch.cat(taps, -1) @ blk["w2"].float().reshape(-1, 64) + blk["b2"])
    y = (y2.to(torch.bfloat16).float() @ blk["w3"].float() + blk["b3"]).to(torch.bfloat16)
    assert not _k3_within(torch.relu(x + y), ref, 1)


def test_fused_resnet_kernel_rejects_what_it_does_not_take(dev):
    x, blocks = _k3_case(dev, 1, 7, 7, 64, 64, 1, seed=0)
    with pytest.raises(TypeError):
        fused_resnet.fused_identity_chain(x.float(), blocks)
    with pytest.raises(TypeError):   # an f32 weight: operands are prepared at load
        fused_resnet.fused_identity_chain(x, [dict(blocks[0], w1=blocks[0]["w1"].float())])
    with pytest.raises(ValueError):  # C not a multiple of 64
        fused_resnet.fused_identity_chain(x[..., :32].contiguous(),
                                          [dict(blocks[0], w1=blocks[0]["w1"][:32].contiguous(),
                                                w3=blocks[0]["w3"][:, :32].contiguous(),
                                                b3=blocks[0]["b3"][:32].contiguous())])
    with pytest.raises(ValueError, match="not divisible"):
        fused_resnet.fused_identity_chain(x, blocks, group=2)
    with pytest.raises(ValueError, match="16-byte"):   # TMA needs aligned bases
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        fused_resnet.fused_identity_chain(flat[1:].view(x.shape), blocks)


# ---------------------------------------------------------------------------
# the radix prefix cache: the CoW page copy as a CUDA graph, a hit's chunk,
# and generate()'s dense entries under the decode graph
# ---------------------------------------------------------------------------
def _radix_batcher(dev, kv):
    """The small GQA model with the prefix cache on and a 3-slot batcher of
    pages of 8 (prefill, decode and CoW graphs captured under
    ``set_sync_debug_mode("error")``)."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    s = LLMServer(model="transformer", model_kwargs=SMALL_LLM, init_random=True,
                  param_dtype="auto", max_new_tokens=12, eos_id=-1, len_buckets=(16, 32),
                  prefix_cache_size=4, device="cuda", **INT8_KNOBS[kv])
    s.load()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = ContinuousBatcher(s, max_slots=3, page_size=8, prefill_chunk=16, device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return s, b


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_cow_graph_replay_bit_equals_eager(dev, kv):
    """On live pools (a chat turn served, its blocks in the trie), one
    replay of the CoW graph (a cached page into a fresh one, 5 of 8 tokens
    valid) is bit-equal on every pool tensor to the eager ``cow_page_copy``
    on identical copies; the destination's positions are the source's up
    to ``n_valid`` and PAD_POS after; the graph launches no kernel of the
    port's own, and a second replay with new staged arguments reads them."""
    from seldon_core_tpu_torch.runtime.batcher import cow_page_copy

    s, b = _radix_batcher(dev, kv)
    assert b._cow_graph is not None
    try:
        b.submit(list(range(1, 20)), 6).result(120)
    finally:
        b.close()
    src = next(iter(b._radix._root.children.values()))[0].page
    for dst, n_valid in ((b._allocator.alloc(1)[0], 5), (b._allocator.alloc(1)[0], 8)):
        pools = [tuple(t.clone() for t in layer) for layer in b._caches]
        before = s._cow_replays
        b._cow_copy(src, dst, n_valid)
        assert s._cow_replays == before + 1
        arg = lambda v: torch.tensor([v], dtype=torch.int64, device=dev)
        cow_page_copy(pools, arg(src), arg(dst), arg(n_valid))
        torch.cuda.synchronize()
        _assert_pools_equal(b, pools)
        pos = b._caches[0][-1]
        assert torch.equal(pos[dst, :n_valid], pos[src, :n_valid])
        assert (pos[dst, n_valid:] == PAD_POS).all()
        assert dict(b._cow_graph.counts) == {}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefix_hit_chunk_replay_bit_equals_eager(dev, kv):
    """A turn-2 admission hits turn 1's blocks (shared pages lead its row,
    one CoW copy, the job starts at k0 > 0): its first chunk's replay gives
    logits and pools bit-equal to the eager chunk program on identical
    copies; then the whole turn through the graphs equals the same turn
    through an eager twin batcher on the same weights, hit for hit."""
    from concurrent.futures import Future

    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.runtime.scheduler import PendingRequest

    s, b = _radix_batcher(dev, kv)
    turn1 = list(range(3, 28))   # 25 tokens: + 5 answered, 3 blocks and a tail of 6
    try:
        out = b.submit(turn1, 6).result(120)
    finally:
        b.close()
    turn2 = turn1 + out + [7, 8, 9]
    cows = s._cow_replays
    assert b._admit_begin(PendingRequest(ids=list(turn2), max_new=6, fut=Future()))
    job, slot = b._prefill, b._slots[b._prefill.slot]
    assert job.next == len(turn1) + len(out) - 1 > 0 and s._cow_replays == cows + 1
    row = b._row.cpu().numpy()
    assert list(row[0, :len(slot.shared)]) == slot.shared and len(slot.shared) == 3
    C = job.chunk
    part = job.ids[job.next:job.next + C]
    toks = np.zeros((1, C), np.int64)
    pos = np.full((1, C), PAD_POS, np.int32)
    toks[0, :len(part)] = part
    pos[0, :len(part)] = np.arange(job.next, job.next + len(part))
    got, want, pools, _ = _replay_vs_eager(s, b, C, row, toks, pos)
    assert torch.isfinite(got).all() and torch.equal(got, want)
    _assert_pools_equal(b, pools)
    # the turn served end to end, graphs against an eager twin
    outs = []
    for eager in (False, True):
        twin = ContinuousBatcher(s, max_slots=3, page_size=8, prefill_chunk=16, device="cuda",
                                 _eager=eager)
        try:
            outs.append([twin.submit(p, 6).result(120) for p in (turn1, turn2)]
                        + [twin._radix.stats()])
        finally:
            twin.close()
    assert outs[0] == outs[1] and outs[0][0] == out
    assert outs[0][2]["prefix_cow_copies"] == 1 and outs[0][2]["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_dense_entry_unchanged_by_generate_graph_replays(dev, kv):
    """generate() with the prefix cache on: a stored entry is a copy, so
    the decode graph's replays into the one dense buffer (an exact hit,
    then a partial hit through ``_get_extend``) leave it bit-equal to what
    was stored; the exact hit's tokens equal the first call's and each
    call's are the eager switch's."""
    s = _gen_server(kv, prefix_cache_size=4)
    prompt = [5, 9, 17, 2, 40, 3]   # with its 8 answered and 2 more: one bucket of 16
    first = s.generate([prompt])["tokens"][0]
    (key, entry), = s._prefix_cache.items()
    snap = [tuple(t.clone() for t in layer) for layer in entry[2]], entry[3].clone()
    replays = s._generate_replays
    assert s.generate([prompt])["tokens"][0] == first
    assert s._generate_replays == replays + 7 and s._prefix_hits == 1
    longer = prompt + first + [4, 4]
    got = s.generate([longer])["tokens"][0]
    assert s._prefix_hits == 2 and len(s._prefix_cache) == 2
    stored = s._prefix_cache[key]
    for layer, before in zip(stored[2], snap[0]):
        for t, b0 in zip(layer, before):
            assert torch.equal(t, b0)
    assert torch.equal(stored[3], snap[1])
    s.clear_prefix_cache()
    assert s.generate([longer], _eager=True)["tokens"][0] == got


# ---------------------------------------------------------------------------
# Batched LoRA: the adapted programs as CUDA graphs
# ---------------------------------------------------------------------------

LORA_RANK = 4


def _lora_factors(cfg, seed):
    from seldon_core_tpu_torch.runtime.adapters import projection_dims

    rng = np.random.default_rng(seed)
    return {p: (rng.standard_normal((cfg.n_layers, din, LORA_RANK)) / np.sqrt(din),
                rng.standard_normal((cfg.n_layers, LORA_RANK, dout)) * 0.1)
            for p, (din, dout) in projection_dims(cfg).items()}


def _lora_batcher(dev, kv, lora_rank=LORA_RANK):
    """``_graph_batcher``'s small model (the same seed, so the same weights)
    with a LoRA pool of 5 rows holding adapters "a", "b", "c" (or none with
    ``lora_rank=0``), and a 3-slot batcher whose prefill and decode graphs
    are the adapted programs, built under ``set_sync_debug_mode("error")``."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    s = LLMServer(model="transformer", model_kwargs=SMALL_LLM, init_random=True,
                  param_dtype="auto", max_new_tokens=12, eos_id=-1, len_buckets=(16,),
                  device="cuda", lora_rank=lora_rank, lora_max_adapters=5, **INT8_KNOBS[kv])
    s.load()
    for i, name in enumerate(("a", "b", "c") if lora_rank else ()):
        s.adapter_registry.load(name, _lora_factors(s._cfg, i), alpha=2 * LORA_RANK)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = ContinuousBatcher(s, max_slots=3, page_size=8, device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return s, b


def _request(s, ids, name):
    from concurrent.futures import Future

    from seldon_core_tpu_torch.runtime.scheduler import PendingRequest

    reg = s.adapter_registry
    return PendingRequest(ids=list(ids), max_new=12, fut=Future(),
                          adapter_id=reg.resolve_and_pin(name) if reg is not None else 0)


def _admit_adapted(s, b, prompts, names):
    for p, name in zip(prompts, names):
        assert b._admit_begin(_request(s, p, name))
        while b._prefill is not None:
            b._prefill_step()
    for i, slot in enumerate(b._slots):
        if slot.active:
            assert b._ensure_slot_pages(i, slot.dispatched_pos() + 16)


LORA_PROMPTS = ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60], [7, 7, 1], [30, 31, 32, 33, 34])


def _stage_chunk(b, ids):
    """Stage the first chunk of the staged job (``_prefill_step``'s inputs)
    and return its length."""
    C = b._prefill.chunk
    n = min(C, len(ids))
    toks = torch.zeros((1, C), dtype=torch.int64)
    pos = torch.full((1, C), PAD_POS, dtype=torch.int32)
    toks[0, :n] = torch.tensor(ids[:n])
    pos[0, :n] = torch.arange(n)
    b._chunk_tokens[:, :C] = toks.cuda()
    b._chunk_pos[:, :C] = pos.cuda()
    return C


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_lora_adapted_replays_bit_equal_eager(dev, kv):
    """An adapted chunk's replay (the job's adapter id in the fixed
    ``_chunk_adapter``) and an adapted decode replay (slots of adapters
    "a", none and "c" in ``_adapter_ids``) are each bit-equal to the eager
    adapted program from identical copies (logits or tokens, pools, state);
    each replay adds what its capture counted, one K1 and K2 a layer."""
    from seldon_core_tpu_torch.servers.step_graph import launch_counts

    s, b = _lora_batcher(dev, kv)
    pool = s.adapter_registry.pool()
    assert b._adapters is not None and sorted(b._graphs) == [1]
    assert b._admit_begin(_request(s, LORA_PROMPTS[0], "b"))
    C = _stage_chunk(b, LORA_PROMPTS[0])
    assert int(b._chunk_adapter[0]) == s.adapter_registry.resolve("b")
    copy = [tuple(t.clone() for t in layer) for layer in b._caches]
    got = b._prefill_graphs[C].replay().clone()
    want = s._get_prefill_chunk(C, b.n_pages, True)(
        copy, b._row, b._chunk_tokens[:, :C], b._chunk_pos[:, :C], adapters=pool,
        adapter_ids=b._chunk_adapter)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for la, lb in zip(b._caches, copy):
        for x, y in zip(la, lb):
            assert torch.equal(x, y)
    b._prefill = None
    b._release_slot(0)
    _admit_adapted(s, b, LORA_PROMPTS, ("a", None, "c"))
    reg = s.adapter_registry
    assert b._adapter_ids.tolist() == [reg.resolve("a"), 0, reg.resolve("c")]
    n_layers = SMALL_LLM["n_layers"]
    for _ in range(2):
        copy = _state_copy(b)
        before = launch_counts()
        toks = b._graphs[1].replay().clone()
        after = launch_counts()
        eager = s._get_decode_step_paged(b.S, b.n_pages, 1, True)(
            *copy, b._temp, b._block_tables, adapters=pool, adapter_ids=b._adapter_ids)
        torch.cuda.synchronize()
        assert torch.equal(toks, eager)
        _assert_state_equal(b, copy)
        delta = {key: n - before[key] for key, n in after.items() if n != before[key]}
        assert delta == dict(b._graphs[1].counts)
        k1 = paged_attention.paged_attention
        assert delta[(k1, "launches_int8" if kv == "int8" else "launches")] == n_layers
        assert delta[(fused_norm.fused_residual_rmsnorm, "launches")] == n_layers


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_lora_identity_through_adapted_graph_equals_plain_graph(dev, kv):
    """Adapter id 0 through the adapted graphs gives what the unadapted
    graphs of a server with the same weights give, bit for bit: a chunk's
    logits and pools, then two decode replays' tokens, pools and state."""
    s, b = _lora_batcher(dev, kv)
    p, pb = _lora_batcher(dev, kv, lora_rank=0)
    assert pb._adapters is None and b._adapters is not None
    for srv, bat in ((s, b), (p, pb)):
        assert bat._admit_begin(_request(srv, LORA_PROMPTS[0], None))
        _stage_chunk(bat, LORA_PROMPTS[0])
    got = b._prefill_graphs[16].replay().clone()
    want = pb._prefill_graphs[16].replay().clone()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for bat in (b, pb):
        bat._prefill = None
        bat._release_slot(0)
        _admit_adapted(bat.server, bat, LORA_PROMPTS, (None, None, None))
    for _ in range(2):
        assert torch.equal(b._graphs[1].replay(), pb._graphs[1].replay())
    torch.cuda.synchronize()
    _assert_state_equal(b, _state_copy(pb))


def test_lora_row_written_in_place_is_read_by_the_next_replay(dev):
    """The pool's addresses are captured, so a load writes its row in
    place: an adapter evicted and its row reloaded with other factors
    between two replays (as a load on a transport thread does) is what the
    second replay reads. It equals the eager adapted step on the new row,
    and its pools differ from a step over the old row's factors."""
    s, b = _lora_batcher(dev, "bf16")
    reg = s.adapter_registry
    pool = reg.pool()
    _admit_adapted(s, b, LORA_PROMPTS, ("a", None, None))
    b._graphs[1].replay()
    old_row = reg.resolve("c")
    old = {p: (ab[0][old_row].clone(), ab[1][old_row].clone())
           for p, ab in pool.items() if p != "scale"}
    assert reg.evict("c") and reg.load("d", _lora_factors(s._cfg, 9), alpha=2 * LORA_RANK) == \
        old_row
    reg.pin(old_row)
    b._slots[2].adapter_id = old_row
    b._adapter_ids[2] = old_row
    new_copy, old_copy = _state_copy(b), _state_copy(b)
    toks = b._graphs[1].replay().clone()
    prog = s._get_decode_step_paged(b.S, b.n_pages, 1, True)
    on_new = prog(*new_copy, b._temp, b._block_tables, adapters=pool,
                  adapter_ids=b._adapter_ids)
    saved = {p: (ab[0][old_row].clone(), ab[1][old_row].clone())
             for p, ab in pool.items() if p != "scale"}
    for p, (a, b_) in old.items():
        pool[p][0][old_row].copy_(a)
        pool[p][1][old_row].copy_(b_)
    on_old = prog(*old_copy, b._temp, b._block_tables, adapters=pool,
                  adapter_ids=b._adapter_ids)
    for p, (a, b_) in saved.items():
        pool[p][0][old_row].copy_(a)
        pool[p][1][old_row].copy_(b_)
    torch.cuda.synchronize()
    assert torch.equal(toks, on_new)
    _assert_state_equal(b, new_copy)
    assert not all(torch.equal(x, y) for la, lb in zip(new_copy[0], old_copy[0])
                   for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the graph engine: a fused AVERAGE_COMBINER over two JAX_SERVER ResNets
# ---------------------------------------------------------------------------
def _engine_pair(dev, tmp_path):
    """Two live folded ResNet-18 checkpoints (64x64, 10 classes) under an
    AVERAGE_COMBINER: (fused engine, unfused engine, the two modules)."""
    from seldon_core_tpu_torch.contracts.graph import PredictorSpec
    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.runtime.engine import GraphEngine
    from seldon_core_tpu_torch.servers.torchserver import export_checkpoint

    children, models = [], []
    for name, seed in (("a", 1), ("b", 2)):
        m = get_model("resnet18", num_classes=10, fused=True, device=dev)
        m.init_params(torch.Generator(device=dev).manual_seed(seed))
        assert all(blk.Conv_2.kernel.abs().max().item() > 0 for blk in m.blocks())
        path = str(tmp_path / name)
        export_checkpoint(path, "resnet18", {"params": m.param_tree()},
                          kwargs={"num_classes": 10, "fused": True}, input_shape=[64, 64, 3])
        children.append({"name": name, "type": "MODEL", "implementation": "JAX_SERVER",
                         "modelUri": path})
        models.append(m)
    spec = PredictorSpec.from_dict({"name": "p", "graph": {
        "name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
        "children": children}})
    return (GraphEngine(spec, device="cuda"), GraphEngine(spec, fuse=False, device="cuda"),
            models)


def _engine_logits(engine, x):
    from seldon_core_tpu_torch.contracts.payload import SeldonMessage

    out = engine.predict_sync(SeldonMessage.from_dict(
        {"data": {"tensor": {"shape": list(x.shape), "values": x.ravel().tolist()}}})).to_dict()
    t = out["data"]["tensor"]
    return np.asarray(t["values"], np.float64).reshape(t["shape"]), out["meta"]


@pytest.mark.parametrize("batch", [8, 1])
def test_engine_fused_combiner_runs_k3_and_equals_unfused(dev, tmp_path, batch):
    """Fused (one composed call on the card, the mean on the card) and
    unfused (each TorchServer's predict, the mean in float64 on the host)
    both run K3 ``expected_launches`` times per leaf forward, answer within
    1e-5 of max|logit| of each other, and within 0.03 of max|logit| of the
    mean of the two cuDNN-chain forwards on the same weights."""
    from seldon_core_tpu_torch.models.resnet_infer import resnet_serve_forward

    fused, unfused, models = _engine_pair(dev, tmp_path)
    x = np.random.default_rng(batch).standard_normal((batch, 64, 64, 3)).round(3)
    xt = torch.from_numpy(x.astype(np.float32)).to(dev)
    with torch.no_grad():
        before = fused_resnet.fused_identity_chain.launches
        models[0](xt)
        torch.cuda.synchronize()
        per_forward = fused_resnet.fused_identity_chain.launches - before
        ref = torch.stack([resnet_serve_forward(m, xt, pallas_stages=()) for m in models]
                          ).mean(0).double().cpu().numpy()
    assert per_forward > 0
    got = {}
    for name, engine in (("fused", fused), ("unfused", unfused)):
        before = fused_resnet.fused_identity_chain.launches
        got[name], meta = _engine_logits(engine, x)
        assert fused_resnet.fused_identity_chain.launches - before == 2 * per_forward
        assert meta["requestPath"] == {"avg": "AverageCombiner", "a": "TorchServer",
                                       "b": "TorchServer"}
    assert fused._fused_calls == 1 and unfused._fused_calls == 0
    scale = np.abs(ref).max()
    assert np.abs(got["fused"] - got["unfused"]).max() <= 1e-5 * scale
    assert np.abs(got["fused"] - ref).max() <= 0.03 * scale


def test_fleet_two_replicas_equal_one(dev):
    """Two small replicas on the card behind a ``ReplicaSet`` (the same seed
    draws the same weights; graph batchers, the prefix cache on) give the
    tokens one server's graph batcher gives for the same six prompts; both
    replicas serve, every chunk and dispatch is a replay, and a follow-up
    carrying a served prompt lands on the replica that holds it."""
    from seldon_core_tpu_torch.runtime.batcher import BatcherService
    from seldon_core_tpu_torch.runtime.engine import ReplicaSet
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    def server():
        s = LLMServer(model="transformer", model_kwargs=SMALL_LLM, init_random=True,
                      param_dtype="auto", max_new_tokens=12, eos_id=-1, len_buckets=(16,),
                      temperature=0.0, continuous_batching=3, prefix_cache_size=8,
                      kv_page_size=8, device="cuda")
        s.load()
        return s

    solo, reps = server(), [server(), server()]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 255, size=int(n)).tolist() for n in (9, 14, 5, 20, 11, 7)]
    svc = BatcherService(solo, max_slots=3)
    want = [f.result(120) for f in [svc.submit(p, 12) for p in prompts]]
    svc.close()
    rs = ReplicaSet(reps)
    futs = [rs.submit(p, 12) for p in prompts]
    assert [f.result(120) for f in futs] == want
    assert all(r._prefill_replays > 0 and r._decode_replays > 0 for r in reps)
    assert all(r._prefill_eager == 0 and r._decode_eager == 0 for r in reps)
    follow = prompts[3] + want[3] + [1, 2, 3]
    owner = [r.prefix_match_len(follow) for r in reps]
    assert max(owner) > 0 and rs.pick_for(follow) is reps[int(np.argmax(owner))]
    for r in reps:
        r._batcher_service.close()


# ---------------------------------------------------------------------------
# Disaggregated prefill: workers on their own streams and graphs, the import
# ---------------------------------------------------------------------------
def _disagg_server(kv):
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    s = LLMServer(model="transformer", model_kwargs=PREFILL_LLM, init_random=True,
                  param_dtype="auto", max_new_tokens=12, eos_id=-1, device="cuda",
                  **INT8_KNOBS[kv])
    s.load()
    return s


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_worker_chunk_graphs_bit_equal_local_beside_decode(dev, kv):
    """A prefill worker captures its chunk graphs (32, 128, 256) on its own
    thread and stream, in its own pool, while this thread replays a decode
    graph on its own stream; a prompt of 300 tokens (two chunks of 256)
    and one of 100 (one of 128) prefilled there, with decode replays
    enqueued meanwhile, hand over buckets whose written pages are bit-equal
    (values where held, positions everywhere) to the local chunk graphs'
    pages for the same prompts, with the same first token; every chunk was a
    replay on the worker (none eager), and the K2 / K4 launches it added
    are its graphs' counts."""
    from concurrent.futures import Future

    from seldon_core_tpu_torch.runtime.disagg import PrefillRequest, PrefillWorker, TransferQueue
    from seldon_core_tpu_torch.runtime.scheduler import PendingRequest
    from seldon_core_tpu_torch.servers.step_graph import launch_counts

    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher

    s = _disagg_server(kv)
    b = ContinuousBatcher(s, device="cuda", **PREFILL_BATCH)
    prompts = ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60] * 30, list(range(3, 103)))
    local = []
    for ids in prompts:
        assert b._admit_begin(PendingRequest(ids=list(ids), max_new=12, fut=Future()))
        while b._prefill is not None:
            b._prefill_step()
        slot = next(sl for sl in b._slots if sl.active and sl.ids == list(ids))
        local.append(([tuple(t[slot.pages].clone() for t in layer) for layer in b._caches],
                      slot.tokens[0]))
    for i, slot in enumerate(b._slots):
        if slot.active:   # room for the decode replays below
            assert b._ensure_slot_pages(i, slot.dispatched_pos() + 24)
    q = TransferQueue()
    w = PrefillWorker(
        s, q, dev, dev, layout="paged", max_len=b.max_len, page_size=b.page_size,
        n_pages=b.n_pages, prefill_chunk=b.prefill_chunk, chunks=b._chunks)
    try:
        assert sorted(w.graphs()) == [32, 128, 256] and w._stream != torch.cuda.current_stream()
        before = launch_counts()
        for job, ids in enumerate(prompts):
            q.register(job)
            w.submit(PrefillRequest(job, ids, 512 if len(ids) > 128 else 128,
                                    first_key=b._first_key(None)))
        for _ in range(20):
            b._graphs[1].replay()    # decode on this thread's stream meanwhile
        got = []
        while len(got) < len(prompts):
            h = q.pop()
            if h is None:
                continue
            assert h.error is None, h.error
            got.append(h)
        torch.cuda.synchronize()
        after = launch_counts()
    finally:
        w.close()
        b.close()
    assert (w.replays, w.eager_runs) == (3, 0)
    for h, (pages, first), ids in zip(sorted(got, key=lambda h: h.job_id), local, prompts):
        n0 = -(-len(ids) // b.page_size)
        assert h.first_token == first
        for layer, want in zip(h.staged, pages):
            pos = layer[-1][RESERVED_PAGES:RESERVED_PAGES + n0]
            assert torch.equal(pos, want[-1])
            held = pos != PAD_POS
            assert int(held.sum()) == len(ids)
            for t, ref in zip(layer[:-1], want[:-1]):
                assert torch.equal(t[RESERVED_PAGES:RESERVED_PAGES + n0][held], ref[held])
    counts = {k: after[k] - before[k] for k in after}
    k2_per = PREFILL_LLM["n_layers"]
    decode_k2 = 20 * k2_per
    assert counts[(fused_norm.fused_residual_rmsnorm, "launches")] == 3 * k2_per + decode_k2
    if kv == "int8":
        k4 = 7 * PREFILL_LLM["n_layers"] + 1
        assert counts[(int8_matmul.int8_matmul, "launches_wgmma")] == 3 * k4


def test_handoff_import_waits_on_the_worker_event(dev):
    """A bucket written on a side stream behind a ~100 ms spin kernel, its
    event recorded after: the batcher's import (``_import_handoff``)
    returns to the host at once (no host wait) and, once the device is
    done, the slot's pages hold the final values, not the ones the bucket
    held before the spin; the slot's block-table row points at them."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher, _RemoteJob
    from seldon_core_tpu_torch.runtime.disagg import Handoff
    from seldon_core_tpu_torch.runtime.scheduler import PendingRequest

    s = _disagg_server("bf16")
    b = ContinuousBatcher(s, device="cuda", disaggregation="remote_prefill", **PREFILL_BATCH)
    try:
        pages = b._allocator.alloc(3)
        row = np.full((b.n_pages,), NULL_PAGE, np.int32)
        row[:3] = pages
        job = _RemoteJob(1, 0, list(range(20)), row, 0,
                         PendingRequest(ids=list(range(20)), max_new=4, fut=None))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            bucket = [tuple(torch.zeros((RESERVED_PAGES + 4, *t.shape[1:]), dtype=t.dtype,
                                        device=dev) for t in layer) for layer in b._caches]
            torch.cuda._sleep(200_000_000)
            for layer in bucket:
                for t in layer:
                    t.fill_(7)
            ev = torch.cuda.Event()
            ev.record(side)
        del layer, t
        import time as _time

        t0 = _time.perf_counter()
        b._import_handoff(job, Handoff(1, staged=bucket, event=ev, first_token=3, first_key=5))
        host_s = _time.perf_counter() - t0
        del bucket
        torch.cuda.synchronize()
        assert host_s < 0.05
        for layer in b._caches:
            for t in layer:
                assert bool((t[pages] == 7).all())
        assert b._block_tables[0, :3].tolist() == pages
    finally:
        b.close()


def test_tma_first_launch_on_a_fresh_worker_stream(dev):
    """K4's prefill route (TMA tensor maps encoded on the host) as the
    first CUDA work of a new host thread, on a stream of its own made there
    (a prefill worker's case): it launches, on that stream, and gives this
    thread's answer bit for bit."""
    import threading

    m, k, n = 128, 4096, 1024
    xq, q, scale = _k4_case(dev, m, k, n, 9)
    want = int8_matmul.int8_matmul(xq, q, scale, out_dtype=torch.bfloat16).clone()
    before = int8_matmul.int8_matmul.launches_wgmma
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            stream = torch.cuda.Stream(device=dev)
            with torch.cuda.stream(stream):
                out = int8_matmul.int8_matmul(xq, q, scale, out_dtype=torch.bfloat16)
            stream.synchronize()
            got.append(out)
        except Exception as exc:   # noqa: BLE001 - reported below
            errors.append(str(exc))

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errors, errors
    assert torch.equal(got[0], want)
    assert int8_matmul.int8_matmul.launches_wgmma == before + 1


@pytest.mark.parametrize("kv,transport,workers", [("bf16", "device", 2), ("int8", "device", 1),
                                                  ("bf16", "network", 1)])
def test_disagg_batcher_on_card_equals_local(dev, kv, transport, workers):
    """Prompts of 1 and 2 chunks of 32, 128 and 256 tokens through a graph
    batcher with remote prefill (every chunk a replay on a worker, the
    workers' graphs captured without a host sync) give the local graph
    batcher's tokens; every page comes back."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher

    prompts = ("hi", "a prompt of more than thirty-two bytes, so its bucket is 128",
               "x" * 300, [3, 4, 5] * 130)
    s = _disagg_server(kv)
    outs = {}
    for mode in ("off", "remote_prefill"):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            b = ContinuousBatcher(s, device="cuda", disaggregation=mode,
                                  handoff_transport=transport, prefill_workers=workers,
                                  **PREFILL_BATCH)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        try:
            outs[mode] = [f.result(120) for f in [b.submit(p) for p in prompts]]
            if mode != "off":
                ws = b._remote.workers
                assert len(ws) == workers and not b._prefill_graphs
                assert sum(w.replays for w in ws) == 6 and sum(w.eager_runs for w in ws) == 0
                assert b.handoff_stats()["handoffs_total"] == 4
                if transport == "network":
                    assert b.handoff_stats()["handoff_network_bytes_total"] > 0
            assert b.page_stats()["kv_pages_in_use"] == 0
        finally:
            b.close()
    assert outs["remote_prefill"] == outs["off"]


def test_rebalance_under_live_replays_new_pool_bit_equal_eager(dev):
    """``rebalance_disagg`` 1 -> 2 -> 1 while the graph batcher decodes:
    each new pool captures its chunk graphs on its workers' streams beside
    the live decode replays; a 300-token prompt (two chunks of 256)
    prefilled by a new pool hands over pages bit-equal (values where held,
    positions everywhere) to the eager local prefill's, with the same first
    token; every request's tokens equal the local eager batcher's; the new
    workers' chunks are replays (none eager); the outgoing pools are
    released, and the card's memory after the batcher closes is what it was
    before it was built."""
    from concurrent.futures import Future

    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.runtime.scheduler import PendingRequest

    s = _disagg_server("bf16")
    long_ids = [5, 9, 17, 2, 40, 3, 22, 8, 11, 60] * 30
    prompts = ["hi", "x" * 300, [3, 4, 5] * 50, "a prompt of more than thirty-two bytes"]
    eager = ContinuousBatcher(s, device="cuda", disaggregation="off", _eager=True,
                              **PREFILL_BATCH)
    try:   # the long prompt's pages by the eager local prefill (no loop running)
        assert eager._admit_begin(PendingRequest(ids=list(long_ids), max_new=12, fut=Future()))
        while eager._prefill is not None:
            eager._prefill_step()
        slot = next(sl for sl in eager._slots if sl.active and sl.ids == long_ids)
        local = ([tuple(t[slot.pages].clone() for t in layer) for layer in eager._caches],
                 slot.tokens[0])
    finally:
        eager.close()
    eager = ContinuousBatcher(s, device="cuda", disaggregation="off", _eager=True,
                              **PREFILL_BATCH)
    try:
        want = [f.result(120) for f in [eager.submit(p) for p in prompts * 3]]
    finally:
        eager.close()
    del eager, slot
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()   # PyTorch's 32 MiB a stream it ran a product on
    mem0 = torch.cuda.memory_allocated()
    b = ContinuousBatcher(s, device="cuda", disaggregation="remote_prefill", prefill_workers=1,
                          **PREFILL_BATCH)
    handoffs = []    # (first token, a copy of the bucket), in publication order
    real_put = b._transfer.put

    def put(h):
        if h.staged is not None and h.first_token is not None:
            handoffs.append((h.first_token, [tuple(x.clone() for x in layer)
                                             for layer in h.staged]))
        return real_put(h)

    b._transfer.put = put
    try:
        outs, pools = [], []
        for n in (2, 1):
            futs = [b.submit(p) for p in prompts]
            old = b._remote
            assert b.rebalance_disagg(n) and len(b._remote.workers) == n
            assert all(w._staging is None and w.graphs() == {} for w in old.workers)
            pools.append(b._remote)
            outs += [f.result(120) for f in futs]
        outs += [f.result(120) for f in [b.submit(p) for p in prompts]]
        b.submit(long_ids, 12).result(120)     # alone: the last handoff published
        ws = b._remote.workers
        assert sum(w.replays for w in ws) > 0 and sum(w.eager_runs for w in ws) == 0
        first, staged = handoffs[-1]
        stats = b.handoff_stats()
    finally:
        b.close()
    assert outs == want
    assert stats["handoffs_total"] == 3 * len(prompts) + 1 and stats["handoff_queue_depth"] == 0
    pages, tok = local
    n0 = -(-len(long_ids) // PREFILL_BATCH["page_size"])
    assert first == tok
    for layer, ref in zip(staged, pages):
        pos = layer[-1][RESERVED_PAGES:RESERVED_PAGES + n0]
        assert torch.equal(pos, ref[-1])
        held = pos != PAD_POS
        for x, r in zip(layer[:-1], ref[:-1]):
            assert torch.equal(x[RESERVED_PAGES:RESERVED_PAGES + n0][held], r[held])
    del b, pools, handoffs, staged, layer, ws, old, put
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    # what may stay: K1's arrival counters, kept for each stream it met
    assert torch.cuda.memory_allocated() - mem0 <= 1 << 20


# ---------------------------------------------------------------------------
# Fleet fault tolerance: a killed loop's crash path, and its restart on a new
# thread over the same captured graphs
# ---------------------------------------------------------------------------
def _kill_mid_decode(b, prompt, after: int = 3):
    """``prompt`` submitted with a ``BatcherKiller`` armed once ``after`` of
    its tokens are out (dispatches still in flight behind them, at the
    batcher's pipeline depth); returns the error the request failed with."""
    from seldon_core_tpu_torch.testing.faults import BatcherKiller

    got = []
    killer = BatcherKiller(trigger=lambda _b: len(got) >= after).install(b)
    fut = b.submit(prompt, 24, on_token=lambda t: got.append(t))
    with pytest.raises(Exception, match="chaos") as e:
        fut.result(120)
    killer.killed_thread.join(120)  # the crash path's end
    b._chaos = None
    return e.value


@pytest.mark.parametrize("mode", ["local", "remote_prefill"])
def test_restarted_loop_replays_graphs_bit_equal(dev, mode):
    """A graph batcher (K = 4, depth 2, the trie on; locally prefilled, or by
    a prefill worker whose handoffs this batcher imports) serves four
    requests, one a partial-block trie hit (a CoW replay); its loop is
    killed mid-decode, with dispatches in flight: every page, pin and
    adapter comes back (``LeakSweep`` residue all 0, the pool's free pages
    as before) and the loop's thread is gone. The next submit restarts the
    loop on a new thread, which replays the same captured graphs (no new
    capture, nothing eager) and serves the same requests with the same
    tokens as before the kill."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import LLMServer
    from seldon_core_tpu_torch.testing.faults import LeakSweep

    s = LLMServer(model="transformer", model_kwargs=SMALL_LLM, init_random=True,
                  param_dtype="auto", max_new_tokens=24, eos_id=-1, len_buckets=(16, 32),
                  temperature=0.7, prefix_cache_size=8, device="cuda")
    s.load()
    b = ContinuousBatcher(s, max_slots=3, page_size=8, fuse_steps=4, pipeline_depth=2,
                          disaggregation="off" if mode == "local" else mode, device="cuda")
    warm = list(range(1, 17))
    prompts = [warm + [40, 41], warm[:12] + [77], [5, 9, 17, 2], "a text prompt"]
    graphs = (dict(b._graphs), dict(b._prefill_graphs), b._cow_graph)
    try:
        assert b.submit(warm, 4, seed=1).result(120)
        before = [f.result(120) for f in [b.submit(p, 24, seed=i) for i, p in
                                          enumerate(prompts)]]
        thread = b._thread
        b._radix.clear()
        free = b._allocator.free_count()
        err = _kill_mid_decode(b, list(range(30, 50)))
        assert b.crashed is err and b._thread is None and not thread.is_alive()
        assert LeakSweep(b).residue() == dict.fromkeys(LeakSweep(b).residue(), 0)
        assert b._allocator.free_count() == free and not b._inflight
        eager = (s._prefill_eager, s._decode_eager, s._cow_eager)
        replays = s._decode_replays
        assert b.submit(warm, 4, seed=1).result(120)
        after = [f.result(120) for f in [b.submit(p, 24, seed=i) for i, p in
                                         enumerate(prompts)]]
        assert after == before
        assert b._thread is not None and b._thread is not thread and b.crashed is None
        assert (s._prefill_eager, s._decode_eager, s._cow_eager) == eager == (0, 0, 0)
        assert s._decode_replays > replays
        assert (b._graphs, b._prefill_graphs, b._cow_graph) == graphs
        assert all(b._graphs[k] is g for k, g in graphs[0].items())
        assert all(b._prefill_graphs[k] is g for k, g in graphs[1].items())
        b._radix.clear()
        assert b.page_stats()["kv_pages_in_use"] == 0
        LeakSweep(b).assert_clean("serving after the restart")
    finally:
        b.close()


def test_crash_path_waits_for_the_stream_before_releasing(dev):
    """The crash path waits on the batcher's stream before it releases the
    dead slots: a kill with two K = 4 dispatches in flight (each still
    writing its slots' pages) returns every page only once they ran, and a
    request admitted into the same pages right after decodes the tokens a
    fresh batcher gives it."""
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.testing.faults import LeakSweep

    s, b = _graph_batcher(dev, "bf16", pipeline_depth=2)
    fresh = ContinuousBatcher(s, max_slots=3, page_size=8, fuse_steps=4, device="cuda")
    try:
        want = fresh.submit([9, 8, 7, 6, 5], 12).result(120)
    finally:
        fresh.close()
    waited = []
    real = b._quiesce

    def quiesce():
        waited.append(len(b._inflight))
        real()

    b._quiesce = quiesce
    try:
        _kill_mid_decode(b, [5, 9, 17, 2, 40, 3, 22, 8, 11, 60])
        assert waited == [0]  # the records were dropped, the stream waited on
        LeakSweep(b).assert_clean("the kill")
        assert b.page_stats()["kv_pages_in_use"] == 0
        assert b.submit([9, 8, 7, 6, 5], 12).result(120) == want
    finally:
        b.close()


def test_traced_loop_replays_bit_equal_and_adds_no_sync(dev):
    """Two graph batchers over one server, the flight recorder on in one
    (``tracing=True``) and off in the other, admit the same prompts on this
    thread; then the loop's dispatch and drain run by hand on both, each
    under ``set_sync_debug_mode("error")`` (a stream or device sync, or a
    copy to the host, raises; the drain's event wait is the one wait
    allowed): every replay leaves the two batchers' tokens, pools and state
    bit-equal, and the traced timelines account for every token."""
    from concurrent.futures import Future

    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.runtime.scheduler import PendingRequest

    s, traced = _graph_batcher(dev, "bf16", tracing=True, pipeline_depth=2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        plain = ContinuousBatcher(s, max_slots=3, page_size=8, fuse_steps=4, pipeline_depth=2,
                                  tracing=False, device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert traced._flight is not None and plain._flight is None
    prompts = ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60], [7, 7, 1], [33, 34, 35, 36, 37])
    futs = {}
    for b in (traced, plain):
        futs[b] = []
        for p in prompts:
            fut = Future()
            futs[b].append(fut)
            assert b._admit_begin(PendingRequest(ids=list(p), max_new=12, fut=fut))
            while b._prefill is not None:
                b._prefill_step()   # the last chunk syncs for the first token
        for i, sl in enumerate(b._slots):  # every page the 12 tokens need, now
            assert b._ensure_slot_pages(i, sl.dispatched_pos() + 16)
    replays = s._decode_replays
    steps = 0
    while any(sl.active for b in (traced, plain) for sl in b._slots):
        torch.cuda.set_sync_debug_mode("error")
        try:
            for b in (traced, plain):
                while len(b._inflight) < b.pipeline_depth and b._dispatch_eligible():
                    b._dispatch()
                if b._inflight:
                    b._drain_one()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        steps += 1
        torch.cuda.synchronize()
        _assert_state_equal(traced, _state_copy(plain))
        assert [sl.tokens for sl in traced._slots] == [sl.tokens for sl in plain._slots]
    assert steps > 3 and s._decode_replays > replays and s._decode_eager == 0
    outs = [[f.result(0) for f in futs[b]] for b in (traced, plain)]
    assert outs[0] == outs[1] and [len(o) for o in outs[0]] == [12] * 3
    tls = traced._flight.timelines()
    assert traced._flight.live_slots() == [] and len(tls) == 3
    for tl, p in zip(sorted(tls, key=lambda t: t["prompt_tokens"], reverse=True),
                     sorted(prompts, key=len, reverse=True)):
        assert tl["token_events_sum"] == tl["tokens"] == 12 and tl["status"] == "done"
        assert tl["prompt_tokens"] == len(p) and tl["events_dropped"] == 0
    traced.close()
    plain.close()


# ------------------------------------------------- tensor-parallel shards
# K4 at Llama-2-7B's shard shapes (models/sharded.py): the column shards
# (wq / wk / wv N = 4096 / tp, w1 / w3 N = 11008 / tp, lm_head N = 32000 /
# tp) and the row shards (wo K = 4096 / tp, w2 K = 11008 / tp) at tp = 2
# and tp = 4 (w2's K = 2752: a multiple of 64, not of 128)
TP_SHARDS = [(4096, 2048), (4096, 5504), (4096, 16000), (2048, 4096), (5504, 4096),
             (4096, 1024), (4096, 2752), (4096, 8000), (1024, 4096), (2752, 4096)]
# the row shards an int8 rank writes as float32 partials (f32_partials):
# wo and w2 at tp = 2 and 4, and a Mixtral-8x7B expert's w2 at tp = 2
TP_ROW_SHARDS = [(2048, 4096), (5504, 4096), (1024, 4096), (2752, 4096), (7168, 4096)]


@pytest.mark.parametrize("m", [8, 32, 128, 256])
@pytest.mark.parametrize("k,n", TP_SHARDS, ids=lambda v: str(v))
def test_int8_matmul_tp_shard_shapes_match_plain(dev, m, k, n):
    """Each shard a contiguous [K, N] copy, both routes (M >= 64: the
    prefill kernel), within K4's tolerance of the plain version."""
    x, q, scale = _k4_case(dev, m, k, n, m + k + n)
    out = int8_matmul.int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    _assert_k4_close(out, x, q, scale)


@pytest.mark.parametrize("m", [8, 32, 128, 256])
@pytest.mark.parametrize("k,n", TP_ROW_SHARDS, ids=lambda v: str(v))
def test_int8_matmul_tp_row_shards_float32_match_plain(dev, m, k, n):
    """The float32 store of a row shard's partial, the output the served
    int8 ranks launch K4 with, at decode and prefill M (both routes)."""
    x, q, scale = _k4_case(dev, m, k, n, m + k + n)
    out = int8_matmul.int8_matmul(x, q, scale, torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    _assert_k4_close(out, x, q, scale)


@pytest.mark.parametrize("h,kvh", [(16, 16), (8, 8), (16, 4)],
                         ids=["7b-tp2", "7b-tp4", "mixtral-tp2"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_attention_tp_shard_heads_match_plain(dev, h, kvh, kv):
    """K1 at a rank's heads (hd 128, pages of 64), within K1's tolerance."""
    q, cache, bt, qpos = _k1_case(dev, 8, h, kvh, 128, 64, 4,
                                  [200, 64, 1, 129, 0, 255, 30, 100], kv, h + kvh)
    out = paged_attention.paged_attention(q, cache, bt, qpos)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    _assert_within_ulp(out, _ref32(q, cache, bt, qpos))


@pytest.mark.parametrize("h,kvh", [(16, 16), (8, 8), (16, 4)],
                         ids=["7b-tp2", "7b-tp4", "mixtral-tp2"])
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_attention_partial_over_seq_ranks_matches_plain(dev, h, kvh, sp, kv):
    """K1's partial mode at a rank's heads: each 'seq' rank reads its table
    columns ``s::sp`` (pages s, s + sp, ...), the ranks merged by
    ``softmax_merge``, within K1's tolerance of the plain version over the
    whole table; row 1 has one page, so ranks 1.. hold none of it and write
    the empty state (max -FLT_MAX, sum 0); with one rank (stride 1) the
    partial state normalised is the one-rank launch bit for bit."""
    from seldon_core_tpu_torch.parallel import collectives

    ctx = [200, 64, 1, 129, 0, 255, 30, 100]
    q, cache, bt, qpos = _k1_case(dev, 8, h, kvh, 128, 64, 4, ctx, kv, h + kvh + sp)
    parts = [paged_attention.paged_attention_partial(q, cache, bt[:, s::sp].contiguous(), qpos,
                                                     sp, s) for s in range(sp)]
    torch.cuda.synchronize()
    for s in range(1, sp):
        m, l, acc = parts[s]
        assert (l[1] == 0).all() and (acc[1] == 0).all() and (m[1] < -1e38).all()
    merged = collectives.softmax_merge(parts, torch.float32)[0]
    assert torch.isfinite(merged).all()
    _assert_within_ulp(merged.to(torch.bfloat16), _ref32(q, cache, bt, qpos))
    m, l, acc = paged_attention.paged_attention_partial(q, cache, bt, qpos)
    one = (acc / l.transpose(1, 2)[..., None]).to(torch.bfloat16)
    assert torch.equal(one, paged_attention.paged_attention(q, cache, bt, qpos))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_seq2_tp2_decode_graph_replay_bit_equals_eager(dev, kv):
    """The batcher over {seq 2, model 2} (four ranks on this card): a
    sequence's pages round robin over the two 'seq' pools; one replay of
    the captured decode step is bit-equal to the eager program from
    identical copies of every rank's pools (every page but TRASH) and the
    state, and adds what its capture counted: per step one K1 partial
    launch and one K2 a layer a rank."""
    from seldon_core_tpu_torch.parallel.topology import Topology
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import LLMServer
    from seldon_core_tpu_torch.servers.step_graph import launch_counts

    s = LLMServer(model="transformer", model_kwargs=SMALL_LLM, init_random=True,
                  param_dtype="auto", max_new_tokens=12, eos_id=-1, len_buckets=(16,),
                  device="cuda", mesh=Topology(devices=["cuda"] * 4).mesh(
                      {"data": 1, "seq": 2, "model": 2}), **INT8_KNOBS[kv])
    s.load()
    b = ContinuousBatcher(s, max_slots=3, page_size=8, device="cuda")
    assert sorted(b._graphs) == [1] and len(b._caches) == 4 * SMALL_LLM["n_layers"]
    _admit(b, ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60], [7, 7, 1]))
    n = SMALL_LLM["n_layers"] * 4
    copy = _state_copy(b)
    before = launch_counts()
    toks = b._graphs[1].replay().clone()
    after = launch_counts()
    eager = s._get_decode_step_paged(b.S, b.n_pages, 1)(*copy, b._temp, b._block_tables)
    torch.cuda.synchronize()
    assert torch.equal(toks, eager)
    # every page but TRASH: a 'seq' rank that does not hold a token's page
    # writes it there, several slots to one offset in no set order
    keep = torch.ones(b._caches[0][0].shape[0], dtype=torch.bool, device=dev)
    keep[TRASH_PAGE] = False
    assert torch.equal(b._last_tok, copy[1]) and torch.equal(b._next_pos, copy[2])
    assert torch.equal(b._keys, copy[3])
    assert all(torch.equal(x[keep], y[keep]) for la, lb in zip(b._caches, copy[0])
               for x, y in zip(la, lb))
    delta = {key: c - before[key] for key, c in after.items() if c != before[key]}
    assert delta == dict(b._graphs[1].counts)
    k1 = paged_attention.paged_attention_partial
    assert delta[(k1, "launches_int8" if kv == "int8" else "launches")] == n
    assert (paged_attention.paged_attention, "launches") not in delta
    assert delta[(fused_norm.fused_residual_rmsnorm, "launches")] == n
    b.close()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_tp2_decode_graph_replay_bit_equals_eager(dev, kv):
    """The batcher over a co-located tp = 2 mesh (two ranks on this card):
    one replay of each captured program (K = 1 and 4) is bit-equal to the
    eager program from identical copies of every rank's pools and the
    state, and adds what its capture counted: per step one K1 and one K2 a
    layer a rank, and in the int8 model one K4 launch a product a rank."""
    from seldon_core_tpu_torch.parallel.topology import Topology
    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
    from seldon_core_tpu_torch.servers.llmserver import LLMServer
    from seldon_core_tpu_torch.servers.step_graph import launch_counts

    s = LLMServer(model="transformer", model_kwargs=SMALL_LLM, init_random=True,
                  param_dtype="auto", max_new_tokens=12, eos_id=-1, len_buckets=(16,),
                  device="cuda", tensor_parallel=2,
                  topology=Topology(devices=["cuda"] * 2), **INT8_KNOBS[kv])
    s.load()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = ContinuousBatcher(s, max_slots=3, page_size=8, fuse_steps=4, device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sorted(b._graphs) == [1, 4] and len(b._caches) == 2 * SMALL_LLM["n_layers"]
    _admit(b, ([5, 9, 17, 2, 40, 3, 22, 8, 11, 60], [7, 7, 1]))
    n = SMALL_LLM["n_layers"] * 2
    for k in (1, 4):
        copy = _state_copy(b)
        before = launch_counts()
        toks = b._graphs[k].replay().clone()
        after = launch_counts()
        eager = s._get_decode_step_paged(b.S, b.n_pages, k)(*copy, b._temp, b._block_tables)
        torch.cuda.synchronize()
        assert torch.equal(toks, eager) and toks.shape == (3, k)
        _assert_state_equal(b, copy)
        delta = {key: c - before[key] for key, c in after.items() if c != before[key]}
        assert delta == dict(b._graphs[k].counts)
        k1 = paged_attention.paged_attention
        assert delta[(k1, "launches_int8" if kv == "int8" else "launches")] == n * k
        assert delta[(fused_norm.fused_residual_rmsnorm, "launches")] == n * k
        k4 = delta.get((int8_matmul.int8_matmul, "launches"), 0)
        assert k4 == ((7 * SMALL_LLM["n_layers"] + 1) * 2 * k if kv == "int8" else 0)
    b.close()


# ----------------------------------------------- predict models (ViT, MLP)
# K4 at the int8 predict path's products: ViT-B/16's four block products at
# M = 8 x 197 and 128 x 197 tokens, its head [768, 1000] (N % 16 != 0: the
# decode kernel at any M, float32 out) at B = 8 and 128, the MLP's [4, 128]
# (K % 8 != 0), [128, 128] and [128, 3] (N = 3) at B = 8 and 128
VIT_B16_PRODUCTS = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
PREDICT_K4_SHAPES = ([(m, k, n, torch.bfloat16) for m in (8 * 197, 128 * 197)
                      for k, n in VIT_B16_PRODUCTS]
                     + [(m, 768, 1000, torch.float32) for m in (8, 128)]
                     + [(m, k, n, torch.bfloat16) for m in (8, 128)
                        for k, n in ((4, 128), (128, 128), (128, 3))])


@pytest.mark.parametrize("m,k,n,out_dtype", PREDICT_K4_SHAPES)
def test_int8_matmul_predict_shapes_match_plain(dev, m, k, n, out_dtype):
    x, q, scale = _k4_case(dev, m, k, n, m + k + n)
    before = int8_matmul.int8_matmul.launches_wgmma
    out = int8_matmul.int8_matmul(x, q, scale, out_dtype)
    torch.cuda.synchronize()
    assert int8_matmul.int8_matmul.launches_wgmma - before == int(
        m >= 64 and k % 8 == 0 and n % 16 == 0)
    assert out.dtype == out_dtype and out.shape == (m, n)
    _assert_k4_close(out, x, q, scale)


def test_k4_and_k3_backward_on_the_card_equal_autograd_through_plain(dev):
    """The input gradients through K4's and K3's Functions on CUDA tensors
    (the kernels forward, the explicit plain backward) against autograd
    through ``int8_matmul_ref`` and ``identity_chain_ref``: K4's within two
    bf16 ulps of max|g| (its backward dequantizes in bf16, the reference in
    float32), K3's bit-equal (the same plain code on the same saved
    input); the forwards launch the kernels once each."""
    x, q, scale = _k4_case(dev, 8 * 197, 768, 2304, 3)
    qt = type("QT", (), {"q": q, "scale": scale, "orig_dtype": torch.bfloat16})()
    dy = torch.randn(x.shape[0], 2304, device=dev).to(torch.bfloat16)
    xa = x.clone().requires_grad_()
    before = int8_matmul.int8_matmul.launches
    y = int8_matmul.int8_dense(xa, qt)
    (got,) = torch.autograd.grad(y, xa, dy)
    assert int8_matmul.int8_matmul.launches == before + 1
    xb = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(int8_matmul.int8_matmul_ref(xb, q, scale), xb, dy)
    tol = 2 * float(_bf16_ulp(np.array(want.float().abs().max().item())))
    assert (got.float() - want.float()).abs().max().item() <= tol
    xc, blocks = _k3_case(dev, 2, 14, 14, 1024, 256, 2, seed=7)
    dyc = torch.randn(xc.shape, device=dev).to(torch.bfloat16)
    xa = xc.clone().requires_grad_()
    before = fused_resnet.fused_identity_chain.launches
    out = fused_resnet.fused_identity_chain(xa, blocks)
    (got,) = torch.autograd.grad(out, xa, dyc)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert fused_resnet.fused_identity_chain.launches - before == fused_resnet.expected_launches(
        2, 14, 14, 1024, 256, 2, sms)
    assert _k3_within(out, fused_resnet.identity_chain_ref(xc, blocks), 2)
    xb = xc.clone().requires_grad_()
    (want,) = torch.autograd.grad(fused_resnet.identity_chain_ref(xb, blocks), xb, dyc)
    assert torch.equal(got, want) and got.float().abs().max() > 0


def test_int8_resnet_operands_equal_a_dequantize_at_load(dev):
    """A folded two-stage ResNet at K3's widths (64 filters), quantized:
    each forward's dequantize into K3's and cuDNN's operands is bit-equal
    to the operands built once from the dequantized weights, and the int8
    forward runs K3 on them (its logits within 1e-4 of max|logit| of that
    float forward's: only the head differs, K4 against a float32 product)."""
    from seldon_core_tpu_torch.models.layers import param_tree
    from seldon_core_tpu_torch.models.resnet import ResNet
    from seldon_core_tpu_torch.models.resnet_infer import (dequantize_operands, forward_operands,
                                                           serving_operands)
    from seldon_core_tpu_torch.ops.quantize import dequantize_params, quantize_params

    m = ResNet((2, 2), num_classes=10, fused=True, device=dev)
    m.init_params(torch.Generator(device=dev).manual_seed(0))
    quantize_params(m)
    ops = dequantize_operands(m.serving_operands(dev), torch.bfloat16)
    once = serving_operands(param_tree(dequantize_params(m)), (2, 2), dev)
    for got, want in zip(ops["blocks"], once["blocks"]):
        for conv in ("Conv_0", "Conv_1", "Conv_2", "conv_proj"):
            if conv in want:
                assert torch.equal(got[conv]["w"], want[conv]["w"])
                assert got[conv]["w"].stride() == want[conv]["w"].stride()
        if "k3" in want:
            for key in want["k3"]:
                assert torch.equal(got["k3"][key], want["k3"][key]), key
    x = torch.randn(4, 32, 32, 3, device=dev)
    before = fused_resnet.fused_identity_chain.launches
    with torch.no_grad():
        logits = m(x)
        torch.cuda.synchronize()
        launched = fused_resnet.fused_identity_chain.launches - before
        want = forward_operands(once, x, (2, 2), pallas_stages=(0, 1))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert launched == (fused_resnet.expected_launches(4, 8, 8, 256, 64, 1, sms)
                        + fused_resnet.expected_launches(4, 4, 4, 512, 128, 1, sms))
    # the same K3 chains; the head on K4 against a float32 product
    assert (logits - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("kind", ["vae", "seq2seq"])
def test_outlier_detector_step_and_score_on_the_card_equal_the_cpu(dev, kind):
    """The VAE and seq2seq detectors (float32 nn.Modules, no kernel of
    their own) on the card: one Adam step from the same weights and inputs
    and the scores after it within 1e-5 (relative; 1e-6 absolute for
    weights near zero) of the same on the CPU. TF32 is off for the run."""
    from seldon_core_tpu_torch.analytics import outliers
    from seldon_core_tpu_torch.parallel.train import adam

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    if kind == "vae":
        cls, dims, loss_fn = outliers.VAEOutlierDetector, dict(hidden_dim=64), outliers.vae_loss
        x = rng.standard_normal((256, 4)).astype(np.float32)
        extra = (torch.from_numpy(rng.standard_normal((256, 2)).astype(np.float32)), 1e-3)
    else:
        cls, dims = outliers.Seq2SeqOutlierDetector, dict(timesteps=8, hidden_dim=32)
        loss_fn = outliers.seq2seq_loss
        x = rng.standard_normal((32, 8, 4)).astype(np.float32)
        extra = ()
    seed_det = cls(device="cpu", **dims)
    seed_det._d = 4
    weights = {k: v.numpy() for k, v in seed_det._new_net(torch.Generator().manual_seed(3))
               .state_dict().items()}
    results = []
    for where in ("cpu", dev):
        det = cls(device=where, **dims).adopt(weights)
        net = det._ready()
        tx = adam(1e-2)
        opt = tx.init(list(net.parameters()))
        inputs = [torch.from_numpy(x).to(where)] + [e.to(where) if torch.is_tensor(e) else e
                                                    for e in extra]
        _, loss = outliers.train_step(net, tx, opt, loss_fn, *inputs)
        results.append((float(loss), det.params(), det.score(x)))
    (l_cpu, p_cpu, s_cpu), (l_dev, p_dev, s_dev) = results
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    for k in p_cpu:
        np.testing.assert_allclose(p_dev[k], p_cpu[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s_dev, s_cpu, rtol=1e-5, atol=1e-7)
