#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and hold every
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing swallows an error):

1. the card's name and power limit (nvidia-smi), torch/CUDA/triton versions,
   TF32 off for float32 matmuls and convolutions;
2. build the kernels from the sources in this checkout (ops/_build.py: one
   nvcc per CUDA source, all started together);
3. kernel phase — each kernel's wrapper on card tensors at the serving
   path's shapes, against its plain version on the same inputs, with its
   time (CUDA events, median of 25), its plain version's, its bound (the
   larger of bytes / 3.35 TB/s and flops / 989 TFLOP/s) and, where one
   PyTorch call computes the same function, that call's;
4. serving phase — the port's REST server in-process on an ephemeral port,
   an LLMServer at Llama-2-7B widths and depth (random weights from a seed,
   bf16, fused_norm=True, paged continuous batching over 8 slots), 8
   concurrent POST /v1/generate requests; every kernel's launch count is
   zeroed just before and read just after, and each kernel must have run;
   every served token is held against a teacher-forced forward over its
   request's prompt and served tokens (within TIE_TOL of the top logit at
   every step), and one prompt is re-run through the private generate()
   and must give the same greedy tokens up to the first bf16 near-tie.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
port's package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
REPS = 25
# Greedy ties: the batcher, the private generate() and a teacher-forced
# forward compute the same function through different kernels and batch
# shapes (the paged kernel in float32 vs the dense bf16 einsum chain; 8-row
# vs 1-row matmuls), so bf16 rounding can flip an argmax between two
# near-equal logits. Every served token must sit within TIE_TOL of the top
# logit of the teacher-forced forward at its step (logit std here ~1.3).
TIE_TOL = 0.1

# K1 is held against its plain version run on float32 copies of the same
# bf16 inputs (the kernel accumulates in float32): within one bf16 ulp of
# that reference, plus K1_ATOL for float32 summation order.
K1_ATOL = 1e-5
K1_TOL_REASON = ("vs the plain version on float32 copies of the bf16 inputs: within "
                 f"1 bf16 ulp + {K1_ATOL} (the kernel rounds its float32 result once)")

LLAMA2_7B = dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
                 ffn_dim=11008, max_seq_len=4096, dtype="bfloat16")
N_REQUESTS = 8
MAX_NEW = 32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_SPIN_CYCLES_PER_MS = []


def spin_cycles(ms: float) -> int:
    """GPU clock cycles that ``torch.cuda._sleep`` spins for ``ms``
    milliseconds on this card (calibrated once with CUDA events)."""
    import torch

    if not _SPIN_CYCLES_PER_MS:
        n = 10_000_000
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(n)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(n / start.elapsed_time(end))
    return int(ms * _SPIN_CYCLES_PER_MS[0])


def time_ms(fn, flush=None) -> float:
    """Device time of one call: median of REPS, CUDA events around the
    call. ``flush`` runs outside the timed region before each call (evicts
    the 50 MB L2). A spin kernel queued ahead of the start event, three
    times longer than the host takes to enqueue the call, keeps the card
    busy meanwhile, so host launch overhead does not count as device time."""
    import torch

    fn()  # warm-up (and any lazy compile)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = spin_cycles(max(3 * enqueue_ms, 1.0))
    times = []
    for _ in range(REPS):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------
def k1_case(b, h, kvh, hd, ps, n_pages, ctx, null_row, seed, flush):
    """Paged-attention decode at one shape: a pool of b * n_pages + 2 pages
    with shuffled page ids, each sequence's positions written up to its
    context, NULL tails in the tables, and optionally one all-NULL row."""
    import torch
    import torch.nn.functional as F

    from seldon_core_tpu_torch.models.transformer import NULL_PAGE, PAD_POS, RESERVED_PAGES
    from seldon_core_tpu_torch.ops.paged_attention import paged_attention, paged_attention_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    P = b * n_pages + RESERVED_PAGES
    k_pool = torch.randn((P, ps, kvh, hd), generator=g, device=dev).to(torch.bfloat16)
    v_pool = torch.randn((P, ps, kvh, hd), generator=g, device=dev).to(torch.bfloat16)
    k_pool[:RESERVED_PAGES] = 0   # NULL/TRASH pages as a fresh pool holds them
    v_pool[:RESERVED_PAGES] = 0
    pos_pool = torch.full((P, ps), PAD_POS, dtype=torch.int32, device=dev)
    perm = torch.randperm(P - RESERVED_PAGES, generator=g, device=dev) + RESERVED_PAGES
    bt = torch.full((b, n_pages), NULL_PAGE, dtype=torch.int32, device=dev)
    used = -(-ctx // ps)
    for i in range(b):
        if i == null_row:
            continue
        pages = perm[i * n_pages:i * n_pages + used]
        bt[i, :used] = pages.to(torch.int32)
        for j in range(used):
            n = min(ps, ctx - j * ps)
            pos_pool[int(pages[j]), :n] = torch.arange(j * ps, j * ps + n, dtype=torch.int32,
                                                       device=dev)
    positions = torch.full((b, 1), ctx - 1, dtype=torch.int32, device=dev)
    q = torch.randn((b, 1, h, hd), generator=g, device=dev).to(torch.bfloat16)
    cache = (k_pool, v_pool, pos_pool)

    before = paged_attention.launches
    out = paged_attention(q, cache, bt, positions)
    torch.cuda.synchronize()
    if paged_attention.launches != before + 1:
        fail("K1 wrapper did not count its launch")
    ref32 = paged_attention_ref(q.float(), (k_pool.float(), v_pool.float(), pos_pool), bt,
                                positions)
    ref_bf16 = paged_attention_ref(q, cache, bt, positions)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"K1 b={b} h={h} kvh={kvh} ctx={ctx}: non-finite output")
    diff = (out.float() - ref32).abs()
    err = diff.max().item()
    if (diff > bf16_ulp(ref32) + K1_ATOL).any():
        fail(f"K1 b={b} h={h} kvh={kvh} ctx={ctx}: max_abs_err {err} beyond 1 bf16 ulp "
             f"+ {K1_ATOL} of the float32 reference")
    # the bf16 plain chain, for information only: it rounds logits and
    # probabilities to bf16 between its matmuls
    err_bf16 = (out.float() - ref_bf16.float()).abs().max().item()
    if null_row is not None and not torch.isfinite(out[null_row].float()).all():
        fail("K1: all-NULL row is not finite")

    ms = time_ms(lambda: paged_attention(q, cache, bt, positions), flush)
    plain_ms = time_ms(lambda: paged_attention_ref(q, cache, bt, positions), flush)
    # library yardstick: SDPA on the gathered logical view (timed only)
    from seldon_core_tpu_torch.models.transformer import gather_paged_view

    k_all, v_all, pos_view = gather_paged_view(cache, bt, q.dtype)
    if kvh != h:  # GQA: repeat kv heads up to the query heads
        k_all = torch.repeat_interleave(k_all, h // kvh, dim=2)
        v_all = torch.repeat_interleave(v_all, h // kvh, dim=2)
    qs = q.transpose(1, 2)                                  # [b, h, 1, hd]
    ks, vs = k_all.transpose(1, 2), v_all.transpose(1, 2)   # [b, h, L, hd]
    mask = (pos_view <= positions)[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

    library_ms = time_ms(sdpa, flush)
    # what this run's data needs: K and V of the ctx attended keys of each
    # live row (none for the all-NULL row, whose output depends on no key),
    # the position rows and table entries of the pages those rows walk,
    # q, the query positions and out; two flops per multiply-add in q.K and p.V
    live = b - (null_row is not None)
    nbytes = (live * ctx * kvh * hd * 2 * 2 + live * used * (ps * 4 + 4)
              + 2 * b * h * hd * 2 + b * 4)
    flops = 4 * live * h * ctx * hd
    bytes_s, flops_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return dict(err=err, err_bf16=err_bf16, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_s, flops_s) * 1e3,
                bound_by="bytes" if bytes_s >= flops_s else "operations")


def bf16_ulp(x):
    import torch

    ax = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(ax)) - 7)


def k2_case(rows, d, seed, flush):
    import torch

    from seldon_core_tpu_torch.ops.fused_norm import fused_residual_rmsnorm, residual_rmsnorm_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
    hh = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)).float()
    eps = 1e-5
    before = fused_residual_rmsnorm.launches
    y, o = fused_residual_rmsnorm(x, hh, w, eps)
    torch.cuda.synchronize()
    if fused_residual_rmsnorm.launches != before + 1:
        fail("K2 wrapper did not count its launch")
    y_ref, o_ref = residual_rmsnorm_ref(x, hh, w, eps)
    if not torch.equal(y, y_ref):
        fail(f"K2 [{rows},{d}]: residual sum y is not bit-equal to the plain version")
    diff = (o.float() - o_ref.float()).abs()
    if (diff > bf16_ulp(o_ref)).any():
        fail(f"K2 [{rows},{d}]: normed output beyond 1 bf16 ulp (max abs {diff.max().item()})")
    ms = time_ms(lambda: fused_residual_rmsnorm(x, hh, w, eps), flush)
    plain_ms = time_ms(lambda: residual_rmsnorm_ref(x, hh, w, eps), flush)
    nbytes = 4 * rows * d * 2 + d * 4          # read x, h; write y, o; weight
    flops = 5 * rows * d
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    return dict(err=diff.max().item(), ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by="bytes")


# ---------------------------------------------------------------------------
# Serving phase
# ---------------------------------------------------------------------------
def post(url: str, body: dict, timeout: float = 600.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def prompts(n: int):
    words = ("tensor page kernel batch decode prefill stream cache token slot "
             "serve model layer head warp block").split()
    out = []
    for i in range(n):
        text, j = f"request {i}:", i
        while len(text) < 120:
            text += " " + words[(j * 7 + len(text)) % len(words)]
            j += 1
        out.append(text[:124])
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "seldon_core_tpu_torch")):
        print("chip_smoke: seldon_core_tpu_torch/ is not beside this script — run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    t_start = time.perf_counter()

    # 1. the card
    card = card_line()
    print(card, flush=True)
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        fail("triton is not installed (K2 is a Triton kernel)")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} triton {triton_version} "
          f"device {torch.cuda.get_device_name(0)} capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build
    from seldon_core_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build_s {time.perf_counter() - t0:.2f} ({card})", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    from seldon_core_tpu_torch.ops.fused_norm import fused_residual_rmsnorm
    from seldon_core_tpu_torch.ops.paged_attention import paged_attention

    # 3. kernel phase
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.fill_(1)

    k1 = {}
    for label, kw in [
        ("ctx160", dict(b=8, h=32, kvh=32, ctx=160)),
        ("ctx2048", dict(b=8, h=32, kvh=32, ctx=2048)),
        ("gqa_ctx2048", dict(b=8, h=32, kvh=8, ctx=2048)),
    ]:
        r = k1_case(hd=128, ps=64, n_pages=32, null_row=7, seed=len(k1), flush=flush, **kw)
        k1[label] = r
        print(f"K1 paged_attention {label} b=8 h={kw['h']} kvh={kw['kvh']} hd=128 ps=64 "
              f"n_pages=32 (row 7 all-NULL): kernel_ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} library_ms "
              f"{r['library_ms']:.4f} max_abs_err {r['err']:.3e} ({K1_TOL_REASON}; "
              f"vs the bf16 plain chain {r['err_bf16']:.3e}) [{card}]", flush=True)
    k2 = {}
    for rows in (8, 256):
        r = k2_case(rows, 4096, seed=rows, flush=flush)
        k2[rows] = r
        print(f"K2 fused_residual_rmsnorm [{rows},4096] bf16: kernel_ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} library_ms null "
              f"max_abs_err {r['err']:.3e} (y bit-equal, o within 1 bf16 ulp) [{card}]",
              flush=True)
    del scratch

    # 4. serving phase
    from seldon_core_tpu_torch.servers.llmserver import LLMServer
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = LLMServer(model="transformer", model_kwargs=dict(LLAMA2_7B, fused_norm=True),
                       init_random=True, param_dtype="auto", continuous_batching=N_REQUESTS,
                       max_new_tokens=MAX_NEW, temperature=0.0, eos_id=-1, seed=0,
                       device="cuda")
    server.load()
    torch.cuda.synchronize()
    print(f"load_s {time.perf_counter() - t0:.2f} (Llama-2-7B widths, 32 layers, random "
          f"bf16 weights) [{card}]", flush=True)
    httpd, _ = start(make_component_app(server, device="cuda"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/ready", timeout=30) as r:
            if r.status != 200:
                fail(f"/ready answered {r.status}")
        texts = prompts(N_REQUESTS)
        # warm-up request (cuBLAS handles, Triton specialisations), not counted
        code, body = post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 4})
        if code != 200:
            fail(f"warm-up request answered {code}: {body}")
        torch.cuda.synchronize()
        server._ttft_times.clear()
        server._decode_step_times.clear()

        paged_attention.launches = 0
        fused_residual_rmsnorm.launches = 0
        results = [None] * N_REQUESTS

        def client(i):
            results[i] = post(url + "/v1/generate", {"prompt": texts[i]})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(N_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        k1_launches = paged_attention.launches
        k2_launches = fused_residual_rmsnorm.launches
    finally:
        httpd.shutdown()
        httpd.server_close()
    for i, res in enumerate(results):
        if res is None:
            fail(f"request {i} did not complete")
        code, body = res
        if code != 200:
            fail(f"request {i} answered {code}: {body}")
        toks = body.get("tokens")
        if not isinstance(toks, list) or len(toks) != MAX_NEW:
            fail(f"request {i}: expected {MAX_NEW} tokens, got {toks!r}")
        if not all(isinstance(t, int) and 0 <= t < LLAMA2_7B["vocab_size"] for t in toks):
            fail(f"request {i}: token ids out of range")
    n_layers = LLAMA2_7B["n_layers"]
    if k1_launches == 0 or k1_launches % n_layers:
        fail(f"K1 launches {k1_launches}: expected a positive multiple of {n_layers} "
             f"(one per layer per decode step)")
    decode_steps = k1_launches // n_layers
    prefill_chunks = N_REQUESTS  # every prompt fits one chunk
    if k2_launches != n_layers * (decode_steps + prefill_chunks):
        fail(f"K2 launches {k2_launches} != {n_layers} x ({decode_steps} decode steps + "
             f"{prefill_chunks} prefill chunks)")
    print(f"launches during the 8-request run: paged_attention {k1_launches} "
          f"({decode_steps} decode steps x {n_layers} layers), fused_residual_rmsnorm "
          f"{k2_launches} ({decode_steps} + {prefill_chunks} forwards x {n_layers} layers)",
          flush=True)

    svc = server._batcher_service
    pages = svc.batcher.page_stats()
    if pages["kv_pages_in_use"] != 0:
        fail(f"pages still held after every request finished: {pages}")
    svc.close()

    # where one decode step's time goes: the host time to enqueue it against
    # its device time by kernel (the batcher's own state, 8 slots riding
    # along). CUDA events cannot time this call: its ~2,000 launches fill
    # the launch queue, so the card waits on the host inside any window.
    b = svc.batcher

    def step():
        with torch.no_grad():
            return server._decode_step_paged(b._caches, b._last_tok, b._next_pos, b._keys,
                                             b._temp, b._block_tables)

    step()
    enqueue = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    step_host_ms = statistics.median(enqueue) * 1e3
    weight_bytes = sum(p.numel() * p.element_size() for p in server._module.parameters())
    # the same step under torch.profiler: device time by kernel
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side rows only (kernels, copies); the host op that launched a
    # kernel reports the same time again as its own
    ops = sorted((e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")),
                 key=dev_us, reverse=True)
    kernel_ms = sum(dev_us(e) for e in ops) / 1e3

    # every served token against a teacher-forced forward over its own
    # request: one batched forward over prompt + served tokens, right-padded
    # (the causal mask keeps the padding out of every earlier position)
    served = [body["tokens"] for _, body in results]
    seqs = [server._tokenizer.encode(texts[i]) + served[i] for i in range(N_REQUESTS)]
    tf_toks = torch.zeros((N_REQUESTS, max(map(len, seqs))), dtype=torch.int64, device="cuda")
    for i, seq in enumerate(seqs):
        tf_toks[i, :len(seq)] = torch.tensor(seq, device="cuda")
    with torch.no_grad():
        tf_logits, _ = server._module(tf_toks)
    # row p - 1 + t of request i predicts its served token t
    rows = torch.stack([tf_logits[i, len(seq) - MAX_NEW - 1:len(seq) - 1]
                        for i, seq in enumerate(seqs)]).float()     # [N, MAX_NEW, vocab]
    picked = rows.gather(2, torch.tensor(served, device="cuda")[:, :, None])[:, :, 0]
    top2 = rows.topk(2, dim=-1).values
    gaps = top2[:, :, 0] - picked
    worst = gaps.max().item()
    print(f"teacher-forced check of all {N_REQUESTS} x {MAX_NEW} served tokens: "
          f"{int((gaps == 0).sum())} are the teacher-forced argmax, worst gap to the top "
          f"logit {worst:.4f} (tie tolerance {TIE_TOL}); median top-1/top-2 margin "
          f"{(top2[:, :, 0] - top2[:, :, 1]).median().item():.4f}, logit std "
          f"{rows.std().item():.3f} [{card}]", flush=True)
    if worst > TIE_TOL:
        i, t = divmod(int(gaps.argmax()), MAX_NEW)
        fail(f"request {i} token {t}: served {served[i][t]} sits {worst:.4f} below the "
             f"teacher-forced top logit (tolerance {TIE_TOL})")
    del tf_logits, rows

    # the batcher's greedy tokens against the private generate() path
    batched = served[0]
    private = server.generate([texts[0]])["tokens"][0]
    t = next((i for i, (a, b) in enumerate(zip(batched, private)) if a != b), None)
    if t is None:
        print("batcher == generate(): greedy tokens equal for request 0", flush=True)
    else:
        ids = server._tokenizer.encode(texts[0]) + batched[:t]
        with torch.no_grad():
            logits, _ = server._module(torch.tensor([ids], device="cuda"))
        row = logits[0, -1].float()
        top = row.max().item()
        gaps = (top - row[batched[t]].item(), top - row[private[t]].item())
        print(f"batcher vs generate(): tokens equal for {t} of {MAX_NEW}, then "
              f"{batched[t]} vs {private[t]}; teacher-forced logit gaps to the top "
              f"{gaps[0]:.4f} / {gaps[1]:.4f} (tie tolerance {TIE_TOL}; logit std "
              f"{row.std().item():.3f})", flush=True)
        if max(gaps) > TIE_TOL:
            fail(f"batcher and generate() diverge at token {t} without a near-tie: "
                 f"{batched} vs {private}")

    ttft = sorted(server._ttft_times)
    steps = sorted(server._decode_step_times)
    step_ms = statistics.median(steps) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"serving: {N_REQUESTS} concurrent requests x {MAX_NEW} tokens in {wall:.3f} s; "
          f"TTFT median {statistics.median(ttft) * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms; "
          f"decode step median {step_ms:.2f} ms = {N_REQUESTS / (step_ms / 1e3):.1f} tok/s "
          f"at {N_REQUESTS} slots; peak device memory {peak_gb:.2f} GB [{card}]", flush=True)
    print(f"decode step at {N_REQUESTS} slots: host enqueue {step_host_ms:.3f} ms, device "
          f"time {kernel_ms:.3f} ms in {sum(e.count for e in ops)} kernels and copies "
          f"(torch.profiler); reading the {weight_bytes / 1e9:.2f} GB of weights alone takes "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms [{card}]", flush=True)
    for e in ops[:10]:
        print(f"  {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:100]}")

    def entry(name, route, source, replaces, launches, r):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": [
        entry("paged_attention", "cuda", "seldon_core_tpu_torch/csrc/paged_attention.cu",
              "seldon_core_tpu/ops/paged_attention.py:253", k1_launches, k1["ctx160"]),
        entry("fused_residual_rmsnorm", "triton", "seldon_core_tpu_torch/ops/fused_norm.py",
              "seldon_core_tpu/ops/fused_norm.py:137", k2_launches, k2[8]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
