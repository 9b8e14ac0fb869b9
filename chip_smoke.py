#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and hold every
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py
    python3 chip_smoke.py --k4-sweep   # only: build, then K4's prefill tiles x splits
    python3 chip_smoke.py --k4-decode-sweep   # only: build, then K4's decode strips x splits
    python3 chip_smoke.py --k1-sweep   # only: build, then K1's splits S at its six shapes
    python3 chip_smoke.py --k3-sweep [rows.json]   # only: build, then K3's tile widths x
                                                   # splits; rows to rows.json
    python3 chip_smoke.py --k2-sweep   # only: build, then K2's threads x slots a row
    python3 chip_smoke.py --prefix     # only: build, then the prefix phase (both models)
    python3 chip_smoke.py --lora       # only: build, then the LoRA, tenant and checkpoint
                                       # phases
    python3 chip_smoke.py --predict    # only: build, the ResNet-50 forward, then the
                                       # predict serving run (REST through TorchServer)
    python3 chip_smoke.py --engine     # only: build, the ResNet-50 forward, then the
                                       # engine phase (and its bf16 7B LLM component)
    python3 chip_smoke.py --remote     # only: build, the ResNet-50 forward, then the
                                       # remote-leaf and micro-batch phases, persistence
                                       # and the host-only servers
    python3 chip_smoke.py --fleet      # only: build, then the replica-fleet phase (its
                                       # [fleet faults] part included)
    python3 chip_smoke.py --disagg     # only: build, then the disaggregation phase
    python3 chip_smoke.py --tracing    # only: build, then the traced parts: [bf16 tracing],
                                       # the fleet phase (its faults traced) and the
                                       # disaggregation phase's traced (a) / (c) runs
    python3 chip_smoke.py --train      # only: build, then the [train] phase and its fuller
                                       # set: 8 layers x 10 steps, {data 2, seq 2, model 2}
                                       # (full and ring attention), the MoE FFN at
                                       # Mixtral-8x7B widths over {expert 2, seq 2, model 2}
    python3 chip_smoke.py --dense      # only: build, then the [dense] runs on their own
                                       # bf16 and int8 loads, the dense handoff (device,
                                       # network), rebalance_disagg, LoRA, a draft, meshes

Phases (any failure exits non-zero; nothing swallows an error):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions,
   TF32 off for float32 matmuls and convolutions;
2. build the kernels from the sources in this checkout (ops/_build.py: one
   nvcc per CUDA source, all started together);
3. kernel phase — each kernel's wrapper on card tensors at the serving
   path's shapes, against its plain version on the same inputs, with its
   time (CUDA events, median of 25), its plain version's, its bound (the
   larger of bytes / 3.35 TB/s and flops / 989 TFLOP/s) and, where one
   PyTorch call computes the same function, that call's: K1 paged attention
   over a bf16 and an int8 pool (at the split S its plan picks; one call
   must put one kernel and nothing else on its stream, counted from a CUDA
   graph of the call, whose replay must agree too), and at the speculative
   verify's folded rows (8 sequences x 5 columns = 40 rows, ctx 160), timed
   in turns with the JAX package's verify read (gather each sequence's
   whole table, then the masked einsum chain), K2 fused
   residual + RMSNorm at [8, 40, 128 and 256, 4096] and [8 and 128, 2048] bf16 (one
   launch, one CTA
   a row at its plan; one call must be one kernel node of a CUDA graph,
   whose replay and a second call must give the same bits; timed in turns
   with a trivial kernel, ``out.zero_()``, which gives the timing floor,
   and, for information, the two library calls ``x + h`` then
   ``F.rms_norm``; its host enqueue per call; and what one call adds to a
   dense stream after the product that makes h, cuBLAS in bf16 and K4 in
   int8, in CUDA graphs, beside a trivial kernel),
   K4 the int8
   GEMM at every decode shape of the int8 7B model (the decode kernel; one
   call must put one kernel and nothing else on its stream, counted from a
   CUDA graph of the call whose replay must give the same bits, and two
   calls must give the same bits; M = 40 is the speculative verify's 8
   slots x 5 columns) and at 128- and 256-row prefill chunks
   of wq, w1, w2 and the lm_head (the prefill kernel, TMA + wgmma; a CUDA
   graph of one call must hold it and, where its plan splits K, the
   split-K reduce, and its replay and a second call must give the same
   bits; timed in turns with the decode kernel
   called through its own entry point at the same shape and with the
   library call), K3 the folded-BN identity bottleneck chain at the four
   ResNet-50 chains at batch 128 and at the served batches 8 and 1, at its
   plan's tile widths and splits (each conv an implicit GEMM on TMA +
   wgmma, K split at the small batches; its launches as
   ``expected_launches`` says; one call captured in a CUDA graph must hold
   exactly those kernel nodes, and its replay must agree too), timed in
   turns with, for information, the eager cuDNN chain of the same blocks
   (several PyTorch calls);
[train] (``train_phase``, lines ``[train] ...``), after the kernel phase:
   the port's training path at Llama-2-7B widths on the one card, float32
   master weights, bf16 compute, fused_norm=True, batch 2 x 2,048,
   adamw(1e-4) with optax's defaults. (a) 4 layers: the graph-cut check
   (one step's gradients through K2 under autograd, every leaf finite and
   non-zero and within TRAIN_GRAD_RTOL (relative, Frobenius) of the same
   step through K2's plain version on the same tensors), K2's explicit
   backward on
   layer 0's saved input against autograd through the plain version, then
   5 steps on one batch (counts zeroed just before, read just after: K2 one
   a layer a forward, no other kernel; the loss falls), the step wall,
   tokens/s, peak memory and one profiled step's device split; (b) 2
   layers with ring attention over a co-located {seq 2, model 2} mesh: one
   step's loss and grad_norm against the unsharded step's; (c) GPipe over
   {pipe 2}, two 7B-wide blocks as stages, 4 microbatches: bit-equal to the
   stages applied in order, within TRAIN_PIPE_RTOL of the whole batch at
   once; K2 at the training shape [4096, 4096] bf16 with a float32 weight,
   timed beside its plain version and its bound; nothing left allocated.
4. serving phase — the port's REST server in-process on an ephemeral
   port, an LLMServer at Llama-2-7B widths and depth (random weights from a
   seed, fused_norm=True, paged continuous batching over 8 slots), five
   runs: in bf16 with the eager prefill and decode programs (the batcher's
   private ``_eager`` switch, for comparison), through the graphs (every
   prefill chunk one replay of the CUDA graph of its chunk length, 32, 128
   or 256; every decode dispatch one replay, K = 1) and with
   decode_fuse_steps=FUSED_K (decode graphs of K = 1 and K = 8) on the
   same loaded weights; then, once bf16 is freed, with quantize="int8" and
   kv_cache_dtype="int8", eager and through the graphs. Each batcher is
   built (its graphs warmed up and captured) under
   ``set_sync_debug_mode("error")``; the graph pools' memory is read from
   the allocator's snapshot. Each run serves 8 concurrent POST
   /v1/generate requests (one chunk of 128 each), then a mixed admission
   (prompts of about 600, 24 and 124 tokens: three chunks of 256, one of
   32, one of 128). Around each set of requests every kernel's launch
   count and the server's prefill counters are zeroed just before and
   read just after (a replay adds what its capture counted): each kernel
   of the path must have run its expected number of times (K2 once a
   layer a forward; int8: K4 225 times a forward, on its prefill kernel
   for a chunk of 64 rows or more, on its decode kernel otherwise), and
   every chunk must have been a graph replay (or, eager, an eager run).
   Every served token is held against a teacher-forced prefill over its
   request's prompt and served tokens through the same KV numerics (within
   TIE_TOL of the top logit at every step), and one prompt is re-run
   through the private generate() and must give the same greedy tokens up
   to the first near-tie; TTFT, step wall, tok/s, the host time per
   dispatch, peak memory and the graph pools' memory are printed. After
   each graph run the served prompts are admitted again (loop stopped)
   and, on that live state, one replay of each captured decode program
   must be bit-equal (tokens, pools, state) to the same program run
   eagerly from identical copies; then the eager step's host enqueue and
   torch.profiler trace (exactly one K1 and one K2 kernel per layer, 225
   K4 decode kernels in int8 and no split-K reduce; K2's device time and
   the idle gap before it) against each replay's host time, its device
   time from CUDA events, and its trace (the same kernels k times over).
   Then, per chunk length, a first and a later chunk on fresh pages of
   the live pool: each replay must be bit-equal (logits, every pool
   tensor) to the eager program from identical copies, one call and one
   replay must launch what the path expects, and the chunk's host time
   (eager enqueue against replay) and device time (CUDA events around the
   replay against the profiler's kernel sum) are printed. In each model's
   graph run (K = 1) the private generate() path too (``generate_phase``):
   the 8 texts greedy through the eager switch and through the decode
   step's CUDA graph of (8, 160), bit-equal, every decode step a replay
   and every call's K2 / K4 launches as expected (they join the kernel
   table's counts); per-step wall, call wall, capture time, the dense
   buffer's and the generate pool's memory; the step's replay against the
   eager step on live state (host and device time; the graph's kernel
   nodes by name); a call under another key and the first again, each
   bit-equal to the eager switch and to a fresh buffer; a sampled call
   (temperature 0.7, seed 11) bit-equal to eager; and two generate()
   requests over REST while the batcher serves the 8, each answering its
   solo tokens. In each graph run (bf16, bf16 K = 8, int8) the streaming
   phase (``stream_phase``): N_REQUESTS concurrent SSE clients on the
   run's prompts, each read event by event (launch counts zeroed before,
   read after): each stream's token events equal its done tokens and pass
   the teacher-forced check, every chunk and every decode dispatch is a
   replay (``_prefill_replays``, ``_decode_replays``, none eager), one
   /metrics scrape counts a TTFT a request and an inter-token gap a
   credited token less one a request, and its page gauges equal
   ``page_stats()``; a client that closes its socket after 4 events leaves
   the loop alive (the handler's failed write counted as a 500) with every
   page returned, and the next request is answered. Printed: the client's
   time to first event beside the server's TTFT, the inter-event gap beside
   the step wall, the events a burst, the streamed step beside the run's
   non-streamed one, one client's arrival times. In the bf16 graph run also
   the 1-slot stream service (built with its own graphs: capture time,
   pools; one stream through it, teacher-forced) and one gRPC
   Model/GenerateStream, whose events must equal SSE's (only a missing
   grpcio or protobuf skips it, saying so). The int8 run's
   device memory after load() must stay under INT8_LOAD_PEAK_GB: the int8
   weights plus one float32 leaf. Speculative decoding (``spec_phase``, K =
   SPEC_K = 4): (a) a ContinuousBatcher(spec_mode="ngram") on the loaded
   bf16 server and (b) on the int8 one, then a bf16 server loaded beside
   (c) a draft configured like the target (the perfect drafter) and (d) a
   TinyLlama-1.1B-wide draft, both with batcher max_len SPEC_MAX_LEN and a
   plain graph run first. Each serves the 8 requests through REST (counts
   zeroed just before, read just after): every verify dispatch a replay
   of the batcher's one spec graph; K1 one launch a layer a verify (its K
   + 1 columns folded into rows), K2 one a layer of every forward and
   draft prefill, K4 one a product; tokens teacher-forced and equal to the
   plain batcher's up to a near-tie; (c) accepting at least
   SPEC_PERFECT_ACCEPT. On live state a replay at full and at mixed caps
   is bit-equal to the eager program (tokens, advance, state, history,
   draft caches, pools but the TRASH page), and the graph's kernel nodes
   and a replay's launches are as expected. Printed: acceptance, tokens a
   forward, draft overhead, the step per dispatch and per token beside the
   plain step, the replay's host and device time beside the eager
   program's, the spec graph's pool, peak memory, and with a draft its
   forwards' share of the step. [dense] (``dense_phase``, after the
   n-gram run on the same server): kv_cache_layout="dense" through the
   graph batcher at the default max_len, bf16 at K = 1, K = FUSED_K and
   n-gram, int8 weights + int8 KV at K = 1: the N_REQUESTS prompts over
   REST; every dispatch a replay, each admission one eager prefill into
   its slot's row, no K1, K2 one a layer a forward, K4 one a product a
   forward (the admissions' on the prefill route); tokens teacher-forced
   and equal to the paged run's up to a near-tie; on live state each
   replay bit-equal to the eager program (every slot row but the trash
   column); nothing left allocated after the service stops; the step and
   replay device time beside the paged step. The radix prefix cache (``prefix_phase``),
   once on a bf16 server and once on int8 weights + int8 KV, each loaded
   with prefix_cache_size=PREFIX_CACHE_SIZE and a dense budget of one 7B
   entry: N_REQUESTS conversations x PREFIX_TURNS turns over a
   PREFIX_SYSTEM-token system prompt (PREFIX_USER user tokens a turn,
   MAX_NEW answered) through REST, conversation 0's turn 1 alone, then the
   other turns 1 at once, then turns 2 and 3 of all at once, through a
   trie-on batcher and then the same requests through a trie-off one
   (counts zeroed before each, read after): the trie's hit tokens, hit
   blocks, CoW copies and bytes saved equal the traffic's arithmetic; every
   chunk (only the uncached suffixes' with the trie on) and every CoW copy
   a replay; launches as the steps and chunks give them; tokens
   teacher-forced and equal to the trie-off run's up to a near-tie; one
   scrape's prefix series equal ``llm_stats``; after the chat the pages in
   use are the trie's, none after ``clear_prefix_cache()``; one CoW replay
   on live pools bit-equal to the eager copy (positions PAD_POS past
   n_valid, the source untouched), both timed; then generate()'s dense
   entries: a 1,088-token prompt cold, again (an exact hit: no prefill
   forward, tokens bit-equal, the entry unchanged by the decode graph), and
   extended by PREFIX_DENSE_EXTRA tokens (a partial hit through
   ``_get_extend``, equal to a cache-cleared call up to a near-tie).
   Printed: TTFT per turn trie on vs off, chunks, peak pages, bytes saved,
   the CoW replay's host and device time beside the eager copy's, each
   dense call's prefill time and wall. Batched LoRA (``lora_phase``), on a
   bf16 server and on int8 weights + int8 KV, each at full depth with
   three random rank-LORA_RANK adapters written as ``adapter.json`` +
   ``weights.npz`` (numpy, seeded) and preloaded from file:// URIs, a pool
   of LORA_MAX rows: the plain graph batcher on the same weights first (the
   registry set aside), then the adapted one, N_REQUESTS requests over REST
   (two a adapter, two base, each with a Seldon-Tenant): every chunk and
   dispatch a replay, launches as the plain path's, every token
   teacher-forced through its adapter, each request equal to itself alone
   and the base requests to the plain batcher's up to a near-tie; a fourth
   adapter loaded while requests decode (an evict of a pinned one refused)
   leaves their tokens as the run without the load; the scrape's
   ``seldon_llm_adapter_*`` equal ``llm_stats``; on live state an adapted
   chunk replay and an adapted decode replay bit-equal to the eager adapted
   programs, their kernel nodes equal to their launches; the decode step's
   LoRA work alone as one CUDA graph (nodes, device time, kernels by name
   from torch.profiler). Printed: the adapted step beside the plain one,
   the graphs' nodes, the pool's bytes, TTFT, peak memory. Then the tenant
   phase (``tenant_phase``) on the bf16 LoRA server: TENANT_FLOOD
   batch-class requests from one tenant queued, one more over its quota
   (503 + Retry-After), then interactive requests from another tenant while
   a batch job is staged: a staged job preempted, the batch tokens equal to
   a run without interactive traffic, the scrape's tenant series and TTFT
   counts by class equal to the run's; interactive and batch TTFT printed.
   Inside the bf16 serving phase, after its graph runs, the tracing phase
   (``tracing_phase``, lines ``[bf16 tracing] ...``) on the same loaded
   weights: a plain and a traced graph batcher (``tracing=True``: a flight
   recorder) take the 8 requests over REST in turns, each with a sampled
   W3C ``traceparent``, their admission gated so each turn runs one
   schedule: tokens bit-equal (greedy, then seeded at T = 0.8), K1 / K2
   launches equal, every chunk and dispatch a replay; each timeline's trace
   id, token count, chunk events and TTFT exact; two unsampled requests
   kept by the tail threshold; SSE ``X-Trace-Id`` and gRPC ``x-trace-id`` =
   the done event's trace id; REST ``/debug/timeline`` = gRPC
   ``DebugTimeline``; one span tree a retained request at an OTLP collector
   on 127.0.0.1, no span dropped. Printed: the decode step wall and the
   host time a dispatch, traced against plain.
   Then the checkpoint phase (``checkpoint_phase``): a 7B-width model and a
   TinyLlama-1.1B-width draft, both cut to CKPT_LAYERS layers, written with
   the port's ``export_checkpoint`` and served by ``model_uri`` (tokens ==
   ``load(params=...)``), by ``quantize="int8"`` from the same directory
   (load peak checked; tokens == the int8 ``load(params=...)``) and with the
   draft from ``draft_model_uri`` (== ``draft_params`` bit for bit); the
   load times and the bytes read printed;
5. ResNet-50 forward phase — the folded model at full width and depth
   (random live weights from a seed: no residual branch is switched off),
   a forward at batch 128 through K3 (its launches: the four chains'
   ``expected_launches``) against the same weights through the cuDNN chain
   (pallas_stages=()), within FWD_TOL of max|logit|, top-1 equal but for
   near-ties; device time and host enqueue per forward both ways, in turns,
   at batch 128 and at a served batch of 8; images/s, peak device memory;
6. predict serving phase — the same weights written with the port's
   export_checkpoint(use_orbax=False), a TorchServer built as the CLI builds
   it (PREDICTIVE_UNIT_PARAMETERS, device="cuda"), the port's REST server
   in-process: 4 concurrent POST /api/v0.1/predictions of 8 images (tensor
   encoding) and one POST /predict (ndarray). Every response is 200 with
   the JAX package's names and meta, its logits within FWD_TOL of the
   cuDNN-chain forward on the same images (and of the in-process K3
   forward); K3's launches, zeroed just before
   the requests and read just after, are exactly what ``expected_launches``
   gives for four forwards at batch 8 and one at batch 1;
7. engine phase (``engine_phase``; lines ``[engine] ...``) — the graph
   engine (``runtime/engine.GraphEngine`` behind the engine app) over two
   live ResNet-50 JAX_SERVER leaves (the forward phase's weights and a
   second seed, each from a msgpack checkpoint): (a) an AVERAGE_COMBINER of
   the two, fused into one composed call on the card, serving 4 concurrent
   requests of 8 images and one of 1 (every response 200 with its puid and
   the three units in requestPath, logits within FWD_TOL of the mean of the
   two cuDNN-chain forwards, one fused run a request, K3 launched 2 x
   ``expected_launches`` a request; the same requests through an unfused
   engine over the same servers within ENGINE_FUSE_TOL; the latency beside
   the component app's on one leaf, concurrent and then one request at a
   time in turns; the fused call's device time beside two single
   forwards); (b) a seeded EPSILON_GREEDY router over the two:
   24 one-image predictions with feedback for the first 16 (routes = a
   fresh seeded router's on the host, its counts = the rewards'
   arithmetic, K3 launched for the routed leaf alone, the scrape's request
   and feedback series); (d) /pause, /unpause, /ready, a spent
   ``Seldon-Deadline-Ms`` (504) and gRPC ``Seldon/Predict`` equal to REST.
   Its (c) runs inside the bf16 serving phase (``engine_llm_phase``, line
   ``[bf16 engine] ...``): the loaded 7B server as a one-unit graph's
   component, one jsonData predict through the engine app giving the
   server's own component-app tokens, K1 and K2 launched, the LLM series
   on the engine's /metrics;
8. remote, micro-batch, persistence and servers (``remote_phase``,
   ``persistence_phase``, ``servers_phase``; lines ``[remote] ...``,
   ``[persistence] ...``, ``[servers] ...``) — the forward phase's
   ResNet-50 as one TorchServer behind the port's component app and gRPC
   component server on 127.0.0.1: (a) engines whose leaf is local, a REST
   endpoint and a GRPC endpoint, 4 concurrent requests of 8 images each
   (remote logits equal to the local engine's, tolerance 0; meta equal but
   the unit's image; K3 launched ``expected_launches`` a forward in this
   process), the REST hop beside the local leaf one request at a time in
   turns, and the failures: 503 REMOTE_NODE_UNAVAILABLE from a closed port
   after the backoffs and after exactly ``retries`` connections to a
   listener that closes each, 504 with no connection for a spent
   ``Seldon-Deadline-Ms``; (b) ``MicroBatcher(max_batch=8)`` behind the
   engine app, 8 one-image requests at once: one flush of 8 rows, K3 one
   B = 8 forward's launches, each answer within FWD_TOL of its solo
   answer; (d) the engine phase's seeded router snapshot through
   ``FileStateStore`` and restored, its next 24 routes equal to the
   router's that carried on; the prepackaged host-only servers: the
   libraries this machine has, an SKLEARN_SERVER leaf equal to
   ``predict_proba`` where joblib and sklearn are here, a clean load error
   naming each absent library.
   The replica fleet (``fleet_phase``, lines ``[fleet] ...``) runs after
   the LoRA phases: two Llama-2-7B replicas (int8 weights from one seed,
   bf16 KV, the prefix cache on) behind one ``ReplicaSet`` on the
   component app, 8 conversations x 3 turns over two 1,024-token system
   prompts: every pick the longest cached prefix, then the least load,
   then the lowest index (each probe recorded), turns 2 and 3 on a replica
   holding their system prompt, both replicas serving, every chunk and
   dispatch a replay, tokens teacher-forced and equal to one server's run
   up to a near-tie, the scrape equal to the merged ``llm_stats``, gRPC
   GenerateStream equal to SSE, ``ReplicaSet.generate`` equal to each
   replica's own, and a drain / collect / add cycle with a request in
   flight. Its ``[fleet faults]`` part (``fleet_faults``) then kills the
   busiest replica mid-decode under 8 SSE streams, greedy ((a)) and
   seeded at temperature 0.8 ((b), on batchers rebuilt at that
   temperature): every stream complete with one ``resumed`` event where
   the survivor took over, equal to the survivor's unfaulted run up to a
   near-tie, teacher-forced (the seeded draw with the fast-forwarded key),
   the victim ejected with every page released, every re-admission and
   decode a replay; (c) a half-open probe on the fleet's FaultClock
   restarts the victim's loop on a new thread over its captured graphs and
   reinstates it, with the survivor's tokens and every page back; (d) a
   kill with the retry budget spent answers 503 with ``Retry-After``. The
   part runs with the tracer on, its batchers rebuilt with flight
   recorders: no timeline left open on either replica, each resumed
   request's victim timeline completed "error" and its survivor timeline
   with one ``resume`` event of the delivered tokens, ``llm.resume`` in its
   trace; the split of kill -> resumed printed (``fault_timelines``).
   The disaggregation phase (``disagg_phase``, lines ``[disagg ...]``) runs
   after the fleet: Llama-2-7B at full width and depth through the
   component app's ``/v1/generate``, local chunked prefill against prefill
   workers on this card (their own threads, streams, staging pools and
   chunk graphs, the server's weight tensors): (a) 8 prompts of mixed
   length (two over 1,024 tokens), bf16, one worker — TTFT, the decode step
   gap while the admissions run, the handoff walls, bytes a handoff, the
   workers' staging and graph pools, the import's device time, host time
   and launches beside two CUDA-graph forms of it measured for comparison;
   (c) the same over the network transport on 127.0.0.1 —
   frame bytes, encode / decode time, the scraped network bytes; (b) 8
   streams decoding, then a burst of 4 prompts of ~2,000 tokens (12
   slots), local and with 1 and 2 workers, each setting in 2 rounds — the
   gap before and during the burst, the burst's TTFT, per round; (e) 4 chats over a 1,024-token system prompt
   with the trie on — chunks a stage (the suffix only), hit tokens; (d)
   int8 weights and KV. Tokens equal to local up to a near-tie (teacher
   forced in (a)), every chunk a worker's replay, launches as the chunks
   say, every page back. The remote runs of (a) and (c) are traced: every
   timeline's handoff events in order, and the handoff's split printed
   (``handoff_split``).

The line before the last is the kernel table as JSON (K1 over a bf16 pool,
K1 over an int8 pool, K2, K2 at the training shape (its launches the
[train] phase's), K3, K4's decode kernel, K4's prefill kernel; K2's
launches are every LLM run's together (the speculative, prefix, LoRA,
tenant, checkpoint, fleet and disaggregation phases' and the engine's LLM
request included, and the [train] phase's; the workers' chunk replays count
as every replay does), K3's
the predict serving run's and the engine, remote and
micro-batch phases');
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
port's package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

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
K1_TOL_REASON = ("vs the plain version on float32 copies of the inputs (an int8 pool "
                 f"dequantized in float32): within 1 bf16 ulp + {K1_ATOL} (the kernel "
                 "rounds its float32 result once)")
# K4 is held against its plain version x.float() @ (q.float() * scale):
# within K4_RTOL * (|x| @ |q * scale|) elementwise — the reach of float32
# summation order over K terms — plus one bf16 ulp for a bf16 output.
K4_RTOL = 1e-5
K4_TOL_REASON = (f"vs the plain version: within {K4_RTOL} * (|x| @ |q*scale|) elementwise "
                 "(float32 summation order), + 1 bf16 ulp for bf16 out")
# K3 is held against its plain version (float32 sums of the same bf16
# products, rounded at the same hand-offs): the two sum in different
# orders, so a hand-off may round to the neighbouring bf16 and carry into
# later blocks; within n_blocks bf16 ulps of max|plain| elementwise.
K3_TOL_REASON = ("vs the plain version: within n_blocks bf16 ulps of max|plain| elementwise "
                 "(float32 sums in another order: a hand-off may round to the neighbouring "
                 "bf16, once per block)")
# ResNet-50 chains at batch 128: (H = W, C, F, identity blocks)
RESNET50_CHAINS = [(56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 5), (7, 2048, 512, 2)]
RESNET_BATCH = 128
K3_BLOCKS = sum(n for *_, n in RESNET50_CHAINS)
# Whole ResNet-50: the K3 forward against the cuDNN forward on the same
# weights. The two round differently (K3 rounds acc + bias once, cuDNN the
# conv and then a bf16 bias add) through 12 blocks; logits within FWD_TOL of
# max|logit|, top-1 equal wherever the reference's top two are further apart
# than that.
FWD_TOL = 0.03
PREDICT_REQUESTS = 4
PREDICT_BATCH = 8
# int8 weights (6.74 GB at 7B) plus one float32 leaf (the 0.52 GB embedding)
INT8_LOAD_PEAK_GB = 8.0

LLAMA2_7B = dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
                 ffn_dim=11008, max_seq_len=4096, dtype="bfloat16")
N_REQUESTS = 8
MAX_NEW = 32
# decode steps per dispatch in the fused serving run (decode_fuse_steps)
FUSED_K = 8
# the chunk lengths the 7B batcher's admissions produce (its defaults:
# buckets 32/128/512/2048, chunks of 256), one prefill graph each
PREFILL_CHUNKS = (32, 128, 256)
# the mixed admission: prompts of about 600, 24 and 124 tokens, run as three
# chunks of 256, one of 32 and one of 128
MIXED_LENGTHS = (600, 24, 124)
MIXED_CHUNKS = (256, 256, 256, 32, 128)
# K4 launches per forward of the int8 model: 7 projections x 32 layers +
# the lm_head
K4_PER_FORWARD = 7 * LLAMA2_7B["n_layers"] + 1


def k4_per_forward(cfg) -> int:
    """K4 launches of one int8 forward of the model ``cfg``: per layer wq,
    wk, wv and wo, then w1, w3 and w2 (of each expert in an MoE layer), and
    the lm_head (K4_PER_FORWARD at Llama-2-7B)."""
    return cfg.n_layers * (4 + 3 * max(cfg.n_experts, 1)) + 1

# speculative decoding: drafts a verify step, and the verify's rows at the 8
# slots (K + 1 columns each, folded into rows of one K1 call)
SPEC_K = 4
SPEC_ROWS = N_REQUESTS * (SPEC_K + 1)
# the draft-model runs' batcher max_len: the dense draft cache holds 8 slots
# x (max_len + 1) positions (at the default 4,128 a 7B-wide draft's would
# take 17.3 GB)
SPEC_MAX_LEN = 512
# the second draft: TinyLlama-1.1B's published widths (its config.json;
# Llama-2's tokenizer and vocab), random weights
TINYLLAMA_1B = dict(vocab_size=32000, dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
                    ffn_dim=5632, max_seq_len=2048, dtype="bfloat16", fused_norm=True)
# the perfect drafter (a copy of the target) must verify nearly every draft:
# only a near-tie between the dense draft read and the paged verify may
# reject one
SPEC_PERFECT_ACCEPT = 0.9
# the prefix phase: N_REQUESTS conversations x PREFIX_TURNS turns over a
# PREFIX_SYSTEM-token system prompt common to all, PREFIX_USER user tokens a
# turn, MAX_NEW answered; conversation 0's turn 1 alone (cold, it fills the
# trie), then the other turns 1 at once, then each later turn of all at once
PREFIX_SYSTEM = 1024
PREFIX_USER = 64
PREFIX_TURNS = 3
PREFIX_GROUPS = ([(0, 0)], [(c, 0) for c in range(1, N_REQUESTS)],
                 *([(c, t) for c in range(N_REQUESTS)] for t in range(1, PREFIX_TURNS)))
PREFIX_ORDER = [key for group in PREFIX_GROUPS for key in group]
PREFIX_CACHE_SIZE = 64
# generate()'s dense entries at 7B span the top length bucket + MAX_NEW
# positions (1.09 GB in bf16: the 512 MB default budget caches nothing);
# the phase's budget holds one; the partial hit extends the prompt by
PREFIX_ENTRY_POSITIONS = 2048 + MAX_NEW
PREFIX_DENSE_EXTRA = 96
# batched LoRA: three random adapters of rank LORA_RANK in a pool of
# LORA_MAX rows (the identity row included), two requests each and two base;
# A ~ N(0, 1 / d_in) and B ~ N(0, LORA_B_STD^2) at alpha LORA_ALPHA put a
# delta at about a fifth of its base projection
LORA_RANK = 8
LORA_MAX = 8
LORA_ALPHA = 16
LORA_B_STD = 0.05
LORA_NAMES = ("acme-support", "globex-legal", "initech-code")
LORA_MIDRUN_TRIES = 3   # runs allowed for the mid-run adapter load to overlap decoding
# the tenant phase: a flood of batch-class requests (three prefill chunks
# each, so a staged job spans loop turns) and a few interactive ones
TENANT_FLOOD = 16
TENANT_INTERACTIVE = 4
TENANT_PROMPT = 600
# the checkpoint phase's depth cut: a 32-layer 7B bf16 tree is 13.5 GB on
# disk and the msgpack reader holds the whole file and its leaves in host
# memory at once
CKPT_LAYERS = 4


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


def time_turns(fns, flush=None):
    """Device time of one call of each of ``fns``, measured in turns (one
    call of each per round, REPS rounds): the median per function, CUDA
    events around each call, and the host time to enqueue one call
    (after a warm-up). ``flush`` runs outside the timed region before each
    call (evicts the 50 MB L2). A spin kernel queued ahead of the start
    event, three times longer than the host takes to enqueue the call,
    keeps the card busy meanwhile, so host launch overhead does not count
    as device time. Returns [(ms, enqueue_ms)] in the order of ``fns``."""
    import torch

    spins, enqueue = [], []
    for fn in fns:
        fn()  # warm-up (and any lazy compile)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        spins.append(spin_cycles(max(3 * enqueue[-1], 1.0)))
    times = [[] for _ in fns]
    for _ in range(REPS):
        for fn, spin, ts in zip(fns, spins, times):
            if flush is not None:
                flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [(statistics.median(ts), e) for ts, e in zip(times, enqueue)]


def time_ms(fn, flush=None) -> float:
    """Device time of one call (``time_turns`` of one function)."""
    return time_turns([fn], flush)[0][0]


def enqueue_turns(fns, n=200):
    """Host time to enqueue one call of each of ``fns``: the median over
    ``n`` rounds, one call of each per round in turns, the card drained
    between rounds (after a warm-up call of each)."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(n):
        for fn, ts in zip(fns, times):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return [statistics.median(ts) for ts in times]


STREAM_PAIRS = 32   # one per layer of the 7B model
_CAPTURE_STREAM = []


def stream_added_ms(product, fns):
    """What one call of each of ``fns`` adds to a dense stream of work, as a
    decode step captured in a CUDA graph would run it (no host gap between
    launches): a graph of STREAM_PAIRS pairs, each a product h = product()
    (as the wo projection makes K2's h) followed by one call fn(h), beside a
    graph of the products alone. The graphs are replayed
    REPS times in turns, CUDA events around each replay. Returns (the median
    of each graph's replay less the products' alone, over STREAM_PAIRS; the
    product's own time), in ms: a call's own time plus the idle gap its
    launch leaves after the product, less what it runs early."""
    import torch

    if not _CAPTURE_STREAM:
        # one side stream for every capture: cuBLAS keeps a workspace for
        # each stream it has run on, for the life of the process
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    stream = _CAPTURE_STREAM[0]
    graphs = []
    for fn in [None, *fns]:
        def body(fn=fn):
            for _ in range(STREAM_PAIRS):
                hh = product()
                if fn is not None:
                    fn(hh)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            body()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            body()
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()
    times = [[] for _ in graphs]
    for _ in range(REPS):
        for g, ts in zip(graphs, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    base = statistics.median(times[0])
    for g in graphs:
        g.reset()   # frees the graph and its memory pool now
    return ([(statistics.median(ts) - base) / STREAM_PAIRS for ts in times[1:]],
            base / STREAM_PAIRS)


# cuGraphNodeGetType's CUgraphNodeType values (cuda.h)
GRAPH_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
                    "event_record", "ext_semas_signal", "ext_semas_wait", "mem_alloc",
                    "mem_free", "batch_mem_op", "conditional")


def cu_check(rc, what):
    if rc != 0:
        fail(f"libcuda: {what} returned CUresult {rc}")


def graph_node_list(graph):
    """(node handle, node type) of every node of ``graph``, a
    torch.cuda.CUDAGraph captured with keep_graph=True, read with
    cuGraphGetNodes and cuGraphNodeGetType from libcuda."""
    import ctypes

    libcuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    cu_check(libcuda.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    cu_check(libcuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        cu_check(libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)),
                 "cuGraphNodeGetType")
        out.append((node, GRAPH_NODE_TYPES[t.value] if 0 <= t.value < len(GRAPH_NODE_TYPES)
                    else str(t.value)))
    return out


def graph_kernel_names(graph):
    """The function name (mangled, as the driver holds it) of every kernel
    node of ``graph`` (as ``graph_node_list``), from
    cuGraphKernelNodeGetParams and cuFuncGetName (cuKernelGetName where
    the node holds a library kernel and no function)."""
    import ctypes

    libcuda = ctypes.CDLL("libcuda.so.1")

    class Params(ctypes.Structure):   # CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)
        _fields_ = ([("func", ctypes.c_void_p)]
                    + [(f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz", "smem")]
                    + [(f, ctypes.c_void_p) for f in ("params", "extra", "kern", "ctx")])

    names = []
    for node, kind in graph_node_list(graph):
        if kind != "kernel":
            continue
        p = Params()
        cu_check(libcuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)),
                 "cuGraphKernelNodeGetParams_v2")
        name = ctypes.c_char_p()
        if p.func:
            cu_check(libcuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)),
                     "cuFuncGetName")
        else:
            cu_check(libcuda.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)),
                     "cuKernelGetName")
        names.append(name.value.decode())
    return names


def node_counts(names):
    """(K2, K4 prefill route, K4 decode route, K1) among kernel names
    (``graph_kernel_names``), in the order of ``launches_of``."""
    return tuple(sum(key in n for n in names) for key in (
        K2_KERNEL, "int8_matmul_wgmma_kernel", "int8_matmul_decode_kernel",
        "paged_attention_decode_kernel"))


def graph_nodes(fn):
    """Every operation one call of ``fn`` puts on its stream: the call is
    captured in a CUDA graph (after a warm-up call on the capture stream,
    so that lazy set-up stays out of the graph) and the graph's nodes are
    read back (``graph_node_list``). A call that synchronises with the host
    fails the capture. Returns (node types, the output of one replay of the
    graph)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=stream):
        out = fn()
    types = [kind for _, kind in graph_node_list(g)]
    g.replay()
    torch.cuda.synchronize()
    return types, out.clone()


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------
def k1_inputs(b, h, kvh, hd, ps, n_pages, ctx, null_row, seed, kv="bf16"):
    """Paged-attention decode inputs at one shape: a pool of b * n_pages + 2
    pages with shuffled page ids, each sequence's positions written up to
    its context, NULL tails in the tables, and optionally one all-NULL row.
    ``kv="int8"`` stores the pool as the int8 write path does (the 5-tuple,
    quantized per position and kv head). Returns (q, cache, the cache on
    float32 copies, tables, positions, pages each live row uses)."""
    import torch

    from seldon_core_tpu_torch.models.transformer import (NULL_PAGE, PAD_POS, RESERVED_PAGES,
                                                          quantize_kv)

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
    if kv == "int8":
        cache = (*quantize_kv(k_pool), *quantize_kv(v_pool), pos_pool)
        cache32 = cache          # the plain version dequantizes in q's dtype
    else:
        cache = (k_pool, v_pool, pos_pool)
        cache32 = (k_pool.float(), v_pool.float(), pos_pool)
    return q, cache, cache32, bt, positions, used


def k1_check(label, out, ref32):
    """K1's tolerance: within one bf16 ulp + K1_ATOL of the float32 plain
    version, finite. Returns the max abs error."""
    import torch

    if not torch.isfinite(out.float()).all():
        fail(f"{label}: non-finite output")
    diff = (out.float() - ref32).abs()
    err = diff.max().item()
    if (diff > bf16_ulp(ref32) + K1_ATOL).any():
        fail(f"{label}: max_abs_err {err} beyond 1 bf16 ulp + {K1_ATOL} of the float32 "
             f"reference")
    return err


def k1_case(b, h, kvh, hd, ps, n_pages, ctx, null_row, seed, flush, kv="bf16"):
    """K1 at one shape, at the split its plan picks: checked against the
    plain version, one call one kernel (``graph_nodes``), timed beside the
    plain version and SDPA."""
    import torch
    import torch.nn.functional as F

    from seldon_core_tpu_torch.models.transformer import gather_paged_view
    from seldon_core_tpu_torch.ops.paged_attention import (_split_plan, paged_attention,
                                                           paged_attention_ref)

    q, cache, cache32, bt, positions, used = k1_inputs(b, h, kvh, hd, ps, n_pages, ctx,
                                                       null_row, seed, kv)
    counter = "launches_int8" if kv == "int8" else "launches"
    splits = _split_plan(b, kvh, h // kvh, n_pages, ps, hd, kv == "int8")
    label = f"K1 {kv} b={b} h={h} kvh={kvh} ctx={ctx}"

    before = getattr(paged_attention, counter)
    out = paged_attention(q, cache, bt, positions)
    torch.cuda.synchronize()
    if getattr(paged_attention, counter) != before + 1:
        fail(f"{label}: the wrapper did not count its launch")
    ref32 = paged_attention_ref(q.float(), cache32, bt, positions)
    ref_bf16 = paged_attention_ref(q, cache, bt, positions)
    torch.cuda.synchronize()
    err = k1_check(label, out, ref32)
    # the bf16 plain chain, for information only: it rounds logits and
    # probabilities to bf16 between its matmuls
    err_bf16 = (out.float() - ref_bf16.float()).abs().max().item()
    if null_row is not None and not torch.isfinite(out[null_row].float()).all():
        fail(f"{label}: all-NULL row is not finite")
    # one call, one launch: every operation one call puts on its stream,
    # counted from a CUDA graph of the call; the replay must give the same
    # answer
    nodes, out_graph = graph_nodes(lambda: paged_attention(q, cache, bt, positions))
    if nodes != ["kernel"]:
        fail(f"{label}: one call put {len(nodes)} operations on its stream: {nodes}")
    k1_check(f"{label} (CUDA graph replay)", out_graph, ref32)

    ms = time_ms(lambda: paged_attention(q, cache, bt, positions), flush)
    plain_ms = time_ms(lambda: paged_attention_ref(q, cache, bt, positions), flush)
    # library yardstick: SDPA over the keys the kernel reads — the view of
    # the pages each row attends (the table cut at the query's page), in
    # bf16. The gather (and an int8 pool's dequantization) happens here,
    # outside the timed call: the yardstick times the attention alone.
    k_all, v_all, pos_view = gather_paged_view(cache, bt[:, :used].contiguous(), q.dtype)
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
    # live row (none for the all-NULL row, whose output depends on no key;
    # an int8 pool's values are 1 byte and each key and value row adds a
    # float32 scale), the position rows and table entries of the pages those
    # rows walk, q, the query positions and out; two flops per multiply-add
    # in q.K and p.V
    live = b - (null_row is not None)
    kv_row = 2 * (hd + 4) if kv == "int8" else 2 * hd * 2
    nbytes = (live * ctx * kvh * kv_row + live * used * (ps * 4 + 4)
              + 2 * b * h * hd * 2 + b * 4)
    flops = 4 * live * h * ctx * hd
    bytes_s, flops_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return dict(err=err, err_bf16=err_bf16, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_s, flops_s) * 1e3, splits=splits,
                bound_by="bytes" if bytes_s >= flops_s else "operations")


def k1_verify_case(kv, flush, seqs=8, ctx=160):
    """K1 at the speculative verify's folded shape: ``seqs`` sequences of
    ``ctx`` keys and SPEC_K + 1 verify columns at positions ctx ..
    ctx + SPEC_K (written, as the verify writes its columns before it
    attends), folded into seqs * (SPEC_K + 1) query rows of one call, each
    with its sequence's table and its own position (what
    ``Transformer.forward(verify=True)`` passes). Checked against the plain
    version on the same rows, one call one kernel; timed in turns with the
    read the JAX package runs for the verify (``gather_paged_view`` over
    each sequence's whole table, then ``masked_attention`` of its columns),
    beside the plain version and SDPA over each sequence's attended view
    (one call: seqs x columns queries, the mask pos <= column position)."""
    import torch
    import torch.nn.functional as F

    from seldon_core_tpu_torch.models.transformer import gather_paged_view, masked_attention
    from seldon_core_tpu_torch.ops.paged_attention import paged_attention, paged_attention_ref

    h, hd, ps, n_pages = 32, 128, 64, 32
    cols = SPEC_K + 1
    q8, cache, cache32, bt8, _, used = k1_inputs(seqs, h, h, hd, ps, n_pages, ctx + cols, None,
                                                 seed=41, kv=kv)
    rows = seqs * cols
    g = torch.Generator(device="cuda").manual_seed(42)
    q = torch.randn((rows, 1, h, hd), generator=g, device="cuda").to(torch.bfloat16)
    bt = bt8.repeat_interleave(cols, dim=0)
    qpos = (ctx + torch.arange(cols, device="cuda", dtype=torch.int32)).repeat(seqs)[:, None]
    label = f"K1 {kv} verify b={rows} (={seqs} x {cols} columns) h=kvh={h} ctx={ctx}"
    counter = "launches_int8" if kv == "int8" else "launches"
    before = getattr(paged_attention, counter)
    out = paged_attention(q, cache, bt, qpos)
    torch.cuda.synchronize()
    if getattr(paged_attention, counter) != before + 1:
        fail(f"{label}: the wrapper did not count its launch")
    ref32 = paged_attention_ref(q.float(), cache32, bt, qpos)
    err = k1_check(label, out, ref32)
    nodes, out_graph = graph_nodes(lambda: paged_attention(q, cache, bt, qpos))
    if nodes != ["kernel"]:
        fail(f"{label}: one call put {len(nodes)} operations on its stream: {nodes}")
    k1_check(f"{label} (CUDA graph replay)", out_graph, ref32)
    # the JAX package's verify read: gather each sequence's whole table,
    # then the masked einsum chain over its columns
    qs = q.view(seqs, cols, h, hd)
    pos_s = qpos.view(seqs, cols)

    def jax_form():
        k_all, v_all, pos_view = gather_paged_view(cache, bt8, q.dtype)
        return masked_attention(qs, k_all, v_all, pos_view[:, None, :] <= pos_s[:, :, None])

    form_err = (jax_form().float().reshape(rows, 1, h, hd) - ref32).abs().max().item()
    timed = time_turns([lambda: paged_attention(q, cache, bt, qpos), jax_form], flush)
    plain_ms = time_ms(lambda: paged_attention_ref(q, cache, bt, qpos), flush)
    k_all, v_all, pos_view = gather_paged_view(cache, bt8[:, :used].contiguous(), q.dtype)
    mask = (pos_view[:, None, :] <= pos_s[:, :, None])[:, None]           # [seqs, 1, cols, L]
    qt, kt, vt = qs.transpose(1, 2), k_all.transpose(1, 2), v_all.transpose(1, 2)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                         flush)
    # each sequence's ctx + cols keys read once (shared by its columns), the
    # position rows and table entries of its pages, q, the positions, out;
    # each row's dot products over the keys it attends (ctx + j + 1)
    kv_row = 2 * (hd + 4) if kv == "int8" else 2 * hd * 2
    nbytes = (seqs * (ctx + cols) * h * kv_row + seqs * used * (ps * 4 + 4)
              + 2 * rows * h * hd * 2 + rows * 4)
    flops = 4 * h * hd * seqs * sum(ctx + j + 1 for j in range(cols))
    bytes_s, flops_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return dict(err=err, ms=timed[0][0], jax_form_ms=timed[1][0], jax_form_err=form_err,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(bytes_s, flops_s) * 1e3,
                bound_by="bytes" if bytes_s >= flops_s else "operations", label=label)


K1_SHAPES = [("ctx160", dict(b=8, h=32, kvh=32, ctx=160)),
             ("ctx2048", dict(b=8, h=32, kvh=32, ctx=2048)),
             ("gqa_ctx2048", dict(b=8, h=32, kvh=8, ctx=2048))]
K1_FIXED = dict(hd=128, ps=64, n_pages=32, null_row=7)
K1_SWEEP_SPLITS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32)


def k1_sweep(card, flush):
    """K1 at each of its six shapes (both pools x the three of K1_SHAPES)
    over the splits S of K1_SWEEP_SPLITS, all S of one shape timed in
    turns; each S is first held to K1's tolerance. Marks the plan's pick
    and the fastest. Prints one line per (shape, S), and, for scale, the
    rate of a plain 256 MB device-to-device copy on this card."""
    import torch

    src = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), flush)
    print(f"K1 sweep yardstick: a 256 MB device copy (read + write) takes {ms:.4f} ms = "
          f"{2 * src.numel() / ms / 1e9:.3f} TB/s [{card}]", flush=True)
    del src, dst
    from seldon_core_tpu_torch.ops.paged_attention import (_split_plan, paged_attention,
                                                           paged_attention_ref)

    for kv in ("bf16", "int8"):
        for label, kw in K1_SHAPES:
            args = dict(K1_FIXED, **kw)
            q, cache, cache32, bt, positions, _ = k1_inputs(seed=1, kv=kv, **args)
            ref32 = paged_attention_ref(q.float(), cache32, bt, positions)
            pick = _split_plan(args["b"], args["kvh"], args["h"] // args["kvh"],
                               args["n_pages"], args["ps"], args["hd"], kv == "int8")
            splits = sorted(set(K1_SWEEP_SPLITS) | {pick})
            for s in splits:
                k1_check(f"K1 sweep {kv} {label} S={s}",
                         paged_attention(q, cache, bt, positions, _splits=s), ref32)
            timed = time_turns([(lambda s=s: paged_attention(q, cache, bt, positions,
                                                             _splits=s)) for s in splits],
                               flush)
            best = min(range(len(splits)), key=lambda i: timed[i][0])
            for i, (s, (ms, _)) in enumerate(zip(splits, timed)):
                ctas = args["b"] * args["kvh"] * s
                print(f"K1 sweep {kv} {label} b={args['b']} h={args['h']} kvh={args['kvh']} "
                      f"hd=128 ps=64 n_pages=32: S={s} ({ctas} CTAs) {ms:.4f} ms"
                      f"{'  <- the plan picks this' if s == pick else ''}"
                      f"{'  <- fastest' if i == best else ''} [{card}]", flush=True)


def bf16_ulp(x):
    import torch

    ax = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(ax)) - 7)


# rows at decode (8 slots), the served prefill chunks, and generate()'s
# calls: a decode step of 1, 4 (bucket of 2 texts) or 8 rows, a dense
# prefill of 4 or 8 rows x 128; the speculative verify's 8 x (K + 1) = 40
K2_SHAPES = (1, 4, 8, 32, 40, 128, 256, 512, 1024)
# the TinyLlama-1.1B-wide draft at d = 2048: its forwards in the spec step
# (8 rows) and its prompt prefill at admission (the 128-token bucket)
K2_DRAFT = ((8, 2048), (128, 2048))
K2_D = LLAMA2_7B["dim"]
K2_EPS = 1e-5


def k2_inputs(rows, d, seed):
    """bf16 activations and a bf16 norm weight, as the served bf16 model
    stores it."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
    hh = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)).to(torch.bfloat16)
    return x, hh, w


def k2_check(label, y, o, y_ref, o_ref):
    """K2's tolerance: y bit-equal, o within one bf16 ulp. Returns the max
    abs error of o."""
    import torch

    if not torch.equal(y, y_ref):
        fail(f"{label}: residual sum y is not bit-equal to the plain version")
    diff = (o.float() - o_ref.float()).abs()
    if not torch.isfinite(o.float()).all() or (diff > bf16_ulp(o_ref)).any():
        fail(f"{label}: normed output beyond 1 bf16 ulp (max abs {diff.max().item()})")
    return diff.max().item()


def k2_bound(rows, d):
    """Read x and h, write y and o (bf16), read the bf16 weight; ~5 flops an
    element. Returns (ms, what bounds it)."""
    nbytes = 4 * rows * d * 2 + d * 2
    bytes_s, flops_s = nbytes / HBM_BYTES_PER_S, 5 * rows * d / BF16_FLOPS_PER_S
    return max(bytes_s, flops_s) * 1e3, "bytes" if bytes_s >= flops_s else "operations"


def k2_case(rows, d, seed, flush):
    """K2 at one shape, at its plan: checked against the plain version, one
    call one kernel node (``graph_nodes``) whose replay and a second call give
    the same bits; timed in turns with a trivial kernel (``out.zero_()``:
    the timing floor) and, for information, the two library calls
    ``x + h`` then ``F.rms_norm``; its host enqueue; and what it adds to a
    dense stream after the product that makes h (``stream_added_ms``),
    beside a trivial kernel."""
    import torch
    import torch.nn.functional as F

    from seldon_core_tpu_torch.ops.fused_norm import (_launch_plan, fused_residual_rmsnorm,
                                                      residual_rmsnorm_ref)
    from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul
    from seldon_core_tpu_torch.ops.quantize import quantize_array

    x, hh, w = k2_inputs(rows, d, seed)
    label = f"K2 [{rows},{d}] bf16"
    before = fused_residual_rmsnorm.launches
    y, o = fused_residual_rmsnorm(x, hh, w, K2_EPS)
    torch.cuda.synchronize()
    if fused_residual_rmsnorm.launches != before + 1:
        fail(f"{label}: the wrapper did not count its launch")
    y_ref, o_ref = residual_rmsnorm_ref(x, hh, w, K2_EPS)
    err = k2_check(label, y, o, y_ref, o_ref)
    nodes, replay = graph_nodes(lambda: fused_residual_rmsnorm(x, hh, w, K2_EPS)[0]._base)
    if nodes != ["kernel"]:
        fail(f"{label}: one call put {len(nodes)} operations on its stream: {nodes}")
    y2, o2 = fused_residual_rmsnorm(x, hh, w, K2_EPS)
    if not (torch.equal(replay[0], y) and torch.equal(replay[1], o)):
        fail(f"{label}: the CUDA graph's replay differs from the eager call")
    if not (torch.equal(y2, y) and torch.equal(o2, o)):
        fail(f"{label}: two calls on the same inputs differ")
    zero = torch.empty_like(x)
    timed = time_turns([lambda: fused_residual_rmsnorm(x, hh, w, K2_EPS),
                        lambda: zero.zero_(),
                        lambda: F.rms_norm(x + hh, (d,), w, K2_EPS)], flush)
    plain_ms = time_ms(lambda: residual_rmsnorm_ref(x, hh, w, K2_EPS), flush)
    enqueue_ms = enqueue_turns([lambda: fused_residual_rmsnorm(x, hh, w, K2_EPS)])[0]
    # in a dense stream, after the product that makes h (bf16 through
    # cuBLAS, int8 through K4): the kernel as served, and a trivial kernel
    w_mm = (torch.randn((d, d), device=x.device) * d ** -0.5).to(torch.bfloat16)
    qt = quantize_array(w_mm)
    calls = [lambda h_in: fused_residual_rmsnorm(x, h_in, w, K2_EPS), lambda h_in: h_in.zero_()]
    added, mm_ms = stream_added_ms(lambda: x @ w_mm, calls)
    added8, mm8_ms = stream_added_ms(lambda: int8_matmul(x, qt.q, qt.scale), calls)
    bound_ms, bound_by = k2_bound(rows, d)
    return dict(err=err, ms=timed[0][0], floor_ms=timed[1][0], pair_ms=timed[2][0],
                enqueue_ms=enqueue_ms, stream=added, mm_ms=mm_ms, stream8=added8, mm8_ms=mm8_ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                plan=_launch_plan(d, 8))


K2_SWEEP_ROWS = (1, 8, 17, 64, 128, 256)
# (threads, slots) of a row at d = 4096 in bf16 (512 16-byte vectors): one
# chunk held in 512, 256 or 128 threads, and two chunks in 256, 128 or 64
K2_SWEEP_PLANS = ((512, 1), (256, 2), (128, 4), (256, 1), (128, 2), (64, 4))


def k2_sweep(card, flush):
    """``--k2-sweep``: K2 at [rows, 4096] bf16 for each of K2_SWEEP_ROWS over
    K2_SWEEP_PLANS (threads a row, 16-byte slots a thread), each first held
    to K2's tolerance, all plans of one shape timed in turns beside a
    trivial kernel (``out.zero_()``), then again as what each adds to a
    dense stream after the product that makes h (``stream_added_ms``).
    Marks the plan's pick and the fastest: the data behind
    ``ops/fused_norm._launch_plan``."""
    import torch

    from seldon_core_tpu_torch.ops.fused_norm import _kernel, _launch_plan, residual_rmsnorm_ref

    plans = [_launch_plan(K2_D, 8, p) for p in K2_SWEEP_PLANS]
    pick = _launch_plan(K2_D, 8)
    for rows in K2_SWEEP_ROWS:
        x, hh, w = k2_inputs(rows, K2_D, rows)
        y_ref, o_ref = residual_rmsnorm_ref(x, hh, w, K2_EPS)
        outs = [torch.empty((2, rows, K2_D), dtype=x.dtype, device=x.device) for _ in plans]
        for p, out in zip(plans, outs):
            _kernel(x, hh, w, out[0], out[1], K2_EPS, p[:2])
            torch.cuda.synchronize()
            k2_check(f"K2 sweep [{rows},{K2_D}] plan {p}", out[0], out[1], y_ref, o_ref)
        zero = torch.empty_like(x)
        timed = time_turns([(lambda p=p, out=out: _kernel(x, hh, w, out[0], out[1], K2_EPS,
                                                          p[:2]))
                            for p, out in zip(plans, outs)] + [lambda: zero.zero_()], flush)
        w_mm = (torch.randn((K2_D, K2_D), device=x.device) * K2_D ** -0.5).to(torch.bfloat16)

        def in_stream(p):
            def fn(h_in):
                out = torch.empty((2, rows, K2_D), dtype=x.dtype, device=x.device)
                _kernel(x, h_in, w, out[0], out[1], K2_EPS, p[:2])
            return fn

        added, _ = stream_added_ms(lambda: x @ w_mm, [in_stream(p) for p in plans]
                                   + [lambda h_in: h_in.zero_()])
        best = min(range(len(plans)), key=lambda i: timed[i][0])
        best_stream = min(range(len(plans)), key=lambda i: added[i])
        for i, (p, (ms, _), add) in enumerate(zip(plans, timed, added)):
            threads, slots, chunks = p
            print(f"K2 sweep [{rows},{K2_D}] bf16: {threads} threads x {slots} slots, "
                  f"{chunks} chunk(s) ({rows} CTAs) {ms:.4f} ms, in a dense stream "
                  f"{add:.4f} ms added"
                  f"{'  <- the plan picks this' if p == pick else ''}"
                  f"{'  <- fastest' if i == best else ''}"
                  f"{'  <- fastest in the stream' if i == best_stream else ''} [{card}]",
                  flush=True)
        print(f"K2 sweep [{rows},{K2_D}]: trivial kernel (out.zero_()) {timed[-1][0]:.4f} ms, "
              f"in the stream {added[-1]:.4f} ms added [{card}]", flush=True)


def k4_case(m, k, n, out_dtype, seed, flush):
    """The int8 GEMM at one shape: bf16 activations, int8 codes and
    per-column scales of the size quantize_array gives a lecun-normal
    weight. M >= PREFILL_MIN_M takes the prefill kernel where TMA can
    address the operands (``_uses_wgmma``); there the decode kernel is also
    run through its own entry point (uncounted: a
    measurement, not a route the server takes), checked and timed in turns
    with the prefill kernel and the library call."""
    import torch

    from seldon_core_tpu_torch.ops.int8_matmul import (_decode_kernel, _decode_plan,
                                                       _uses_wgmma, _wgmma_plan, int8_matmul,
                                                       int8_matmul_ref)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    scale = (torch.rand((n,), generator=g, device=dev) + 0.5) * (2.0 / 127 / k ** 0.5)
    label = f"K4 [{m},{k}]x[{k},{n}] -> {str(out_dtype).split('.')[-1]}"
    prefill = _uses_wgmma(m, n, k, x.data_ptr(), q.data_ptr())
    before, before_wgmma = int8_matmul.launches, int8_matmul.launches_wgmma
    out = int8_matmul(x, q, scale, out_dtype)
    torch.cuda.synchronize()
    if int8_matmul.launches != before + 1:
        fail(f"{label}: the wrapper did not count its launch")
    if int8_matmul.launches_wgmma != before_wgmma + int(prefill):
        fail(f"{label}: expected the {'prefill' if prefill else 'decode'} kernel's route")
    ref = int8_matmul_ref(x, q, scale, torch.float32)
    tol = K4_RTOL * (x.float().abs() @ (q.float() * scale).abs())
    if out_dtype == torch.bfloat16:
        tol += bf16_ulp(ref)

    def check(got, what):
        diff = (got.float() - ref).abs()
        if not torch.isfinite(got.float()).all() or (diff > tol).any():
            fail(f"{label} ({what}): max_abs_err {diff.max().item()} beyond {K4_TOL_REASON}")
        return diff.max().item()

    err = check(out, "prefill kernel" if prefill else "decode kernel")
    decode_err = check(_decode_kernel(x, q, scale, torch.empty_like(out)),
                       "decode kernel") if prefill else None
    # every operation one call puts on its stream, counted from a CUDA
    # graph of the call (as a prefill-chunk or decode-step graph holds it):
    # the decode kernel is one launch; the prefill kernel one, plus the
    # split-K reduce when its plan splits (the float32 partial comes from
    # the graph's pool). The replay and a second call must give the same
    # bits (splits merge in rank order)
    splits = _wgmma_plan(m, n, k, torch.cuda.get_device_properties(0).multi_processor_count)[1]
    want_nodes = ["kernel"] * (1 + (prefill and splits > 1))
    nodes, out_graph = graph_nodes(lambda: int8_matmul(x, q, scale, out_dtype))
    if nodes != want_nodes:
        fail(f"{label}: one call put {nodes} on its stream, expected {want_nodes}")
    if not torch.equal(out_graph, out):
        fail(f"{label}: the CUDA graph's replay differs from the eager call")
    if not torch.equal(int8_matmul(x, q, scale, out_dtype), out):
        fail(f"{label}: two calls on the same inputs differ")
    del ref, tol
    # library yardstick: torch.matmul on a bf16 copy of the dequantized
    # weight (made here, not timed) — the product K4 must beat at decode by
    # reading half the weight bytes
    w_bf16 = q.to(torch.bfloat16) * scale.to(torch.bfloat16)
    fns = [lambda: int8_matmul(x, q, scale, out_dtype), lambda: torch.matmul(x, w_bf16)]
    if prefill:
        fns.append(lambda: _decode_kernel(x, q, scale, torch.empty_like(out)))
    timed = time_turns(fns, flush)
    plain_ms = time_ms(lambda: int8_matmul_ref(x, q, scale, out_dtype), flush)
    # x, the int8 weight and its scales read once, the output written once;
    # two flops per multiply-add
    out_size = 4 if out_dtype == torch.float32 else 2
    nbytes = m * k * 2 + k * n + n * 4 + m * n * out_size
    bytes_s, flops_s = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / BF16_FLOPS_PER_S
    return dict(err=err, ms=timed[0][0], enqueue_ms=timed[0][1], plain_ms=plain_ms,
                library_ms=timed[1][0], decode_err=decode_err, nodes=len(nodes),
                decode_ms=timed[2][0] if prefill else None,
                decode_enqueue_ms=timed[2][1] if prefill else None,
                plan=None if prefill else _decode_plan(
                    m, n, k, torch.cuda.get_device_properties(0).multi_processor_count),
                bound_ms=max(bytes_s, flops_s) * 1e3,
                bound_by="bytes" if bytes_s >= flops_s else "operations")


K4_FAMILIES = [("wq/wk/wv/wo", 4096, 4096, "bfloat16"), ("w1/w3", 4096, 11008, "bfloat16"),
               ("w2", 11008, 4096, "bfloat16"), ("lm_head", 4096, 32000, "float32")]
# the rows K4 takes on the main path: generate()'s decode steps of 1 and 4
# rows, the 8 serving slots, the served prefill chunks (32 on the decode
# route), the speculative verify's 8 x (K + 1) = 40 (the decode route),
# generate()'s dense prefills of 4 and 8 rows x 128
K4_SHAPES = (1, 4, 8, 32, 40, 128, 256, 512, 1024)


def k4_label(name: str, m: int) -> str:
    if m == 8:
        return name
    if m == SPEC_ROWS:
        return f"{name} verify M={m}"
    return f"{name} M={m}" if m < 8 else f"{name} prefill M={m}"


def k4_sweep(card, flush):
    """K4's prefill kernel at each prefill shape of the int8 7B model
    (M = 128 and 256) over its tile widths (128, 256) and splits of K, all
    of one shape timed in turns; each configuration is first held to the
    K4 tolerance. The wrapper's own choice is marked. Prints one line per
    configuration."""
    import torch

    from seldon_core_tpu_torch.ops.int8_matmul import (WG_BK, WG_BM, WG_BNS, _wgmma_kernel,
                                                       _wgmma_plan, int8_matmul_ref)

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in (128, 256):
        for name, k, n, dt in K4_FAMILIES:
            dt = getattr(torch, dt)
            g = torch.Generator(device=dev).manual_seed(m + n)
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            q = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
            scale = (torch.rand((n,), generator=g, device=dev) + 0.5) * (2.0 / 127 / k ** 0.5)
            ref = int8_matmul_ref(x, q, scale, torch.float32)
            tol = K4_RTOL * (x.float().abs() @ (q.float() * scale).abs())
            if dt == torch.bfloat16:
                tol += bf16_ulp(ref)
            steps = -(-k // WG_BK)
            configs = []
            for bn in WG_BNS:
                for s in (1, 2, 3, 4, 5, 6, 8):
                    per = -(-steps // s)
                    if (bn, -(-steps // per), per) not in configs:
                        configs.append((bn, -(-steps // per), per))
            pick = _wgmma_plan(m, n, k, sms)
            for plan in configs:
                out = _wgmma_kernel(x, q, scale, torch.empty((m, n), dtype=dt, device=dev), plan)
                if (((out.float() - ref).abs() > tol).any() or
                        not torch.isfinite(out.float()).all()):
                    fail(f"K4 sweep {name} M={m} (BN, splits, steps) {plan}: beyond "
                         f"{K4_TOL_REASON}")
            del ref, tol
            timed = time_turns([
                (lambda plan=plan: _wgmma_kernel(x, q, scale,
                                                 torch.empty((m, n), dtype=dt, device=dev), plan))
                for plan in configs], flush)
            for (bn, s, per), (ms, _) in zip(configs, timed):
                tiles = -(-m // WG_BM) * -(-n // bn)
                print(f"K4 sweep {name} [{m},{k}]x[{k},{n}]: BN={bn} splits={s} ({per} steps "
                      f"each, {tiles * s} CTAs) {ms:.4f} ms"
                      f"{'  <- the wrapper picks this' if (bn, s, per) == pick else ''} [{card}]",
                      flush=True)


def k4_decode_sweep(card, flush, clean_flush, model="7b"):
    """K4's decode kernel at each decode shape of the int8 7B model, at
    M = 8 (the serving slots) and M = 1 (``model`` "moe": at the MoE
    products' shapes, MOE_K4, at M = 8), over its strip widths and cluster
    sizes (splits of K), with torch.matmul on a dequantized bf16 copy of the
    weight, all of one shape timed in turns; each configuration is first
    held to the K4 tolerance. The wrapper's own choice is marked. Prints
    one line per configuration: the data behind
    ops/int8_matmul._decode_plan. Then, per shape, what is not the weight's
    stream, in turns: the wrapper's grid launched with K = 0 (the ring's
    set-up, the epilogue and the cluster's merge only) beside a trivial
    PyTorch kernel (``out.zero_()``: the timing method's own floor), and
    the wrapper's plan after a flush that reads the 64 MB instead of
    writing it (no dirty lines to write back while the weight streams)."""
    import torch

    from seldon_core_tpu_torch.ops.int8_matmul import (DEC_MAX_SPLITS, DEC_STAGE_BYTES,
                                                       DEC_WIDTHS, _decode_kernel, _decode_plan,
                                                       _decode_rows, int8_matmul_ref)

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    families, rows = K4_FAMILIES, (8, 1)
    if model == "moe":
        families, rows = [(name, k, n, "bfloat16") for name, k, n in MOE_K4], (8,)
    for m in rows:
        for name, k, n, dt in families:
            dt = getattr(torch, dt)
            g = torch.Generator(device=dev).manual_seed(m + n)
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            q = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
            scale = (torch.rand((n,), generator=g, device=dev) + 0.5) * (2.0 / 127 / k ** 0.5)
            ref = int8_matmul_ref(x, q, scale, torch.float32)
            tol = K4_RTOL * (x.float().abs() @ (q.float() * scale).abs())
            if dt == torch.bfloat16:
                tol += bf16_ulp(ref)
            configs = []
            for bn in DEC_WIDTHS:
                steps = max(-(-k // (DEC_STAGE_BYTES // bn)), 1)
                for s in range(1, DEC_MAX_SPLITS + 1):
                    per = -(-steps // s)
                    if (bn, -(-steps // per), per) not in configs:
                        configs.append((bn, -(-steps // per), per))
            pick = _decode_plan(m, n, k, sms)
            for plan in configs:
                out = _decode_kernel(x, q, scale, torch.empty((m, n), dtype=dt, device=dev), plan)
                if (((out.float() - ref).abs() > tol).any() or
                        not torch.isfinite(out.float()).all()):
                    fail(f"K4 decode sweep {name} M={m} (BN, splits, stages) {plan}: beyond "
                         f"{K4_TOL_REASON}")
            del ref, tol
            w_bf16 = q.to(torch.bfloat16) * scale.to(torch.bfloat16)
            timed = time_turns([
                (lambda plan=plan: _decode_kernel(x, q, scale,
                                                  torch.empty((m, n), dtype=dt, device=dev), plan))
                for plan in configs] + [lambda: torch.matmul(x, w_bf16)], flush)
            nbytes = m * k * 2 + k * n + n * 4 + m * n * (4 if dt == torch.float32 else 2)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            for (bn, s, per), (ms, _) in zip(configs, timed):
                ctas = -(-m // _decode_rows(m)) * -(-n // bn) * s
                print(f"K4 decode sweep {name} [{m},{k}]x[{k},{n}]: BN={bn} splits={s} ({per} "
                      f"stages each, {ctas} CTAs) {ms:.4f} ms = {bound_ms / ms:.0%} of the bound "
                      f"{bound_ms:.4f}"
                      f"{'  <- the wrapper picks this' if (bn, s, per) == pick else ''} [{card}]",
                      flush=True)
            print(f"K4 decode sweep {name} [{m},{k}]x[{k},{n}]: torch.matmul on a bf16 copy of "
                  f"the weight {timed[-1][0]:.4f} ms [{card}]", flush=True)
            out = torch.empty((m, n), dtype=dt, device=dev)
            fixed = time_turns([lambda: _decode_kernel(x[:, :0], q[:0], scale, out,
                                                       pick[:2] + (1,)),
                                lambda: out.zero_()], flush)
            clean = time_turns([lambda: _decode_kernel(x, q, scale, out, pick)], clean_flush)
            print(f"K4 decode sweep {name} [{m},{k}]x[{k},{n}]: the pick's grid at K = 0 "
                  f"{fixed[0][0]:.4f} ms, out.zero_() {fixed[1][0]:.4f} ms (the floor), in "
                  f"turns; the pick after a read-only flush {clean[0][0]:.4f} ms [{card}]",
                  flush=True)


# ---------------------------------------------------------------------------
# Serving phase
# ---------------------------------------------------------------------------
def post(url: str, body: dict, timeout: float = 600.0, headers: Optional[dict] = None):
    return post_headers(url, body, timeout, headers)[::2]


def post_headers(url: str, body: dict, timeout: float = 600.0,
                 headers: Optional[dict] = None):
    """(status, response headers, JSON body) of one POST."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def prompt_text(i: int, length: int = 124) -> str:
    """Request ``i``'s prompt: words appended until it is at least ``length``
    - 4 bytes long, cut at ``length`` (the byte tokenizer: one token a
    byte)."""
    words = ("tensor page kernel batch decode prefill stream cache token slot "
             "serve model layer head warp block").split()
    text, j = f"request {i}:", i
    while len(text) < length - 4:
        text += " " + words[(j * 7 + len(text)) % len(words)]
        j += 1
    return text[:length]


def prompts(n: int):
    return [prompt_text(i) for i in range(n)]


def chunks_of(b, n: int, prompt_len: Optional[int] = None):
    """The prefill chunks the batcher ``b`` runs for ``n`` uncached tokens
    of a prompt of ``prompt_len`` (default ``n``) tokens: its chunk length
    (from the prompt's bucket), once per chunk."""
    _, plen = b._truncate_prompt([0] * (prompt_len or n), MAX_NEW, None)
    c = min(b.prefill_chunk, plen)
    return [c] * -(-n // c)


def teacher_logits(server, seqs, adapter_ids=None):
    """float32 logits of one batched prefill over right-padded ``seqs``
    into fresh dense caches of the server's KV dtype (``server._prefill_fresh``):
    the same K/V numerics the serving path runs (an int8 cache quantizes
    every position on write and attends the dequantized values); with
    ``adapter_ids`` (one a sequence) each row through its LoRA adapter. The
    causal mask keeps each row's padding out of its earlier positions."""
    import torch

    n, L = len(seqs), max(map(len, seqs))
    toks = torch.zeros((n, L), dtype=torch.int64, device="cuda")
    for i, seq in enumerate(seqs):
        toks[i, :len(seq)] = torch.tensor(seq, device="cuda")
    pos = torch.arange(L, device="cuda")[None].expand(n, L)
    with torch.no_grad():
        ids = (None if adapter_ids is None
               else torch.tensor(list(adapter_ids), dtype=torch.int64, device="cuda"))
        logits, _ = server._prefill_fresh(toks, pos, L, adapter_ids=ids)
    return logits


K2_KERNEL = "fused_residual_rmsnorm_kernel"


def dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def k2_in_step(events, name):
    """K2 in one traced step, from the device events' start and end times:
    the calls (kernels whose name holds ``name``), and the medians over them
    of the kernel's own time, of the idle gap on its stream between the end
    of the operation before it and its start, and of the time from that
    end to K2's end (what K2 adds to the step)."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    prev_end, durs, gaps, adds = {}, [], [], []
    for e in evs:
        stream = getattr(e, "device_resource_id", 0)
        if name in e.name:
            durs.append(e.time_range.end - e.time_range.start)
            if stream in prev_end:
                gaps.append(e.time_range.start - prev_end[stream])
                adds.append(e.time_range.end - prev_end[stream])
        prev_end[stream] = e.time_range.end
    med = (lambda v: statistics.median(v) / 1e3 if v else float("nan"))
    return dict(calls=len(durs), ms=med(durs), total_ms=sum(durs) / 1e3, gap_ms=med(gaps),
                added_ms=med(adds), gaps=len(gaps))


def k2_line(k):
    return (f"{k['calls']} K2 kernels, device time per call {k['ms']:.4f} ms (median; "
            f"{k['total_ms']:.3f} ms in all), idle gap from the end of the operation before "
            f"each to its start {k['gap_ms']:.4f} ms (median of {k['gaps']}), from that end to "
            f"K2's end {k['added_ms']:.4f} ms")


def profile_step(step, k2_name, reps=REPS):
    """One decode dispatch (an eager step, or a graph replay): its host
    time (median of ``reps`` calls, after a warm-up; the card drained before
    each), then one torch.profiler trace of it. Returns (host ms, device ms
    of every kernel and copy, the trace's device rows by time, K2's numbers
    from ``k2_in_step``). A trace may come back without a single device
    event (the profiler lost them: a step runs thousands of kernels); such
    a trace is taken again, up to 3 times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        # device-side rows only (kernels, copies); the host op that launched
        # a kernel reports the same time again as its own
        ops = sorted((e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")),
                     key=dev_us, reverse=True)
        k2 = k2_in_step(prof.events(), k2_name)
        del prof
        if ops:
            break
    return (statistics.median(host) * 1e3, sum(dev_us(e) for e in ops) / 1e3, ops, k2)


def events_ms(fn) -> float:
    """Device time of one call of ``fn`` from CUDA events around it, the
    median of REPS calls (after a warm-up). For a graph replay this is the
    graph's whole run, the gaps between its kernels included."""
    import torch

    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def step_kernels(ops, name):
    return sum(e.count for e in ops if name in e.key)


def load_llm(label: str, card: str, knobs: dict):
    """An LLMServer at Llama-2-7B widths and depth (random weights from a
    seed, fused_norm=True, paged continuous batching over N_REQUESTS slots)
    with the LLMServer ``knobs``, loaded. Returns (server, weight bytes)."""
    import torch

    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    server = LLMServer(model="transformer", model_kwargs=dict(LLAMA2_7B, fused_norm=True),
                       init_random=True, param_dtype="auto", continuous_batching=N_REQUESTS,
                       max_new_tokens=MAX_NEW, temperature=0.0, eos_id=-1, seed=0,
                       device="cuda", **knobs)
    server.load()
    torch.cuda.synchronize()
    load_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in (*server._module.parameters(), *server._module.buffers()))
    print(f"[{label}] load_s {time.perf_counter() - t0:.2f} (Llama-2-7B widths, 32 layers, "
          f"random weights, {weight_bytes / 1e9:.3f} GB); peak device memory after load() "
          f"{load_peak_gb:.3f} GB ({before_gb:.3f} GB allocated before) [{card}]", flush=True)
    # a LoRA pool is allocated at load() beside the weights
    pool_gb = (server.adapter_registry.stats()["adapter_pool_bytes"] / 1e9
               if server.adapter_registry is not None else 0.0)
    if knobs.get("quantize") == "int8" and load_peak_gb > INT8_LOAD_PEAK_GB + pool_gb:
        fail(f"[{label}] peak device memory after load() {load_peak_gb:.3f} GB > "
             f"{INT8_LOAD_PEAK_GB} GB + the adapter pool's {pool_gb:.3f} GB: more than the "
             f"int8 tree plus one float leaf")
    return server, weight_bytes


def admit_now(b, texts, ahead: int) -> None:
    """Admit ``texts`` into the batcher's slots on this thread (its loop is
    stopped), prefill each, and grow every slot's pages ``ahead`` positions
    past its next write: live block tables and slot state for stepping the
    programs directly, as the served run had them."""
    from concurrent.futures import Future

    from seldon_core_tpu_torch.runtime.scheduler import PendingRequest

    for text in texts:
        ids = b.server._tokenizer.encode(text)
        if not b._admit_begin(PendingRequest(ids=ids, max_new=MAX_NEW, fut=Future())):
            fail("step phase: no free slot for a re-admitted prompt")
        while b._prefill is not None:
            b._prefill_step()
    for i, slot in enumerate(b._slots):
        if not (slot.active and b._ensure_slot_pages(i, slot.dispatched_pos() + ahead)):
            fail(f"step phase: slot {i} is not live")


def state_copy(b):
    return ([tuple(t.clone() for t in layer) for layer in b._caches], b._last_tok.clone(),
            b._next_pos.clone(), b._keys.clone())


def state_equal(b, copy, pools: bool = True) -> bool:
    """The slot state against ``copy`` and, with ``pools``, every pool."""
    import torch

    pool_copy, last_tok, next_pos, keys = copy
    return (torch.equal(b._last_tok, last_tok) and torch.equal(b._next_pos, next_pos)
            and torch.equal(b._keys, keys)
            and (not pools or all(torch.equal(x, y) for la, lb in zip(b._caches, pool_copy)
                                  for x, y in zip(la, lb))))


def draw_ms(server, b):
    """Device time of one decode step's token pick at the batcher's b.S
    slots over float32 logits [b.S, vocab], each as a CUDA graph of the pick
    alone (CUDA events around its replay, median of REPS): ``sample_tokens``
    with a 0-dim temperature tensor of 0 (the greedy and the sampled token
    both made, one chosen on the device: ``generate()``'s form), and with
    None (the greedy pick alone, chosen on the host: the greedy batcher's
    form). Returns (tensor form ms, None form ms)."""
    import torch

    from seldon_core_tpu_torch.servers.llmserver import sample_tokens

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    logits = torch.randn((b.S, LLAMA2_7B["vocab_size"]), generator=g, device=dev) * 3
    keys = b._keys.clone()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = []
    for temp in (zero, None):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            sample_tokens(keys, logits, temp, server.top_k)
        out.append(events_ms(graph.replay))
    return tuple(out)


def step_phase(label: str, card: str, server, b, texts, weight_bytes: int) -> dict:
    """Where a decode dispatch's time goes, on live state: the served
    prompts admitted again into the batcher (loop stopped), then (1) one
    replay of each captured program against the same program run eagerly
    from identical copies of the pools and slot state: tokens, pools and
    state must be bit-equal; (2) the eager step's host enqueue and
    torch.profiler device time (one K1 and one K2 kernel a layer, 225 K4
    decode kernels in the int8 model, no split-K reduce), then each graph's
    replay: its host time, its device time from CUDA events and from the
    trace (the same kernels, k times over, where the trace sees them)."""
    import torch

    quantized = server.quantize == "int8"
    n_layers = server._cfg.n_layers
    k4_step = k4_per_forward(server._cfg) if quantized else 0
    admit_now(b, texts, ahead=768)
    pool_gb = sum(t.numel() * t.element_size() for layer in b._caches for t in layer) / 1e9
    for k in sorted(b._graphs):
        copy = state_copy(b)
        toks = b._graphs[k].replay().clone()
        eager = server._get_decode_step_paged(b.S, b.n_pages, k)(*copy, b._temp,
                                                                 b._block_tables)
        torch.cuda.synchronize()
        same_tokens = torch.equal(toks, eager)
        same = same_tokens and state_equal(b, copy)
        print(f"[{label}] replay vs eager, K = {k}, from identical copies of the pools "
              f"({pool_gb:.2f} GB) and slot state, {b.S} live slots: tokens "
              f"{'bit-equal' if same_tokens else 'DIFFER'}, tokens + pools + state "
              f"{'bit-equal' if same else 'DIFFER'} [{card}]", flush=True)
        if not same:
            fail(f"[{label}] the K = {k} graph replay and the eager program differ")
        del copy, eager
    torch.cuda.empty_cache()

    def eager_step(k):
        prog = server._get_decode_step_paged(b.S, b.n_pages, k)
        return lambda: prog(b._caches, b._last_tok, b._next_pos, b._keys, b._temp,
                            b._block_tables)

    # what one eager step launches, from the wrappers' counters (a trace
    # can lose events: a step runs ~2,000 kernels); the trace times it
    k2_n, k4_wgmma, k4_kernels, k1_kernels = launches_of(eager_step(1))
    host_e, dev_e, ops, k2_e = profile_step(eager_step(1), K2_KERNEL)
    reduces = [e.key for e in ops if "splitk_reduce" in e.key]
    # one K1, one K2 call a layer, one K4 call a product: each one kernel
    if k1_kernels != n_layers or k2_n != n_layers:
        fail(f"[{label}] one eager decode step launched {k1_kernels} paged-attention and "
             f"{k2_n} {K2_KERNEL} kernels, expected one per layer ({n_layers})")
    if k4_kernels != k4_step or k4_wgmma or reduces:
        fail(f"[{label}] one eager decode step launched {k4_kernels} K4 decode kernels "
             f"(expected {k4_step}), {k4_wgmma} on the prefill route and "
             f"{len(reduces)} kinds of split-K reduce kernel {reduces}")
    n_e = sum(e.count for e in ops)
    print(f"[{label}] eager decode step at {b.S} live slots: host enqueue {host_e:.3f} ms, "
          f"device time {dev_e:.3f} ms in {n_e} kernels and copies (torch.profiler); launched "
          f"{k1_kernels} paged attention, one per layer; {k4_kernels} K4 decode, one per "
          f"product; {k2_n} K2, one per layer (the wrappers' counters); reading the "
          f"{weight_bytes / 1e9:.2f} GB of weights alone takes "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms [{card}]", flush=True)
    print(f"[{label}] eager decode step, K2 in the trace: {k2_line(k2_e)} [{card}]", flush=True)
    for e in ops[:12]:
        print(f"  {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:100]} [{card}]")
    out = {"eager_host_ms": host_e, "eager_dev_ms": dev_e, "eager_kernels": n_e}
    pick_ms, greedy_ms = draw_ms(server, b)
    print(f"[{label}] the token pick of one decode step at {b.S} slots (a CUDA graph of it "
          f"alone, CUDA events, median of {REPS}): sample_tokens with a 0-dim temperature of 0 "
          f"(greedy and sampled tokens both made, one chosen on the device; generate()'s "
          f"form) {pick_ms:.4f} ms, with None (the greedy pick alone, key split + argmax; the "
          f"greedy batcher's form) {greedy_ms:.4f} ms [{card}]", flush=True)
    out["draw_ms"] = (pick_ms, greedy_ms)
    for k in sorted(b._graphs):
        replay = b._graphs[k].replay
        # what the replay runs, from the graph's kernel nodes by name; the
        # trace times it
        names = graph_kernel_names(b._graphs[k].graph)
        seen = node_counts(names)
        want = (n_layers * k, 0, k4_step * k, n_layers * k)
        if seen != want:
            fail(f"[{label}] the K = {k} graph holds (K2, K4 prefill, K4 decode, K1) kernel "
                 f"nodes {seen}, expected {want}")
        host_g, dev_g, ops_g, k2_g = profile_step(replay, K2_KERNEL)
        ev_g = events_ms(replay)
        n_g = sum(e.count for e in ops_g)
        traced = (f"torch.profiler {dev_g:.3f} ms in {n_g} kernels and copies "
                  f"({dev_g / k:.3f} ms a step; kernel nodes (K2, K4 prefill, K4 decode, K1) "
                  f"{seen})" if ops_g else
                  "torch.profiler saw no device event in the replay")
        print(f"[{label}] graph replay of K = {k} step(s) at {b.S} live slots: host time "
              f"{host_g:.4f} ms (median of {REPS} replay() calls; the eager step's enqueue "
              f"{host_e:.3f} ms), device time {ev_g:.3f} ms = {ev_g / k:.3f} ms a step (CUDA "
              f"events around the replay, median of {REPS}); {traced} [{card}]", flush=True)
        if ops_g:
            print(f"[{label}] K = {k} replay, K2 in the trace: {k2_line(k2_g)} [{card}]",
                  flush=True)
        out[k] = {"host_ms": host_g, "dev_ms": ev_g, "traced_ms": dev_g if ops_g else None,
                  "nodes": len(names)}
        if k > 1:
            host_ek = profile_step(eager_step(k), K2_KERNEL, reps=3)[0]
            print(f"[{label}] the same K = {k} program run eagerly: host enqueue "
                  f"{host_ek:.3f} ms (median of 3) against the replay's {host_g:.4f} ms "
                  f"[{card}]", flush=True)
            out[k]["eager_host_ms"] = host_ek
    return out


def zero_counts(server) -> None:
    """Every kernel's launch counters, the server's prefill counters and
    its serving series, set to 0 / emptied just before a run."""
    from seldon_core_tpu_torch.ops.fused_norm import fused_residual_rmsnorm
    from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul
    from seldon_core_tpu_torch.ops.paged_attention import (paged_attention,
                                                           paged_attention_partial)

    paged_attention.launches = 0
    paged_attention.launches_int8 = 0
    paged_attention_partial.launches = 0
    paged_attention_partial.launches_int8 = 0
    fused_residual_rmsnorm.launches = 0
    int8_matmul.launches = 0
    int8_matmul.launches_wgmma = 0
    server._prefill_replays = 0
    server._prefill_eager = 0
    for series in (server._ttft_times, server._inter_token_times, server._decode_step_times,
                   server._decode_dispatch_times, server._decode_sync_times,
                   server._decode_host_lag, server._ttft_by_class):
        series.clear()


def read_counts(server) -> dict:
    from seldon_core_tpu_torch.ops.fused_norm import fused_residual_rmsnorm
    from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul
    from seldon_core_tpu_torch.ops.paged_attention import (paged_attention,
                                                           paged_attention_partial)

    return {"k1": paged_attention.launches, "k1_int8": paged_attention.launches_int8,
            "k1p": paged_attention_partial.launches,
            "k1p_int8": paged_attention_partial.launches_int8,
            "k2": fused_residual_rmsnorm.launches, "k4": int8_matmul.launches,
            "k4_wgmma": int8_matmul.launches_wgmma, "replays": server._prefill_replays,
            "eager": server._prefill_eager}


def post_all(url: str, texts, adapters=None):
    """POST one /v1/generate per text (with ``adapters``, each its
    adapter's, None for the base model), all at once. Returns (the
    results, the wall time)."""
    results = [None] * len(texts)

    def client(i):
        adapter = adapters[i] if adapters else None
        results[i] = post(url + "/v1/generate",
                          {"prompt": texts[i], **({"adapter": adapter} if adapter else {})})

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return results, time.perf_counter() - t0


def served_tokens(label: str, results):
    """The tokens of each response; fails unless every request answered 200
    with MAX_NEW token ids in range."""
    served = []
    for i, res in enumerate(results):
        if res is None:
            fail(f"[{label}] request {i} did not complete")
        code, body = res
        if code != 200:
            fail(f"[{label}] request {i} answered {code}: {body}")
        toks = body.get("tokens")
        if not isinstance(toks, list) or len(toks) != MAX_NEW:
            fail(f"[{label}] request {i}: expected {MAX_NEW} tokens, got {toks!r}")
        if not all(isinstance(t, int) and 0 <= t < LLAMA2_7B["vocab_size"] for t in toks):
            fail(f"[{label}] request {i}: token ids out of range")
        served.append(toks)
    return served


def check_launches(label: str, card: str, counts: dict, chunks, quantized: bool,
                   int8_kv: bool, eager: bool, cfg=None, ranks: int = 1,
                   partial: bool = False) -> int:
    """A run's launches against its work: one K1 a layer a decode step on
    the pool's kernel and none on the other; one K2 a layer a forward
    (decode steps and prefill ``chunks``); in the int8 model one K4 a
    product a forward, on the prefill route (``launches_wgmma``) for the
    chunks of 64 rows and more; every chunk a graph replay, or with
    ``eager`` an eager run; ``cfg`` the model's config (default
    Llama-2-7B's); ``ranks`` the mesh ranks (each runs every kernel at its
    shard's shapes); ``partial``: a 'seq' mesh, whose K1 launches are its
    partial mode's, and none the one-rank read's. Returns the decode
    steps."""
    n_layers = cfg.n_layers if cfg else LLAMA2_7B["n_layers"]
    per_step = n_layers * ranks
    k1_key, idle_k1 = ("k1_int8", "k1") if int8_kv else ("k1", "k1_int8")
    idle = [idle_k1]
    if partial:
        idle, k1_key = [k1_key, idle_k1, "k1p" if int8_kv else "k1p_int8"], "k1p" + k1_key[2:]
    elif "k1p" in counts:
        idle += ["k1p", "k1p_int8"]
    k1_launches = counts[k1_key]
    if k1_launches == 0 or k1_launches % per_step or any(counts[k] for k in idle):
        fail(f"[{label}] K1 launches {counts}: expected a positive multiple of {per_step} "
             f"on the {k1_key} kernel (one per layer per rank per decode step) and none on "
             f"{idle}")
    decode_steps = k1_launches // per_step
    forwards = decode_steps + len(chunks)
    if counts["k2"] != per_step * forwards:
        fail(f"[{label}] K2 launches {counts['k2']} != {n_layers} x {ranks} x ({decode_steps} "
             f"decode steps + {len(chunks)} prefill chunks)")
    per = ((k4_per_forward(cfg) if cfg else K4_PER_FORWARD) if quantized else 0) * ranks
    if counts["k4"] != per * forwards:
        fail(f"[{label}] K4 launches {counts['k4']}: expected {per} x {forwards} forwards")
    wide = sum(c >= 64 for c in chunks)
    if counts["k4_wgmma"] != per * wide:
        fail(f"[{label}] K4 prefill-kernel launches {counts['k4_wgmma']} != {per} x {wide} "
             f"prefill chunks of 64 rows or more")
    want = (0, len(chunks)) if eager else (len(chunks), 0)
    if (counts["replays"], counts["eager"]) != want:
        fail(f"[{label}] prefill chunks as (graph replays, eager runs) "
             f"{(counts['replays'], counts['eager'])}, expected {want}")
    of = f"{n_layers} layers" + (f" x {ranks} ranks" if ranks > 1 else "")
    print(f"[{label}] launches: paged_attention ({k1_key}) {k1_launches} ({decode_steps} decode "
          f"steps x {of}), fused_residual_rmsnorm {counts['k2']} ({decode_steps} + "
          f"{len(chunks)} forwards x {of}), int8_matmul {counts['k4']} ({forwards} "
          f"forwards x {per}): prefill kernel {counts['k4_wgmma']} ({wide} chunks of >= 64 "
          f"rows), decode kernel {counts['k4'] - counts['k4_wgmma']} ({decode_steps} steps + "
          f"{len(chunks) - wide} chunks); prefill chunks {list(chunks)}: "
          f"{counts['replays']} graph replays, {counts['eager']} eager runs [{card}]",
          flush=True)
    return decode_steps


def prompt_ids(server, prompt) -> list:
    """A request's prompt as token ids: a text through the byte tokenizer,
    a token list as it is."""
    return server._tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)


def teacher_check(label: str, card: str, server, texts, served, adapter_ids=None) -> None:
    """Every served token against a teacher-forced prefill over its own
    request's prompt (a text or token ids) and served tokens, through the
    same KV numerics (and, with ``adapter_ids``, each request's adapter):
    within TIE_TOL of the top logit at every step."""
    import torch

    seqs = [prompt_ids(server, t) + toks for t, toks in zip(texts, served)]
    tf_logits = teacher_logits(server, seqs, adapter_ids)
    # row p - 1 + t of request i predicts its served token t
    rows = torch.stack([tf_logits[i, len(seq) - MAX_NEW - 1:len(seq) - 1]
                        for i, seq in enumerate(seqs)]).float()     # [N, MAX_NEW, vocab]
    picked = rows.gather(2, torch.tensor(served, device="cuda")[:, :, None])[:, :, 0]
    top2 = rows.topk(2, dim=-1).values
    gaps = top2[:, :, 0] - picked
    worst = gaps.max().item()
    print(f"[{label}] teacher-forced check of all {len(texts)} x {MAX_NEW} served tokens "
          f"(prompts of {[len(s) - MAX_NEW for s in seqs]} tokens): "
          f"{int((gaps == 0).sum())} are the teacher-forced argmax, worst gap to the top "
          f"logit {worst:.4f} (tie tolerance {TIE_TOL}); median top-1/top-2 margin "
          f"{(top2[:, :, 0] - top2[:, :, 1]).median().item():.4f}, logit std "
          f"{rows.std().item():.3f} [{card}]", flush=True)
    if worst > TIE_TOL:
        i, t = divmod(int(gaps.argmax()), MAX_NEW)
        fail(f"[{label}] request {i} token {t}: served {served[i][t]} sits {worst:.4f} below "
             f"the teacher-forced top logit (tolerance {TIE_TOL})")


def graph_pool_gb(graphs) -> Optional[float]:
    """Device memory held by the memory pools of ``graphs`` (ReplayGraph
    objects; a shared pool counted once), from torch.cuda.memory_snapshot's
    segments. None when no segment names one of the pools (not measured)."""
    import torch

    ids = {tuple(g.graph.pool()) for g in graphs}
    if not ids:
        return 0.0
    sizes = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
             if tuple(seg.get("segment_pool_id", ())) in ids]
    return sum(sizes) / 1e9 if sizes else None


def gb_text(x: Optional[float]) -> str:
    return "not measured" if x is None else f"{x:.3f} GB"


def launches_of(fn):
    """(K2, K4 prefill route, K4 decode route, K1) launches of one call of
    ``fn`` (a replay adds what its capture counted), from the wrappers'
    counters."""
    from seldon_core_tpu_torch.servers.step_graph import launch_counts

    before = launch_counts()
    fn()
    delta = {(f.__name__, name): n - before[f, name] for (f, name), n in launch_counts().items()}
    wgmma = delta["int8_matmul", "launches_wgmma"]
    return (delta["fused_residual_rmsnorm", "launches"], wgmma,
            delta["int8_matmul", "launches"] - wgmma,
            delta["paged_attention", "launches"] + delta["paged_attention", "launches_int8"])


def prefill_phase(label: str, card: str, server, b) -> dict:
    """One prefill chunk of each length the batcher captured, on live state
    (after ``step_phase``: the pools hold the served prompts): fresh pages
    of the pool, then a first chunk (C tokens of the served prompts' text at
    positions 0..C-1) and a later one (C - 3 tokens at C.., padded,
    attending over the first through the pool), each replayed through the
    chunk's graph and run through the eager program from identical copies
    of the pools: logits and every pool tensor must be bit-equal. Then, on
    the later chunk's inputs: the launches of one call and of one replay
    (one K2 a layer, no K1, and in the int8 model one K4 a product on the
    route its M takes): the eager call's from the wrappers' counters, the
    replayed graph's from its own kernel nodes by name, and what a replay
    adds to the counters must equal those nodes; then the eager program's
    host enqueue and
    torch.profiler trace against the replay's host time, its device time
    from CUDA events and its trace."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.transformer import NULL_PAGE, PAD_POS

    n_layers = server._cfg.n_layers
    k4 = k4_per_forward(server._cfg) if server.quantize == "int8" else 0
    text = server._tokenizer.encode(" ".join(prompts(N_REQUESTS)))
    out = {}
    for C in sorted(b._prefill_graphs):
        pages = b._allocator.alloc(-(-2 * C // b.page_size))
        if pages is None:
            fail(f"[{label}] prefill phase: no free pages for two chunks of {C}")
        b._reset_pages(pages)
        row = np.full((1, b.n_pages), NULL_PAGE, np.int32)
        row[0, :len(pages)] = pages
        b._row.copy_(b._to_device(row))
        graph, prog = b._prefill_graphs[C], server._get_prefill_chunk(C, b.n_pages)
        toks_view, pos_view = b._chunk_tokens[:, :C], b._chunk_pos[:, :C]
        for start, n in ((0, C), (C, C - 3)):
            toks = np.zeros((1, C), np.int64)
            pos = np.full((1, C), PAD_POS, np.int32)
            toks[0, :n] = text[start:start + n]
            pos[0, :n] = np.arange(start, start + n)
            toks_view.copy_(b._to_device(toks))
            pos_view.copy_(b._to_device(pos))
            copy = [tuple(t.clone() for t in layer) for layer in b._caches]
            got = graph.replay().clone()
            want = prog(copy, b._row, toks_view, pos_view)
            torch.cuda.synchronize()
            same_logits = torch.equal(got, want) and bool(torch.isfinite(got).all())
            same = same_logits and all(torch.equal(x, y) for la, lb in zip(b._caches, copy)
                                       for x, y in zip(la, lb))
            print(f"[{label}] prefill chunk of {C} ({n} tokens at positions {start}.."
                  f"{start + n - 1}): replay vs eager from identical copies of the pools: "
                  f"logits {'bit-equal' if same_logits else 'DIFFER'}, logits + pools "
                  f"{'bit-equal' if same else 'DIFFER'} [{card}]", flush=True)
            if not same:
                fail(f"[{label}] the chunk-{C} prefill graph's replay and the eager program "
                     f"differ")
            del copy, got, want
        torch.cuda.empty_cache()
        eager = (lambda: prog(b._caches, b._row, toks_view, pos_view))
        # (K2, K4 prefill route, K4 decode route, K1): one eager call's
        # launches from the wrappers' counters; the replayed graph's kernel
        # nodes, by name; what one replay adds to the counters
        want_k = (n_layers, k4 if C >= 64 else 0, 0 if C >= 64 else k4, 0)
        names = graph_kernel_names(graph.graph)
        in_graph = node_counts(names)
        reduces = sum("splitk_reduce" in n for n in names)
        for what, seen in (("eager program launched", launches_of(eager)),
                           ("graph holds kernel nodes", in_graph),
                           ("replay added to the counters", launches_of(graph.replay))):
            if seen != want_k:
                fail(f"[{label}] one chunk-{C} {what} (K2, K4 prefill, K4 decode, K1) "
                     f"{seen}, expected {want_k}")
        host_e, dev_e, ops_e, _ = profile_step(eager, K2_KERNEL)
        host_g, dev_g, ops_g, _ = profile_step(graph.replay, K2_KERNEL)
        ev_g = events_ms(graph.replay)
        b._allocator.free(pages)
        in_trace = tuple(step_kernels(ops_e, name) for name in (
            "int8_matmul_wgmma_kernel", "int8_matmul_decode_kernel", "splitk_reduce"))
        n_e = sum(e.count for e in ops_e)
        traced_g = (f"torch.profiler {dev_g:.3f} ms in {sum(e.count for e in ops_g)} kernels "
                    f"and copies" if ops_g else "torch.profiler saw no device event in the replay")
        print(f"[{label}] prefill chunk of {C}: one call launches (K2, K4 prefill, K4 decode, "
              f"K1) {want_k} (the wrappers' counters); the replayed graph holds as many of "
              f"those kernel nodes, {reduces} split-K reduce nodes, {len(names)} kernel nodes "
              f"in all (cuGraphGetNodes, by function name); eager program host "
              f"enqueue {host_e:.3f} ms, device time {dev_e:.3f} ms in {n_e} kernels and copies "
              f"(torch.profiler; it saw (K4 prefill, K4 decode, split-K reduce) "
              f"{in_trace}); graph replay host time {host_g:.4f} ms "
              f"(median of {REPS}), device time {ev_g:.3f} ms (CUDA events around the replay, "
              f"median of {REPS}), {traced_g} [{card}]", flush=True)
        for e in ops_e[:8]:
            print(f"  {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:100]} [{card}]")
        out[C] = {"eager_host_ms": host_e, "eager_dev_ms": dev_e, "host_ms": host_g,
                  "dev_ms": ev_g, "traced_ms": dev_g if ops_g else None}
    return out


def fresh_generate(server, texts, max_new: int):
    """``server.generate(texts)`` through the eager programs over a dense
    buffer made for this call alone (fresh ``init_kv_caches`` of its rows
    x positions), the server's own buffer and generate graphs put back
    afterwards untouched: the oracle for a call on the reused buffer."""
    saved = (server._dense, dict(server._generate_graphs), server._generate_pool)
    server._dense = None
    try:
        return server.generate(texts, max_new_tokens=max_new, _eager=True)
    finally:
        server._dense, graphs, server._generate_pool = saved
        server._generate_graphs.clear()
        server._generate_graphs.update(graphs)


def generate_launches(server, rows: int, plen: int, max_new: int) -> dict:
    """What one generate() call of ``rows`` x ``plen`` launches: one K2 a
    layer a forward (the prefill and ``max_new`` - 1 decode steps, one
    more where the call captures its graph after a warm-up step); in the
    int8 model one K4 a product a forward, the prefill's on the prefill
    route (``rows * plen`` >= 64), the steps' on the decode route; no K1."""
    n_layers = LLAMA2_7B["n_layers"]
    per = K4_PER_FORWARD if server.quantize == "int8" else 0
    wide = per if rows * plen >= 64 else 0
    return {"k1": 0, "k1_int8": 0, "k1p": 0, "k1p_int8": 0, "k2": n_layers * max_new,
            "k4": per * max_new, "k4_wgmma": wide}


def generate_phase(label: str, card: str, server, url: str, texts) -> dict:
    """The private generate() path on the served server (its batcher idle
    until part 5), through the decode graphs:

    1. the N_REQUESTS texts, greedy (batch bucket 8, plen 128, MAX_NEW
       tokens: key (8, 160)), once through the private eager switch, then
       twice through the graph (captured at the first): tokens bit-equal,
       every decode step a replay, each call launching what
       ``generate_launches`` says; per-step wall (``_decode_step_times``)
       and call wall, the capture's host time, the dense buffer's and the
       generate pool's GB, peak memory; then on the buffer's live state the
       step's replay (host time; device time from CUDA events) against the
       eager step (host enqueue; torch.profiler's kernel sum), each timed
       call first re-pointing ``pos`` at the prompts' ends (one small copy);
    2. reuse: one text with 8 new tokens (key (1, 136)), then the texts
       again: each bit-equal to the eager switch and to a call on a fresh
       buffer (``fresh_generate``);
    3. sampled: the texts at temperature 0.7, seed 11, graph and eager
       bit-equal;
    4. the graph's kernel nodes by name (32 K2 a step, in int8 225 K4
       decode, no K4 prefill, no K1), and what a replay adds to the
       counters equal to them;
    5. REST under load: while the N_REQUESTS prompts are served by the
       batcher, one {"prompts": [2 texts]} and one {"prompt", "temperature":
       0.7, "seed": 5} (both the generate() path: new keys, captured while
       the batcher's thread replays) answer 200 with the tokens the same
       requests get alone afterwards.

    Returns the phase's numbers and the launches of the graph calls of
    parts 1-3 (the generate path's share of the kernel table)."""
    import torch

    n_layers = LLAMA2_7B["n_layers"]
    quantized = server.quantize == "int8"
    k4 = K4_PER_FORWARD if quantized else 0
    plen = 128
    key = (N_REQUESTS, plen + MAX_NEW)
    counted = {}

    def call(texts_, max_new=MAX_NEW, eager=False, **kw):
        """One generate() call: (its result, its wall, its per-step wall);
        a graph call's launches are checked and summed into ``counted``,
        and every decode step of it must be a replay."""
        before = read_counts(server)
        replays, n_eager = server._generate_replays, server._generate_eager
        rows = 1 if len(texts_) == 1 else N_REQUESTS
        # a first use captures the key's graph after one warm-up step
        warm_up = int(not eager and (rows, plen + max_new) not in server._generate_graphs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = server.generate(texts_, max_new_tokens=max_new, _eager=eager, **kw)
        wall = time.perf_counter() - t0
        step_s = server._decode_step_times[-1]
        after = read_counts(server)
        steps = (server._generate_replays - replays, server._generate_eager - n_eager)
        want_steps = (0, max_new - 1) if eager else (max_new - 1, 0)
        if steps != want_steps:
            fail(f"[{label}] generate() ran (replayed, eager) decode steps {steps}, expected "
                 f"{want_steps}")
        if not eager:
            delta = {k: after[k] - before[k] for k in after if k not in ("replays", "eager")}
            want = generate_launches(server, rows, plen, max_new + warm_up)
            if delta != want:
                fail(f"[{label}] one generate() call of {len(texts_)} x {max_new} launched "
                     f"{delta}, expected {want}")
            for k, n in delta.items():
                counted[k] = counted.get(k, 0) + n
        return out, wall, step_s

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager, eager_wall, eager_step = call(texts, eager=True)
    graph, first_wall, first_step = call(texts)
    again, graph_wall, graph_step = call(texts)
    if not (graph == eager == again):
        fail(f"[{label}] generate() through its graph differs from the eager switch")
    # an oracle apart from the programs the graph replays: the eager
    # switch runs the same step program and kernels
    teacher_check(f"{label} generate()", card, server, texts, graph["tokens"])
    g = server._generate_graphs.get(key)
    if g is None:
        fail(f"[{label}] generate() holds graphs {sorted(server._generate_graphs)}, not {key}")
    dense_gb = server._dense.nbytes() / 1e9
    pool_gb = graph_pool_gb(server._generate_graphs.values())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{label}] generate() of {N_REQUESTS} texts x {MAX_NEW} tokens, greedy (key {key}): "
          f"tokens bit-equal through the graph and the eager switch; per-step wall "
          f"(_decode_step_times: decode wall / {MAX_NEW - 1}, the sync included) eager "
          f"{eager_step * 1e3:.3f} ms, graph {graph_step * 1e3:.3f} ms (first call, capture "
          f"outside the wall, {first_step * 1e3:.3f}); call wall eager {eager_wall:.3f} s, "
          f"graph {graph_wall:.3f} s (first {first_wall:.3f} s); capture of the key "
          f"{g.capture_s * 1e3:.1f} ms of host (capture + instantiate); dense buffer "
          f"{dense_gb:.3f} GB, generate pool {gb_text(pool_gb)}; peak device memory "
          f"{peak_gb:.2f} GB [{card}]", flush=True)

    # the step on the buffer's live state: replay against the eager program
    d = server._dense
    tok, pos, done, keys = d.state(N_REQUESTS)
    start = (pos - (MAX_NEW - 1)).clone()
    caches = d.caches(*key)
    step = server._get_decode(*key)

    def eager_step_fn():
        pos.copy_(start)
        return step(caches, tok, pos, done, keys, d.temperature)

    def replay_fn():
        pos.copy_(start)
        return g.replay()

    names = graph_kernel_names(g.graph)
    in_graph = node_counts(names)
    want_k = (n_layers, 0, k4, 0)
    for what, seen in (("eager step launched", launches_of(eager_step_fn)),
                       ("graph holds kernel nodes", in_graph),
                       ("replay added to the counters", launches_of(replay_fn))):
        if seen != want_k:
            fail(f"[{label}] one generate step: {what} (K2, K4 prefill, K4 decode, K1) {seen}, "
                 f"expected {want_k}")
    host_e, dev_e, ops_e, k2_e = profile_step(eager_step_fn, K2_KERNEL)
    host_g, dev_g, ops_g, _ = profile_step(replay_fn, K2_KERNEL)
    ev_g = events_ms(replay_fn)
    traced = (f"torch.profiler {dev_g:.3f} ms in {sum(e.count for e in ops_g)} kernels and "
              f"copies" if ops_g else "torch.profiler saw no device event in the replay")
    print(f"[{label}] generate step (key {key}) on live state: the graph holds (K2, K4 prefill, "
          f"K4 decode, K1) {in_graph} kernel nodes of {len(names)} (by function name), as one "
          f"eager step launches and one replay adds; eager step host enqueue {host_e:.3f} ms, "
          f"device time {dev_e:.3f} ms in {sum(e.count for e in ops_e)} kernels and copies "
          f"(torch.profiler; {k2_e['calls']} K2); graph replay host time {host_g:.4f} ms "
          f"(median of {REPS}), device time {ev_g:.3f} ms (CUDA events, median of {REPS}), "
          f"{traced} [{card}]", flush=True)
    for e in ops_e[:10]:
        print(f"  {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:100]} [{card}]")

    # 2. reuse of the buffer under another key, then the first key again
    growths = server._dense_growths
    one, one_wall, one_step = call(texts[:1], max_new=8)
    one_eager = call(texts[:1], max_new=8, eager=True)[0]
    one_fresh = fresh_generate(server, texts[:1], 8)
    third = call(texts)[0]
    third_fresh = fresh_generate(server, texts, MAX_NEW)
    if not (one == one_eager == one_fresh) or not (third == eager == third_fresh):
        fail(f"[{label}] generate() on the reused buffer differs from the eager switch or a "
             f"fresh buffer")
    if server._dense_growths != growths:
        fail(f"[{label}] the dense buffer grew under a smaller key")
    print(f"[{label}] generate() reuse: 1 text x 8 tokens (key (1, {plen + 8})), then the "
          f"{N_REQUESTS} texts again: both bit-equal to the eager switch and to a fresh "
          f"buffer; per-step wall of the 1-text call {one_step * 1e3:.3f} ms, call wall "
          f"{one_wall:.3f} s; no growth ({growths} growths of the buffer on this server so "
          f"far) [{card}]", flush=True)

    # 3. sampled, seeded: the temperature is data of the graph
    sampled, sampled_wall, sampled_step = call(texts, temperature=0.7, seed=11)
    sampled_eager = call(texts, eager=True, temperature=0.7, seed=11)[0]
    if sampled != sampled_eager or sampled == eager:
        fail(f"[{label}] sampled generate(): graph == eager {sampled == sampled_eager}, "
             f"== greedy {sampled == eager}")
    print(f"[{label}] generate() sampled (temperature 0.7, seed 11): graph and eager switch "
          f"bit-equal, unlike the greedy tokens; per-step wall {sampled_step * 1e3:.3f} ms "
          f"[{card}]", flush=True)

    # 5. REST under load: the batcher serves while generate() captures and
    # replays on REST threads
    bodies = [{"prompts": texts[:2]}, {"prompt": texts[2], "temperature": 0.7, "seed": 5}]
    loaded = [None, None]
    batched = [None]

    def private(i):
        loaded[i] = post(url + "/v1/generate", bodies[i])

    threads = [threading.Thread(target=lambda: batched.__setitem__(0, post_all(url, texts)))]
    threads += [threading.Thread(target=private, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    served_tokens(f"{label} under load", batched[0][0] if batched[0] else [None])
    alone = [post(url + "/v1/generate", body) for body in bodies]
    for i, (got, want) in enumerate(zip(loaded, alone)):
        if got is None or got[0] != 200 or want[0] != 200 or got[1]["tokens"] != want[1]["tokens"]:
            fail(f"[{label}] generate() request {bodies[i]} under load answered "
                 f"{got and got[0]} with other tokens than alone ({want[0]})")
    pool_gb = graph_pool_gb(server._generate_graphs.values())
    print(f"[{label}] REST under load: {N_REQUESTS} batched requests (200) with one "
          f"'prompts' request of 2 texts and one 'prompt' at temperature 0.7, seed 5, at "
          f"once: both 200 with the tokens they get alone; generate graphs "
          f"{sorted(server._generate_graphs)} in one pool ({gb_text(pool_gb)}) [{card}]",
          flush=True)
    # the graphs captured while the batcher's thread replayed: each counted
    # its own kernels only, and a replay adds exactly its kernel nodes
    for gkey, gg in sorted(server._generate_graphs.items()):
        nodes = node_counts(graph_kernel_names(gg.graph))
        with server._dense_lock:
            server._dense.pos[:gkey[0]].zero_()   # the replay writes at position 0
            added = launches_of(gg.replay)
            torch.cuda.synchronize()
        if not (nodes == added == want_k):
            fail(f"[{label}] generate graph {gkey}: (K2, K4 prefill, K4 decode, K1) kernel "
                 f"nodes {nodes}, a replay adds {added}, expected {want_k}")
    print(f"[{label}] generate graphs {sorted(server._generate_graphs)}, two of them "
          f"captured under load: each holds (K2, K4 prefill, K4 decode, K1) {want_k} kernel "
          f"nodes, and a replay adds exactly those to the counters [{card}]", flush=True)
    return {"eager_step_ms": eager_step * 1e3, "graph_step_ms": graph_step * 1e3,
            "eager_wall_s": eager_wall, "graph_wall_s": graph_wall,
            "capture_ms": g.capture_s * 1e3, "dense_gb": dense_gb, "pool_gb": pool_gb,
            "peak_gb": peak_gb, "eager_host_ms": host_e, "eager_dev_ms": dev_e,
            "host_ms": host_g, "dev_ms": ev_g, "graphs": len(server._generate_graphs),
            "launches": counted}


# ---------------------------------------------------------------------------
# Streaming: SSE on /v1/generate, the scrape, the 1-slot stream service, gRPC
# ---------------------------------------------------------------------------
# token events closer than this arrived in one drain's burst
BURST_GAP_MS = 2.0


def sse_client(url: str, body: dict, stop_after: Optional[int] = None, on_event=None,
               headers: Optional[dict] = None, resp_headers: Optional[dict] = None):
    """One streaming POST /v1/generate read event by event as it arrives
    (``readline``). Returns (status, the time the request was sent, [(arrival
    time, event)], the time the response's headers arrived: the server sends
    them just before it submits the request); with ``stop_after`` the
    client closes its socket after that many events; ``on_event(event)``
    is called as each arrives. ``headers`` go with the request; the
    response's are copied into ``resp_headers`` when given."""
    import http.client
    from urllib.parse import urlsplit

    u = urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/generate", json.dumps(dict(body, stream=True)),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    t_headers = time.perf_counter()
    if resp_headers is not None:
        resp_headers.update(resp.getheaders())
    events = []
    try:
        if resp.status != 200:
            return resp.status, t0, [(time.perf_counter(), resp.read().decode())], t_headers
        while stop_after is None or len(events) < stop_after:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if line.startswith(b"data: "):
                events.append((time.perf_counter(), json.loads(line[6:])))
                if on_event is not None:
                    on_event(events[-1][1])
    finally:
        resp.close()
        conn.close()
    return 200, t0, events, t_headers


def streamed_tokens(label: str, res) -> list:
    """The tokens of one finished stream; fails unless it answered 200 and
    its token events equal its done event's MAX_NEW tokens."""
    if res is None:
        fail(f"[{label}] a stream did not complete")
    code, _, events, _ = res
    if code != 200 or not events:
        fail(f"[{label}] a stream answered {code}: {events}")
    done = events[-1][1]
    toks = [e["token"] for _, e in events[:-1] if "token" in e]
    if done.get("done") is not True or len(toks) != len(events) - 1:
        fail(f"[{label}] a stream did not end with its done event: {done}")
    if toks != done["tokens"] or len(toks) != MAX_NEW:
        fail(f"[{label}] a stream's token events {toks} != its done tokens {done['tokens']} "
             f"(expected {MAX_NEW})")
    return toks


def scrape(url: str) -> list:
    """GET /metrics: [(sample name, its labels' text, value)], the
    Prometheus text format parsed here (the card has no prometheus_client)."""
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    out = []
    for line in text.splitlines():
        if line and not line.startswith("#"):
            sample, value = line.rsplit(" ", 1)
            name, _, labels = sample.partition("{")
            out.append((name, labels, float(value)))
    return out


def sample(samples: list, name: str, *labels: str) -> float:
    """The sum of ``name``'s samples whose labels hold each of ``labels``."""
    return sum(v for n, text, v in samples if n == name and all(x in text for x in labels))


def stream_phase(label: str, card: str, server, b, url: str, texts, step_ms: float) -> dict:
    """Streaming on the served path (the batcher's graphs): N_REQUESTS
    concurrent SSE clients on the run's prompts, each read event by event.
    Hard checks: each stream's token events equal its done tokens, which
    pass the teacher-forced check; every prefill chunk and every decode
    dispatch was a replay and each kernel launched what the path needs; one
    scrape of /metrics (after this function has read the deques it times)
    counts TTFT once a request and the inter-token gap once a credited
    token less one a request, and its page gauges equal ``page_stats()``;
    a client that closes its socket after 4 events leaves the loop alive
    (``crashed`` None, the handler's write failed), every page returns, and
    the next request is answered. Printed: the client's time to first event
    beside the server's TTFT, the inter-event gap beside the step wall,
    the events a burst, and the streamed step beside ``step_ms`` (this
    run's non-streamed step). Returns (launches, numbers)."""
    import torch

    quantized = server.quantize == "int8"
    torch.cuda.synchronize()
    zero_counts(server)
    server._decode_replays = server._decode_eager = 0
    base = scrape(url)
    results = [None] * len(texts)

    def client(i):
        results[i] = sse_client(url, {"prompt": texts[i]})

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    launches = read_counts(server)
    decode = (server._decode_replays, server._decode_eager)
    served = [streamed_tokens(label, r) for r in results]
    ttft = sorted(server._ttft_times)
    steps = sorted(server._decode_step_times)
    n_gaps = len(server._inter_token_times)
    pages = b.page_stats()
    after = scrape(url)   # drains the deques read above
    check_launches(label, card, launches, [128] * len(texts), quantized,
                   server.kv_cache_dtype == "int8", eager=False)
    if decode[0] == 0 or decode[1]:
        fail(f"[{label}] decode dispatches (replays, eager) {decode}: expected replays only")
    credited = len(texts) * MAX_NEW
    seen = {k: sample(after, k) - sample(base, k) for k in (
        "seldon_llm_ttft_seconds_count", "seldon_llm_inter_token_seconds_count")}
    want = {"seldon_llm_ttft_seconds_count": len(texts),
            "seldon_llm_inter_token_seconds_count": credited - len(texts)}
    if seen != want or n_gaps != want["seldon_llm_inter_token_seconds_count"]:
        fail(f"[{label}] the scrape counted {seen} ({n_gaps} gaps recorded), expected {want}")
    gauges = (sample(after, "seldon_llm_kv_pages_in_use"),
              sample(after, "seldon_llm_kv_pages_total"))
    if gauges != (pages["kv_pages_in_use"], pages["kv_pages_total"]):
        fail(f"[{label}] the scrape's page gauges (in use, total) {gauges} != page_stats "
             f"{pages}")
    teacher_check(label, card, server, texts, served)

    ttfe = sorted((r[2][0][0] - r[1]) * 1e3 for r in results)
    # from the headers (sent just before the submit) to the first event
    after_headers = sorted((r[2][0][0] - r[3]) * 1e3 for r in results)
    gaps = sorted((e1[0] - e0[0]) * 1e3 for r in results
                  for e0, e1 in zip(r[2][:-2], r[2][1:-1]))
    bursts = []
    for r in results:
        size = 1
        for e0, e1 in zip(r[2][:-2], r[2][1:-1]):
            if (e1[0] - e0[0]) * 1e3 < BURST_GAP_MS:
                size += 1
            else:
                bursts.append(size)
                size = 1
        bursts.append(size)
    streamed_step = statistics.median(steps) * 1e3
    out = {"ttfe_med_ms": statistics.median(ttfe), "ttfe_max_ms": ttfe[-1],
           "headers_to_first_med_ms": statistics.median(after_headers),
           "headers_to_first_max_ms": after_headers[-1],
           "ttft_med_ms": statistics.median(ttft) * 1e3, "ttft_max_ms": ttft[-1] * 1e3,
           "gap_med_ms": statistics.median(gaps), "gap_p90_ms": gaps[int(0.9 * (len(gaps) - 1))],
           "gap_max_ms": gaps[-1], "step_ms": streamed_step, "plain_step_ms": step_ms,
           "burst_med": statistics.median(bursts), "burst_max": max(bursts), "wall_s": wall}
    print(f"[{label}] streaming: {len(texts)} concurrent SSE clients x {MAX_NEW} tokens in "
          f"{wall:.3f} s (chunked, one event a chunk, every chunk and dispatch a replay: "
          f"{launches['replays']} chunks, {decode[0]} dispatches); client time to first event "
          f"median {out['ttfe_med_ms']:.1f} / max {out['ttfe_max_ms']:.1f} ms (from the "
          f"response headers, sent just before the submit: {out['headers_to_first_med_ms']:.1f} "
          f"/ {out['headers_to_first_max_ms']:.1f} ms) beside the server's TTFT "
          f"{out['ttft_med_ms']:.1f} / {out['ttft_max_ms']:.1f} ms; inter-event "
          f"gap median {out['gap_med_ms']:.2f} / p90 {out['gap_p90_ms']:.2f} / max "
          f"{out['gap_max_ms']:.2f} ms beside the streamed step wall median "
          f"{streamed_step:.2f} ms; events a burst (arrivals under {BURST_GAP_MS} ms apart) "
          f"median {out['burst_med']} max {out['burst_max']} ({len(bursts)} bursts); decode "
          f"step median streamed {streamed_step:.2f} ms vs not streamed {step_ms:.2f} ms in "
          f"this call; the scrape counted {seen['seldon_llm_ttft_seconds_count']:.0f} TTFTs "
          f"and {seen['seldon_llm_inter_token_seconds_count']:.0f} gaps, page gauges "
          f"{gauges} [{card}]", flush=True)
    last = results[-1][2]
    print(f"[{label}] the last client's {len(last)} events arrived at (ms after its first): "
          f"{' '.join(f'{(t - last[0][0]) * 1e3:.1f}' for t, _ in last)} [{card}]", flush=True)

    # a client that leaves after 4 events: its handler's next write fails
    # and cancels the request, which decodes out with its result dropped
    def failed_generates():
        return sample(scrape(url), "seldon_api_executor_server_requests_total",
                      'method="generate"', 'code="500"')

    failed_before = failed_generates()
    code, _, events, _ = sse_client(url, {"prompt": texts[0]}, stop_after=4)
    if code != 200 or len(events) != 4:
        fail(f"[{label}] the disconnecting client read {code}, {len(events)} events")
    t0 = time.perf_counter()
    failed_writes = 0.0
    while time.perf_counter() - t0 < 120:
        failed_writes = failed_generates() - failed_before
        if failed_writes and b.page_stats()["kv_pages_in_use"] == 0:
            break
        time.sleep(0.05)
    in_use = b.page_stats()["kv_pages_in_use"]
    if b.crashed is not None or not b._thread.is_alive() or in_use or not failed_writes:
        fail(f"[{label}] after a client disconnect: crashed {b.crashed!r}, loop alive "
             f"{b._thread.is_alive()}, {in_use} pages in use, failed writes {failed_writes}")
    code, body = post(url + "/v1/generate", {"prompt": texts[1], "max_new_tokens": 4})
    if code != 200 or len(body.get("tokens", ())) != 4:
        fail(f"[{label}] the request after a disconnect answered {code}: {body}")
    print(f"[{label}] a client that closed its socket after 4 events: the handler's write "
          f"failed ({failed_writes:.0f} more generate request counted as 500), the loop is alive "
          f"(crashed None), 0 pages in use once it drained, and the next request answered "
          f"200 with 4 tokens [{card}]", flush=True)
    return launches, out


def stream_service_phase(label: str, card: str, server, url: str, texts) -> dict:
    """The 1-slot stream service a component without continuous batching
    streams through (``runtime/batcher.ensure_stream_service``), built on
    the served weights while the run's 8-slot service is set aside: its
    capture time (prefill graphs a chunk length and the decode graph, under
    ``set_sync_debug_mode("error")``) and graph pools; one stream through
    it over REST, teacher-forced, its chunk and every decode dispatch a
    replay."""
    import torch

    from seldon_core_tpu_torch.runtime.batcher import ensure_stream_service

    shared, slots = server._batcher_service, server.continuous_batching
    server._batcher_service, server.continuous_batching = None, 0
    try:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            svc = ensure_stream_service(server)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        one = svc.batcher
        if one.S != 1 or sorted(one._prefill_graphs) != sorted(PREFILL_CHUNKS) \
                or sorted(one._graphs) != [1]:
            fail(f"[{label}] the stream service has {one.S} slots, prefill graphs "
                 f"{sorted(one._prefill_graphs)} and decode graphs {sorted(one._graphs)}")
        kv_gb = sum(t.numel() * t.element_size() for layer in one._caches for t in layer) / 1e9
        out = {"build_s": build_s, "prefill_pool_gb": graph_pool_gb(one._prefill_graphs.values()),
               "decode_pool_gb": graph_pool_gb(one._graphs.values()), "kv_gb": kv_gb,
               "added_gb": (torch.cuda.memory_allocated() - mem0) / 1e9}
        replays = server._prefill_replays
        server._decode_replays = server._decode_eager = 0
        res = sse_client(url, {"prompt": texts[0]})
        toks = streamed_tokens(f"{label} stream service", res)
        decode = (server._decode_replays, server._decode_eager)
        if server._prefill_replays != replays + 1:
            fail(f"[{label}] the stream service's chunk was not a replay")
        if decode[0] == 0 or decode[1]:
            fail(f"[{label}] the stream service's decode dispatches (replays, eager) {decode}: "
                 f"expected replays only")
        svc.close()
    finally:
        server._batcher_service, server.continuous_batching = shared, slots
    teacher_check(f"{label} stream service", card, server, texts[:1], [toks])
    print(f"[{label}] 1-slot stream service (no continuous batching): built in "
          f"{build_s:.3f} s (prefill graphs {sorted(PREFILL_CHUNKS)} and the K = 1 decode graph "
          f"captured under set_sync_debug_mode('error')); graph pools prefill "
          f"{gb_text(out['prefill_pool_gb'])}, decode {gb_text(out['decode_pool_gb'])}; its KV "
          f"pool {kv_gb:.3f} GB; +{out['added_gb']:.3f} GB allocated; one stream through it: "
          f"{MAX_NEW} events equal its done tokens, its chunk and {decode[0]} decode "
          f"dispatches replays, time to first event "
          f"{(res[2][0][0] - res[1]) * 1e3:.1f} ms [{card}]", flush=True)
    return out


def grpc_phase(label: str, card: str, server, url: str, text: str) -> None:
    """One Model/GenerateStream through the port's gRPC server, its events
    equal to an SSE stream's of the same prompt. Only a missing grpcio or
    protobuf skips it, with a line that says so."""
    try:
        import grpc

        from seldon_core_tpu_torch.contracts.payload import SeldonMessage
        from seldon_core_tpu_torch.transport import proto_convert as pc
        from seldon_core_tpu_torch.transport.grpc_server import make_component_server
        from seldon_core_tpu_torch.transport.proto import prediction_pb2 as pb
    except ImportError as e:
        if (e.name or "").split(".")[0] not in ("grpc", "google"):
            raise
        print(f"[{label}] gRPC unverified on the card: the '{e.name}' module is not installed "
              f"here, so Model/GenerateStream was not run [{card}]", flush=True)
        return
    srv = make_component_server(server, host="127.0.0.1", port=None)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            rpc = channel.unary_stream("/seldon.protos.Model/GenerateStream",
                                       request_serializer=lambda m: m.SerializeToString(),
                                       response_deserializer=pb.SeldonMessage.FromString)
            request = pc.message_to_proto(SeldonMessage.from_json_data({"prompt": text}))
            got = [pc.message_from_proto(m).json_data for m in rpc(request, timeout=600)]
    finally:
        srv.stop(None)
    want = [e for _, e in sse_client(url, {"prompt": text})[2]]
    if got != want:
        fail(f"[{label}] gRPC GenerateStream events differ from SSE's: {got} vs {want}")
    print(f"[{label}] gRPC Model/GenerateStream: {len(got)} events, equal to the SSE "
          f"stream's [{card}]", flush=True)


# ---------------------------------------------------------------------------
# Tracing: W3C traceparent, the flight recorder, OTLP, /debug/timeline
# ---------------------------------------------------------------------------
TRACE_TAIL_TTFT_MS = "1"   # the tail threshold: every served TTFT is above it
TRACE_TURNS = ("plain", "traced", "traced", "plain")   # greedy, in turns
TRACE_TTFT_TOL_S = 1e-3


class OTLPCollector:
    """An OTLP/HTTP collector on 127.0.0.1 (the standard library's
    http.server): every POST body to /v1/traces kept, parsed."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.bodies = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                data = self.rfile.read(int(self.headers["Content-Length"]))
                ok = self.path == "/v1/traces"
                if ok:
                    outer.bodies.append(json.loads(data))
                self.send_response(200 if ok else 404)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def spans(self) -> list:
        return [s for b in self.bodies for rs in b["resourceSpans"]
                for ss in rs["scopeSpans"] for s in ss["spans"]]

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


@contextlib.contextmanager
def traced(collector: Optional[OTLPCollector] = None):
    """The process tracer on for the block (exporting to ``collector`` when
    given), then flushed and off again. The REST and gRPC apps hold the
    tracer object itself, so the switch reaches apps built before it; a
    batcher built inside the block carries a flight recorder."""
    from seldon_core_tpu_torch.tracing import get_tracer
    from seldon_core_tpu_torch.tracing.export import OTLPExporter

    tr = get_tracer()
    if tr.enabled:
        fail("the tracer is on before a traced part: TRACING must be unset for chip_smoke")
    tr.enabled = True
    tr.exporter = OTLPExporter(collector.url, timeout_s=30.0) if collector is not None else None
    try:
        yield tr
    finally:
        tr.flush()
        tr.enabled, tr.exporter = False, None
        tr.drain()


def gate_admission(b, n: int, timeout_s: float = 120.0) -> None:
    """Installs a one-shot hook on the batcher's loop (its ``_chaos``, called
    at the top of every turn): the next turn waits until ``n`` requests are
    queued, then the hook removes itself. The loop decides from host state
    alone, so a gated run admits, prefills and dispatches on the same
    schedule whatever time its clients arrive at: two runs' launch counts
    compare exactly."""
    def hook(batcher):
        t0 = time.perf_counter()
        while len(batcher._pending) < n:
            if time.perf_counter() - t0 > timeout_s:
                batcher._chaos = None
                raise RuntimeError(f"gate: {len(batcher._pending)} of {n} requests queued")
            time.sleep(0.0002)
        batcher._chaos = None

    b._chaos = hook


def trace_ids(i: int, turn: int):
    """Request i's inbound (trace id, span id) in run ``turn``: unique."""
    return f"{turn:08x}{i:08x}" + "7" * 16, f"{turn:04x}{i:04x}" + "5" * 8


def traceparent(parent, sampled: bool = True) -> dict:
    return {"traceparent": f"00-{parent[0]}-{parent[1]}-{'01' if sampled else '00'}"}


def post_traced(url: str, bodies, parents, sampled: bool = True):
    """One POST /v1/generate a body, all at once, request i with the W3C
    traceparent of ``parents[i]``. Returns (results as (status, headers,
    body), wall)."""
    results = [None] * len(bodies)

    def client(i):
        results[i] = post_headers(url + "/v1/generate", bodies[i],
                                  headers=traceparent(parents[i], sampled))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return results, time.perf_counter() - t0


def check_timelines(label: str, server, b, texts, results, parents, sampling: str) -> dict:
    """Each request's timeline in ``b``'s recorder, found by its inbound
    trace id: status ``done``, ``sampling``, no event dropped, the token
    events' sum = its tokens = the response's count, one ``prefill_chunk``
    event a chunk its prompt runs, one ``first_token``; the TTFTs within
    TRACE_TTFT_TOL_S of the batcher's own observations (``_ttft_times``,
    both sorted). Returns {trace id: timeline}."""
    by_id = {t["trace_id"]: t for t in b._flight.timelines(256)}
    out = {}
    for i, (res, parent) in enumerate(zip(results, parents)):
        tl = by_id.get(parent[0])
        if tl is None:
            fail(f"[{label}] request {i}: no timeline for its trace id {parent[0]}")
        code, _, body = res
        if code != 200 or body.get("trace_id") != parent[0]:
            fail(f"[{label}] request {i} answered {code} with trace_id {body.get('trace_id')}, "
                 f"sent {parent[0]}")
        kinds = [e["kind"] for e in tl["events"]]
        chunks = chunks_of(b, len(prompt_ids(server, texts[i])))
        if (tl["status"], tl["sampling"], tl["events_dropped"]) != ("done", sampling, 0) or \
                not (tl["token_events_sum"] == tl["tokens"] == len(body["tokens"])) or \
                kinds.count("prefill_chunk") != len(chunks) or kinds.count("first_token") != 1:
            fail(f"[{label}] request {i}'s timeline: status {tl['status']}, sampling "
                 f"{tl['sampling']} (want {sampling}), dropped {tl['events_dropped']}, token "
                 f"events {tl['token_events_sum']} / credited {tl['tokens']} / served "
                 f"{len(body['tokens'])}, chunks {kinds.count('prefill_chunk')} (the prompt "
                 f"runs {len(chunks)}), first tokens {kinds.count('first_token')}")
        out[parent[0]] = tl
    got = sorted(t["ttft_s"] for t in out.values())
    want = sorted(server._ttft_times)
    if len(got) != len(want) or max(abs(x - y) for x, y in zip(got, want)) > TRACE_TTFT_TOL_S:
        fail(f"[{label}] timeline TTFTs {got} vs the batcher's {want} (tolerance "
             f"{TRACE_TTFT_TOL_S} s)")
    return out


def span_trees(label: str, collector: OTLPCollector, trees) -> int:
    """``trees``: (timeline, the inbound span id). Each retained request's
    spans at the collector form one tree in its trace: one root
    ``llm.request <ingress>``, under the caller's span when head-sampled
    (tail: no parent), every other span its child, one ``llm.step`` a step
    event. Returns the trees checked."""
    by_trace = {}
    for s in collector.spans():
        by_trace.setdefault(s["traceId"], []).append(s)
    for tl, parent_span in trees:
        mine = by_trace.get(tl["trace_id"], [])
        roots = [s for s in mine if s["name"].startswith("llm.request")]
        if len(roots) != 1:
            fail(f"[{label}] trace {tl['trace_id']}: {len(roots)} roots among {len(mine)} spans")
        root = roots[0]
        want_parent = parent_span if tl["sampling"] == "head" else None
        steps = sum(1 for e in tl["events"] if e["kind"] == "step")
        if root["name"] != f"llm.request {tl['ingress']}" or \
                root.get("parentSpanId") != want_parent or \
                any(s.get("parentSpanId") != root["spanId"] for s in mine if s is not root) or \
                sum(1 for s in mine if s["name"] == "llm.step") != steps:
            fail(f"[{label}] trace {tl['trace_id']}'s spans do not form its request's tree "
                 f"(root {root['name']!r} under {root.get('parentSpanId')}, want "
                 f"{want_parent}; {len(mine)} spans, {steps} steps)")
    return len(trees)


def tracing_phase(card: str, server) -> list:
    """[bf16 tracing] on a loaded bf16 server (graph batchers, K = 1). Two
    services on it, built under ``set_sync_debug_mode("error")``: a plain
    one (``tracing=False``) and a traced one (``tracing=True``, the TTFT
    tail threshold set). The N_REQUESTS prompts go over REST in turns
    (TRACE_TURNS), the tracer off for the plain turns, each turn's
    admission gated (``gate_admission``) so every turn runs one schedule.
    Checks: every turn's tokens bit-equal to the first plain turn's and its
    K1 and K2 launches equal to it (``check_launches``: every chunk a
    replay, none eager; no eager dispatch); the traced turns' timelines
    (``check_timelines``, each request with a sampled inbound
    traceparent); two requests with unsampled traceparents retained by the
    tail threshold; an SSE stream's ``X-Trace-Id`` = its done event's trace
    id = the inbound one, gRPC ``GenerateStream``'s ``x-trace-id`` initial
    metadata likewise; REST ``/debug/timeline?n=8`` = gRPC
    ``DebugTimeline`` with the server quiescent; at the OTLP collector one
    span tree a retained request (``span_trees``), the scrape's
    ``seldon_trace_spans_dropped_total`` 0 and its retained counts the
    recorder's; then both services rebuilt at T = FAULT_TEMPERATURE, top_k
    FAULT_TOP_K, and the seeded prompts once each way, bit-equal, with
    equal K1 and K2 launches. Measured: each turn's decode step wall
    median and host time a dispatch. Returns the launch records of every
    turn."""
    import grpc

    import torch

    from seldon_core_tpu_torch.contracts.payload import SeldonMessage
    from seldon_core_tpu_torch.transport import proto_convert as pc
    from seldon_core_tpu_torch.transport.grpc_server import make_component_server
    from seldon_core_tpu_torch.transport.proto import prediction_pb2 as pb

    label = "bf16 tracing"
    t_phase = time.perf_counter()
    texts = prompts(N_REQUESTS)
    bodies = [{"prompt": t} for t in texts]
    server.decode_fuse_steps = 0
    top_k0 = server.top_k
    collector = OTLPCollector()
    records, turns, trees = [], [], []
    svcs, httpds, urls = {}, [], {}

    def build(temperature: float, top_k: int) -> None:
        for svc in svcs.values():
            svc.close()
        server._batcher_service = None
        svcs.clear()
        server.temperature, server.top_k = temperature, top_k
        with server._lock:
            server._decode_cache.clear()  # the step programs hold top_k
        release_server_memory()
        builds = []
        for mode in ("plain", "traced"):
            if mode == "traced":
                os.environ["TRACING_TAIL_TTFT_MS"] = TRACE_TAIL_TTFT_MS
            try:
                svc, httpd, url, build_s = build_service(f"{label} {mode}", server,
                                                         tracing=mode == "traced")
            finally:
                os.environ.pop("TRACING_TAIL_TTFT_MS", None)
            svcs[mode], urls[mode] = svc, url
            httpds.append(httpd)
            builds.append(build_s)
        rec = svcs["traced"].batcher._flight
        if svcs["plain"].batcher._flight is not None or rec is None or \
                rec.tail_ttft_s != float(TRACE_TAIL_TTFT_MS) / 1e3:
            fail(f"[{label}] the recorders: plain {svcs['plain'].batcher._flight}, traced {rec}")
        print(f"[{label}] services built at temperature {temperature}: plain {builds[0]:.2f} s, "
              f"traced {builds[1]:.2f} s (graphs captured under set_sync_debug_mode('error')) "
              f"[{card}]", flush=True)

    def run(mode: str, turn: int, reqs, tr) -> dict:
        svc = svcs[mode]
        server._batcher_service = svc
        b = svc.batcher
        parents = [trace_ids(i, turn) for i in range(len(reqs))]
        torch.cuda.synchronize()
        zero_counts(server)
        server._decode_replays = server._decode_eager = 0
        tr.enabled = mode == "traced"
        gate_admission(b, len(reqs))
        try:
            results, wall = post_traced(urls[mode], reqs, parents)
        finally:
            tr.enabled = True
        counts = read_counts(server)
        if b._chaos is not None:
            fail(f"[{label}] turn {turn}: the gate never opened")
        served = served_tokens(f"{label} turn {turn}", [(c, body) for c, _, body in results])
        steps = check_launches(f"{label} turn {turn} ({mode})", card, counts,
                               [128] * len(reqs), False, False, False)
        if server._decode_eager or server._decode_replays <= 0:
            fail(f"[{label}] turn {turn}: decode dispatches replayed {server._decode_replays}, "
                 f"eager {server._decode_eager}")
        m = {"mode": mode, "step_ms": statistics.median(server._decode_step_times) * 1e3,
             "dispatch_ms": statistics.median(server._decode_dispatch_times) * 1e3,
             "steps": steps, "wall_s": wall, "counts": counts, "served": served}
        if mode == "traced":
            tls = check_timelines(f"{label} turn {turn}", server, b, texts, results, parents,
                                  "head")
            trees.extend((tls[tid], sid) for tid, sid in parents)
        records.append((f"{label} turn {turn}", counts))
        return m

    def same(ref: dict, m: dict, what: str) -> None:
        if m["served"] != ref["served"]:
            fail(f"[{label}] {what}: a {m['mode']} turn's tokens differ from the plain turn's")
        if (m["counts"]["k1"], m["counts"]["k2"]) != (ref["counts"]["k1"], ref["counts"]["k2"]):
            fail(f"[{label}] {what}: a {m['mode']} turn's K1 / K2 launches {m['counts']['k1']} "
                 f"/ {m['counts']['k2']} != the plain turn's {ref['counts']['k1']} / "
                 f"{ref['counts']['k2']}")

    try:
        with traced(collector) as tr:
            build(0.0, top_k0)
            for turn, mode in enumerate(TRACE_TURNS):
                turns.append(run(mode, turn, bodies, tr))
            for m in turns[1:]:
                same(turns[0], m, "greedy")
            # the tail: two unsampled requests, retained by the TTFT threshold
            b = svcs["traced"].batcher
            server._batcher_service = svcs["traced"]
            tail_parents = [trace_ids(i, 90) for i in range(2)]
            zero_counts(server)
            tail, _ = post_traced(urls["traced"], bodies[:2], tail_parents, sampled=False)
            tls = check_timelines(f"{label} tail", server, b, texts[:2], tail, tail_parents,
                                  "tail")
            trees.extend((tls[tid], sid) for tid, sid in tail_parents)
            # SSE, then gRPC: the trace id before the first token = the done event's
            sse_parent, g_parent = trace_ids(0, 91), trace_ids(0, 92)
            hdrs = {}
            res = sse_client(urls["traced"], {"prompt": texts[0]}, resp_headers=hdrs,
                             headers=traceparent(sse_parent))
            streamed_tokens(f"{label} sse", res)
            done = res[2][-1][1]
            if not (hdrs.get("X-Trace-Id") == done.get("trace_id") == sse_parent[0]):
                fail(f"[{label}] SSE X-Trace-Id {hdrs.get('X-Trace-Id')}, done event "
                     f"{done.get('trace_id')}, sent {sse_parent[0]}")
            gsrv = make_component_server(server, host="127.0.0.1", port=None)
            gport = gsrv.add_insecure_port("127.0.0.1:0")
            gsrv.start()
            try:
                with grpc.insecure_channel(f"127.0.0.1:{gport}") as channel:
                    rpc = channel.unary_stream(
                        "/seldon.protos.Model/GenerateStream",
                        request_serializer=lambda m: m.SerializeToString(),
                        response_deserializer=pb.SeldonMessage.FromString)
                    call = rpc(pc.message_to_proto(SeldonMessage.from_json_data(
                        {"prompt": texts[0]})), timeout=600,
                        metadata=tuple(traceparent(g_parent).items()))
                    md = dict(call.initial_metadata())
                    events = [pc.message_from_proto(m).json_data for m in call]
                if not (md.get("x-trace-id") == events[-1].get("trace_id") == g_parent[0]) \
                        or events[-1]["tokens"] != done["tokens"]:
                    fail(f"[{label}] gRPC x-trace-id {md.get('x-trace-id')}, done event "
                         f"{events[-1].get('trace_id')}, sent {g_parent[0]}; tokens equal to "
                         f"SSE's: {events[-1]['tokens'] == done['tokens']}")
                # quiescent: REST /debug/timeline = gRPC DebugTimeline
                with urllib.request.urlopen(urls["traced"] + "/debug/timeline?n=8",
                                            timeout=60) as r:
                    rest = json.loads(r.read())
                with grpc.insecure_channel(f"127.0.0.1:{gport}") as channel:
                    rpc = channel.unary_unary(
                        "/seldon.protos.Model/DebugTimeline",
                        request_serializer=lambda m: m.SerializeToString(),
                        response_deserializer=pb.SeldonMessage.FromString)
                    grep = pc.message_from_proto(rpc(pc.message_to_proto(
                        SeldonMessage.from_json_data({"n": 8})), timeout=60)).json_data
            finally:
                gsrv.stop(None)
            if grep != rest or len(rest["timelines"]) != 8 or not rest["tracing"]:
                fail(f"[{label}] REST /debug/timeline?n=8 ({len(rest['timelines'])} timelines) "
                     f"!= gRPC DebugTimeline ({len(grep.get('timelines', []))})")
            by_id = {t["trace_id"]: t for t in b._flight.timelines(256)}
            trees.extend((by_id[p[0]], p[1]) for p in (sse_parent, g_parent))
            retained = dict(b._flight.snapshot()["retained"])
            tr.flush()
            samples = scrape(urls["traced"])
            dropped = sample(samples, "seldon_trace_spans_dropped_total")
            head = sample(samples, "seldon_llm_traces_retained_total", 'mode="head"')
            tailn = sample(samples, "seldon_llm_traces_retained_total", 'mode="tail"')
            n_trees = span_trees(label, collector, trees)
            if dropped != 0 or tr.spans_dropped_total != 0 or tailn != 2 or \
                    head != retained["head"] or retained["tail"] != 2:
                fail(f"[{label}] scrape: spans dropped {dropped}, retained head {head} / tail "
                     f"{tailn}; the recorder's {retained}")
            posts, n_spans = len(collector.bodies), len(collector.spans())
            # seeded: both services rebuilt at a sampling temperature
            build(FAULT_TEMPERATURE, FAULT_TOP_K)
            seeded = [dict(body, seed=FAULT_SEEDS[i]) for i, body in enumerate(bodies)]
            s_plain = run("plain", 10, seeded, tr)
            s_traced = run("traced", 11, seeded, tr)
            same(s_plain, s_traced, "seeded")
    finally:
        for httpd in httpds:
            httpd.shutdown()
            httpd.server_close()
        for svc in svcs.values():
            svc.close()
        server._batcher_service = None
        server.temperature, server.top_k = 0.0, top_k0
        with server._lock:
            server._decode_cache.clear()
        collector.close()

    def ms(ms_list, key, fmt):
        return " / ".join(format(m[key], fmt) for m in ms_list)

    plain = [m for m in turns if m["mode"] == "plain"]
    trace = [m for m in turns if m["mode"] == "traced"]
    ratio = (statistics.mean(m["step_ms"] for m in trace)
             / statistics.mean(m["step_ms"] for m in plain) - 1)
    ref = turns[0]
    print(f"[{label}] {N_REQUESTS} requests x {MAX_NEW} tokens over REST a turn, admission gated "
          f"(one schedule every turn), turns {' / '.join(TRACE_TURNS)}: tokens bit-equal in "
          f"every turn (greedy; seeded at T = {FAULT_TEMPERATURE}, one turn each way, too), K1 / "
          f"K2 launches equal ({ref['counts']['k1']} / {ref['counts']['k2']}: {ref['steps']} "
          f"decode steps), every chunk and dispatch a replay; decode step wall median traced "
          f"{ms(trace, 'step_ms', '.3f')} ms vs plain {ms(plain, 'step_ms', '.3f')} ms "
          f"({ratio:+.2%}); host time a dispatch median traced {ms(trace, 'dispatch_ms', '.4f')} "
          f"ms vs plain {ms(plain, 'dispatch_ms', '.4f')} ms; seeded step wall traced "
          f"{s_traced['step_ms']:.3f} vs plain {s_plain['step_ms']:.3f} ms [{card}]", flush=True)
    print(f"[{label}] timelines: each request's trace id the inbound one, token events = tokens "
          f"= the response's {MAX_NEW}, no event dropped, one prefill_chunk event a chunk, TTFT "
          f"within {TRACE_TTFT_TOL_S * 1e3:.0f} ms of the batcher's; 2 unsampled requests "
          f"retained by the tail threshold ({TRACE_TAIL_TTFT_MS} ms); SSE X-Trace-Id = its done "
          f"event's, gRPC x-trace-id = its done event's; REST /debug/timeline?n=8 = gRPC "
          f"DebugTimeline; OTLP: {posts} posts, {n_spans} spans, {n_trees} request trees each "
          f"rooted at its ingress span; seldon_trace_spans_dropped_total 0, retained head "
          f"{head:.0f} / tail {tailn:.0f}; phase_s {time.perf_counter() - t_phase:.1f} [{card}]",
          flush=True)
    return records


def serve(label: str, card: str, server, weight_bytes: int, fuse: int = 0,
          eager: bool = False):
    """One serving run of the port's main path through ``server`` (loaded by
    ``load_llm``): its prefill chunks graph replays (one graph per chunk
    length) and its decode dispatches K = 1 and, with ``fuse`` > 1, K =
    ``fuse`` steps, graph replays; or with ``eager`` the eager programs (the
    batcher's private switch, for comparison). The batcher and its graphs
    are built under ``set_sync_debug_mode("error")``. Two sets of requests
    through REST: the N_REQUESTS prompts (one chunk of 128 each), then the
    mixed admission (MIXED_LENGTHS: three chunks of 256, one of 32, one of
    128). Fails on any check; returns (the run's kernel launch counts, its
    metrics)."""
    import gc

    import torch

    from seldon_core_tpu_torch.ops.paged_attention import _split_plan
    from seldon_core_tpu_torch.runtime.batcher import BatcherService
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    quantized = server.quantize == "int8"
    int8_kv = server.kv_cache_dtype == "int8"
    server.decode_fuse_steps = fuse
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        svc = BatcherService(server, max_slots=N_REQUESTS, _eager=eager)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    b = svc.batcher
    want = [] if eager else sorted({1, fuse} if fuse > 1 else {1})
    if sorted(b._graphs) != want:
        fail(f"[{label}] batcher holds graphs of K = {sorted(b._graphs)}, expected {want}")
    want_chunks = [] if eager else sorted(PREFILL_CHUNKS)
    if list(b._chunks) != sorted(PREFILL_CHUNKS) or sorted(b._prefill_graphs) != want_chunks:
        fail(f"[{label}] batcher's chunk lengths {b._chunks} with prefill graphs "
             f"{sorted(b._prefill_graphs)}, expected {sorted(PREFILL_CHUNKS)} and {want_chunks}")
    pool_gb = sum(t.numel() * t.element_size() for layer in b._caches for t in layer) / 1e9
    prefill_pool_gb = graph_pool_gb(b._prefill_graphs.values())
    decode_pool_gb = graph_pool_gb(b._graphs.values())
    what = ("the eager prefill and decode programs (the batcher's private _eager switch)"
            if eager else
            f"prefill graphs of chunks {want_chunks} (one shared pool, "
            f"{gb_text(prefill_pool_gb)}) and decode graphs of K = {want} ({gb_text(decode_pool_gb)}"
            f") captured (warm-up and capture under set_sync_debug_mode('error'): no host sync)")
    print(f"[{label}] batcher built in {build_s:.3f} s with {what}; device memory "
          f"+{(torch.cuda.memory_allocated() - mem0) / 1e9:.3f} GB allocated (the KV pool "
          f"{pool_gb:.3f} GB, slot state, fixed buffers, graph outputs) [{card}]", flush=True)
    server._batcher_service = svc
    httpd, _ = start(make_component_app(server, device="cuda"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    texts = prompts(N_REQUESTS)
    mixed = [prompt_text(100 + i, n) for i, n in enumerate(MIXED_LENGTHS)]
    mixed_lens = [len(server._tokenizer.encode(t)) for t in mixed]
    mixed_chunks = [c for n in mixed_lens for c in chunks_of(b, n)]
    if mixed_chunks != list(MIXED_CHUNKS):
        fail(f"[{label}] the mixed prompts run chunks {mixed_chunks}, expected {MIXED_CHUNKS}")
    try:
        with urllib.request.urlopen(url + "/ready", timeout=30) as r:
            if r.status != 200:
                fail(f"[{label}] /ready answered {r.status}")
        # warm-up request (the first use of the REST path), not counted
        code, body = post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 4})
        if code != 200:
            fail(f"[{label}] warm-up request answered {code}: {body}")
        torch.cuda.synchronize()
        zero_counts(server)
        results, wall = post_all(url, texts)
        launches = read_counts(server)
        ttft = sorted(server._ttft_times)
        steps = sorted(server._decode_step_times)
        dispatch_ms = statistics.median(server._decode_dispatch_times) * 1e3
        sync_ms = statistics.median(server._decode_sync_times) * 1e3
        lag = list(server._decode_host_lag)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the mixed admission: one prompt of three chunks, one of 32 tokens,
        # one of 124, all at once
        zero_counts(server)
        mixed_results, mixed_wall = post_all(url, mixed)
        mixed_launches = read_counts(server)
        mixed_ttft = sorted(server._ttft_times)
        mixed_steps = sorted(server._decode_step_times)
        mixed_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the private generate() path: in the graph runs of each model
        gen = generate_phase(label, card, server, url, texts) if not eager and fuse <= 1 \
            else None
        # streaming through the graphs: SSE, the scrape, a disconnect; in the
        # bf16 graph run also the 1-slot stream service and gRPC
        stream_launches, streamed = {}, None
        if not eager:
            stream_launches, streamed = stream_phase(f"{label} stream", card, server, b, url,
                                                     texts, statistics.median(steps) * 1e3)
            if label == "bf16":
                streamed["service"] = stream_service_phase(label, card, server, url, texts)
                grpc_phase(label, card, server, url, texts[0])
    finally:
        httpd.shutdown()
        httpd.server_close()
    served = served_tokens(label, results)
    mixed_served = served_tokens(f"{label} mixed", mixed_results)
    decode_steps = check_launches(label, card, launches, [128] * N_REQUESTS, quantized,
                                  int8_kv, eager)
    check_launches(f"{label} mixed", card, mixed_launches, MIXED_CHUNKS, quantized, int8_kv,
                   eager)
    cfg = LLAMA2_7B
    served_s = _split_plan(N_REQUESTS, cfg["n_kv_heads"], cfg["n_heads"] // cfg["n_kv_heads"],
                           b.n_pages, b.page_size, cfg["dim"] // cfg["n_heads"], int8_kv)
    print(f"[{label}] K1 split at the served shape (b={N_REQUESTS} slots, "
          f"n_pages={b.n_pages} of {b.page_size}): S={served_s} [{card}]", flush=True)
    pages = b.page_stats()
    if pages["kv_pages_in_use"] != 0:
        fail(f"[{label}] pages still held after every request finished: {pages}")
    svc.close()

    step_ms = statistics.median(steps) * 1e3
    metrics = {"step_ms": step_ms, "ttft_med_ms": statistics.median(ttft) * 1e3,
               "ttft_max_ms": ttft[-1] * 1e3, "peak_gb": peak_gb, "dispatch_ms": dispatch_ms,
               "sync_ms": sync_ms, "wall_s": wall, "max_lag": max(lag),
               "decode_steps": decode_steps, "prefill_pool_gb": prefill_pool_gb,
               "decode_pool_gb": decode_pool_gb,
               "mixed_ttft_ms": [t * 1e3 for t in mixed_ttft],
               "mixed_step_ms": statistics.median(mixed_steps) * 1e3,
               "mixed_peak_gb": mixed_peak_gb, "generate": gen, "stream": streamed,
               "served": served}
    print(f"[{label}] serving: {N_REQUESTS} concurrent requests x {MAX_NEW} tokens in "
          f"{wall:.3f} s; TTFT median {metrics['ttft_med_ms']:.1f} ms max "
          f"{metrics['ttft_max_ms']:.1f} ms; decode step median {step_ms:.2f} ms = "
          f"{N_REQUESTS / (step_ms / 1e3):.1f} tok/s at {N_REQUESTS} slots ({len(steps)} steps "
          f"in {len(lag)} dispatches; host time per dispatch median {dispatch_ms:.3f} ms, "
          f"host wait per drain median {sync_ms:.3f} ms, host lag up to {max(lag)} steps); "
          f"peak device memory over the run {peak_gb:.2f} GB; prefill graphs' pool "
          f"{gb_text(prefill_pool_gb)}, decode graphs' pools {gb_text(decode_pool_gb)} "
          f"[{card}]", flush=True)
    print(f"[{label}] mixed admission: prompts of {mixed_lens} tokens (chunks "
          f"{list(MIXED_CHUNKS)}) x {MAX_NEW} tokens in {mixed_wall:.3f} s; TTFT in arrival "
          f"order of first tokens {', '.join(f'{t:.1f}' for t in metrics['mixed_ttft_ms'])} "
          f"ms; decode step median {metrics['mixed_step_ms']:.2f} ms; peak device memory "
          f"{mixed_peak_gb:.2f} GB [{card}]", flush=True)

    teacher_check(label, card, server, texts, served)
    teacher_check(f"{label} mixed", card, server, mixed, mixed_served)

    # the batcher's greedy tokens against the private generate() path
    batched = served[0]
    private = server.generate([texts[0]])["tokens"][0]
    t = next((i for i, (a, b_) in enumerate(zip(batched, private)) if a != b_), None)
    if t is None:
        print(f"[{label}] batcher == generate(): greedy tokens equal for request 0 [{card}]",
              flush=True)
    else:
        ids = server._tokenizer.encode(texts[0]) + batched[:t]
        row = teacher_logits(server, [ids])[0, -1].float()
        top = row.max().item()
        gaps = (top - row[batched[t]].item(), top - row[private[t]].item())
        print(f"[{label}] batcher vs generate(): tokens equal for {t} of {MAX_NEW}, then "
              f"{batched[t]} vs {private[t]}; teacher-forced logit gaps to the top "
              f"{gaps[0]:.4f} / {gaps[1]:.4f} (tie tolerance {TIE_TOL}; logit std "
              f"{row.std().item():.3f}) [{card}]", flush=True)
        if max(gaps) > TIE_TOL:
            fail(f"[{label}] batcher and generate() diverge at token {t} without a near-tie: "
                 f"{batched} vs {private}")
    if not eager:
        metrics["step"] = step_phase(label, card, server, b, texts, weight_bytes)
        metrics["prefill"] = prefill_phase(label, card, server, b)
    server._batcher_service = None
    del svc, b
    gc.collect()
    torch.cuda.empty_cache()
    gen_launches = gen["launches"] if gen else {}
    total = {key: launches[key] + mixed_launches[key] + gen_launches.get(key, 0)
             + stream_launches.get(key, 0) for key in launches}
    return total, metrics


# ---------------------------------------------------------------------------
# Speculative decoding: the spec step as one CUDA graph per batcher
# ---------------------------------------------------------------------------
def rest_serve(label: str, card: str, server, texts, adapters=None, **batcher_kw):
    """``texts`` through REST, all at once (each with its adapter of
    ``adapters``), on a new BatcherService of
    ``server`` with ``batcher_kw`` (built, its graphs warmed up and
    captured, under ``set_sync_debug_mode("error")``), after one warm-up
    request; every launch counter and the server's dispatch counters
    zeroed just before the requests and read just after. Returns (the
    closed batcher, the served tokens, the launch counts, metrics: the
    step wall, the verify dispatches as (replays, eager runs), the host
    time per dispatch, TTFT, the controller's counters over the requests,
    peak memory)."""
    import torch

    from seldon_core_tpu_torch.runtime.batcher import BatcherService
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        svc = BatcherService(server, max_slots=N_REQUESTS, **batcher_kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    b = svc.batcher
    server._batcher_service = svc
    httpd, _ = start(make_component_app(server, device="cuda"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, body = post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 4})
        if code != 200:
            fail(f"[{label}] warm-up request answered {code}: {body}")
        torch.cuda.synchronize()
        zero_counts(server)
        server._decode_replays = server._decode_eager = 0
        before = b._spec.snapshot() if b._spec is not None else None
        results, wall = post_all(url, texts, adapters)
        launches = read_counts(server)
        dispatches = (server._decode_replays, server._decode_eager)
        after = b._spec.snapshot() if b._spec is not None else None
        steps = sorted(server._decode_step_times)
        metrics = {"step_ms": statistics.median(steps) * 1e3, "steps": len(steps),
                   "dispatch_ms": statistics.median(server._decode_dispatch_times) * 1e3,
                   "ttft_med_ms": statistics.median(server._ttft_times) * 1e3,
                   "wall_s": wall, "build_s": build_s, "dispatches": dispatches,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        httpd.shutdown()
        httpd.server_close()
    served = served_tokens(label, results)
    if b.page_stats()["kv_pages_in_use"] != 0:
        fail(f"[{label}] pages still held after every request finished: {b.page_stats()}")
    svc.close()
    server._batcher_service = None
    if before is not None:
        d = {k: after[k] - before[k] for k in ("spec_accepted_drafts_total",
                                               "spec_drafted_total", "spec_slot_steps_total",
                                               "spec_tokens_total")}
        drafted, acc = d["spec_drafted_total"], d["spec_accepted_drafts_total"]
        metrics.update(accept=acc / drafted if drafted else 0.0,
                       tokens_per_forward=d["spec_tokens_total"] / d["spec_slot_steps_total"],
                       overhead=(drafted - acc) / (drafted + d["spec_slot_steps_total"]))
    return b, served, launches, metrics


def near_tie_check(label: str, card: str, server, texts, served, plain,
                   adapter_ids=None) -> int:
    """Each request's served tokens against the plain batcher's: equal, or
    equal up to a first difference where both tokens sit within TIE_TOL of
    the top logit of a teacher-forced prefill (through the request's
    adapter, with ``adapter_ids``). Returns the requests equal
    throughout."""
    equal = 0
    for i, (a, b_) in enumerate(zip(served, plain)):
        t = next((j for j, (x, y) in enumerate(zip(a, b_)) if x != y), None)
        if t is None:
            equal += 1
            continue
        aid = None if adapter_ids is None else [adapter_ids[i]]
        row = teacher_logits(server, [prompt_ids(server, texts[i]) + a[:t]], aid)[0, -1].float()
        top = row.max().item()
        gaps = (top - row[a[t]].item(), top - row[b_[t]].item())
        print(f"[{label}] request {i}: tokens equal to the plain batcher's for {t} of "
              f"{MAX_NEW}, then {a[t]} vs {b_[t]}; teacher-forced gaps to the top {gaps[0]:.4f} "
              f"/ {gaps[1]:.4f} (tie tolerance {TIE_TOL}) [{card}]", flush=True)
        if max(gaps) > TIE_TOL:
            fail(f"[{label}] request {i} leaves the plain batcher's greedy tokens at {t} "
                 f"without a near-tie")
    return equal


def spec_state(b, pools: bool):
    """Copies of a spec batcher's slot state, history and draft caches (and
    with ``pools`` its KV pools)."""
    draft = None if b._draft_caches is None else [tuple(t.clone() for t in layer)
                                                  for layer in b._draft_caches]
    return ([tuple(t.clone() for t in layer) for layer in b._caches] if pools else None,
            b._last_tok.clone(), b._next_pos.clone(), b._keys.clone(), b._hist.clone(), draft)


def spec_restore(b, copy) -> None:
    _, last_tok, next_pos, keys, hist, draft = copy
    for t, c in ((b._last_tok, last_tok), (b._next_pos, next_pos), (b._keys, keys),
                 (b._hist, hist)):
        t.copy_(c)
    for layer, saved in zip(b._draft_caches or (), draft or ()):
        for t, c in zip(layer, saved):
            t.copy_(c)


def spec_equal(b, copy) -> bool:
    """The batcher's state against ``copy`` (an eager run from identical
    copies): slot state, history, draft caches, and every pool page but
    TRASH, which absorbs the columns past each cap (several a row) in no
    set order."""
    import torch

    from seldon_core_tpu_torch.models.transformer import TRASH_PAGE

    pools, last_tok, next_pos, keys, hist, draft = copy
    keep = torch.ones(b._caches[0][0].shape[0], dtype=torch.bool, device="cuda")
    keep[TRASH_PAGE] = False
    return (torch.equal(b._last_tok, last_tok) and torch.equal(b._next_pos, next_pos)
            and torch.equal(b._keys, keys) and torch.equal(b._hist, hist)
            and all(torch.equal(x[keep], y[keep]) for la, lb in zip(b._caches, pools)
                    for x, y in zip(la, lb))
            and all(torch.equal(x, y) for la, lb in zip(b._draft_caches or (), draft or ())
                    for x, y in zip(la, lb)))


def draft_check(label: str, card: str, server, b, prog, snap) -> None:
    """The drafts of one eager spec step at full caps on live state (read
    off the verify's input, ``[last_tok, d_1..d_K]``, by a forward pre-hook
    on the target) against the draft model's own teacher-forced prefill
    over each slot's history, last token and drafts, in fresh dense caches:
    every draft must sit within TIE_TOL of that prefill's top logit. Runs
    on copies of the state; the live state is left as ``snap``."""
    import torch

    from seldon_core_tpu_torch.models.transformer import init_kv_caches

    spec_restore(b, snap)
    b._draft_cap.fill_(SPEC_K)
    copy = spec_state(b, pools=True)
    fed = []
    hook = server._module.register_forward_pre_hook(lambda mod, args: fed.append(args[0].clone()))
    try:
        prog(copy[0], *copy[1:4], b._temp, b._block_tables, copy[4], b._draft_cap, copy[5])
    finally:
        hook.remove()
    if len(fed) != 1 or tuple(fed[0].shape) != (b.S, SPEC_K + 1):
        fail(f"[{label}] the eager spec step fed the target {[tuple(t.shape) for t in fed]}, "
             f"expected one verify of {(b.S, SPEC_K + 1)}")
    drafts = fed[0][:, 1:]                                              # [S, K]
    start = b._next_pos.long()                                          # last_tok's position
    seqs = [b._hist[i, :int(start[i]) + 1].tolist() + drafts[i, :SPEC_K - 1].tolist()
            for i in range(b.S)]
    n, L = len(seqs), max(map(len, seqs))
    toks = torch.zeros((n, L), dtype=torch.int64, device="cuda")
    for i, seq in enumerate(seqs):
        toks[i, :len(seq)] = torch.tensor(seq, device="cuda")
    pos = torch.arange(L, device="cuda")[None].expand(n, L)
    with torch.no_grad():
        logits, _ = server._draft_module(
            toks, positions=pos, caches=init_kv_caches(server._draft_cfg, n, L, device="cuda"),
            cache_index=0)
    # row start + j - 1 predicts draft j
    rows = torch.stack([logits[i, int(start[i]):int(start[i]) + SPEC_K]
                        for i in range(n)]).float()                    # [S, K, vocab]
    picked = rows.gather(2, drafts[:, :, None])[:, :, 0]
    top2 = rows.topk(2, dim=-1).values
    gaps = top2[:, :, 0] - picked
    worst = gaps.max().item()
    print(f"[{label}] the {SPEC_K} drafts of one eager spec step on live state ({n} slots, "
          f"{server._draft_cfg.n_kv_heads} draft kv heads) against the draft model's "
          f"teacher-forced prefill over the same tokens: {int((gaps == 0).sum())} of "
          f"{gaps.numel()} are its argmax, worst gap to the top logit {worst:.4f} (tie "
          f"tolerance {TIE_TOL}); median top-1/top-2 margin "
          f"{(top2[:, :, 0] - top2[:, :, 1]).median().item():.4f} [{card}]", flush=True)
    if worst > TIE_TOL:
        i, j = divmod(int(gaps.argmax()), SPEC_K)
        fail(f"[{label}] slot {i} draft {j + 1}: {int(drafts[i, j])} sits {worst:.4f} below the "
             f"draft model's teacher-forced top logit (tolerance {TIE_TOL})")
    del copy
    spec_restore(b, snap)


def spec_phase(label: str, card: str, server, mode: str, plain: Optional[dict] = None):
    """One speculative run on ``server`` (loaded): the N_REQUESTS prompts x
    MAX_NEW tokens through REST on ContinuousBatcher(spec_mode=``mode``,
    spec_k=SPEC_K), every verify dispatch a replay of the batcher's one spec
    graph. Without ``plain`` (the plain graph run's step wall and served
    tokens on this server) a plain batcher serves the same prompts first.
    Fails unless every verify dispatch was a replay; each kernel launched
    what the dispatches, chunks and admissions need; every served token is
    within TIE_TOL of the teacher-forced top logit and equals the plain
    greedy token up to a near-tie; the perfect drafter accepted at least
    SPEC_PERFECT_ACCEPT; then, on live state (the prompts admitted again,
    the loop stopped), a replay at full and at mixed caps is bit-equal to
    the same program run eagerly from identical copies (tokens, advance,
    state, history, draft caches, pools but TRASH), with a draft the K
    drafts of one eager step are within TIE_TOL of the draft model's
    teacher-forced top logit (``draft_check``), and the graph's kernel
    nodes and a replay's launches are one K1 a layer of the target, one K2
    a layer of every forward (the verify and, with a draft, its K + 1
    forwards) and in int8 one K4 decode launch a product. Prints the
    acceptance counters, the step wall per dispatch and per token beside
    the plain step, the replay's host and device time against the eager
    program's enqueue and kernel sum, the spec graph's pool and peak
    memory, and with a draft the draft forwards' share of the step (their
    own CUDA graph, events), and the end-to-end wall of the requests (and
    tokens/s) beside the plain batcher's on this server: ``plain``'s, or
    the plain run here. Returns ([(label, launch counts)], metrics)."""
    import gc

    import torch

    quantized, int8_kv = server.quantize == "int8", server.kv_cache_dtype == "int8"
    n_layers = LLAMA2_7B["n_layers"]
    texts = prompts(N_REQUESTS)
    records = []
    if plain is None:
        pb, pserved, plaunch, pm = rest_serve(f"{label} plain", card, server, texts,
                                              spec_mode="off")
        check_launches(f"{label} plain", card, plaunch,
                       [c for t in texts for c in chunks_of(pb, len(t))], quantized, int8_kv,
                       eager=False)
        del pb
        records.append((f"{label} plain", plaunch))
        plain = {"step_ms": pm["step_ms"], "served": pserved, "wall_s": pm["wall_s"]}
        print(f"[{label} plain] plain graph batcher on this server: decode step median "
              f"{pm['step_ms']:.2f} ms over {pm['steps']} steps [{card}]", flush=True)
    b, served, launches, m = rest_serve(label, card, server, texts, spec_mode=mode,
                                        spec_k=SPEC_K)
    records.append((label, launches))
    if b._graphs or b._spec_graph is None:
        fail(f"[{label}] spec batcher holds decode graphs {sorted(b._graphs)} and spec graph "
             f"{b._spec_graph}: expected the spec graph alone")
    replays, eager = m["dispatches"]
    if replays == 0 or eager:
        fail(f"[{label}] verify dispatches: {replays} replays, {eager} eager runs; every one "
             f"must be a replay")
    # launches over the requests: the verify dispatches, the prefill chunks,
    # and with a draft its prompt prefill at each admission
    dcfg = server._draft_cfg
    draft_k2 = dcfg.n_layers if mode == "draft" and dcfg.fused_norm else 0
    verify_k2 = n_layers + (SPEC_K + 1) * draft_k2
    chunks = [c for t in texts for c in chunks_of(b, len(server._tokenizer.encode(t)))]
    per = K4_PER_FORWARD if quantized else 0
    wide = sum(c >= 64 for c in chunks)
    k1_key, idle_k1 = ("k1_int8", "k1") if int8_kv else ("k1", "k1_int8")
    want = {k1_key: replays * n_layers, idle_k1: 0,
            "k2": replays * verify_k2 + len(chunks) * n_layers + len(texts) * draft_k2,
            "k4": (replays + len(chunks)) * per, "k4_wgmma": wide * per,
            "replays": len(chunks), "eager": 0}
    if {k: launches[k] for k in want} != want:
        fail(f"[{label}] launches {launches}, expected {want} ({replays} verify dispatches, "
             f"chunks {chunks}, {len(texts)} admissions)")
    print(f"[{label}] launches: paged_attention ({k1_key}) {launches[k1_key]} ({replays} verify "
          f"replays x {n_layers} layers, the {SPEC_K + 1} columns folded into rows), "
          f"fused_residual_rmsnorm {launches['k2']} ({replays} x {verify_k2} + {len(chunks)} "
          f"chunks x {n_layers} + {len(texts)} draft prefills x {draft_k2}), int8_matmul "
          f"{launches['k4']} (prefill kernel {launches['k4_wgmma']}); prefill chunks "
          f"{launches['replays']} replays [{card}]", flush=True)
    teacher_check(label, card, server, texts, served)
    same = near_tie_check(label, card, server, texts, served, plain["served"])
    if mode == "draft" and dcfg == server._cfg and m["accept"] < SPEC_PERFECT_ACCEPT:
        fail(f"[{label}] the perfect drafter accepted {m['accept']:.3f} of its drafts "
             f"(< {SPEC_PERFECT_ACCEPT})")
    per_token = m["step_ms"] / m["tokens_per_forward"]
    n_tok = N_REQUESTS * MAX_NEW
    print(f"[{label}] end to end: {n_tok} tokens ({N_REQUESTS} concurrent requests x {MAX_NEW}, "
          f"through REST, prefill included) in {m['wall_s']:.4f} s = "
          f"{n_tok / m['wall_s']:.1f} tokens/s, against the plain graph batcher's "
          f"{plain['wall_s']:.4f} s = {n_tok / plain['wall_s']:.1f} tokens/s for the same "
          f"requests on this server ({plain['wall_s'] / m['wall_s']:.3f}x) [{card}]", flush=True)
    print(f"[{label}] served {N_REQUESTS} x {MAX_NEW} tokens in {m['wall_s']:.3f} s: accept rate "
          f"{m['accept']:.4f}, tokens per forward {m['tokens_per_forward']:.4f}, draft overhead "
          f"{m['overhead']:.4f} (the controller's counters over these requests); step wall "
          f"(drain to drain) {m['step_ms']:.2f} ms a verify dispatch ({m['steps']} "
          f"dispatches), {per_token:.2f} ms a token a slot, against the plain step "
          f"{plain['step_ms']:.2f} ms ({plain['step_ms'] / per_token:.2f}x); host time a "
          f"dispatch {m['dispatch_ms']:.3f} ms; TTFT median {m['ttft_med_ms']:.1f} ms; built "
          f"in {m['build_s']:.3f} s; {same} of {N_REQUESTS} requests equal to the plain "
          f"batcher's tokens throughout; peak device memory {m['peak_gb']:.2f} GB [{card}]",
          flush=True)

    # live state: the prompts admitted again with the loop stopped
    admit_now(b, texts, ahead=768)
    prog = server._get_spec_step(b.S, SPEC_K, b.hist_len, mode=mode, n_pages=b.n_pages)
    snap = spec_state(b, pools=False)
    full = (SPEC_K,) * N_REQUESTS
    for caps in (full, (4, 3, 2, 1, 0, 4, 2, 1)):
        spec_restore(b, snap)
        b._draft_cap.copy_(torch.tensor(caps, dtype=torch.int32, device="cuda"))
        copy = spec_state(b, pools=True)
        out = b._spec_graph.replay().clone()
        ref = prog(copy[0], *copy[1:4], b._temp, b._block_tables, copy[4], b._draft_cap,
                   copy[5])
        torch.cuda.synchronize()
        ok = torch.equal(out, ref) and spec_equal(b, copy)
        print(f"[{label}] replay vs eager at caps {caps} on live state ({N_REQUESTS} slots), from "
              f"identical copies: tokens + advance {out[:, SPEC_K + 1].tolist()}, state, "
              f"history, draft caches and pools (but TRASH) {'bit-equal' if ok else 'DIFFER'} "
              f"[{card}]", flush=True)
        if not ok:
            fail(f"[{label}] the spec graph's replay and the eager program differ at caps {caps}")
        del copy, out, ref
    if mode == "draft":
        draft_check(label, card, server, b, prog, snap)
    torch.cuda.empty_cache()
    k4_want = K4_PER_FORWARD if quantized else 0
    want_nodes = (verify_k2, 0, k4_want, n_layers)
    seen = node_counts(graph_kernel_names(b._spec_graph.graph))
    spec_restore(b, snap)
    per_replay = launches_of(b._spec_graph.replay)
    if seen != want_nodes or per_replay != want_nodes:
        fail(f"[{label}] the spec graph holds (K2, K4 prefill, K4 decode, K1) kernel nodes "
             f"{seen}, a replay launched {per_replay}, expected {want_nodes}")
    b._draft_cap.copy_(torch.tensor(full, dtype=torch.int32, device="cuda"))

    def eager_step():
        return prog(b._caches, b._last_tok, b._next_pos, b._keys, b._temp, b._block_tables,
                    b._hist, b._draft_cap, b._draft_caches)

    spec_restore(b, snap)
    host_e, dev_e, ops_e, _ = profile_step(eager_step, K2_KERNEL, reps=5)
    spec_restore(b, snap)
    host_g, dev_g, ops_g, _ = profile_step(b._spec_graph.replay, K2_KERNEL)
    spec_restore(b, snap)
    ev_g = events_ms(b._spec_graph.replay)
    pool_gb = graph_pool_gb([b._spec_graph])
    traced = f"{dev_g:.3f} ms" if ops_g else "no device event in the trace"
    print(f"[{label}] spec step at full caps on live state: replay host {host_g:.4f} ms (median "
          f"of {REPS}) vs the eager enqueue {host_e:.3f} ms (median of 5); replay device "
          f"{ev_g:.3f} ms (CUDA events, median of {REPS}; traced {traced}) vs the eager "
          f"program's kernel sum {dev_e:.3f} ms "
          f"(torch.profiler, {sum(e.count for e in ops_e)} kernels and copies); graph kernel "
          f"nodes (K2, K4 prefill, K4 decode, K1) {seen}; spec graph pool {gb_text(pool_gb)} "
          f"[{card}]", flush=True)
    for e in ops_e[:8]:
        print(f"  {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:100]} [{card}]")
    m.update(replay_host_ms=host_g, replay_dev_ms=ev_g, eager_host_ms=host_e, eager_dev_ms=dev_e,
             pool_gb=pool_gb, per_token_ms=per_token, plain_step_ms=plain["step_ms"],
             plain_wall_s=plain["wall_s"])
    if mode == "draft":
        spec_restore(b, snap)
        tok0, pos0, width = b._last_tok.clone(), b._next_pos.clone(), b.max_len

        def drafts():
            tok, pos = tok0, pos0
            for _ in range(SPEC_K + 1):
                logits, _ = server._draft_module(tok[:, None], positions=pos[:, None],
                                                 caches=b._draft_caches,
                                                 cache_index=pos.clamp(max=width))
                tok, pos = torch.argmax(logits[:, -1], dim=-1), pos + 1
            return tok

        # their share of the eager step's trace: the same forwards traced
        # eagerly once, their kernel sum against the eager step's
        from torch.profiler import ProfilerActivity, profile

        drafts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            drafts()
            torch.cuda.synchronize()
        dev_d = sum(dev_us(e) for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA")) / 1e3
        del prof
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            drafts()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            drafts()
        draft_ms = events_ms(g.replay)
        del g
        m.update(draft_ms=draft_ms, draft_eager_ms=dev_d)
        print(f"[{label}] the {SPEC_K + 1} draft forwards ({dcfg.n_layers} layers, dim "
              f"{dcfg.dim}) alone: eagerly {dev_d:.3f} ms of kernels (torch.profiler) = "
              f"{dev_d / dev_e:.1%} of the eager spec step's {dev_e:.3f} ms; as a CUDA graph of "
              f"their own {draft_ms:.3f} ms (CUDA events, median of {REPS}) = "
              f"{draft_ms / ev_g:.1%} of the replay's {ev_g:.3f} ms [{card}]", flush=True)
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return records, m


# ---------------------------------------------------------------------------
# The dense batcher layout: the slot pool, one-shot admission, dense graphs
# ---------------------------------------------------------------------------
DENSE_LEFT_GB = 0.1   # what a stopped dense service may leave: its loop thread's cuBLAS workspaces


def dense_pool_like(pools, layers):
    """``layers`` (copies of a slot pool's tuples) as caches of ``pools``'
    kind: a ``SlotCaches``, or a sharded model's ``RankCaches``."""
    from seldon_core_tpu_torch.models.sharded import RankCaches
    from seldon_core_tpu_torch.models.transformer import SlotCaches

    if isinstance(pools, RankCaches):
        return RankCaches(layers, pools.lead, pools.width)
    return SlotCaches(layers, pools.width)


def dense_state(b):
    """Copies of a dense batcher's pool, slot state, history and draft caches."""
    pools = dense_pool_like(b._caches, [tuple(t.clone() for t in layer) for layer in b._caches])
    draft = None if b._draft_caches is None else [tuple(t.clone() for t in layer)
                                                  for layer in b._draft_caches]
    hist = None if b._hist is None else b._hist.clone()
    return pools, b._last_tok.clone(), b._next_pos.clone(), b._keys.clone(), hist, draft


def dense_equal(b, copy) -> bool:
    """The batcher's state against ``copy`` (an eager run from identical
    copies): slot state, history, draft caches and every slot row of the
    pool but its trash column (each buffer's last; a dropped write lands
    there in no set order)."""
    import torch

    pools, last_tok, next_pos, keys, hist, draft = copy
    return (torch.equal(b._last_tok, last_tok) and torch.equal(b._next_pos, next_pos)
            and torch.equal(b._keys, keys)
            and (hist is None or torch.equal(b._hist, hist))
            and all(torch.equal(x[:, :-1], y[:, :-1]) for la, lb in zip(b._caches, pools)
                    for x, y in zip(la, lb))
            and all(torch.equal(x, y) for la, lb in zip(b._draft_caches or (), draft or ())
                    for x, y in zip(la, lb)))


def dense_replays(label: str, card: str, server, b, texts, adapter_ids=None,
                  ranks: int = 1) -> dict:
    """On live state: the served prompts admitted again (the loop stopped;
    each a one-shot prefill into its slot's row), then each captured
    program (K = 1 and K, or the spec step at full caps) replayed against
    the same program run eagerly from identical copies: tokens, slot state
    and every slot row but the trash column must be bit-equal; a decode
    graph must hold one K2 kernel a layer a step, one K4 decode kernel a
    product in the int8 model and no K1. Then each replay's host time
    (median of REPS replay() calls) and device time (CUDA events)."""
    from concurrent.futures import Future

    import torch

    from seldon_core_tpu_torch.runtime.scheduler import PendingRequest

    for i, text in enumerate(texts):
        req = PendingRequest(ids=server._tokenizer.encode(text), max_new=MAX_NEW, fut=Future(),
                             adapter_id=0 if adapter_ids is None else adapter_ids[i])
        if not b._admit(req):
            fail(f"[{label}] no free slot to admit prompt {i} again")
    graphs = ({k: b._graphs[k] for k in sorted(b._graphs)} if b._spec_graph is None
              else {"spec": b._spec_graph})
    lora = b._lora(b._adapter_ids)
    n_layers = server._cfg.n_layers
    k4_step = k4_per_forward(server._cfg) * ranks if server.quantize == "int8" else 0
    out = {}
    for k, g in graphs.items():
        if k == "spec":
            b._draft_cap.fill_(SPEC_K)
        copy = dense_state(b)
        toks = g.replay().clone()
        pools, last_tok, next_pos, keys, hist, draft = copy
        if k == "spec":
            eager = server._get_spec_step(b.S, SPEC_K, b.hist_len, mode=b.spec_mode,
                                          layout="dense", lora=bool(lora))(
                pools, last_tok, next_pos, keys, b._temp, None, hist, b._draft_cap, draft,
                **lora)
        else:
            eager = server._get_decode_step(b.S, b.max_len, k, bool(lora))(
                pools, last_tok, next_pos, keys, b._temp, **lora)
        torch.cuda.synchronize()
        same_tokens = torch.equal(toks, eager)
        same = same_tokens and dense_equal(b, copy)
        print(f"[{label}] replay vs eager, {'the spec step' if k == 'spec' else f'K = {k}'}, "
              f"from identical copies of the slot pool ({b._cache_nbytes / 1e9:.2f} GB) and "
              f"slot state, {b.S} live slots: tokens {'bit-equal' if same_tokens else 'DIFFER'}, "
              f"tokens + state + every slot row but the trash column "
              f"{'bit-equal' if same else 'DIFFER'} [{card}]", flush=True)
        if not same:
            fail(f"[{label}] the dense {k} graph replay and the eager program differ")
        del copy, pools, draft, eager
        torch.cuda.empty_cache()
        seen = node_counts(graph_kernel_names(g.graph))
        if k != "spec":
            want = (n_layers * ranks * k, 0, k4_step * k, 0)
            if seen != want:
                fail(f"[{label}] the dense K = {k} graph holds (K2, K4 prefill, K4 decode, K1) "
                     f"kernel nodes {seen}, expected {want}")
        elif seen[3] or seen[1] or not seen[0]:
            fail(f"[{label}] the dense spec graph holds (K2, K4 prefill, K4 decode, K1) kernel "
                 f"nodes {seen}: K2 expected, no K1 and no K4 prefill route")
        # host and device time of a replay, each the median over the reps
        # (fewer for a fused graph: each replay runs K steps)
        reps = REPS if k in (1, "spec") else 5
        g.replay()
        hosts, devs = [], []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            g.replay()
            hosts.append(time.perf_counter() - t0)
            end.record()
            end.synchronize()
            devs.append(start.elapsed_time(end))
        out[k] = {"host_ms": statistics.median(hosts) * 1e3, "dev_ms": statistics.median(devs),
                  "nodes": seen}
        print(f"[{label}] dense graph replay of {'the spec step' if k == 'spec' else f'K = {k}'}"
              f" at {b.S} live slots: host {out[k]['host_ms']:.4f} ms, device "
              f"{out[k]['dev_ms']:.3f} ms (CUDA events), medians of {reps}; kernel nodes (K2, "
              f"K4 prefill, K4 decode, K1) {seen} [{card}]", flush=True)
        if k in (1, "spec"):
            # where the replay's device time goes, by kernel (torch.profiler)
            _, traced, ops, _ = profile_step(g.replay, K2_KERNEL, reps=3)
            out[k]["traced_ms"] = traced if ops else None
            out[k]["top"] = [(e.key, e.count, dev_us(e) / 1e3) for e in ops[:8]]
            print(f"[{label}] the replay in torch.profiler: "
                  + (f"{traced:.3f} ms in {sum(e.count for e in ops)} kernels and copies; "
                     f"by time: " + "; ".join(f"{e.key[:70]} x{e.count} {dev_us(e) / 1e3:.3f} ms"
                                              for e in ops[:8]) if ops else
                     "no device event seen") + f" [{card}]", flush=True)
    return out


def dense_run(label: str, card: str, server, texts, plain, adapters=None, adapter_ids=None,
              ranks: int = 1, exact: bool = True, **batcher_kw):
    """One [dense] run: ``texts`` (each with its adapter of ``adapters``)
    through REST on a dense BatcherService of ``server`` (``rest_serve``:
    built and captured under set_sync_debug_mode("error"), counters zeroed
    just before the requests). Fails unless every dispatch was a replay;
    each admission was one prefill (eager: on this thread, or on a prefill
    worker with disaggregation); no K1 launched (the dense read is the
    masked einsum) and, with ``exact``, K2 and K4 launched exactly what the
    forwards need (one K2 a layer a forward; in int8 one K4 a product a
    forward, the admissions' on the prefill route); every served token is
    teacher-forced and equals ``plain`` (the paged batcher's on this
    server) up to a near-tie; the replays are bit-equal to the eager
    programs on live state (``dense_replays``); and nothing is left
    allocated once the service has stopped. Returns (launch counts,
    metrics)."""
    import gc

    import torch

    release_server_memory(workspaces=False)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    b, served, counts, m = rest_serve(label, card, server, texts, adapters=adapters,
                                      layout="dense", **batcher_kw)
    if b.paged or b._allocator is not None or b._prefill_graphs:
        fail(f"[{label}] the batcher is not the dense layout's")
    if m["dispatches"][1] or not m["dispatches"][0]:
        fail(f"[{label}] dense dispatches as (graph replays, eager runs) {m['dispatches']}: "
             f"every dispatch must be a replay")
    per = server._cfg.n_layers * ranks
    remote = b._remote is not None
    if any(counts[k] for k in ("k1", "k1_int8", "k1p", "k1p_int8")) or counts["replays"]:
        fail(f"[{label}] launches {counts}: the dense read launches no K1, and admission "
             f"replays no prefill graph")
    if counts["eager"] != (0 if remote else len(texts)):
        fail(f"[{label}] {counts['eager']} eager admission prefills on this server, expected "
             f"{0 if remote else len(texts)}")
    forwards = counts["k2"] // per
    steps = forwards - len(texts)
    if (counts["k2"] % per or steps <= 0) if exact else not counts["k2"]:
        fail(f"[{label}] K2 launches {counts['k2']}: not {per} a forward over the "
             f"{len(texts)} admissions and some decode forwards")
    plens = [b._truncate_prompt(server._tokenizer.encode(t), MAX_NEW, None)[1] for t in texts]
    wide = sum(p >= 64 for p in plens)
    k4 = k4_per_forward(server._cfg) * ranks if server.quantize == "int8" else 0
    if exact and (counts["k4"] != k4 * forwards or counts["k4_wgmma"] != k4 * wide):
        fail(f"[{label}] K4 launches {counts['k4']} (prefill route {counts['k4_wgmma']}): "
             f"expected {k4} x {forwards} forwards, {k4} x {wide} admissions of >= 64 rows on "
             f"the prefill route")
    print(f"[{label}] launches: K1 0 (the dense read is the masked einsum); "
          f"fused_residual_rmsnorm {counts['k2']} "
          f"{f'= {forwards} forwards x {per}' if exact else '(the target and draft forwards)'}; "
          f"int8_matmul {counts['k4']}: "
          f"prefill route {counts['k4_wgmma']} ({wide} one-shot admission prefills of plen "
          f"{sorted(set(plens))}), decode route {counts['k4'] - counts['k4_wgmma']}; "
          f"{len(texts)} eager admission prefills "
          f"({'on the prefill workers' if remote else 'on the batcher thread'}) [{card}]",
          flush=True)
    teacher_check(label, card, server, texts, served, adapter_ids)
    equal = near_tie_check(f"{label} vs paged", card, server, texts, served, plain, adapter_ids)
    live = dense_replays(label, card, server, b, texts, adapter_ids, ranks)
    spec = b._spec_graph is not None
    pool_gb = b._cache_nbytes / 1e9
    graph_gb = graph_pool_gb(list(b._graphs.values()) + ([b._spec_graph] if spec else []))
    del b
    gc.collect()
    release_server_memory(workspaces=False)
    torch.cuda.synchronize()
    left = (torch.cuda.memory_allocated() - mem0) / 1e9
    if left > DENSE_LEFT_GB:
        fail(f"[{label}] {left:.3f} GB still allocated after the dense service stopped")
    m.update(live=live, pool_gb=pool_gb, graph_gb=graph_gb, left_gb=left, equal=equal,
             steps=steps, served=served)
    print(f"[{label}] dense: {len(texts)} requests x {MAX_NEW} tokens in {m['wall_s']:.3f} s; "
          f"step wall median {m['step_ms']:.2f} ms; host per dispatch {m['dispatch_ms']:.4f} ms; "
          f"TTFT median {m['ttft_med_ms']:.1f} ms; {len(texts)} eager prefills; slot pool "
          f"{pool_gb:.3f} GB; graph pool {gb_text(graph_gb)}; peak {m['peak_gb']:.2f} GB; "
          f"tokens equal to the paged batcher's for {equal} of {len(texts)} requests "
          f"throughout, the rest up to a near-tie; allocated after the service stopped "
          f"{left:+.4f} GB [{card}]", flush=True)
    return counts, m


def dense_phase(card: str, server, model: str, paged: dict, spec_runs: dict) -> tuple:
    """[dense] on a loaded section-4 server: bf16 at K = 1, K = FUSED_K and
    n-gram speculation, int8 weights + int8 KV at K = 1, each beside the
    paged run of the same server and K (``paged``: the serving runs,
    ``spec_runs``: the paged n-gram run). Returns ([(label, counts)],
    {label: metrics with the paged step beside})."""
    t_phase = time.perf_counter()
    texts = prompts(N_REQUESTS)
    plans = [(model, model, dict(fuse_steps=0, spec_mode="off"))]
    if model == "bf16":
        plans += [(f"bf16 K={FUSED_K}", f"bf16 K={FUSED_K}",
                   dict(fuse_steps=FUSED_K, spec_mode="off")),
                  ("bf16 spec ngram", "bf16 spec ngram",
                   dict(fuse_steps=0, spec_mode="ngram", spec_k=SPEC_K))]
    records, out = [], {}
    for name, ref, kw in plans:
        label = f"{name} dense"
        spec = kw["spec_mode"] != "off"
        plain = paged[model][1]["served"] if spec else paged[ref][1]["served"]
        counts, m = dense_run(label, card, server, texts, plain, **kw)
        records.append((label, counts))
        if spec:
            p = spec_runs[ref]
            m["paged_step_ms"], m["paged_dev_ms"] = p["step_ms"], p["replay_dev_ms"]
        else:
            p = paged[ref][1]
            k = kw["fuse_steps"] or 1
            dev = p.get("step", {}).get(k, {}).get("dev_ms")
            m["paged_step_ms"], m["paged_dev_ms"] = p["step_ms"], None if dev is None else dev / k
        out[label] = m
    print(f"[{model} dense] phase_s {time.perf_counter() - t_phase:.1f} [{card}]", flush=True)
    return records, out


def print_dense(card: str, dense_runs: dict, records) -> None:
    """The dense runs beside the paged ones, and their K2 / K4 launches."""
    print(f"dense runs (Llama-2-7B, kv_cache_layout='dense', {N_REQUESTS} concurrent requests x "
          f"{MAX_NEW} tokens; step wall drain to drain; replay device a step, CUDA events; the "
          f"paged run of the same server beside) [{card}]:", flush=True)
    for label, m in dense_runs.items():
        if "live" not in m:
            continue
        live = m["live"]
        dev = " ".join(f"{'spec' if k == 'spec' else f'K={k}'} "
                       f"{v['dev_ms'] / (1 if k == 'spec' else k):.3f} ms "
                       f"(host {v['host_ms']:.4f} ms a replay);" for k, v in live.items())
        paged_dev = m.get("paged_dev_ms")
        print(f"  {label:26s} step {m['step_ms']:.2f} ms vs paged {m['paged_step_ms']:.2f} ms "
              f"({m['step_ms'] / m['paged_step_ms']:.2f}x); replay device a step {dev} paged "
              f"{'not measured' if paged_dev is None else f'{paged_dev:.3f} ms'}; host per "
              f"dispatch {m['dispatch_ms']:.4f} ms; TTFT median {m['ttft_med_ms']:.1f} ms; slot "
              f"pool {m['pool_gb']:.3f} GB, graph pool {gb_text(m['graph_gb'])}, peak "
              f"{m['peak_gb']:.2f} GB; {m['equal']}/{N_REQUESTS} equal to paged throughout "
              f"[{card}]", flush=True)
    dense = [c for label, c in records if label.endswith("dense")
             or label.startswith("bf16 dense disagg")]
    print(f"dense runs' launches: fused_residual_rmsnorm "
          f"{sum(c['k2'] for c in dense)}, int8_matmul {sum(c['k4'] for c in dense)} "
          f"(prefill route {sum(c['k4_wgmma'] for c in dense)}), paged_attention "
          f"{sum(c['k1'] + c['k1_int8'] + c['k1p'] + c['k1p_int8'] for c in dense)} over "
          f"{len(dense)} runs [{card}]", flush=True)


def dense_rebalance(label: str, card: str, server, texts, plain) -> dict:
    """``rebalance_disagg`` on a dense batcher with disaggregation: 2
    workers, the requests submitted, the pool swapped to 1 worker while
    jobs are staged on the outgoing one; every request served (tokens equal
    to ``plain`` up to a near-tie), every slot back, the old workers'
    staging rows freed."""
    import torch

    from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher

    b = ContinuousBatcher(server, max_slots=N_REQUESTS, layout="dense", device="cuda",
                          disaggregation="remote_prefill", prefill_workers=2)
    try:
        old = b._remote
        t0 = time.perf_counter()
        futs = [b.submit(t, MAX_NEW) for t in texts]
        while b.handoff_stats()["handoff_queue_depth"] == 0 and time.perf_counter() - t0 < 10:
            time.sleep(0.001)   # a job staged on the outgoing pool
        staged = b.handoff_stats()["handoff_queue_depth"]
        t1 = time.perf_counter()
        if not b.rebalance_disagg(1):
            fail(f"[{label}] rebalance_disagg(1) refused")
        swap_s = time.perf_counter() - t1
        served = [f.result(600) for f in futs]
        wall = time.perf_counter() - t0
        if any(w._staging is not None for w in old.workers) or len(b._remote.workers) != 1:
            fail(f"[{label}] the outgoing workers kept their staging rows, or the pool is not "
                 f"one worker")
        if any(s.active or s.prefilling for s in b._slots) or b._remote_jobs:
            fail(f"[{label}] slots still held after every request finished")
        handoffs = b.handoff_stats()["handoffs_total"]
    finally:
        b.close()
    del b, old
    release_server_memory(workspaces=False)
    if handoffs != len(texts):
        fail(f"[{label}] {handoffs} handoffs for {len(texts)} requests")
    equal = near_tie_check(label, card, server, texts, served, plain)
    print(f"[{label}] rebalance_disagg 2 -> 1 worker with {staged} job(s) staged: swap "
          f"{swap_s:.3f} s, {len(texts)} requests in {wall:.3f} s, {handoffs} handoffs, "
          f"{equal}/{len(texts)} equal to paged throughout; allocated now "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB [{card}]", flush=True)
    return {"swap_s": swap_s, "wall_s": wall, "equal": equal}


def dense_flag_phase(card: str) -> tuple:
    """``--dense``: the [dense] runs of the full run on an int8 and a bf16
    7B server loaded here (each beside paged runs of the same server at
    the same K), then on the bf16 server the dense handoff over the device
    and the network transports and ``rebalance_disagg`` on a dense
    batcher; then LoRA over dense (rank LORA_RANK adapters and base traffic
    in one batch), the draft spec over dense (a TinyLlama-wide draft), and
    dense on {model 2} and {data 1, seq 2, model 2} (the bf16 weights),
    each against the paged batcher of its own server. Returns ([(label,
    counts)], {label: metrics})."""
    texts = prompts(N_REQUESTS)
    records, out = [], {}

    def paged_run(label, server, **kw):
        pb, served, counts, pm = rest_serve(f"{label} paged", card, server, texts, **kw)
        del pb
        release_server_memory(workspaces=False)
        records.append((f"{label} paged", counts))
        return counts, dict(pm, served=served)

    tree = None
    # int8 first: its load's peak check counts what is allocated before it
    for model, knobs in (("int8", dict(quantize="int8", kv_cache_dtype="int8")), ("bf16", {})):
        server, _ = load_llm(model, card, knobs)
        paged = {model: paged_run(model, server, fuse_steps=0, spec_mode="off")}
        spec_runs = {}
        if model == "bf16":
            paged[f"bf16 K={FUSED_K}"] = paged_run(f"bf16 K={FUSED_K}", server,
                                                   fuse_steps=FUSED_K, spec_mode="off")
            spec_runs["bf16 spec ngram"] = dict(paged_run("bf16 spec ngram", server,
                                                          spec_mode="ngram", spec_k=SPEC_K)[1],
                                                replay_dev_ms=None)
        rec, runs = dense_phase(card, server, model, paged, spec_runs)
        records += rec
        out.update(runs)
        if model == "bf16":
            plain = paged["bf16"][1]["served"]
            for transport in ("device", "network"):
                label = f"bf16 dense disagg {transport}"
                counts, out[label] = dense_run(
                    label, card, server, texts, plain, fuse_steps=0, spec_mode="off",
                    disaggregation="remote_prefill", prefill_workers=2,
                    handoff_transport=transport)
                records.append((label, counts))
                out[label].update(paged_step_ms=paged["bf16"][1]["step_ms"])
            out["bf16 dense rebalance"] = dense_rebalance("bf16 dense rebalance", card, server,
                                                          texts, plain)
            tree = server._module.param_tree()
            plain_bf16 = plain
        del server
        release_server_memory()
    # LoRA over dense: base traffic and PAR_ADAPTERS adapters in one batch
    names = [f"tenant-{i}" for i in range(PAR_ADAPTERS)]
    weights = par_adapter_weights(names)
    assign = [None if i % 4 == 3 else names[i % PAR_ADAPTERS] for i in range(N_REQUESTS)]
    server, _ = par_load("bf16 lora", card, {}, params=tree, lora_rank=LORA_RANK,
                         lora_max_adapters=PAR_ADAPTERS + 1)
    for name in names:
        server.adapter_registry.load(name, weights[name], alpha=LORA_ALPHA)
    ids = [0 if a is None else server.adapter_registry.resolve(a) for a in assign]
    _, lpaged = paged_run("bf16 lora", server, adapters=assign, fuse_steps=0, spec_mode="off")
    counts, out["bf16 lora dense"] = dense_run("bf16 lora dense", card, server, texts,
                                               lpaged["served"], adapters=assign, adapter_ids=ids,
                                               fuse_steps=0, spec_mode="off")
    records.append(("bf16 lora dense", counts))
    out["bf16 lora dense"].update(paged_step_ms=lpaged["step_ms"])
    del server
    release_server_memory(workspaces=False)
    # the draft spec over dense: a TinyLlama-wide draft beside the bf16 target
    server, _ = par_load("bf16 draft tinyllama", card, {}, params=tree, spec_mode="draft",
                         spec_k=SPEC_K, draft_model="transformer",
                         draft_model_kwargs=TINYLLAMA_1B,
                         continuous_batching_max_len=SPEC_MAX_LEN)
    _, dpaged = paged_run("bf16 spec draft tinyllama", server)
    counts, out["bf16 spec draft tinyllama dense"] = dense_run(
        "bf16 spec draft tinyllama dense", card, server, texts, dpaged["served"], exact=False)
    records.append(("bf16 spec draft tinyllama dense", counts))
    out["bf16 spec draft tinyllama dense"].update(paged_step_ms=dpaged["step_ms"])
    del server
    release_server_memory(workspaces=False)
    # dense over meshes whose ranks share this card
    for label, mesh_kw in ((f"bf16 tp={PAR_TP} dense",
                            dict(tensor_parallel=PAR_TP, topology=par_topology(PAR_TP))),
                           ("bf16 seq=2 model=2 dense",
                            dict(mesh=par_topology(4).mesh(PAR_SEQ_MESH)))):
        server, _ = par_load(label, card, {}, params=tree, **mesh_kw)
        ranks = server.mesh.size
        counts, out[label] = dense_run(label, card, server, texts, plain_bf16, ranks=ranks,
                                       fuse_steps=0, spec_mode="off")
        records.append((label, counts))
        out[label].update(paged_step_ms=out["bf16 dense"]["paged_step_ms"])
        del server
        release_server_memory(workspaces=False)
    del tree
    release_server_memory()
    return records, out


# ---------------------------------------------------------------------------
# the radix prefix cache: a multi-turn chat over a shared system prompt
# ---------------------------------------------------------------------------
def chat_tokens():
    """The chat's byte-token pieces: a PREFIX_SYSTEM-token system prompt
    common to every conversation, and per conversation and turn
    PREFIX_USER user tokens, whose first token differs from every other
    turn's (so no conversation matches another's turn)."""
    words = ("you are a careful assistant serving tensor page kernel batch decode prefill "
             "stream cache token slot model layer head warp block").split()
    text, j = "system:", 0
    while len(text) < PREFIX_SYSTEM:
        text += " " + words[(j * 7 + len(text)) % len(words)]
        j += 1
    system = list(text.encode())[:PREFIX_SYSTEM]
    users = [[[65 + PREFIX_TURNS * c + t] + list(
        (f" conversation {c} turn {t}: " + " ".join(words[(c + t + k) % len(words)]
                                                   for k in range(20))).encode())[:PREFIX_USER - 1]
              for t in range(PREFIX_TURNS)] for c in range(N_REQUESTS)]
    return system, users


def prefix_entry_bytes(knobs: dict) -> int:
    """One generate() dense entry at Llama-2-7B: PREFIX_ENTRY_POSITIONS
    positions of the KV dtype's bytes (``kv_cache_bytes_per_token``)."""
    import torch

    from seldon_core_tpu_torch.models.transformer import (TransformerConfig,
                                                          kv_cache_bytes_per_token)

    cfg = TransformerConfig(**dict(LLAMA2_7B, dtype=torch.bfloat16))
    return PREFIX_ENTRY_POSITIONS * kv_cache_bytes_per_token(
        cfg, knobs.get("kv_cache_dtype") or "bf16")


def prefix_expected(system, prompts, page_size):
    """Each request's hit from the traffic's arithmetic: turn 1 of the
    first conversation is cold; a later conversation's turn 1 shares the
    system prompt (whole blocks, its user turn differs from the first
    token); a turn t > 1 matches the conversation's previous history, its
    prompt and every answered token but the last, in full blocks and a
    copy-on-write tail. Returns [(k0, shared blocks, cow)] in order."""
    out = []
    for c, t in PREFIX_ORDER:
        if t == 0:
            k0 = 0 if c == 0 else len(system) // page_size * page_size
        else:
            k0 = len(prompts[c, t - 1]) + MAX_NEW - 1
        out.append((k0, k0 // page_size, int(k0 % page_size != 0)))
    return out


def prefix_run(label: str, card: str, server, system, users, trie: bool, prompts=None):
    """The chat through a new BatcherService (trie on or off; built under
    ``set_sync_debug_mode("error")``) behind the REST app: conversation
    0's turn 1 alone, then turn 1 of the others at once, then turns 2 and 3
    of all at once, turn by turn. ``prompts`` (the trie-on run's) replays
    the same requests; else each turn's prompt is the last one, its served
    answer and the user's turn. After a warm-up request and a cleared
    trie, every launch counter is zeroed just before the chat and read just
    after. Returns (the batcher, its service, the prompts, the served
    tokens, the launch counts, per group the TTFTs, the peak pages in use,
    the trie's counters over the chat)."""
    import torch

    from seldon_core_tpu_torch.runtime.batcher import BatcherService
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    size = server.prefix_cache_size
    server.prefix_cache_size = size if trie else 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        svc = BatcherService(server, max_slots=N_REQUESTS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        server.prefix_cache_size = size
    b = svc.batcher
    if (b._radix is not None) != trie or (b._cow_graph is not None) != trie:
        fail(f"[{label}] trie {'on' if trie else 'off'}: batcher radix {b._radix}, CoW graph "
             f"{b._cow_graph}")
    # pages in use grow only at an allocation: its exact peak
    peak = [0]
    alloc = b._allocator.alloc

    def counted(n):
        got = alloc(n)
        if got is not None:
            peak[0] = max(peak[0], b._allocator.stats()[1])
        return got

    b._allocator.alloc = counted
    server._batcher_service = svc
    httpd, _ = start(make_component_app(server, device="cuda"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    prompts = dict(prompts or {})
    served, ttfts = {}, []
    try:
        code, body = post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 4})
        if code != 200:
            fail(f"[{label}] warm-up request answered {code}: {body}")
        server.clear_prefix_cache()
        torch.cuda.synchronize()
        before = b._radix.stats() if trie else None
        zero_counts(server)
        server._cow_replays = server._cow_eager = 0
        peak[0] = 0
        for group in PREFIX_GROUPS:
            for c, t in group:
                if (c, t) not in prompts:
                    prompts[c, t] = (system + users[c][0] if t == 0 else
                                     prompts[c, t - 1] + served[c, t - 1] + users[c][t])
            server._ttft_times.clear()
            results, _ = post_all(url, [prompts[key] for key in group])
            for key, toks in zip(group, served_tokens(label, results)):
                served[key] = toks
            ttfts.append(sorted(server._ttft_times))
        launches = read_counts(server)
        launches["cow"] = (server._cow_replays, server._cow_eager)
        after = b._radix.stats() if trie else None
    finally:
        httpd.shutdown()
        httpd.server_close()
    counters = ({k: after[k] - before[k] for k in ("prefix_hit_blocks", "prefix_hit_tokens",
                                                   "prefix_cow_copies", "prefix_bytes_saved")}
                if trie else {})
    return b, svc, prompts, served, launches, ttfts, peak[0], counters


def prefix_phase(label: str, card: str, server) -> tuple:
    """The radix prefix cache on the served path (Llama-2-7B, ``server``
    loaded with the cache on): N_REQUESTS conversations x PREFIX_TURNS
    turns over a PREFIX_SYSTEM-token system prompt, MAX_NEW answered a
    turn, through the trie-on batcher and then the same requests through a
    trie-off one on the same weights. Hard checks: served tokens teacher-
    forced and equal to the trie-off run's up to a near-tie; the trie's
    hit tokens, hit blocks, CoW copies and bytes saved equal the traffic's
    arithmetic (``prefix_expected``); every chunk and every CoW a replay,
    the chunks (PREFILL_CHUNKS' 256) as many as each request's uncached
    suffix needs, the kernels' launches as the run's steps and chunks give
    them; one CoW replay on live pools bit-equal to the eager
    ``cow_page_copy`` (destination positions PAD_POS from n_valid on, the
    source untouched); after the chat the pages in use are the trie's,
    and none after ``clear_prefix_cache()``; one scrape's prefix series
    equal ``llm_stats``. Then generate()'s dense entries
    (``dense_prefix_check``). Returns (launch records, metrics)."""
    import gc

    import torch

    from seldon_core_tpu_torch.models.transformer import PAD_POS
    from seldon_core_tpu_torch.runtime.batcher import cow_page_copy
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    quantized, int8_kv = server.quantize == "int8", server.kv_cache_dtype == "int8"
    system, users = chat_tokens()
    b, svc, prompts, served, on_counts, on_ttft, on_peak, counters = prefix_run(
        label, card, server, system, users, trie=True)
    ps = b.page_size
    expect = prefix_expected(system, prompts, ps)
    bpt = b._radix.bytes_per_block // ps
    want = {"prefix_hit_tokens": sum(k0 for k0, _, _ in expect),
            "prefix_hit_blocks": sum(n + cow for _, n, cow in expect),
            "prefix_cow_copies": sum(cow for *_, cow in expect),
            "prefix_bytes_saved": sum(n for _, n, _ in expect) * ps * bpt}
    if counters != want:
        fail(f"[{label}] trie counters over the chat {counters} != the traffic's {want}")
    # each request's chunk length is its prompt bucket's; its chunks cover
    # the uncached suffix only
    on_chunks = [c for key, (k0, _, _) in zip(PREFIX_ORDER, expect)
                 for c in chunks_of(b, len(prompts[key]) - k0, len(prompts[key]))]
    on_steps = check_launches(f"{label} trie on", card, on_counts, on_chunks, quantized,
                              int8_kv, eager=False)
    if on_counts["cow"] != (want["prefix_cow_copies"], 0):
        fail(f"[{label}] CoW copies as (replays, eager runs) {on_counts['cow']}, expected "
             f"({want['prefix_cow_copies']}, 0)")
    for group in PREFIX_GROUPS:
        teacher_check(f"{label} trie on", card, server, [prompts[k] for k in group],
                      [served[k] for k in group])
    # the pool holds the trie's pages and nothing else; the scrape agrees
    httpd, _ = start(make_component_app(server, device="cuda"))
    try:
        samples = scrape(f"http://127.0.0.1:{httpd.server_address[1]}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    stats = server.llm_stats()
    for key, name in (("prefix_hit_blocks", "seldon_llm_prefix_hit_blocks_total"),
                      ("prefix_cow_copies", "seldon_llm_prefix_cow_copies_total"),
                      ("prefix_evicted_blocks", "seldon_llm_prefix_evicted_blocks_total"),
                      ("prefix_bytes_saved", "seldon_llm_prefix_bytes_saved_total"),
                      ("prefix_shared_pages", "seldon_llm_prefix_shared_pages"),
                      ("prefix_cached_blocks", "seldon_llm_prefix_cached_blocks"),
                      ("kv_pages_in_use", "seldon_llm_kv_pages_in_use"),
                      ("kv_cache_bytes", "seldon_llm_kv_cache_bytes")):
        if sample(samples, name) != stats[key]:
            fail(f"[{label}] scrape {name} {sample(samples, name)} != llm_stats {key} "
                 f"{stats[key]}")
    if stats["kv_pages_in_use"] != stats["prefix_cached_blocks"] or stats["prefix_shared_pages"]:
        fail(f"[{label}] after the chat: pages in use {stats['kv_pages_in_use']}, trie blocks "
             f"{stats['prefix_cached_blocks']}, shared {stats['prefix_shared_pages']}")
    # one CoW replay on live pools against the eager copy
    tail = next(n for _, n in b._radix._iter_nodes() if len(n.key) < ps)
    src, n_valid = tail.page, len(tail.key)
    dst = b._allocator.alloc(1)[0]
    src_before = [tuple(t[src].clone() for t in layer) for layer in b._caches]
    replays = server._cow_replays
    b._cow_copy(src, dst, n_valid)
    if server._cow_replays != replays + 1:
        fail(f"[{label}] the CoW copy was not a replay")
    got = [tuple(t[dst].clone() for t in layer) for layer in b._caches]
    for layer in b._caches:
        for t in layer:
            t[dst].fill_(3)
    a = b._cow_args
    cow_page_copy(b._caches, a[0:1], a[1:2], a[2:3])
    torch.cuda.synchronize()
    for layer, g, s0 in zip(b._caches, got, src_before):
        if not all(torch.equal(t[dst], x) and torch.equal(t[src], y)
                   for t, x, y in zip(layer, g, s0)):
            fail(f"[{label}] CoW replay != the eager cow_page_copy on live pools (or the source "
                 f"page changed)")
        pos = layer[-1]
        if not (torch.equal(pos[dst, :n_valid], pos[src, :n_valid])
                and bool((pos[dst, n_valid:] == PAD_POS).all())):
            fail(f"[{label}] CoW destination positions: not the source's up to {n_valid}, "
                 f"PAD_POS after")
    graph = b._cow_graph
    (dev_replay, _), (dev_eager, _) = time_turns(
        [graph.replay, lambda: cow_page_copy(b._caches, a[0:1], a[1:2], a[2:3])])
    host_replay, host_eager = enqueue_turns(
        [graph.replay, lambda: cow_page_copy(b._caches, a[0:1], a[1:2], a[2:3])], n=50)
    page_bytes = sum(t[0].numel() * t.element_size() for layer in b._caches for t in layer)
    cow = {"dev_ms": dev_replay, "eager_dev_ms": dev_eager, "host_ms": host_replay,
           "eager_host_ms": host_eager, "bound_ms": 2 * page_bytes / HBM_BYTES_PER_S * 1e3,
           "n_valid": n_valid, "page_mb": page_bytes / 1e6}
    b._allocator.free([dst])
    server.clear_prefix_cache()
    if b.page_stats()["kv_pages_in_use"] != 0:
        fail(f"[{label}] pages still held after clear_prefix_cache(): {b.page_stats()}")
    saved_bytes = stats["prefix_bytes_saved"]
    svc.close()
    server._batcher_service = None
    del b, svc, graph, got, src_before
    gc.collect()
    torch.cuda.empty_cache()
    # the same requests with the trie off
    b, svc, _, plain, off_counts, off_ttft, off_peak, _ = prefix_run(
        label, card, server, system, users, trie=False, prompts=prompts)
    off_chunks = [c for key in PREFIX_ORDER for c in chunks_of(b, len(prompts[key]))]
    off_steps = check_launches(f"{label} trie off", card, off_counts, off_chunks, quantized,
                               int8_kv, eager=False)
    if off_counts["cow"] != (0, 0) or b.page_stats()["kv_pages_in_use"] != 0:
        fail(f"[{label}] trie off: CoW copies {off_counts['cow']}, pages {b.page_stats()}")
    svc.close()
    server._batcher_service = None
    del b, svc
    gc.collect()
    torch.cuda.empty_cache()
    equal = near_tie_check(f"{label} trie on vs off", card, server,
                           [prompts[k] for k in PREFIX_ORDER], [served[k] for k in PREFIX_ORDER],
                           [plain[k] for k in PREFIX_ORDER])
    turns = ("turn 1, cold, alone", f"turn 1, {N_REQUESTS - 1} at once",
             f"turn 2, {N_REQUESTS} at once", f"turn 3, {N_REQUESTS} at once")
    ms = lambda ts: (statistics.median(ts) * 1e3, max(ts) * 1e3)
    for name, on, off in zip(turns, on_ttft, off_ttft):
        print(f"[{label}] TTFT {name}: median / max trie on {ms(on)[0]:.1f} / {ms(on)[1]:.1f} ms, "
              f"trie off {ms(off)[0]:.1f} / {ms(off)[1]:.1f} ms "
              f"({ms(off)[0] / ms(on)[0]:.2f}x) [{card}]", flush=True)
    print(f"[{label}] chat of {N_REQUESTS} conversations x {PREFIX_TURNS} turns "
          f"({PREFIX_SYSTEM}-token system prompt, {PREFIX_USER} user tokens a turn, {MAX_NEW} answered): prefill chunks "
          f"of {sorted(set(on_chunks))} trie on {len(on_chunks)} vs off {len(off_chunks)} (all "
          f"replays); decode "
          f"steps {on_steps} vs {off_steps}; hits {want['prefix_hit_tokens']} tokens in "
          f"{want['prefix_hit_blocks']} blocks, {want['prefix_cow_copies']} CoW copies (all "
          f"replays), prefix_bytes_saved {saved_bytes} ({saved_bytes / 1e9:.3f} GB); peak pages "
          f"in use on {on_peak} vs off {off_peak}; served tokens equal to the trie-off run's for "
          f"{equal} of {len(PREFIX_ORDER)} requests (the rest near-ties) [{card}]", flush=True)
    print(f"[{label}] CoW copy of one page ({cow['page_mb']:.1f} MB, {n_valid} of {ps} tokens "
          f"valid), on live pools: replay device {cow['dev_ms']:.4f} ms vs the eager copy's "
          f"{cow['eager_dev_ms']:.4f} ms (in turns; bound {cow['bound_ms']:.4f} ms, bytes: the "
          f"page read and written), host {cow['host_ms']:.4f} vs {cow['eager_host_ms']:.4f} ms; "
          f"bit-equal on the destination page, source untouched [{card}]", flush=True)
    dense, dense_counts = dense_prefix_check(label, card, server, system, users)
    metrics = {"on_ttft": [ms(t) for t in on_ttft], "off_ttft": [ms(t) for t in off_ttft],
               "chunks": (len(on_chunks), len(off_chunks)), "peak": (on_peak, off_peak),
               "saved_gb": saved_bytes / 1e9, "cow": cow, "dense": dense, "equal": equal}
    return [(f"{label} trie on", on_counts), (f"{label} trie off", off_counts),
            (f"{label} generate", dense_counts)], metrics


def dense_prefix_check(label: str, card: str, server, system, users):
    """generate()'s dense entries at 7B (one entry fits ``prefix_cache_bytes``):
    the system prompt and a user turn (PREFIX_SYSTEM + PREFIX_USER tokens)
    three ways: cold (a prefill, the entry stored), again (an exact hit:
    the stored logits, no prefill forward, tokens bit-equal), and extended
    by PREFIX_DENSE_EXTRA tokens (a partial hit: the entry copied in, the
    suffix through ``_get_extend``), the last equal to a cache-cleared
    call up to a near-tie. The stored entry is bit-equal to itself before
    the exact hit's decode-graph replays into the dense buffer. Each call's
    launches are its forwards' (K2 one a layer; int8 K4 one a product, on
    the prefill route for the prefill or extend). Returns (metrics, the
    launch counts of the calls)."""
    import torch

    n_layers = LLAMA2_7B["n_layers"]
    per = K4_PER_FORWARD if server.quantize == "int8" else 0
    prompt = system + users[0][0]
    longer = prompt + (users[1][1] + users[2][2])[:PREFIX_DENSE_EXTRA]
    # the (1, max_len) decode graph captured first, on a prompt sharing nothing
    server.generate([[90] * 40], max_new_tokens=MAX_NEW)
    server.clear_prefix_cache()
    zero_counts(server)
    calls = {}

    def call(name, p, forwards, wide):
        torch.cuda.synchronize()
        out = {}

        def run():
            t0 = time.perf_counter()
            out["tokens"] = server.generate([p], max_new_tokens=MAX_NEW)["tokens"][0]
            out["wall_ms"] = (time.perf_counter() - t0) * 1e3

        k2, k4w, k4d, k1 = launches_of(run)
        decode_ms = server._decode_step_times[-1] * (MAX_NEW - 1) * 1e3
        got = (k2, k4w, k4d, k1)
        expect = (n_layers * (forwards + MAX_NEW - 1), per * wide,
                  per * (forwards + MAX_NEW - 1 - wide), 0)
        if got != expect:
            fail(f"[{label}] generate() {name}: launches (K2, K4 prefill, K4 decode, K1) {got} "
                 f"!= {expect}")
        calls[name] = dict(out, prefill_ms=out["wall_ms"] - decode_ms, prompt=len(p))
        return out["tokens"]

    cold = call("cold", prompt, 1, 1)
    if len(server._prefix_cache) != 1 or server._prefix_hits != 0:
        fail(f"[{label}] generate() cold: {len(server._prefix_cache)} entries, "
             f"{server._prefix_hits} hits")
    (key, entry), = server._prefix_cache.items()
    snap = [tuple(t.clone() for t in layer) for layer in entry[2]]
    replays = server._generate_replays
    if call("exact hit", prompt, 0, 0) != cold or server._prefix_hits != 1:
        fail(f"[{label}] generate() exact hit: tokens differ from the cold call's, or no hit")
    if server._generate_replays != replays + MAX_NEW - 1:
        fail(f"[{label}] generate() exact hit: {server._generate_replays - replays} decode "
             f"replays")
    if not all(torch.equal(t, x) for layer, s0 in zip(entry[2], snap) for t, x in zip(layer, s0)):
        fail(f"[{label}] the stored entry changed under the decode graph's replays")
    dense_pos = server._dense.caches(1, entry[0])[0][-1][0]
    if dense_pos[len(prompt)].item() != len(prompt):
        fail(f"[{label}] the exact hit's decode did not write the dense buffer")
    del snap
    extended = call("partial hit", longer, 1, 1)
    if server._prefix_hits != 2 or tuple(longer) not in server._prefix_cache:
        fail(f"[{label}] generate() partial hit: hits {server._prefix_hits}, extended entry "
             f"stored {tuple(longer) in server._prefix_cache}")
    server.clear_prefix_cache()
    fresh = call("cleared", longer, 1, 1)
    counts = read_counts(server)
    teacher_check(f"{label} generate", card, server, [prompt, longer], [cold, extended])
    near_tie_check(f"{label} generate partial hit vs cleared", card, server, [longer],
                   [extended], [fresh])
    server.clear_prefix_cache()
    print(f"[{label}] generate() with the prefix cache (max_len {entry[0]}, entry "
          f"{entry[4] / 1e9:.3f} GB of a {server.prefix_cache_bytes / 1e9:.3f} GB budget): "
          + "; ".join(f"{name} ({c['prompt']} tokens): prefill (the wall less the decode's) "
                      f"{c['prefill_ms']:.1f} ms, wall {c['wall_ms']:.1f} ms"
                      for name, c in calls.items())
          + f"; exact hit bit-equal to cold, no prefill forward; the entry unchanged by the "
          f"decode graph [{card}]", flush=True)
    return calls, counts


def release_server_memory(workspaces: bool = True) -> None:
    """After a dropped server: collect it, return the cached blocks, and
    free the cuBLAS workspaces PyTorch keeps for every stream it ever ran a
    product on (32 MiB each; a server's capture and generate streams die
    with it), so the next ``load_llm`` starts from what is really live.
    ``workspaces=False`` keeps them: a live server's captured graphs hold
    their workspace's address (the [parallel] phase beside its tp = 1
    server)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    if workspaces:
        torch._C._cuda_clearCublasWorkspaces()


def prefix_runs_phase(card: str):
    """``prefix_phase`` on a bf16 server, then on int8 weights + int8 KV,
    each loaded for it with the cache on (PREFIX_CACHE_SIZE entries, a
    dense budget of one 7B entry) and dropped before the next. Returns
    (launch records, label -> metrics)."""
    records, runs = [], {}
    for model, knobs in (("bf16", {}), ("int8", dict(quantize="int8", kv_cache_dtype="int8"))):
        label = f"{model} prefix"
        server, _ = load_llm(label, card, dict(
            knobs, prefix_cache_size=PREFIX_CACHE_SIZE,
            prefix_cache_bytes=int(1.5 * prefix_entry_bytes(knobs))))
        recs, runs[label] = prefix_phase(label, card, server)
        records += recs
        del server
        release_server_memory()
    return records, runs


def print_prefix_runs(card: str, runs: dict) -> None:
    print(f"prefix runs (Llama-2-7B, {N_REQUESTS} conversations x {PREFIX_TURNS} turns over a "
          f"{PREFIX_SYSTEM}-token system prompt; TTFT median / max, trie on vs off) [{card}]:",
          flush=True)
    for label, m in runs.items():
        ttft = "; ".join(f"{on[0]:.1f} / {on[1]:.1f} vs {off[0]:.1f} / {off[1]:.1f} ms"
                         for on, off in zip(m["on_ttft"], m["off_ttft"]))
        c, d = m["cow"], m["dense"]
        print(f"  {label:12s} TTFT by group (turn 1 alone, turn 1 x {N_REQUESTS - 1}, turn 2, "
              f"turn 3): {ttft}; chunks {m['chunks'][0]} vs {m['chunks'][1]}; peak pages "
              f"{m['peak'][0]} vs {m['peak'][1]}; bytes saved {m['saved_gb']:.3f} GB; CoW replay "
              f"device {c['dev_ms']:.4f} ms host {c['host_ms']:.4f} ms vs eager "
              f"{c['eager_dev_ms']:.4f} / {c['eager_host_ms']:.4f} ms; generate() prefill cold "
              f"{d['cold']['prefill_ms']:.1f}, exact hit {d['exact hit']['prefill_ms']:.1f}, "
              f"partial hit {d['partial hit']['prefill_ms']:.1f} ms [{card}]", flush=True)


# ---------------------------------------------------------------------------
# ResNet-50: K3, the forward, predict serving
# ---------------------------------------------------------------------------
def live_blocks(c, f, n_blocks, g, dev):
    """Folded identity blocks drawn from ``g`` with live residual branches:
    weights at 1/sqrt(fan_in), biases normal(0.1), b1 positive so the 3x3
    conv's zero padding differs from relu(b1); every w3 non-zero."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    blocks = []
    for _ in range(n_blocks):
        blk = dict(w1=rnd(c, f, scale=c ** -0.5).to(torch.bfloat16).contiguous(),
                   b1=0.05 + 0.1 * torch.rand((f,), generator=g, device=dev),
                   w2=rnd(3, 3, f, f, scale=(9 * f) ** -0.5).to(torch.bfloat16).contiguous(),
                   b2=rnd(f, scale=0.1),
                   w3=rnd(f, c, scale=0.5 * f ** -0.5).to(torch.bfloat16).contiguous(),
                   b3=rnd(c, scale=0.1))
        if blk["w3"].abs().max().item() == 0:
            fail("K3 weights: a w3 is all zero (the residual branch would be switched off)")
        blocks.append(blk)
    return blocks


def k3_forward_launches(batch, sms):
    """The launches K3 adds in one ResNet-50 forward at ``batch``: the four
    chains' ``expected_launches``."""
    from seldon_core_tpu_torch.ops.fused_resnet import expected_launches

    return sum(expected_launches(batch, hw, hw, c, f, n, sms) for hw, c, f, n in RESNET50_CHAINS)


def k3_count():
    from seldon_core_tpu_torch.ops.fused_resnet import fused_identity_chain

    return fused_identity_chain.launches


def k3_chain_inputs(batch, hw, c, f, n_blocks, seed):
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn((batch, hw, hw, c), generator=g, device=dev)).to(torch.bfloat16)
    return x, live_blocks(c, f, n_blocks, g, dev)


def cudnn_chain_fn(x, blocks):
    """The eager cuDNN chain of the same blocks: F.conv2d on channels-last
    bf16 operands, bf16 bias add, relu — the folded flax graph's numerics,
    several PyTorch calls."""
    import torch

    from seldon_core_tpu_torch.models.resnet_infer import bottleneck, conv_weight

    dev = x.device
    c, f = blocks[0]["w1"].shape
    cud = [{"Conv_0": {"w": conv_weight(b["w1"].reshape(1, 1, c, f), dev, torch.bfloat16),
                       "b": b["b1"].to(torch.bfloat16)},
            "Conv_1": {"w": conv_weight(b["w2"], dev, torch.bfloat16),
                       "b": b["b2"].to(torch.bfloat16)},
            "Conv_2": {"w": conv_weight(b["w3"].reshape(1, 1, f, c), dev, torch.bfloat16),
                       "b": b["b3"].to(torch.bfloat16)}} for b in blocks]

    def run():
        y = x
        for blk in cud:
            y = bottleneck(y, blk, 1)
        return y

    return run


def k3_case(batch, hw, c, f, n_blocks, seed, flush, sms):
    """One ResNet-50 identity chain at ``batch`` through K3 under its plan,
    against its plain version: its launches as ``expected_launches`` says,
    and one call captured in a CUDA graph (exactly those kernel nodes, the
    replay within tolerance); timed in turns with the eager cuDNN chain of
    the same blocks."""
    import torch

    from seldon_core_tpu_torch.ops.fused_resnet import (_k3_plan, expected_launches,
                                                        fused_identity_chain, identity_chain_ref)

    x, blocks = k3_chain_inputs(batch, hw, c, f, n_blocks, seed)
    label = f"K3 {hw}x{hw}x{c} F={f} x{n_blocks} blocks, B={batch}"
    want = expected_launches(batch, hw, hw, c, f, n_blocks, sms)
    before = k3_count()
    out = fused_identity_chain(x, blocks)
    torch.cuda.synchronize()
    got = k3_count() - before
    if got != want:
        fail(f"{label}: {got} launches, expected_launches says {want}")
    ref = identity_chain_ref(x, blocks)
    tol = n_blocks * bf16_ulp(ref.float().abs().max()).item()

    def err_of(y, what):
        e = (y.float() - ref.float()).abs().max().item()
        if not torch.isfinite(y.float()).all() or e > tol:
            fail(f"{label}: {what} max_abs_err {e} > {tol} ({K3_TOL_REASON})")
        return e

    err = err_of(out, "the kernel")
    nodes, replay = graph_nodes(lambda: fused_identity_chain(x, blocks))
    if nodes != ["kernel"] * want:
        fail(f"{label}: one chain call put {nodes} on its stream, expected {want} kernels")
    graph_err = err_of(replay, "the CUDA graph's replay")
    cudnn_chain = cudnn_chain_fn(x, blocks)
    cudnn_err = (cudnn_chain().float() - ref.float()).abs().max().item()
    del out, ref, replay
    timed = time_turns([lambda: fused_identity_chain(x, blocks), cudnn_chain], flush)
    plain_ms = time_ms(lambda: identity_chain_ref(x, blocks), flush)
    # one read and one write of the chain's activation, the weights (bf16)
    # and biases (float32) once; two flops per multiply-add
    m = batch * hw * hw
    nbytes = 2 * x.numel() * 2 + n_blocks * ((2 * c * f + 9 * f * f) * 2 + (2 * f + c) * 4)
    flops = 2 * m * (2 * c * f + 9 * f * f) * n_blocks
    bytes_s, flops_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    # the design's own byte floor: per block x read twice, y1 and y2
    # written and read back, out written
    floor_ms = n_blocks * m * (3 * c + 4 * f) * 2 / HBM_BYTES_PER_S * 1e3
    return dict(err=err, graph_err=graph_err, tol=tol, cudnn_err=cudnn_err,
                ms=timed[0][0], cudnn_ms=timed[1][0], enqueue_ms=timed[0][1], plain_ms=plain_ms,
                library_ms=None, bound_ms=max(bytes_s, flops_s) * 1e3,
                bound_by="bytes" if bytes_s >= flops_s else "operations", floor_ms=floor_ms,
                launches=want, plan=_k3_plan(batch, hw, hw, c, f, sms))


K3_SWEEP_SPLITS = (1, 2, 3, 4, 6, 8)


def k3_sweep(card, flush, rows_path=None):
    """``--k3-sweep``: at the four ResNet-50 chains, at B = 128 and B = 8,
    every tile width x split of each of K3's three convs (each conv alone
    on the chain's first block, checked against its plain conv once, then
    timed in turns with the others of its conv, without flushing L2: in the
    chain its input was just written), then the chain through the plan and
    the eager cuDNN chain in turns (L2 flushed).
    The data behind ``ops/fused_resnet._k3_plan``; every row also goes to
    ``rows_path`` as JSON, when given."""
    import torch

    from seldon_core_tpu_torch.ops.fused_resnet import (GEMM_BNS, _block_param_list, _conv_dims,
                                                        _conv_gemm, _k3_plan, _conv3x3_same,
                                                        fused_identity_chain)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for batch in (RESNET_BATCH, PREDICT_BATCH):
        for hw, c, f, n_blocks in RESNET50_CHAINS:
            x, blocks = k3_chain_inputs(batch, hw, c, f, n_blocks, seed=hw + batch)
            m = batch * hw * hw
            w1, b1, w2, b2, w3, b3 = _block_param_list(blocks[:1])
            xm = x.view(m, c)
            y1 = torch.relu(xm.float() @ w1.float() + b1).to(torch.bfloat16)
            y2 = _conv3x3_same(y1.view(batch, hw, hw, f).float(), w2.float()).reshape(m, f)
            y2 = torch.relu(y2 + b2).to(torch.bfloat16)
            y3 = torch.relu((y2.float() @ w3.float() + b3).to(torch.bfloat16) + xm)
            convs = [(1, xm, w1, b1, None, y1), (2, y1, w2, b2, None, y2), (3, y2, w3, b3, xm, y3)]
            partial = torch.empty(max(K3_SWEEP_SPLITS) * m * max(c, f), dtype=torch.float32,
                                  device=x.device)
            plan = _k3_plan(batch, hw, hw, c, f, sms)
            label = f"{hw}x{hw}x{c} F={f} B={batch}"
            for (stage, a, wt, bias, resid, want), (_, n, steps), picked in zip(
                    convs, _conv_dims(c, f), plan):
                configs = []
                for bn in GEMM_BNS:
                    for s in K3_SWEEP_SPLITS:
                        per = -(-steps // s)
                        if n % bn == 0 and s <= steps and -(-steps // per) == s:
                            configs.append((bn, s, per))
                outs = [torch.empty_like(want) for _ in configs]
                tol = bf16_ulp(want.float().abs().max()).item()
                for cfg, o in zip(configs, outs):
                    _conv_gemm(stage, a, wt, bias, resid, o, hw, hw, cfg, partial)
                    e = (o.float() - want.float()).abs().max().item()
                    if not e <= tol:
                        fail(f"k3-sweep {label} conv {stage} {cfg}: max_abs_err {e} > 1 ulp {tol}")
                timed = time_turns([
                    (lambda cfg=cfg, o=o: _conv_gemm(stage, a, wt, bias, resid, o, hw, hw, cfg,
                                                     partial)) for cfg, o in zip(configs, outs)])
                best = min(range(len(configs)), key=lambda i: timed[i][0])
                for cfg, (ms, enq) in zip(configs, timed):
                    rows.append(dict(chain=hw, batch=batch, conv=stage, m=m, n=n, steps=steps,
                                     bn=cfg[0], splits=cfg[1], per=cfg[2], ms=ms, enqueue_ms=enq,
                                     plan=cfg == tuple(picked)))
                print(f"k3-sweep {label} conv {stage} [{m},{steps * 64}]x[{steps * 64},{n}]: "
                      + ", ".join(f"{cfg[0]}/{cfg[1]}{'*' if cfg == tuple(picked) else ''} "
                                  f"{ms:.4f}" for cfg, (ms, _) in zip(configs, timed))
                      + f"; fastest {configs[best]}, plan {tuple(picked)} [{card}]", flush=True)
                del outs
            cudnn_chain = cudnn_chain_fn(x, blocks)
            timed = time_turns([lambda: fused_identity_chain(x, blocks), cudnn_chain], flush)
            rows.append(dict(chain=hw, batch=batch, n_blocks=n_blocks, plan_ms=timed[0][0],
                             cudnn_ms=timed[1][0], plan_enqueue_ms=timed[0][1]))
            print(f"k3-sweep {label} x{n_blocks} blocks, in turns: K3 (plan) "
                  f"{timed[0][0]:.4f} ms, cuDNN chain {timed[1][0]:.4f} ms; host enqueue "
                  f"{timed[0][1]:.4f} ms [{card}]", flush=True)
            del x, blocks, partial, convs, y1, y2, y3
    if rows_path:
        os.makedirs(os.path.dirname(os.path.abspath(rows_path)), exist_ok=True)
        with open(rows_path, "w") as fh:
            json.dump(dict(card=card, rows=rows), fh, indent=1)


def check_logits(label, got, ref):
    """``got`` within FWD_TOL * max|ref| of ``ref``; top-1 equal in every row
    whose reference top two are further apart than that bound."""
    import torch

    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{label}: logits {tuple(got.shape)} not finite or not shaped {tuple(ref.shape)}")
    bound = FWD_TOL * ref.abs().max().item()
    err = (got - ref).abs().max().item()
    if err > bound:
        fail(f"{label}: max |logit diff| {err:.4g} > {FWD_TOL} x max|logit| = {bound:.4g}")
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > bound
    agree = got.argmax(-1) == ref.argmax(-1)
    if (clear & ~agree).any():
        fail(f"{label}: top-1 differs in a row whose reference margin exceeds {bound:.4g}")
    return err, bound, int(clear.sum()), int((agree & clear).sum())


def resnet_forward_phase(card):
    """ResNet-50 folded at full width and depth, live seeded weights, a
    forward at batch 128 through K3 and through the cuDNN chain."""
    import torch

    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.models.resnet_infer import resnet_serve_forward
    from seldon_core_tpu_torch.ops.fused_resnet import fused_identity_chain

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    model = get_model("resnet50", fused=True, device="cuda")
    model.init_params(torch.Generator(device=dev).manual_seed(50))
    for i, blk in enumerate(model.blocks()):
        if blk.Conv_2.kernel.abs().max().item() == 0:
            fail(f"ResNet-50 weights: BottleneckBlock_{i} Conv_2 is all zero")
    g = torch.Generator(device=dev).manual_seed(51)
    x = torch.randn((RESNET_BATCH, 224, 224, 3), generator=g, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = k3_forward_launches(RESNET_BATCH, sms)
    with torch.no_grad():
        fused_identity_chain.launches = 0
        logits = model(x)
        torch.cuda.synchronize()
        launches = k3_count()
        if launches != want:
            fail(f"ResNet-50 forward: {launches} K3 launches, expected_launches says {want}")
        ref = resnet_serve_forward(model, x, pallas_stages=())
        err, bound, clear, agree = check_logits("ResNet-50 K3 vs cuDNN forward", logits, ref)
        # the forward both ways in turns, at B = 128 and at a served B = 8
        x8 = x[:PREDICT_BATCH].contiguous()
        timed = time_turns([lambda: model(x),
                            lambda: resnet_serve_forward(model, x, pallas_stages=()),
                            lambda: model(x8),
                            lambda: resnet_serve_forward(model, x8, pallas_stages=())])
    (ms, enq), (cudnn_ms, cudnn_enq), (ms8, enq8), (cudnn_ms8, cudnn_enq8) = timed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"ResNet-50 folded forward, B={RESNET_BATCH} 224x224x3 bf16, random live weights: "
          f"K3 forward {ms:.3f} ms = {RESNET_BATCH / ms * 1e3:.1f} images/s ({launches} K3 "
          f"launches per forward; host enqueue {enq:.3f} ms); cuDNN-chain forward (pallas_stages=()) {cudnn_ms:.3f} ms = "
          f"{RESNET_BATCH / cudnn_ms * 1e3:.1f} images/s (enqueue {cudnn_enq:.3f} ms), in "
          f"turns; at B={PREDICT_BATCH}: K3 {ms8:.3f} ms (enqueue {enq8:.3f} ms), cuDNN chain "
          f"{cudnn_ms8:.3f} ms (enqueue {cudnn_enq8:.3f} ms); max |logit diff| {err:.4g} (bound "
          f"{bound:.4g} = {FWD_TOL} x max|logit|), top-1 equal in {agree} of {clear} rows with a "
          f"clear margin; peak device memory {peak_gb:.2f} GB [{card}]", flush=True)
    return model, dict(ms=ms, cudnn_ms=cudnn_ms, err=err, peak_gb=peak_gb)


def resnet_serving_phase(card, model):
    """The folded ResNet-50 through the port's predict path: checkpoint ->
    TorchServer (as the CLI builds it) -> REST /api/v0.1/predictions and
    /predict. Returns K3's launches during the requests."""
    import tempfile

    import numpy as np
    import torch

    from seldon_core_tpu_torch.contracts.parameters import parse_parameters
    from seldon_core_tpu_torch.models.resnet_infer import resnet_serve_forward
    from seldon_core_tpu_torch.ops.fused_resnet import fused_identity_chain
    from seldon_core_tpu_torch.servers.torchserver import TorchServer, export_checkpoint
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    with tempfile.TemporaryDirectory(prefix="resnet50-ckpt-") as ckpt:
        t0 = time.perf_counter()
        export_checkpoint(ckpt, "resnet50", {"params": model.param_tree()},
                          kwargs={"fused": True}, input_shape=[224, 224, 3], use_orbax=False)
        export_s = time.perf_counter() - t0
        unit_params = json.dumps([{"name": "model_uri", "value": ckpt, "type": "STRING"}])
        t0 = time.perf_counter()
        server = TorchServer(device="cuda", **parse_parameters(unit_params))
        server.load()
        load_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    images = [np.round(rng.standard_normal((PREDICT_BATCH, 224, 224, 3)), 2).astype(np.float32)
              for _ in range(PREDICT_REQUESTS)]
    single = np.round(rng.standard_normal((1, 224, 224, 3)), 2).astype(np.float32)
    bodies = [{"meta": {"puid": f"req-{i}"},
               "data": {"tensor": {"shape": list(im.shape), "values": im.ravel().tolist()}}}
              for i, im in enumerate(images)]
    single_body = {"meta": {"puid": "req-nd"}, "data": {"ndarray": single.tolist()}}
    httpd, _ = start(make_component_app(server, device="cuda"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    results, walls = [None] * PREDICT_REQUESTS, [None] * PREDICT_REQUESTS
    try:
        code, body = post(url + "/api/v0.1/predictions", bodies[0])   # warm-up, not counted
        if code != 200:
            fail(f"predict warm-up answered {code}: {body}")
        torch.cuda.synchronize()

        def client(i):
            t = time.perf_counter()
            results[i] = post(url + "/api/v0.1/predictions", bodies[i])
            walls[i] = time.perf_counter() - t

        fused_identity_chain.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(PREDICT_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        t1 = time.perf_counter()
        nd = post(url + "/predict", single_body)
        nd_wall = time.perf_counter() - t1
        launches = k3_count()
    finally:
        httpd.shutdown()
        httpd.server_close()
    # the requests' batches pad to their buckets: 8 images stay 8, 1 stays 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per8, per1 = k3_forward_launches(PREDICT_BATCH, sms), k3_forward_launches(1, sms)
    want = PREDICT_REQUESTS * per8 + per1
    if launches != want:
        fail(f"predict serving: {launches} K3 launches for {PREDICT_REQUESTS} requests of "
             f"{PREDICT_BATCH} images and one of 1, expected_launches says {want}")
    names = [f"t:{i}" for i in range(1000)]
    errs = []
    for i, (res, im) in enumerate(zip(results + [nd], images + [single])):
        if res is None:
            fail(f"predict request {i} did not complete")
        code, body = res
        if code != 200:
            fail(f"predict request {i} answered {code}: {body}")
        data = body.get("data", {})
        enc = "ndarray" if i == PREDICT_REQUESTS else "tensor"
        if enc not in data or data.get("names") != names:
            fail(f"predict request {i}: expected {enc} data with names t:0..t:999, got keys "
                 f"{sorted(data)}")
        puid = "req-nd" if i == PREDICT_REQUESTS else f"req-{i}"
        if body.get("meta", {}).get("puid") != puid:
            fail(f"predict request {i}: meta {body.get('meta')} does not echo puid {puid}")
        got = (np.asarray(data["ndarray"]) if enc == "ndarray"
               else np.asarray(data["tensor"]["values"]).reshape(data["tensor"]["shape"]))
        if got.shape != (im.shape[0], 1000):
            fail(f"predict request {i}: logits shaped {got.shape}")
        # the served logits against the cuDNN chain on the same weights (a
        # computation independent of K3) and against the in-process forward
        with torch.no_grad():
            xi = torch.from_numpy(im).cuda()
            cudnn = resnet_serve_forward(model, xi, pallas_stages=()).cpu()
            k3 = model(xi).cpu()
        err, bound, _, _ = check_logits(f"predict request {i} vs the cuDNN-chain forward",
                                        torch.from_numpy(got), cudnn)
        check_logits(f"predict request {i} vs the in-process forward", torch.from_numpy(got), k3)
        errs.append((err, bound))
    print(f"predict serving (ResNet-50 folded, TorchServer from a msgpack checkpoint: export "
          f"{export_s:.2f} s, load {load_s:.2f} s): {PREDICT_REQUESTS} concurrent POST "
          f"/api/v0.1/predictions of {PREDICT_BATCH} images (tensor JSON) in "
          f"{max(walls):.3f} s, request latency median {statistics.median(walls) * 1e3:.1f} ms "
          f"max {max(walls) * 1e3:.1f} ms; POST /predict of 1 image (ndarray JSON) "
          f"{nd_wall * 1e3:.1f} ms; K3 launches {launches} = {PREDICT_REQUESTS} x {per8} + "
          f"{per1}, as expected_launches says; every response 200 with names t:0..t:999, puid "
          f"echoed, logits within {FWD_TOL} x max|logit| of the cuDNN-chain forward (max "
          f"|diff| {max(e for e, _ in errs):.4g}, bound at least {min(b for _, b in errs):.4g})"
          f" and of the in-process forward [{card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# The graph engine: a fused combiner and a bandit router over two ResNet-50
# JAX_SERVER leaves, an LLM component, the control routes
# ---------------------------------------------------------------------------
# the fused combiner (a float32 mean on the card) against the same graph
# unfused (each TorchServer's predict, a float64 mean on the host) over the
# same servers, and gRPC against REST on one engine: the same kernels on the
# same batch shapes (8 and 1 are buckets: nothing pads), so only the mean's
# rounding differs; the card test holds the same comparison to the same bound
ENGINE_FUSE_TOL = 1e-5
ENGINE_TURNS = 2          # rounds of C E E C single requests in (a)'s latency turns
ENGINE_BANDIT = dict(n_branches=2, epsilon=0.5, seed=5)
ENGINE_ROUTED = (16, 8)   # predictions before the feedback, and after


def graph_spec(root: dict):
    from seldon_core_tpu_torch.contracts.graph import PredictorSpec

    return PredictorSpec.from_dict({"name": "engine", "graph": root})


def logits_of(body: dict):
    import numpy as np

    data = body.get("data", {})
    if "tensor" in data:
        return np.asarray(data["tensor"]["values"]).reshape(data["tensor"]["shape"])
    return np.asarray(data["ndarray"])


def concurrent_posts(url: str, bodies):
    """POST every body at once; [(code, body, wall s)] in order."""
    out = [None] * len(bodies)

    def client(i):
        t = time.perf_counter()
        code, body = post(url, bodies[i])
        out[i] = (code, body, time.perf_counter() - t)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(r is None for r in out):
        fail(f"a request to {url} did not complete")
    return out


def engine_phase(card: str, model) -> tuple:
    """The port's graph engine on the card (``runtime/engine.GraphEngine``
    behind ``transport/rest.make_engine_app``), over two live folded
    ResNet-50 ``JAX_SERVER`` leaves (``model``, seed 50, and a second one,
    seed 52, each through a msgpack checkpoint):

    (a) an AVERAGE_COMBINER of the two, fused: PREDICT_REQUESTS concurrent
        requests of PREDICT_BATCH images (tensor JSON) and one of 1 image
        (ndarray); every response 200 with its puid and all three units in
        requestPath, logits within FWD_TOL of the mean of the two
        cuDNN-chain forwards, one fused run a request (``_fused_calls``),
        K3 launched 2 x ``expected_launches`` a request; the same requests
        through an unfused engine over the same servers within
        ENGINE_FUSE_TOL; the latency beside the component app's on one
        leaf (concurrent, then one request at a time in turns), and the
        fused call's device time beside two single forwards;
    (b) a seeded EPSILON_GREEDY over the same leaves: ENGINE_ROUTED[0]
        one-image predictions, feedback with rewards for each through
        /api/v0.1/feedback, ENGINE_ROUTED[1] more: the routes a fresh
        router with the same seed and the same feedback gives on the host,
        the router's counts the rewards' arithmetic, K3 launched for the
        routed leaf alone, and the scrape's request and feedback series;
    (d) /pause (predictions and /ready 503) and /unpause, a spent
        ``Seldon-Deadline-Ms`` (504), and gRPC ``Seldon/Predict`` equal to
        REST's answer to (a)'s first request.

    Returns K3's launches in (a) and (b), and (b)'s router."""
    import tempfile

    import numpy as np
    import torch

    from seldon_core_tpu_torch.analytics.routers import EpsilonGreedy
    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.models.resnet_infer import resnet_serve_forward
    from seldon_core_tpu_torch.ops.fused_resnet import fused_identity_chain
    from seldon_core_tpu_torch.runtime.engine import GraphEngine
    from seldon_core_tpu_torch.servers.torchserver import export_checkpoint
    from seldon_core_tpu_torch.transport.rest import make_component_app, make_engine_app, start

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    model_b = get_model("resnet50", fused=True, device="cuda")
    model_b.init_params(torch.Generator(device=dev).manual_seed(52))
    models = [model, model_b]
    for m in models:
        if any(blk.Conv_2.kernel.abs().max().item() == 0 for blk in m.blocks()):
            fail("engine phase: a ResNet-50 leaf has a Conv_2 that is all zero")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per8, per1 = k3_forward_launches(PREDICT_BATCH, sms), k3_forward_launches(1, sms)
    with tempfile.TemporaryDirectory(prefix="engine-ckpts-") as root:
        leaves = []
        for name, m in zip(("a", "b"), models):
            path = os.path.join(root, name)
            export_checkpoint(path, "resnet50", {"params": m.param_tree()},
                              kwargs={"fused": True}, input_shape=[224, 224, 3])
            leaves.append({"name": name, "type": "MODEL", "implementation": "JAX_SERVER",
                           "modelUri": path})
        combiner = {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
                    "children": leaves}
        t0 = time.perf_counter()
        fused = GraphEngine(graph_spec(combiner), device="cuda")
        build_s = time.perf_counter() - t0
    servers = {name: fused.state.unit_by_name(name).component for name in ("a", "b")}
    unfused = GraphEngine(graph_spec(combiner), components=servers, fuse=False, device="cuda")
    root_state = fused.state.root
    if root_state.fused_fn is None or [u.name for u in root_state.fused_units] != \
            ["avg", "a", "b"]:
        fail(f"engine phase: the combiner did not fuse its two leaves "
             f"({[u.name for u in root_state.fused_units]})")

    rng = np.random.default_rng(17)
    images = [np.round(rng.standard_normal((PREDICT_BATCH, 224, 224, 3)), 2).astype(np.float32)
              for _ in range(PREDICT_REQUESTS)]
    single = np.round(rng.standard_normal((1, 224, 224, 3)), 2).astype(np.float32)
    bodies = [{"meta": {"puid": f"eng-{i}"},
               "data": {"tensor": {"shape": list(im.shape), "values": im.ravel().tolist()}}}
              for i, im in enumerate(images)]
    single_body = {"meta": {"puid": "eng-nd"}, "data": {"ndarray": single.tolist()}}
    handler = make_engine_app(fused, device="cuda")
    httpd, _ = start(handler)
    comp_httpd, _ = start(make_component_app(servers["a"], device="cuda"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    comp_url = f"http://127.0.0.1:{comp_httpd.server_address[1]}"
    try:
        # (a) the fused combiner
        for u in (url, comp_url):  # warm-up, not counted
            code, body = post(u + "/api/v0.1/predictions", bodies[0])
            if code != 200:
                fail(f"engine warm-up at {u} answered {code}: {body}")
        torch.cuda.synchronize()
        fused._fused_calls = 0
        fused_identity_chain.launches = 0
        results = concurrent_posts(url + "/api/v0.1/predictions", bodies)
        t1 = time.perf_counter()
        nd = post(url + "/api/v0.1/predictions", single_body)
        nd_wall = time.perf_counter() - t1
        launches_a = k3_count()
        calls_a = fused._fused_calls
        want_a = 2 * (PREDICT_REQUESTS * per8 + per1)
        if launches_a != want_a:
            fail(f"engine (a): {launches_a} K3 launches for {PREDICT_REQUESTS} requests of "
                 f"{PREDICT_BATCH} images and one of 1 through two leaves, expected_launches "
                 f"says {want_a}")
        if calls_a != PREDICT_REQUESTS + 1:
            fail(f"engine (a): {calls_a} fused runs for {PREDICT_REQUESTS + 1} requests")
        comp = concurrent_posts(comp_url + "/api/v0.1/predictions", bodies)
        errs, fuse_errs = [], []
        for i, ((code, body, _), im) in enumerate(zip(results + [(*nd, nd_wall)],
                                                     images + [single])):
            puid = "eng-nd" if i == PREDICT_REQUESTS else f"eng-{i}"
            meta = body.get("meta", {})
            if code != 200 or meta.get("puid") != puid:
                fail(f"engine (a) request {i}: {code}, meta {meta} (puid {puid} expected)")
            if meta.get("requestPath") != {"avg": "AverageCombiner", "a": "TorchServer",
                                           "b": "TorchServer"}:
                fail(f"engine (a) request {i}: requestPath {meta.get('requestPath')}")
            got = logits_of(body)
            with torch.no_grad():
                xi = torch.from_numpy(im).cuda()
                ref = torch.stack([resnet_serve_forward(m, xi, pallas_stages=())
                                   for m in models]).mean(0).cpu()
            err, bound, _, _ = check_logits(f"engine (a) request {i} vs the mean of the two "
                                            f"cuDNN-chain forwards", torch.from_numpy(got), ref)
            errs.append((err, bound))
            plain = logits_of(unfused.predict_sync(
                seldon_message(body_for(im, puid))).to_dict())
            fe = float(np.abs(got - plain).max())
            if fe > ENGINE_FUSE_TOL * float(np.abs(plain).max()):
                fail(f"engine (a) request {i}: fused vs unfused max |diff| {fe:.4g} > "
                     f"{ENGINE_FUSE_TOL} x max|logit|")
            fuse_errs.append(fe)
        for code, body, _ in comp:
            if code != 200:
                fail(f"component app on leaf a answered {code}: {body}")
        # what the graph adds: one request of PREDICT_BATCH images at a time,
        # to the component app on leaf a and to the engine in turns (C E E C,
        # ENGINE_TURNS rounds), and the client's encoding of that body and a
        # parse of the same text timed apart
        turns = {"component": [], "engine": []}
        for _ in range(ENGINE_TURNS):
            for side, u in (("component", comp_url), ("engine", url), ("engine", url),
                            ("component", comp_url)):
                t = time.perf_counter()
                code, body = post(u + "/api/v0.1/predictions", bodies[0])
                turns[side].append(time.perf_counter() - t)
                if code != 200:
                    fail(f"engine (a) turns: the {side} answered {code}: {body}")
        t = time.perf_counter()
        text = json.dumps(bodies[0])
        encode_s = time.perf_counter() - t
        t = time.perf_counter()
        json.loads(text)
        parse_s = time.perf_counter() - t
        walls = [w for _, _, w in results]
        comp_walls = [w for _, _, w in comp]
        fused_fn = root_state.fused_fn
        x8 = torch.from_numpy(images[0]).cuda()
        with torch.inference_mode():
            (fused_ms, fused_enq), (two_ms, two_enq) = time_turns(
                [lambda: fused_fn(images[0]),
                 lambda: (servers["a"]._module(x8), servers["b"]._module(x8))])
        print(f"[engine] (a) AVERAGE_COMBINER over two JAX_SERVER ResNet-50 leaves (folded, "
              f"live weights, msgpack checkpoints; engine built in {build_s:.2f} s), fused "
              f"into one composed call on the card: {PREDICT_REQUESTS} concurrent POST "
              f"/api/v0.1/predictions of {PREDICT_BATCH} images (tensor JSON), request "
              f"latency median {statistics.median(walls) * 1e3:.1f} ms max "
              f"{max(walls) * 1e3:.1f} ms, beside the component app on leaf a (one forward "
              f"a request) median {statistics.median(comp_walls) * 1e3:.1f} ms max "
              f"{max(comp_walls) * 1e3:.1f} ms; 1 image (ndarray JSON) {nd_wall * 1e3:.1f} ms; "
              f"fused runs {calls_a} = requests; K3 launches {launches_a} = 2 x "
              f"({PREDICT_REQUESTS} x {per8} + {per1}), as expected_launches says; logits "
              f"within {FWD_TOL} x max|logit| of the mean of the two cuDNN-chain forwards "
              f"(max |diff| {max(e for e, _ in errs):.4g}, bound at least "
              f"{min(b for _, b in errs):.4g}); fused vs unfused (host float64 mean) max "
              f"|diff| {max(fuse_errs):.3g} (<= {ENGINE_FUSE_TOL} x max|logit|); the fused "
              f"call at B={PREDICT_BATCH} (staging + two forwards + the mean) {fused_ms:.3f} "
              f"ms of device vs two single forwards {two_ms:.3f} ms, in turns (host enqueue "
              f"{fused_enq:.3f} vs {two_enq:.3f} ms) [{card}]", flush=True)
        eng_med = statistics.median(turns["engine"])
        comp_med = statistics.median(turns["component"])
        print(f"[engine] (a) one request of {PREDICT_BATCH} images (tensor JSON, "
              f"{len(text)} bytes) at a time, in turns (component, engine, engine, component "
              f"x {ENGINE_TURNS}): engine median {eng_med * 1e3:.1f} ms max "
              f"{max(turns['engine']) * 1e3:.1f} ms, component app on leaf a median "
              f"{comp_med * 1e3:.1f} ms max {max(turns['component']) * 1e3:.1f} ms, what the "
              f"graph adds {(eng_med - comp_med) * 1e3:.1f} ms; of a request, the client's "
              f"json.dumps of the body {encode_s * 1e3:.1f} ms and a json.loads of the same "
              f"text {parse_s * 1e3:.1f} ms [{card}]", flush=True)

        # (b) the bandit router
        bandit = {"name": "router", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
                  "parameters": [{"name": k, "value": str(v),
                                  "type": "FLOAT" if k == "epsilon" else "INT"}
                                 for k, v in ENGINE_BANDIT.items()],
                  "children": [dict(leaf) for leaf in leaves]}
        routed = GraphEngine(graph_spec(bandit), components=servers, device="cuda")
        b_httpd, _ = start(make_engine_app(routed, device="cuda"))
        b_url = f"http://127.0.0.1:{b_httpd.server_address[1]}"
        mirror = EpsilonGreedy(**ENGINE_BANDIT)
        rewards = np.random.default_rng(3).uniform(0, 1, ENGINE_ROUTED[0]).round(3)
        try:
            fused_identity_chain.launches = 0
            n_requests, routes, want_routes = 0, [], []
            answers = []
            for i in range(ENGINE_ROUTED[0]):
                body = body_for(images[i % PREDICT_REQUESTS][i % PREDICT_BATCH:][:1],
                                f"bandit-{i}")
                code, resp = post(b_url + "/api/v0.1/predictions", body)
                if code != 200:
                    fail(f"engine (b) request {i} answered {code}: {resp}")
                answers.append((body, resp))
                routes.append(resp["meta"]["routing"]["router"])
                want_routes.append(mirror.route(None, []))
            for i, ((body, resp), reward) in enumerate(zip(answers, rewards)):
                code, out = post(b_url + "/api/v0.1/feedback",
                                 {"request": body, "response": resp, "reward": float(reward)})
                if code != 200:
                    fail(f"engine (b) feedback {i} answered {code}: {out}")
                mirror.send_feedback(None, [], float(reward), None, routing=routes[i])
            for i in range(ENGINE_ROUTED[1]):
                body = body_for(images[i % PREDICT_REQUESTS][:1], f"bandit-late-{i}")
                code, resp = post(b_url + "/api/v0.1/predictions", body)
                if code != 200:
                    fail(f"engine (b) late request {i} answered {code}: {resp}")
                routes.append(resp["meta"]["routing"]["router"])
                want_routes.append(mirror.route(None, []))
                if resp["meta"]["tags"].get("bandit") != "EpsilonGreedy":
                    fail(f"engine (b): response tags {resp['meta']['tags']} lack the router's")
            launches_b = k3_count()
            samples = scrape(b_url)
        finally:
            b_httpd.shutdown()
            b_httpd.server_close()
        n = sum(ENGINE_ROUTED)
        if routes != want_routes:
            fail(f"engine (b): routes {routes} differ from a fresh seeded router's "
                 f"{want_routes}")
        router = routed.state.root.component
        first = np.asarray(routes[:ENGINE_ROUTED[0]])
        want_pulls = [int((first == k).sum()) for k in range(2)]
        want_sums = [float(rewards[first == k].sum()) for k in range(2)]
        if router.pulls.tolist() != want_pulls or not np.allclose(router.reward_sum, want_sums,
                                                                   rtol=0, atol=1e-9):
            fail(f"engine (b): router pulls {router.pulls.tolist()} reward sums "
                 f"{router.reward_sum.tolist()}, the rewards give {want_pulls} {want_sums}")
        if launches_b != n * per1:
            fail(f"engine (b): {launches_b} K3 launches for {n} one-image requests, each "
                 f"through its routed leaf only: expected {n} x {per1}")
        checks = {"predictions": (sample(samples, "seldon_api_executor_server_requests_total",
                                         'method="predictions"', 'code="200"'), n),
                  "feedback": (sample(samples, "seldon_api_executor_server_requests_total",
                                      'method="feedback"', 'code="200"'), ENGINE_ROUTED[0]),
                  "feedback events": (sample(samples, "seldon_api_model_feedback_total"),
                                      ENGINE_ROUTED[0]),
                  "reward": (round(sample(samples, "seldon_api_model_feedback_reward_total"),
                                   6), round(float(np.abs(rewards).sum()), 6))}
        for what, (got, want) in checks.items():
            if got != want:
                fail(f"engine (b): /metrics {what} {got}, expected {want}")
        print(f"[engine] (b) EPSILON_GREEDY {ENGINE_BANDIT} over the same two leaves: "
              f"{ENGINE_ROUTED[0]} one-image predictions, feedback with seeded rewards for "
              f"each through /api/v0.1/feedback, {ENGINE_ROUTED[1]} more: routes {routes} = a "
              f"fresh seeded router's on the host with the same feedback; router pulls "
              f"{router.pulls.tolist()}, reward sums "
              f"{[round(v, 6) for v in router.reward_sum.tolist()]} = the rewards' arithmetic; "
              f"K3 launches {launches_b} = {n} x {per1} (the routed leaf alone); /metrics: "
              f"{checks['predictions'][0]:.0f} predictions, {checks['feedback'][0]:.0f} "
              f"feedback requests, seldon_api_model_feedback_total "
              f"{checks['feedback events'][0]:.0f}, _reward_total {checks['reward'][0]} "
              f"[{card}]", flush=True)

        # (d) control routes, the deadline, gRPC
        steps = [("/pause", 200), ("/api/v0.1/predictions", 503), ("/ready", 503),
                 ("/unpause", 200), ("/ready", 200)]
        seen = []
        for path, want in steps:
            if path.startswith("/api"):
                code = post(url + path, single_body)[0]
            else:
                req = urllib.request.Request(url + path, method="POST" if "pause" in path
                                             else "GET", data=b"" if "pause" in path else None)
                try:
                    with urllib.request.urlopen(req, timeout=60) as r:
                        code = r.status
                except urllib.error.HTTPError as e:
                    code = e.code
            seen.append(code)
            if code != want:
                fail(f"engine (d): {path} answered {code}, expected {want} ({seen})")
        code, body = post(url + "/api/v0.1/predictions", bodies[0],
                          headers={"Seldon-Deadline-Ms": "1"})
        if code != 504 or body.get("status", {}).get("reason") != "DEADLINE_EXCEEDED":
            fail(f"engine (d): Seldon-Deadline-Ms: 1 answered {code}: {body}")
        grpc_line = engine_grpc_check(fused, bodies[0], results[0][1])
        print(f"[engine] (d) /pause, predictions, /ready, /unpause, /ready answered {seen}; "
              f"Seldon-Deadline-Ms: 1 on the 2-leaf graph answered 504 DEADLINE_EXCEEDED "
              f"({body['status']['info']}); {grpc_line} [{card}]", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        comp_httpd.shutdown()
        comp_httpd.server_close()
    del fused, unfused, routed, servers, model_b, models
    # [controlplane] (b): a canary router over two ResNet-50 leaves
    launches_cp = controlplane_canary(card, model)
    print(f"[engine] phase_s {time.perf_counter() - t_phase:.1f} [{card}]", flush=True)
    return launches_a + launches_b + launches_cp, router


def body_for(images, puid: str) -> dict:
    return {"meta": {"puid": puid},
            "data": {"tensor": {"shape": list(images.shape), "values": images.ravel().tolist()}}}


def seldon_message(body: dict):
    from seldon_core_tpu_torch.contracts.payload import SeldonMessage

    return SeldonMessage.from_dict(body)


def engine_grpc_check(engine, body: dict, rest_answer: dict) -> str:
    """``Seldon/Predict`` on the gRPC engine server for ``body``: its
    answer must equal REST's (meta exactly, logits within ENGINE_FUSE_TOL
    of max|logit|: the same kernels on the same inputs). Only a missing
    grpcio or protobuf skips it, with words that say so."""
    import numpy as np

    try:
        import grpc

        from seldon_core_tpu_torch.transport import proto_convert as pc
        from seldon_core_tpu_torch.transport.grpc_server import make_engine_server
        from seldon_core_tpu_torch.transport.proto import prediction_pb2 as pb
    except ImportError as e:
        if (e.name or "").split(".")[0] not in ("grpc", "google"):
            raise
        return f"gRPC unverified: the '{e.name}' module is not installed here"
    # a request of 8 images is ~9.6 MB of proto: past gRPC's 4 MiB default
    srv = make_engine_server(engine, host="127.0.0.1", port=None,
                             annotations={"seldon.io/grpc-max-message-size": str(64 << 20)})
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            rpc = channel.unary_unary("/seldon.protos.Seldon/Predict",
                                      request_serializer=lambda m: m.SerializeToString(),
                                      response_deserializer=pb.SeldonMessage.FromString)
            got = pc.message_from_proto(rpc(pc.message_to_proto(seldon_message(body)),
                                            timeout=600)).to_dict()
    finally:
        srv.stop(None)
    g, w = logits_of(got), logits_of(rest_answer)
    err = float(np.abs(g - w).max())
    if got["meta"] != rest_answer["meta"] or g.shape != w.shape or \
            err > ENGINE_FUSE_TOL * float(np.abs(w).max()):
        fail(f"engine (d): gRPC Seldon/Predict differs from REST: meta {got['meta']} vs "
             f"{rest_answer['meta']}, logits max |diff| {err:.4g}")
    return f"gRPC Seldon/Predict of (a)'s first request = REST's answer (max |diff| {err:.3g})"


def engine_llm_phase(card: str, server) -> dict:
    """(c) The loaded bf16 Llama-2-7B server as the one component of a
    graph: one single-prompt jsonData predict through the engine app must
    give the greedy tokens of the same server's own component app, its
    kernels launched (K1 and K2: the engine path over the served LLM's
    kernels), and the engine's /metrics must carry the LLM series.
    Returns the launches of the engine request."""
    from seldon_core_tpu_torch.runtime.engine import GraphEngine
    from seldon_core_tpu_torch.transport.rest import make_engine_app, start

    label = "bf16 engine"
    svc, httpd, url, build_s = build_service(label, server)
    engine = GraphEngine(graph_spec({"name": "llm", "type": "MODEL"}),
                         components={"llm": server}, device="cuda")
    e_httpd, _ = start(make_engine_app(engine, device="cuda"))
    e_url = f"http://127.0.0.1:{e_httpd.server_address[1]}"
    body = {"meta": {"puid": "llm-0"}, "jsonData": {"prompt": prompt_text(3),
                                                     "max_new_tokens": MAX_NEW}}
    try:
        code, own = post(url + "/api/v0.1/predictions", body)
        if code != 200:
            fail(f"[{label}] the component app answered {code}: {own}")
        zero_counts(server)
        t0 = time.perf_counter()
        code, got = post(e_url + "/api/v0.1/predictions", body)
        wall = time.perf_counter() - t0
        counts = read_counts(server)
        samples = scrape(e_url)
    finally:
        e_httpd.shutdown()
        e_httpd.server_close()
        stop_service(label, server, svc, httpd)
    if code != 200:
        fail(f"[{label}] the engine app answered {code}: {got}")
    tokens, want = got["jsonData"]["tokens"][0], own["jsonData"]["tokens"][0]
    if tokens != want or len(tokens) != MAX_NEW:
        fail(f"[{label}] the engine's tokens {tokens} differ from the component app's {want}")
    if got["meta"].get("requestPath") != {"llm": "LLMServer"} or got["meta"]["puid"] != "llm-0":
        fail(f"[{label}] meta {got['meta']}")
    if counts["k1"] <= 0 or counts["k2"] <= 0:
        fail(f"[{label}] the engine request launched K1 {counts['k1']} and K2 {counts['k2']} "
             f"times")
    ttft = sample(samples, "seldon_llm_ttft_seconds_count")
    pages = sample(samples, "seldon_llm_kv_pages_total")
    if ttft != 1 or pages <= 0:
        fail(f"[{label}] the engine's /metrics: seldon_llm_ttft_seconds_count {ttft}, "
             f"seldon_llm_kv_pages_total {pages}")
    print(f"[{label}] (c) the bf16 Llama-2-7B server as a one-unit graph's component: one "
          f"single-prompt jsonData predict through the engine app in {wall * 1e3:.1f} ms, "
          f"{len(tokens)} greedy tokens = its own component app's answer; K1 {counts['k1']} "
          f"and K2 {counts['k2']} launches (batcher built in {build_s:.2f} s); the engine's "
          f"/metrics: seldon_llm_ttft_seconds_count {ttft:.0f}, seldon_llm_kv_pages_total "
          f"{pages:.0f} [{card}]", flush=True)
    return counts


# ---------------------------------------------------------------------------
# Batched LoRA, tenants and checkpoints
# ---------------------------------------------------------------------------
def lora_cfg():
    """The 7B model's config (the adapter pool's shapes come from it)."""
    from seldon_core_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**{k: v for k, v in LLAMA2_7B.items() if k != "dtype"})


def write_adapters(root: str, names, seed: int) -> dict:
    """Random rank-LORA_RANK adapters at 7B widths, one directory each
    (``adapter.json`` + ``weights.npz``, float32 factors from numpy's seeded
    generator: A ~ N(0, 1 / d_in), B ~ N(0, LORA_B_STD^2), alpha LORA_ALPHA,
    so a delta is about a fifth of its base projection). Returns name ->
    file:// URI."""
    import numpy as np

    from seldon_core_tpu_torch.runtime.adapters import projection_dims

    rng = np.random.default_rng(seed)
    L, r = LLAMA2_7B["n_layers"], LORA_RANK
    uris = {}
    for name in names:
        d = os.path.join(root, name)
        os.makedirs(d)
        arrays = {}
        for proj, (din, dout) in projection_dims(lora_cfg()).items():
            arrays[f"{proj}.A"] = rng.standard_normal((L, din, r), np.float32) / np.sqrt(din)
            arrays[f"{proj}.B"] = rng.standard_normal((L, r, dout), np.float32) * LORA_B_STD
        np.savez(os.path.join(d, "weights.npz"), **arrays)
        with open(os.path.join(d, "adapter.json"), "w") as f:
            json.dump({"rank": r, "alpha": LORA_ALPHA}, f)
        uris[name] = "file://" + d
    return uris


def post_many(url: str, reqs):
    """POST each (body, headers) of ``reqs`` to /v1/generate, all at once.
    Returns (the (status, body) results, the wall time)."""
    results = [None] * len(reqs)

    def client(i):
        results[i] = post(url + "/v1/generate", reqs[i][0], headers=reqs[i][1])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return results, time.perf_counter() - t0


def build_service(label: str, server, slots: int = N_REQUESTS, **batcher_kw):
    """A BatcherService of ``slots`` slots on ``server``, built (graphs
    warmed up and captured, a prefill worker's too) under
    ``set_sync_debug_mode("error")``, and the REST app on it. Returns
    (service, httpd, url, build seconds)."""
    import torch

    from seldon_core_tpu_torch.runtime.batcher import BatcherService
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        svc = BatcherService(server, max_slots=slots, **batcher_kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    server._batcher_service = svc
    httpd, _ = start(make_component_app(server, device="cuda"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    code, body = post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 4})
    if code != 200:
        fail(f"[{label}] warm-up request answered {code}: {body}")
    torch.cuda.synchronize()
    return svc, httpd, url, build_s


def stop_service(label: str, server, svc, httpd) -> None:
    httpd.shutdown()
    httpd.server_close()
    if svc.batcher.page_stats()["kv_pages_in_use"] != 0:
        fail(f"[{label}] pages still held after every request finished: "
             f"{svc.batcher.page_stats()}")
    svc.close()
    server._batcher_service = None


def lora_served_run(label: str, card: str, server, url: str, texts, assign, during=None):
    """The N_REQUESTS requests over REST, request i with adapter
    ``assign[i]`` (None = base) and tenant ``tenant-{i % 4}``, counts zeroed
    just before and read just after; ``during`` (optional) runs on its own
    thread meanwhile. Returns (served tokens, launch counts, decode
    dispatches as (replays, eager), step walls, TTFTs, peak GB, wall)."""
    import torch

    reqs = [({"prompt": t} if a is None else {"prompt": t, "adapter": a},
             {"Seldon-Tenant": f"tenant-{i % 4}"}) for i, (t, a) in enumerate(zip(texts, assign))]
    torch.cuda.reset_peak_memory_stats()
    zero_counts(server)
    server._decode_replays = server._decode_eager = 0
    side = threading.Thread(target=during) if during is not None else None
    if side is not None:
        side.start()
    results, wall = post_many(url, reqs)
    if side is not None:
        side.join(600)
    counts = read_counts(server)
    out = (served_tokens(label, results), counts,
           (server._decode_replays, server._decode_eager), sorted(server._decode_step_times),
           sorted(server._ttft_times), torch.cuda.max_memory_allocated() / 1e9, wall)
    return out


def lora_live_checks(label: str, card: str, server, b, texts, assign) -> dict:
    """On the adapted batcher's live state (its loop stopped): one chunk of
    the first prompt (through its adapter) replayed against the eager
    adapted chunk program from identical copies of the pools (logits and
    pools bit-equal); the prompts admitted with their adapters, then one
    replay of the decode graph against the eager adapted step from
    identical copies (tokens, pools, state bit-equal). Each graph's K1, K2
    and K4 kernel nodes by name must equal what one replay adds to the
    launch counters. Then the replay's device time (CUDA events) and the
    lora_delta chain's (``lora_chain``)."""
    from concurrent.futures import Future

    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.transformer import PAD_POS
    from seldon_core_tpu_torch.runtime.scheduler import PendingRequest

    reg = server.adapter_registry
    pool = reg.pool()

    def request(i):
        ids = server._tokenizer.encode(texts[i])
        return ids, PendingRequest(ids=ids, max_new=MAX_NEW, fut=Future(),
                                   adapter_id=reg.resolve_and_pin(assign[i]))

    out = {}
    # a chunk: stage request 0's job, then its first chunk replayed and eager
    ids, req = request(0)
    if not b._admit_begin(req):
        fail(f"[{label}] no free slot for the chunk check")
    job = b._prefill
    C, n = job.chunk, min(job.chunk, len(ids))
    toks = np.zeros((1, C), np.int64)
    pos = np.full((1, C), PAD_POS, np.int32)
    toks[0, :n] = ids[:n]
    pos[0, :n] = np.arange(n)
    b._chunk_tokens[:, :C] = torch.from_numpy(toks).cuda()
    b._chunk_pos[:, :C] = torch.from_numpy(pos).cuda()
    copy = [tuple(t.clone() for t in layer) for layer in b._caches]
    graph = b._prefill_graphs[C]
    got = graph.replay().clone()
    want = server._get_prefill_chunk(C, b.n_pages, True)(
        copy, b._row, b._chunk_tokens[:, :C], b._chunk_pos[:, :C], adapters=pool,
        adapter_ids=b._chunk_adapter)
    torch.cuda.synchronize()
    same = torch.equal(got, want) and all(torch.equal(x, y) for la, lb in zip(b._caches, copy)
                                          for x, y in zip(la, lb))
    del copy, want
    nodes = node_counts(graph_kernel_names(graph.graph))
    added = launches_of(graph.replay)
    print(f"[{label}] adapted chunk of {C} (adapter id {req.adapter_id}, chunk id buffer "
          f"{int(b._chunk_adapter[0])}) replay vs the eager adapted program from identical "
          f"copies of the pools: logits + pools {'bit-equal' if same else 'DIFFER'}; kernel nodes "
          f"(K2, K4 prefill, K4 decode, K1) {nodes}, a replay adds {added}; "
          f"{len(graph_node_list(graph.graph))} nodes in all [{card}]", flush=True)
    if not same:
        fail(f"[{label}] the adapted chunk replay and the eager program differ")
    if nodes != added or nodes[0] != LLAMA2_7B["n_layers"]:
        fail(f"[{label}] the adapted chunk graph's kernel nodes {nodes} != a replay's "
             f"launches {added}")
    while b._prefill is not None:
        b._prefill_step()
    for i in range(1, N_REQUESTS):
        _, req = request(i)
        if not b._admit_begin(req):
            fail(f"[{label}] no free slot for a re-admitted prompt")
        while b._prefill is not None:
            b._prefill_step()
    for i, slot in enumerate(b._slots):
        if not (slot.active and b._ensure_slot_pages(i, slot.dispatched_pos() + 128)):
            fail(f"[{label}] slot {i} is not live")
    ids_now = b._adapter_ids.tolist()
    want_ids = [reg.resolve(a) for a in assign]
    if sorted(ids_now) != sorted(want_ids):
        fail(f"[{label}] slot adapter ids {ids_now}, expected {sorted(want_ids)}")
    graph = b._graphs[1]
    copy = state_copy(b)
    got = graph.replay().clone()
    eager = server._get_decode_step_paged(b.S, b.n_pages, 1, True)(
        *copy, b._temp, b._block_tables, adapters=pool, adapter_ids=b._adapter_ids)
    torch.cuda.synchronize()
    same_tokens = torch.equal(got, eager)
    same = same_tokens and state_equal(b, copy)
    del copy, eager
    torch.cuda.empty_cache()
    nodes = node_counts(graph_kernel_names(graph.graph))
    added = launches_of(graph.replay)
    n_nodes = len(graph_node_list(graph.graph))
    print(f"[{label}] adapted decode replay vs the eager adapted step from identical copies, "
          f"{b.S} live slots with adapter ids {ids_now}: tokens "
          f"{'bit-equal' if same_tokens else 'DIFFER'}, tokens + pools + state "
          f"{'bit-equal' if same else 'DIFFER'}; kernel nodes (K2, K4 prefill, K4 decode, K1) "
          f"{nodes}, a replay adds {added}; {n_nodes} nodes in all [{card}]", flush=True)
    if not same:
        fail(f"[{label}] the adapted decode replay and the eager adapted step differ")
    if nodes != added:
        fail(f"[{label}] the adapted decode graph's kernel nodes {nodes} != a replay's "
             f"launches {added}")
    out["replay_dev_ms"] = events_ms(graph.replay)
    out["nodes"] = n_nodes
    out.update(lora_chain(label, card, server, b))
    for i in range(b.S):   # drop the re-admissions (and their adapter pins)
        b._release_slot(i)
    return out


def lora_chain(label: str, card: str, server, b) -> dict:
    """The decode step's LoRA work alone: the 5 x 32 ``lora_delta`` calls
    of one adapted decode step and their adds, at the step's shapes ([S, 1,
    d_in] activations, the live pool, the slots' ids), captured as one CUDA
    graph: its nodes, its device time (CUDA events around a replay) and,
    from torch.profiler over one replay, its kernels by name (count and
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seldon_core_tpu_torch.models.transformer import lora_delta
    from seldon_core_tpu_torch.runtime.adapters import projection_dims

    pool = server.adapter_registry.pool()
    dims = projection_dims(lora_cfg())
    g = torch.Generator(device="cuda").manual_seed(5)
    xs = {p: torch.randn((b.S, 1, din), generator=g, device="cuda").to(torch.bfloat16)
          for p, (din, _) in dims.items()}
    ys = {p: torch.randn((b.S, 1, dout), generator=g, device="cuda").to(torch.bfloat16)
          for p, (_, dout) in dims.items()}

    def chain():
        for layer in range(LLAMA2_7B["n_layers"]):
            for p in dims:
                A, B = pool[p]
                ys[p] + lora_delta(xs[p], A[:, layer], B[:, layer], b._adapter_ids,
                                   pool["scale"])

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chain()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        chain()
    nodes = len(graph_node_list(graph))
    ms = events_ms(graph.replay)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        if rows:
            break
    traced = sum(dev_us(e) for e in rows) / 1e3
    kernels = sum(e.count for e in rows)
    top = sorted(rows, key=dev_us, reverse=True)[:6]
    print(f"[{label}] the decode step's LoRA work alone ({len(dims)} x "
          f"{LLAMA2_7B['n_layers']} lora_delta calls and adds at {b.S} slots, live pool and "
          f"ids) as one CUDA graph: {nodes} nodes, device time {ms:.3f} ms (CUDA events); "
          f"torch.profiler over one replay: {kernels} kernels, {traced:.3f} ms; by name: "
          + "; ".join(f"{e.key[:60]} x{e.count} {dev_us(e) / 1e3:.3f} ms" for e in top)
          + f" [{card}]", flush=True)
    return {"chain_nodes": nodes, "chain_ms": ms, "chain_traced_ms": traced,
            "chain_kernels": kernels}


def lora_phase(label: str, card: str, knobs: dict, root: str) -> tuple:
    """Batched LoRA on a 7B server (random base weights, full depth) with
    three random rank-LORA_RANK adapters preloaded from file:// URIs
    (``lora_adapters``) and a pool of LORA_MAX rows: N_REQUESTS requests over
    REST, two a adapter and two base, each with a Seldon-Tenant. Checks:
    every chunk and dispatch a graph replay; launches as the plain path's;
    every token teacher-forced through its adapter; each request equal to
    itself served alone up to a near-tie; the base requests equal to the
    plain (unadapted) graph batcher's on the same weights; the adapted
    programs' replays bit-equal to the eager adapted programs on live state,
    their kernel nodes equal to their launches; a fourth adapter loaded
    while requests decode leaves their tokens as a run without the load
    (and then serves), an evict while pinned returns False; the scrape's
    adapter series equal ``llm_stats``. Returns (server, (label, launches)
    records, metrics)."""
    import torch

    from seldon_core_tpu_torch.runtime.adapters import projection_dims

    uris = write_adapters(root, LORA_NAMES, seed=7 + len(label))
    server, weight_bytes = load_llm(label, card, dict(
        knobs, lora_rank=LORA_RANK, lora_max_adapters=LORA_MAX, lora_adapters=uris))
    reg = server.adapter_registry
    quantized, int8_kv = server.quantize == "int8", server.kv_cache_dtype == "int8"
    stats = reg.stats()
    L, r = LLAMA2_7B["n_layers"], LORA_RANK
    per_row = sum(din * r + r * dout for din, dout in projection_dims(lora_cfg()).values())
    want_bytes = LORA_MAX * L * per_row * 2 + LORA_MAX * 4
    if stats["adapter_loaded"] != 3 or stats["adapter_pool_bytes"] != want_bytes:
        fail(f"[{label}] adapter pool {stats}, expected 3 loaded and {want_bytes} bytes")
    texts = prompts(N_REQUESTS)
    assign = [LORA_NAMES[i // 2] if i < 6 else None for i in range(N_REQUESTS)]
    ids = [reg.resolve(a) for a in assign]
    records, metrics = [], {"pool_bytes": stats["adapter_pool_bytes"]}
    # the plain graph batcher on the same weights (the registry set aside)
    server.adapter_registry = None
    svc, httpd, url, _ = build_service(label, server)
    try:
        plain, counts, _, steps, _, _, _ = lora_served_run(f"{label} plain", card, server, url,
                                                           texts, [None] * N_REQUESTS)
        metrics["plain_step_ms"] = statistics.median(steps) * 1e3
        metrics["plain_nodes"] = len(graph_node_list(svc.batcher._graphs[1].graph))
    finally:
        stop_service(f"{label} plain", server, svc, httpd)
        server.adapter_registry = reg
    records.append((f"{label} plain", counts))
    check_launches(f"{label} plain", card, counts, [128] * N_REQUESTS, quantized, int8_kv, False)
    del svc
    torch.cuda.empty_cache()
    svc, httpd, url, build_s = build_service(label, server)
    b = svc.batcher
    if not ("pagedstep", N_REQUESTS, b.n_pages, 1, True) in server._decode_cache:
        fail(f"[{label}] the batcher did not capture the adapted decode program")
    metrics["prefill_pool_gb"] = graph_pool_gb(b._prefill_graphs.values())
    try:
        served, counts, disp, steps, ttft, peak, wall = lora_served_run(label, card, server,
                                                                         url, texts, assign)
        records.append((label, counts))
        check_launches(label, card, counts, [128] * N_REQUESTS, quantized, int8_kv, False)
        if disp[1] != 0 or disp[0] == 0:
            fail(f"[{label}] decode dispatches as (replays, eager) {disp}")
        metrics.update(step_ms=statistics.median(steps) * 1e3, ttft_med_ms=statistics.median(
            ttft) * 1e3, ttft_max_ms=ttft[-1] * 1e3, peak_gb=peak, wall_s=wall, build_s=build_s)
        teacher_check(label, card, server, texts, served, ids)
        base_equal = near_tie_check(f"{label} base vs plain", card, server, texts[6:],
                                    served[6:], plain[6:])
        adapted_differ = sum(s != p for s, p in zip(served[:6], plain[:6]))
        if adapted_differ < 4:
            fail(f"[{label}] only {adapted_differ} of 6 adapted requests differ from the base "
                 f"model's tokens: the adapters do not act")
        # each request alone through the same batcher
        zero_counts(server)
        solo = [svc.submit_sync(t, adapter=a, tenant="solo") for t, a in zip(texts, assign)]
        records.append((f"{label} solo", read_counts(server)))
        solo_equal = near_tie_check(f"{label} vs solo", card, server, texts, served, solo, ids)
        # a fourth adapter loaded while the requests decode; an evict of a
        # pinned adapter refused meanwhile
        fourth = write_adapters(root, ["fourth"], seed=99 + len(label))["fourth"]
        seen = {}

        def load_midrun():
            for _ in range(6000):
                if sum(s.active for s in b._slots) == N_REQUESTS:
                    break
                time.sleep(0.0005)
            seen["active"] = sum(s.active for s in b._slots)
            seen["refs"] = reg.refs_of(LORA_NAMES[0])
            seen["evict"] = reg.evict(LORA_NAMES[0])
            t0 = time.perf_counter()
            seen["row"] = reg.load_uri("fourth", fourth)
            seen["load_s"] = time.perf_counter() - t0
            seen["still"] = sum(s.active for s in b._slots)

        # the load's copies queue behind the decode replays in flight, so it
        # can outlast the requests' last steps: a run whose load ended after
        # every request is taken again (up to LORA_MIDRUN_TRIES runs, each
        # one's tokens checked), the adapter evicted first; one run must
        # overlap
        for attempt in range(1, LORA_MIDRUN_TRIES + 1):
            if attempt > 1:
                reg.evict("fourth")
            again, counts, _, _, _, _, _ = lora_served_run(
                f"{label} mid-run load", card, server, url, texts, assign, during=load_midrun)
            records.append((f"{label} mid-run load {attempt}", counts))
            print(f"[{label}] mid-run load (run {attempt}): {seen['active']} slots active when "
                  f"adapter 'fourth' loaded into row {seen['row']} in {seen['load_s'] * 1e3:.1f} "
                  f"ms ({seen['still']} still active after); evict({LORA_NAMES[0]!r}) while "
                  f"pinned by {seen['refs']} returned {seen['evict']} [{card}]", flush=True)
            if seen["evict"] is not False or seen["refs"] == 0:
                fail(f"[{label}] an evict while pinned was not refused: {seen}")
            midrun_equal = near_tie_check(f"{label} mid-run load vs without", card, server,
                                          texts, again, served, ids)
            if seen["still"] > 0:
                break
        else:
            fail(f"[{label}] in {LORA_MIDRUN_TRIES} runs the mid-run load never overlapped "
                 f"pinned, decoding requests: {seen}")
        code, body = post(url + "/v1/generate", {"prompt": texts[0], "adapter": "fourth"},
                          headers={"Seldon-Tenant": "late"})
        if code != 200:
            fail(f"[{label}] a request of the mid-run adapter answered {code}: {body}")
        teacher_check(f"{label} fourth", card, server, texts[:1], [body["tokens"]],
                      [seen["row"]])
        if reg.evict("fourth") is not True:
            fail(f"[{label}] evict of the unpinned adapter 'fourth' refused")
        scraped = scrape(url)
        st = server.llm_stats()
        got = {k: sample(scraped, "seldon_llm_" + k)
               for k in ("adapter_loaded", "adapter_pool_bytes", "adapter_evictions_total")}
        want = {k: float(st[k]) for k in got}
        print(f"[{label}] scrape: {got}; llm_stats: {want} [{card}]", flush=True)
        if got != want or want["adapter_evictions_total"] != 1 or want["adapter_loaded"] != 3:
            fail(f"[{label}] the scrape's adapter series {got} != llm_stats {want}")
        metrics.update(solo_equal=solo_equal, midrun_equal=midrun_equal,
                       base_equal=base_equal, load_ms=seen["load_s"] * 1e3)
    finally:
        httpd.shutdown()
        httpd.server_close()
    svc.close()
    metrics.update(lora_live_checks(label, card, server, b, texts, assign))
    server._batcher_service = None
    del svc, b
    torch.cuda.empty_cache()
    print(f"[{label}] LoRA serving: {N_REQUESTS} requests (2 x 3 adapters + 2 base, rank "
          f"{LORA_RANK}, pool of {LORA_MAX} rows {metrics['pool_bytes'] / 1e6:.1f} MB) x "
          f"{MAX_NEW} tokens in {metrics['wall_s']:.3f} s; adapted decode step median "
          f"{metrics['step_ms']:.2f} ms vs the plain graph batcher's {metrics['plain_step_ms']:.2f}"
          f" ms on the same weights ({metrics['step_ms'] / metrics['plain_step_ms']:.3f}x); "
          f"decode graph nodes {metrics['nodes']} vs {metrics['plain_nodes']}; TTFT median "
          f"{metrics['ttft_med_ms']:.1f} ms max {metrics['ttft_max_ms']:.1f}; peak device "
          f"memory {metrics['peak_gb']:.2f} GB; batcher built in {metrics['build_s']:.2f} s; "
          f"equal to solo {solo_equal} of {N_REQUESTS}, to the run without the mid-run load "
          f"{midrun_equal} of {N_REQUESTS}, base to plain {base_equal} of 2 [{card}]",
          flush=True)
    return server, records, metrics


def tenant_phase(label: str, card: str, server) -> tuple:
    """Weighted-fair admission on the bf16 LoRA server (class weights,
    tenant weights, a quota for the flooding tenant): TENANT_FLOOD batch-class
    requests of TENANT_PROMPT tokens (several prefill chunks each) from
    one tenant, queued while admission is held, then one more from it over
    its quota (503 + Retry-After), then admission released and, while a
    batch job is staged, TENANT_INTERACTIVE interactive requests from
    another tenant. Checks: at least one staged batch job preempted and no
    active slot (the batch tokens equal a run without interactive traffic
    up to a near-tie; every request teacher-forced); the scrape's
    seldon_tenant_*_total and TTFT-by-class counts equal the run's. Returns
    ((label, launches) records, metrics)."""
    import torch

    server.slo_class_weights = {"interactive": 4.0, "batch": 1.0}
    server.tenant_weights = {"bulk-evals": 1.0, "chat-app": 2.0}
    server.tenant_quotas = {"bulk-evals": TENANT_FLOOD}
    flood = [prompt_text(200 + i, TENANT_PROMPT) for i in range(TENANT_FLOOD)]
    chat = [prompt_text(300 + i) for i in range(TENANT_INTERACTIVE)]
    batch_hdr = {"Seldon-Tenant": "bulk-evals", "Seldon-SLO-Class": "batch"}
    chat_hdr = {"Seldon-Tenant": "chat-app", "Seldon-SLO-Class": "interactive"}
    records = []
    # the reference: the flood alone
    svc, httpd, url, _ = build_service(label, server)
    try:
        zero_counts(server)
        ref, _ = post_many(url, [({"prompt": t}, batch_hdr) for t in flood])
        records.append((f"{label} reference", read_counts(server)))
    finally:
        stop_service(label, server, svc, httpd)
    ref = served_tokens(f"{label} reference", ref)
    svc, httpd, url, _ = build_service(label, server)
    b = svc.batcher
    gate = threading.Event()
    admit = b._admit_pending
    b._admit_pending = lambda: (gate.wait(), admit())
    results = {}
    try:
        zero_counts(server)
        scrape(url)    # drains the warm-up's series
        threads = []
        for i, t in enumerate(flood):
            th = threading.Thread(target=lambda i=i, t=t: results.__setitem__(
                i, post(url + "/v1/generate", {"prompt": t}, headers=batch_hdr)))
            th.start()
            threads.append(th)
        for _ in range(20000):
            if b._pending.depths()["batch"] == TENANT_FLOOD:
                break
            time.sleep(0.0005)
        code, hdrs, body = post_headers(url + "/v1/generate", {"prompt": flood[0]},
                                        headers=batch_hdr)
        if code != 503 or int(hdrs.get("Retry-After", 0)) < 1:
            fail(f"[{label}] the over-quota request answered {code} (Retry-After "
                 f"{hdrs.get('Retry-After')}): {body}")
        print(f"[{label}] {TENANT_FLOOD} batch requests queued; one more from the same tenant "
              f"answered 503, Retry-After {hdrs['Retry-After']} s: {body['status']['info']} "
              f"[{card}]", flush=True)
        gate.set()
        for _ in range(20000):
            job = b._prefill
            if job is not None and job.req.slo_class == "batch" and job.next > 0:
                break
            time.sleep(0.0002)
        active_before = sum(s.active for s in b._slots)
        chat_res, _ = post_many(url, [({"prompt": t}, chat_hdr) for t in chat])
        for th in threads:
            th.join(600)
        counts = read_counts(server)
        records.append((label, counts))
        rows = {(r["tenant"], r["slo_class"]): r for r in b._pending.counters()}
        ttft = {c: sorted(v for k, v in server._ttft_by_class if k == c)
                for c in ("interactive", "batch")}
        scraped = scrape(url)
    finally:
        gate.set()
        httpd.shutdown()
        httpd.server_close()
    flood_served = served_tokens(f"{label} batch", [results[i] for i in range(TENANT_FLOOD)])
    chat_served = served_tokens(f"{label} interactive", chat_res)
    bulk, chat_row = rows[("bulk-evals", "batch")], rows[("chat-app", "interactive")]
    print(f"[{label}] tallies: bulk-evals/batch {bulk}, chat-app/interactive {chat_row}; "
          f"{active_before} slots active when the interactive requests came [{card}]",
          flush=True)
    if bulk["preempted"] < 1:
        fail(f"[{label}] no staged batch job was preempted: {bulk}")
    if bulk["admitted"] != TENANT_FLOOD or bulk["shed"] != 1 or chat_row["admitted"] != 4:
        fail(f"[{label}] tallies {rows}")
    teacher_check(f"{label} batch", card, server, flood, flood_served)
    teacher_check(f"{label} interactive", card, server, chat, chat_served)
    equal = near_tie_check(f"{label} batch vs without preemption", card, server, flood,
                           flood_served, ref)
    want = {("admitted", "bulk-evals"): TENANT_FLOOD, ("shed", "bulk-evals"): 1,
            ("tokens", "bulk-evals"): TENANT_FLOOD * MAX_NEW,
            ("admitted", "chat-app"): TENANT_INTERACTIVE,
            ("tokens", "chat-app"): TENANT_INTERACTIVE * MAX_NEW}
    got = {(k, t): sample(scraped, f"seldon_tenant_{k}_total", f'tenant="{t}"') for k, t in want}
    ttft_counts = {c: sample(scraped, "seldon_llm_tenant_ttft_seconds_count",
                             f'slo_class="{c}"') for c in ("interactive", "batch")}
    print(f"[{label}] scrape: {got}; TTFT counts by class {ttft_counts} [{card}]", flush=True)
    if got != {k: float(v) for k, v in want.items()} or ttft_counts != {
            "interactive": float(TENANT_INTERACTIVE), "batch": float(TENANT_FLOOD)}:
        fail(f"[{label}] the scrape's tenant series {got}, TTFT counts {ttft_counts}, expected "
             f"{want}")
    if sum(s.active for s in b._slots) or any(len(v) == 0 for v in ttft.values()):
        fail(f"[{label}] slots still active after the run, or no TTFT: {ttft}")
    stop_service(label, server, svc, httpd)
    metrics = {"ttft_interactive_ms": statistics.median(ttft["interactive"]) * 1e3,
               "ttft_batch_ms": statistics.median(ttft["batch"]) * 1e3,
               "ttft_interactive_max_ms": ttft["interactive"][-1] * 1e3,
               "ttft_batch_max_ms": ttft["batch"][-1] * 1e3, "preempted": bulk["preempted"],
               "equal": equal}
    print(f"[{label}] TTFT median / max: interactive {metrics['ttft_interactive_ms']:.1f} / "
          f"{metrics['ttft_interactive_max_ms']:.1f} ms, batch {metrics['ttft_batch_ms']:.1f} / "
          f"{metrics['ttft_batch_max_ms']:.1f} ms ({TENANT_FLOOD} batch requests of "
          f"{TENANT_PROMPT} tokens, {TENANT_INTERACTIVE} interactive of 124); "
          f"{bulk['preempted']} staged batch jobs preempted, batch tokens equal to the run "
          f"without interactive traffic {equal} of {TENANT_FLOOD} [{card}]", flush=True)
    del svc, b
    return records, metrics


def checkpoint_phase(card: str, root: str) -> tuple:
    """LLM checkpoints: a 7B-width model cut to CKPT_LAYERS layers and a
    TinyLlama-1.1B-width draft cut to CKPT_LAYERS layers, random bf16
    leaves, written with the port's ``export_checkpoint`` (the JAX
    package's msgpack format), then served three ways: ``model_uri`` over
    REST (tokens equal to ``load(params=...)`` on the same arrays,
    teacher-forced), ``quantize="int8"`` from the same directory (its
    load peak under INT8_LOAD_PEAK_GB; tokens equal to the int8 ``load(
    params=...)``), and ``spec_mode="draft"`` with ``draft_model_uri`` (the
    draft equal to the one passed as ``draft_params``, bit for bit, and the
    served tokens equal). Returns ((label, launches) records, metrics)."""
    import gc

    import torch

    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.servers.llmserver import LLMServer
    from seldon_core_tpu_torch.servers.torchserver import export_checkpoint

    kw = dict(LLAMA2_7B, n_layers=CKPT_LAYERS, fused_norm=True)
    dkw = dict(TINYLLAMA_1B, n_layers=CKPT_LAYERS)
    dirs, trees, metrics = {}, {}, {}
    for name, kwargs, seed in (("target", kw, 21), ("draft", dkw, 22)):
        m = get_model("transformer", device="cuda", param_dtype="auto", **kwargs)
        m.init_params(torch.Generator(device="cuda").manual_seed(seed))
        t0 = time.perf_counter()
        dirs[name] = export_checkpoint(os.path.join(root, name), "transformer",
                                       {"params": m.param_tree()}, kwargs=kwargs)
        nbytes = os.path.getsize(os.path.join(dirs[name], "params.msgpack"))
        print(f"[ckpt] wrote the {name} ({kwargs['dim']} wide, {CKPT_LAYERS} layers, cut from "
              f"{LLAMA2_7B['n_layers'] if name == 'target' else TINYLLAMA_1B['n_layers']}; bf16 "
              f"leaves) with export_checkpoint: {nbytes / 1e9:.3f} GB in "
              f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
        trees[name] = {"params": m.param_tree()}
        metrics[f"{name}_bytes"] = nbytes
    common = dict(init_random=False, continuous_batching=N_REQUESTS, max_new_tokens=MAX_NEW,
                  temperature=0.0, eos_id=-1, seed=0, device="cuda", param_dtype="auto")
    texts = prompts(N_REQUESTS)
    records = []

    def served_by(label, server):
        svc, httpd, url, _ = build_service(label, server)
        try:
            zero_counts(server)
            res, _ = post_all(url, texts)
            records.append((label, read_counts(server)))
        finally:
            stop_service(label, server, svc, httpd)
        return served_tokens(label, res)

    def loaded(label, **extra):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        s = LLMServer(**dict(common, **extra))
        s.load()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9 - before
        print(f"[{label}] load_s {dt:.2f}; peak device memory of the load {peak:.3f} GB "
              f"[{card}]", flush=True)
        return s, dt, peak

    # 1. model_uri against load(params=...) on the same arrays
    s, dt, _ = loaded("bf16 ckpt", model_uri="file://" + dirs["target"])
    metrics["load_s"] = dt
    by_uri = served_by("bf16 ckpt", s)
    teacher_check("bf16 ckpt", card, s, texts, by_uri)
    del s
    release_server_memory()
    s = LLMServer(model="transformer", model_kwargs=kw, **common)
    s.load(params=trees["target"])
    by_params = served_by("bf16 ckpt params", s)
    del s
    release_server_memory()
    if by_uri != by_params:
        fail("[bf16 ckpt] tokens served from model_uri differ from load(params=...)")
    # 2. int8 from the same directory
    s, dt, peak = loaded("int8 ckpt", model_uri=dirs["target"], quantize="int8")
    metrics.update(int8_load_s=dt, int8_peak_gb=peak)
    if peak > INT8_LOAD_PEAK_GB:
        fail(f"[int8 ckpt] load peak {peak:.3f} GB > {INT8_LOAD_PEAK_GB} GB")
    int8_uri = served_by("int8 ckpt", s)
    teacher_check("int8 ckpt", card, s, texts, int8_uri)
    del s
    release_server_memory()
    s = LLMServer(model="transformer", model_kwargs=kw, quantize="int8", **common)
    s.load(params=trees["target"])
    int8_params = served_by("int8 ckpt params", s)
    del s
    release_server_memory()
    if int8_uri != int8_params:
        fail("[int8 ckpt] int8 tokens from model_uri differ from the int8 load(params=...)")
    # 3. the draft from its URI
    spec = dict(spec_mode="draft", spec_k=SPEC_K, continuous_batching_max_len=SPEC_MAX_LEN)
    s, dt, _ = loaded("bf16 ckpt draft", model_uri=dirs["target"],
                      draft_model_uri="file://" + dirs["draft"], **spec)
    metrics["draft_load_s"] = dt
    t = LLMServer(model="transformer", model_kwargs=kw, draft_model="transformer",
                  draft_model_kwargs=dkw, **dict(common, **spec))
    t.load(params=trees["target"], draft_params=trees["draft"])
    same = all(torch.equal(a, b_) for a, b_ in zip(s._draft_module.state_dict().values(),
                                                  t._draft_module.state_dict().values()))
    if not same or s._draft_cfg.n_layers != CKPT_LAYERS:
        fail("[bf16 ckpt draft] the draft from draft_model_uri differs from draft_params")
    del t
    release_server_memory()
    spec_tokens = served_by("bf16 ckpt draft", s)
    near = near_tie_check("bf16 ckpt draft vs plain", card, s, texts, spec_tokens, by_uri)
    del s, trees
    gc.collect()
    release_server_memory()
    metrics["draft_equal"] = near
    print(f"[ckpt] served from checkpoints ({CKPT_LAYERS} of 32 layers at Llama-2-7B widths): "
          f"bf16 load {metrics['load_s']:.2f} s of {metrics['target_bytes'] / 1e9:.3f} GB, "
          f"tokens == load(params=...); int8 load {metrics['int8_load_s']:.2f} s, peak "
          f"{metrics['int8_peak_gb']:.3f} GB, tokens == int8 load(params=...); draft from its "
          f"URI ({metrics['draft_bytes'] / 1e9:.3f} GB) == draft_params bit for bit, spec "
          f"tokens equal to the plain batcher's {near} of {N_REQUESTS} [{card}]", flush=True)
    return records, metrics


def print_lora_runs(card: str, runs: dict) -> None:
    print(f"LoRA, tenant and checkpoint runs (Llama-2-7B widths) [{card}]:", flush=True)
    for label in ("bf16 lora", "int8 lora"):
        m = runs[label]
        print(f"  {label:10s} adapted step {m['step_ms']:.2f} ms vs plain {m['plain_step_ms']:.2f} "
              f"ms; decode graph {m['nodes']} vs {m['plain_nodes']} nodes, replay "
              f"{m['replay_dev_ms']:.3f} ms; the LoRA work alone {m['chain_ms']:.3f} ms "
              f"({m['chain_nodes']} nodes, {m['chain_traced_ms']:.3f} ms traced); pool "
              f"{m['pool_bytes'] / 1e6:.1f} MB; TTFT "
              f"{m['ttft_med_ms']:.1f} / {m['ttft_max_ms']:.1f} ms; peak {m['peak_gb']:.2f} GB "
              f"[{card}]", flush=True)
    for label, counts in runs["launches"]:
        print(f"  launches {label}: K1 {counts['k1']} (int8 pool {counts['k1_int8']}), K2 "
              f"{counts['k2']}, K4 {counts['k4']} (prefill route {counts['k4_wgmma']}); chunks "
              f"replayed {counts['replays']}, eager {counts['eager']} [{card}]", flush=True)
    t, c = runs["bf16 tenant"], runs["ckpt"]
    print(f"  bf16 tenant TTFT median interactive {t['ttft_interactive_ms']:.1f} ms, batch "
          f"{t['ttft_batch_ms']:.1f} ms; {t['preempted']} preempted [{card}]", flush=True)
    print(f"  checkpoint  load {c['load_s']:.2f} s ({c['target_bytes'] / 1e9:.3f} GB read), int8 "
          f"{c['int8_load_s']:.2f} s (peak {c['int8_peak_gb']:.3f} GB), with the draft "
          f"{c['draft_load_s']:.2f} s [{card}]", flush=True)


def lora_runs_phase(card: str) -> tuple:
    """The LoRA phase on bf16 (then the tenant phase on the same server)
    and on int8 weights + int8 KV, then the checkpoint phase, each server
    freed before the next. Returns ((label, launches) records, metrics by
    run)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_lora_")
    records, runs = [], {}
    try:
        for model, knobs in (("bf16", {}), ("int8", dict(quantize="int8",
                                                         kv_cache_dtype="int8"))):
            label = f"{model} lora"
            server, recs, runs[label] = lora_phase(label, card, knobs, os.path.join(root, model))
            records += recs
            if model == "bf16":
                recs, runs["bf16 tenant"] = tenant_phase("bf16 tenant", card, server)
                records += recs
            del server
            release_server_memory()
        recs, runs["ckpt"] = checkpoint_phase(card, os.path.join(root, "ckpt"))
        records += recs
    finally:
        shutil.rmtree(root, ignore_errors=True)
    runs["launches"] = records
    return records, runs


# ---------------------------------------------------------------------------
# Remote graph nodes, micro-batching, the replica fleet, persistence, servers
# ---------------------------------------------------------------------------
REMOTE_TURNS = 2          # rounds of L R R L single requests in (a)'s latency turns
# a remote hop carries 8 images of JSON both ways while other requests parse
# theirs: the hop's read timeouts are raised past the 5 s default
REMOTE_ANNOTATIONS = {"seldon.io/rest-read-timeout": "120000",
                      "seldon.io/grpc-read-timeout": "120000",
                      "seldon.io/grpc-max-message-size": str(64 << 20)}
MICRO_CLIENTS = 8         # one-image requests at once through the micro-batcher
# a replica of the fleet: int8 weights (bf16 weights never reach K4) over a
# bf16 KV pool of FLEET_POOL_PAGES pages of 64 positions (10.7 GB), the
# prefix cache on
FLEET_POOL_PAGES = 320
FLEET_KNOBS = dict(quantize="int8", prefix_cache_size=PREFIX_CACHE_SIZE,
                   kv_pool_pages=FLEET_POOL_PAGES)
FLEET_SYSTEMS = 2         # system prompts A and B
PERSIST_ROUTES = 24
SERVER_LIBRARIES = ("joblib", "sklearn", "xgboost", "mlflow", "pandas")


class _Listener:
    """A listening socket on 127.0.0.1. ``accept_close``: a thread accepts
    each connection, counts it and closes it at once; else nothing accepts
    (a connect completes in the backlog and is never answered)."""

    def __init__(self, accept_close: bool):
        import socket

        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.accepted = 0
        if accept_close:
            threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.accepted += 1
            conn.close()

    def pending(self) -> int:
        """Connections waiting in the backlog (never accepted)."""
        n = 0
        self.sock.setblocking(False)
        try:
            while True:
                conn, _ = self.sock.accept()
                conn.close()
                n += 1
        except BlockingIOError:
            return n

    def close(self):
        self.sock.close()


def endpoint_unit(port: int, api: str) -> dict:
    return {"name": "leaf", "type": "MODEL",
            "endpoint": {"service_host": "127.0.0.1", "service_port": port, "type": api}}


def remote_phase(card: str, model) -> int:
    """Remote graph nodes and micro-batching over the forward phase's live
    ResNet-50 weights (``model``), written as a msgpack checkpoint and served
    by one ``TorchServer`` in this process:

    (a) the leaf as a remote node: the port's component app (REST) and gRPC
        component server on 127.0.0.1 over that server, and an engine app for
        each of three engines with the same one-unit graph: the leaf local
        (JAX_SERVER), over the REST endpoint, over the GRPC endpoint.
        PREDICT_REQUESTS concurrent requests of PREDICT_BATCH images to each:
        the remote answers' logits equal the local engine's exactly (float32
        values cross JSON and proto unchanged), their meta the local's but
        for the unit's image in requestPath (RemoteComponent), and K3, zeroed
        before and read after each engine's requests, launched
        ``expected_launches`` a forward. Then the REST remote engine beside
        the local one, one request at a time in turns (L R R L x
        REMOTE_TURNS). Failures: a closed port answers 503
        REMOTE_NODE_UNAVAILABLE after the backoffs, a listener that closes
        each connection sees exactly ``retries`` of them, and
        ``Seldon-Deadline-Ms: 1`` answers 504 with no connection made to a
        listener that never answers.
    (b) ``make_engine_app(MicroBatcher(engine, max_batch=MICRO_CLIENTS))``
        over the local engine: MICRO_CLIENTS threads each send one one-image
        request at once; one flush of MICRO_CLIENTS rows (``batches`` 1,
        ``batched_requests`` MICRO_CLIENTS), K3 launched one forward at B =
        MICRO_CLIENTS's worth, each answer within FWD_TOL of the same image's
        solo answer (the same requests through the plain engine app, at
        once), top-1 equal but for near-ties.

    Returns K3's launches in (a) and (b)."""
    import tempfile

    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.resnet_infer import resnet_serve_forward
    from seldon_core_tpu_torch.ops.fused_resnet import fused_identity_chain
    from seldon_core_tpu_torch.runtime.engine import GraphEngine
    from seldon_core_tpu_torch.runtime.microbatch import MicroBatcher
    from seldon_core_tpu_torch.servers.torchserver import TorchServer, export_checkpoint
    from seldon_core_tpu_torch.transport.grpc_server import make_component_server
    from seldon_core_tpu_torch.transport.rest import make_component_app, make_engine_app, start

    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per8 = k3_forward_launches(PREDICT_BATCH, sms)
    per_micro = k3_forward_launches(MICRO_CLIENTS, sms)
    with tempfile.TemporaryDirectory(prefix="remote-ckpt-") as root:
        path = os.path.join(root, "resnet50")
        export_checkpoint(path, "resnet50", {"params": model.param_tree()},
                          kwargs={"fused": True}, input_shape=[224, 224, 3])
        server = TorchServer(model_uri=path, device="cuda")
        server.load()
    # the local leaf: the same TorchServer, registered under the unit's name
    leaf = {"name": "leaf", "type": "MODEL", "implementation": "JAX_SERVER", "modelUri": path}
    rng = np.random.default_rng(23)
    images = [np.round(rng.standard_normal((PREDICT_BATCH, 224, 224, 3)), 2).astype(np.float32)
              for _ in range(PREDICT_REQUESTS)]
    bodies = [body_for(im, f"remote-{i}") for i, im in enumerate(images)]
    one = body_for(images[0][:1], "remote-one")
    servers, stops = [], []
    try:
        comp_httpd, _ = start(make_component_app(server, device="cuda"))
        stops.append(comp_httpd)
        grpc_srv = make_component_server(server, host="127.0.0.1", port=None,
                                         annotations=REMOTE_ANNOTATIONS)
        gport = grpc_srv.add_insecure_port("127.0.0.1:0")
        grpc_srv.start()
        servers.append(grpc_srv)
        engines = {"local": GraphEngine(graph_spec(leaf), components={"leaf": server},
                                        device="cuda"),
                   "REST": GraphEngine(graph_spec(endpoint_unit(comp_httpd.server_address[1],
                                                                "REST")),
                                       annotations=REMOTE_ANNOTATIONS, device="cuda"),
                   "GRPC": GraphEngine(graph_spec(endpoint_unit(gport, "GRPC")),
                                       annotations=REMOTE_ANNOTATIONS, device="cuda")}
        urls = {}
        for name, engine in engines.items():
            httpd, _ = start(make_engine_app(engine, device="cuda"))
            stops.append(httpd)
            urls[name] = f"http://127.0.0.1:{httpd.server_address[1]}/api/v0.1/predictions"
        for name, u in urls.items():  # warm-up, not counted
            code, body = post(u, one)
            if code != 200:
                fail(f"remote (a): warm-up through the {name} engine answered {code}: {body}")
        answers, walls, launches = {}, {}, {}
        for name, u in urls.items():
            torch.cuda.synchronize()
            fused_identity_chain.launches = 0
            results = concurrent_posts(u, bodies)
            launches[name] = k3_count()
            for i, (code, body, _) in enumerate(results):
                if code != 200 or body.get("meta", {}).get("puid") != f"remote-{i}":
                    fail(f"remote (a): request {i} through the {name} engine answered {code}: "
                         f"{str(body)[:300]}")
            answers[name] = [body for _, body, _ in results]
            walls[name] = [w for _, _, w in results]
            if launches[name] != PREDICT_REQUESTS * per8:
                fail(f"remote (a): {launches[name]} K3 launches in this process for "
                     f"{PREDICT_REQUESTS} requests of {PREDICT_BATCH} images through the {name} "
                     f"engine, expected_launches says {PREDICT_REQUESTS} x {per8}")
        for api in ("REST", "GRPC"):
            for i, (got, want) in enumerate(zip(answers[api], answers["local"])):
                g, w = logits_of(got), logits_of(want)
                if g.shape != w.shape or not np.array_equal(g, w):
                    fail(f"remote (a): request {i} over {api}: logits differ from the local "
                         f"engine's (max |diff| {float(np.abs(g - w).max()):.4g}; tolerance 0)")
                gm, wm = dict(got["meta"]), dict(want["meta"])
                if gm.pop("requestPath") != {"leaf": "RemoteComponent"} or \
                        wm.pop("requestPath") != {"leaf": "TorchServer"} or gm != wm or \
                        got["data"].get("names") != want["data"].get("names"):
                    fail(f"remote (a): request {i} over {api}: meta {got['meta']} names "
                         f"{got['data'].get('names')} vs the local {want['meta']} "
                         f"{want['data'].get('names')}")
        ref = torch.from_numpy(np.asarray(logits_of(answers["local"][0]), np.float32))
        with torch.no_grad():
            cudnn = resnet_serve_forward(model, torch.from_numpy(images[0]).cuda(),
                                         pallas_stages=()).float().cpu()
        err, bound, _, _ = check_logits("remote (a): the local engine vs the cuDNN-chain "
                                        "forward", ref, cudnn)
        turns = {"local": [], "REST": []}
        for _ in range(REMOTE_TURNS):
            for name in ("local", "REST", "REST", "local"):
                t = time.perf_counter()
                code, body = post(urls[name], bodies[0])
                turns[name].append(time.perf_counter() - t)
                if code != 200:
                    fail(f"remote (a) turns: the {name} engine answered {code}")
        print(f"[remote] (a) a ResNet-50 JAX_SERVER leaf (the forward phase's live weights, "
              f"one TorchServer) as a remote node: {PREDICT_REQUESTS} concurrent requests of "
              f"{PREDICT_BATCH} images through the local engine, over REST (the component "
              f"app) and over GRPC (the component server), all on 127.0.0.1: remote logits "
              f"equal to the local engine's exactly (tolerance 0; the local's within "
              f"{FWD_TOL} x max|logit| of the cuDNN chain: {err:.4g} <= {bound:.4g}), meta "
              f"equal but requestPath's image (RemoteComponent), K3 launches "
              f"{launches['local']} / {launches['REST']} / {launches['GRPC']} = "
              f"{PREDICT_REQUESTS} x {per8} each; request latency median / max local "
              f"{statistics.median(walls['local']) * 1e3:.1f} / {max(walls['local']) * 1e3:.1f} "
              f"ms, REST {statistics.median(walls['REST']) * 1e3:.1f} / "
              f"{max(walls['REST']) * 1e3:.1f} ms, GRPC "
              f"{statistics.median(walls['GRPC']) * 1e3:.1f} / {max(walls['GRPC']) * 1e3:.1f} "
              f"ms [{card}]", flush=True)
        lm, rm = statistics.median(turns["local"]), statistics.median(turns["REST"])
        print(f"[remote] (a) one request of {PREDICT_BATCH} images at a time, in turns (L R R L "
              f"x {REMOTE_TURNS}): local engine median {lm * 1e3:.1f} ms (spread "
              f"{(max(turns['local']) - min(turns['local'])) * 1e3:.1f} ms), REST remote leaf "
              f"median {rm * 1e3:.1f} ms (spread "
              f"{(max(turns['REST']) - min(turns['REST'])) * 1e3:.1f} ms): the hop adds "
              f"{(rm - lm) * 1e3:.1f} ms [{card}]", flush=True)

        # failure paths: a closed port, a listener closing each connection,
        # a spent deadline against a listener that never answers
        closed = _Listener(accept_close=False)
        closed_port = closed.port
        closed.close()
        closing, silent = _Listener(accept_close=True), _Listener(accept_close=False)
        try:
            fails = {}
            for name, port in (("closed", closed_port), ("closing", closing.port),
                               ("silent", silent.port)):
                eng = GraphEngine(graph_spec(endpoint_unit(port, "REST")), device="cuda")
                httpd, _ = start(make_engine_app(eng, device="cuda"))
                stops.append(httpd)
                u = f"http://127.0.0.1:{httpd.server_address[1]}/api/v0.1/predictions"
                t = time.perf_counter()
                if name == "silent":
                    code, body = post(u, bodies[0], headers={"Seldon-Deadline-Ms": "1"})
                else:  # a one-value body: the wall is the attempts and backoffs
                    code, body = post(u, {"data": {"tensor": {"shape": [1, 1],
                                                              "values": [1.0]}}})
                fails[name] = (code, body.get("status", {}).get("reason"),
                               time.perf_counter() - t)
            retries = 3  # the reference's default, unannotated
            backoffs = sum(0.05 * 2 ** a for a in range(retries - 1))
            if fails["closed"][:2] != (503, "REMOTE_NODE_UNAVAILABLE") or \
                    fails["closing"][:2] != (503, "REMOTE_NODE_UNAVAILABLE"):
                fail(f"remote (a): a dead endpoint answered {fails['closed'][:2]} / "
                     f"{fails['closing'][:2]}, expected 503 REMOTE_NODE_UNAVAILABLE")
            if closing.accepted != retries:
                fail(f"remote (a): {closing.accepted} attempts on a listener closing each "
                     f"connection, expected {retries}")
            if not backoffs <= fails["closed"][2] < backoffs + 1.0:
                fail(f"remote (a): the closed port's 503 took {fails['closed'][2]:.3f} s, the "
                     f"backoffs sum to {backoffs:.3f} s")
            pending = silent.pending()
            if fails["silent"][:2] != (504, "DEADLINE_EXCEEDED") or pending != 0:
                fail(f"remote (a): Seldon-Deadline-Ms: 1 answered {fails['silent'][:2]} with "
                     f"{pending} connection(s) made, expected 504 and none")
        finally:
            closing.close()
            silent.close()
        print(f"[remote] (a) failures: a closed port 503 REMOTE_NODE_UNAVAILABLE in "
              f"{fails['closed'][2] * 1e3:.1f} ms (backoffs {backoffs * 1e3:.0f} ms); a listener "
              f"closing each connection saw {closing.accepted} = retries attempts (503 in "
              f"{fails['closing'][2] * 1e3:.1f} ms); Seldon-Deadline-Ms: 1 on a request of "
              f"{PREDICT_BATCH} images 504 DEADLINE_EXCEEDED in "
              f"{fails['silent'][2] * 1e3:.1f} ms with no connection made [{card}]", flush=True)

        # (b) the micro-batcher over the local engine
        micro_bodies = [body_for(images[i // PREDICT_BATCH][i % PREDICT_BATCH:][:1],
                                 f"micro-{i}") for i in range(MICRO_CLIENTS)]
        fused_identity_chain.launches = 0
        solo = concurrent_posts(urls["local"], micro_bodies)
        solo_launches = k3_count()
        mb = MicroBatcher(engines["local"], max_batch=MICRO_CLIENTS, max_delay_ms=60_000.0)
        mb_httpd, _ = start(make_engine_app(mb, device="cuda"))
        stops.append(mb_httpd)
        torch.cuda.synchronize()
        fused_identity_chain.launches = 0
        batched = concurrent_posts(
            f"http://127.0.0.1:{mb_httpd.server_address[1]}/api/v0.1/predictions", micro_bodies)
        micro_launches = k3_count()
        if (mb.batches, mb.batched_requests) != (1, MICRO_CLIENTS):
            fail(f"remote (b): {mb.batches} flushes of {mb.batched_requests} requests, expected "
                 f"one of {MICRO_CLIENTS}")
        if micro_launches != per_micro:
            fail(f"remote (b): {micro_launches} K3 launches for {MICRO_CLIENTS} one-image "
                 f"requests, one forward at B={MICRO_CLIENTS} is {per_micro}")
        errs = []
        for i, ((code, body, _), (scode, sbody, _)) in enumerate(zip(batched, solo)):
            if code != 200 or scode != 200 or body["meta"]["puid"] != f"micro-{i}":
                fail(f"remote (b) request {i}: {code} / {scode}: {str(body)[:300]}")
            err, bound, _, _ = check_logits(
                f"remote (b) request {i} vs its solo answer",
                torch.from_numpy(np.asarray(logits_of(body), np.float32)),
                torch.from_numpy(np.asarray(logits_of(sbody), np.float32)))
            errs.append(err)
        print(f"[remote] (b) MicroBatcher(max_batch={MICRO_CLIENTS}) behind the engine app: "
              f"{MICRO_CLIENTS} threads each sending one one-image request at once -> "
              f"{mb.batches} flush of {mb.batched_requests} rows, K3 launches {micro_launches} "
              f"= one forward at B={MICRO_CLIENTS} (without the batcher: {solo_launches} = "
              f"{MICRO_CLIENTS} x {k3_forward_launches(1, sms)}); each answer within "
              f"{FWD_TOL} x max|logit| of its solo answer (max |diff| {max(errs):.4g}); "
              f"request latency median / max {statistics.median([w for *_, w in batched]) * 1e3:.1f}"
              f" / {max(w for *_, w in batched) * 1e3:.1f} ms, without the batcher "
              f"{statistics.median([w for *_, w in solo]) * 1e3:.1f} / "
              f"{max(w for *_, w in solo) * 1e3:.1f} ms; each request's ms with / without: "
              f"{', '.join(f'{w * 1e3:.1f} / {sw * 1e3:.1f}' for (*_, w), (*_, sw) in zip(batched, solo))}"
              f" [{card}]", flush=True)
    finally:
        for httpd in stops:
            httpd.shutdown()
            httpd.server_close()
        for srv in servers:
            srv.stop(None)
    total = sum(launches.values()) + solo_launches + micro_launches
    print(f"[remote] phase_s {time.perf_counter() - t_phase:.1f} [{card}]", flush=True)
    return total


def persistence_phase(card: str, router=None) -> None:
    """(d) The engine phase's seeded EPSILON_GREEDY router (or, alone, one
    with ENGINE_BANDIT and the same seeded feedback) snapshot through a
    ``FileStateStore`` in a temporary directory and restored: its next
    PERSIST_ROUTES routes equal the router's that carried on. Host only."""
    import tempfile

    import numpy as np

    from seldon_core_tpu_torch.analytics.routers import EpsilonGreedy
    from seldon_core_tpu_torch.runtime.persistence import FileStateStore

    if router is None:
        router = EpsilonGreedy(**ENGINE_BANDIT)
        rewards = np.random.default_rng(3).uniform(0, 1, ENGINE_ROUTED[0]).round(3)
        for reward in rewards:
            router.send_feedback(None, [], float(reward), None, routing=router.route(None, []))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="persist-") as root:
        store = FileStateStore(root)
        store.save("router", router)
        restored = store.restore("router")
    wall = time.perf_counter() - t0
    got = [restored.route(None, []) for _ in range(PERSIST_ROUTES)]
    want = [router.route(None, []) for _ in range(PERSIST_ROUTES)]
    if got != want or restored.pulls.tolist() != router.pulls.tolist():
        fail(f"persistence (d): the restored router routes {got}, the one that carried on "
             f"{want}")
    print(f"[persistence] (d) the seeded EPSILON_GREEDY router (pulls {router.pulls.tolist()}) "
          f"snapshot through FileStateStore and restored in {wall * 1e3:.1f} ms: its next "
          f"{PERSIST_ROUTES} routes {got} = the router's that carried on [{card}]", flush=True)


def servers_phase(card: str) -> None:
    """The host-only prepackaged servers: which of SERVER_LIBRARIES this
    machine has; with joblib and sklearn, an SKLEARN_SERVER leaf in an
    engine answering as the model's own ``predict_proba``; for each server
    whose library is absent, its ``load()`` raising, naming it."""
    import importlib.util
    import tempfile

    import numpy as np

    from seldon_core_tpu_torch.contracts.graph import UnitImplementation
    from seldon_core_tpu_torch.contracts.payload import SeldonError
    from seldon_core_tpu_torch.runtime.engine import GraphEngine
    from seldon_core_tpu_torch.servers import make_prepackaged_server

    have = {lib: importlib.util.find_spec(lib) is not None for lib in SERVER_LIBRARIES}
    lines = []
    with tempfile.TemporaryDirectory(prefix="servers-") as root:
        if have["joblib"] and have["sklearn"]:
            import joblib
            from sklearn.linear_model import LogisticRegression

            rng = np.random.default_rng(0)
            X = rng.normal(size=(64, 4))
            clf = LogisticRegression().fit(X, (X[:, 0] + X[:, 1] > 0).astype(int))
            joblib.dump(clf, os.path.join(root, "model.joblib"))
            engine = GraphEngine(graph_spec({"name": "clf", "type": "MODEL",
                                             "implementation": "SKLEARN_SERVER",
                                             "modelUri": root}), device="cuda")
            x = rng.normal(size=(5, 4)).round(3)
            out = engine.predict_sync(seldon_message(body_for(x, "sk"))).to_dict()
            got = logits_of(out)
            if not np.array_equal(got, clf.predict_proba(x)):
                fail(f"servers: the SKLEARN_SERVER leaf answered {got}, predict_proba "
                     f"{clf.predict_proba(x)}")
            lines.append("SKLEARN_SERVER leaf = predict_proba exactly")
        cases = [("SKLEARN_SERVER", "joblib"), ("XGBOOST_SERVER", "xgboost"),
                 ("MLFLOW_SERVER", "mlflow")]
        for impl, lib in cases:
            if have[lib]:
                continue
            try:
                make_prepackaged_server(UnitImplementation(impl), root, {}).load()
            except SeldonError as e:
                if lib not in e.message:
                    fail(f"servers: {impl} without {lib} raised without naming it: {e.message}")
                lines.append(f"{impl} load() raised naming {lib}")
                continue
            fail(f"servers: {impl} loaded although {lib} is absent")
    print(f"[servers] this machine has {', '.join(f'{k} {v}' for k, v in have.items())}; "
          f"{'; '.join(lines)} [{card}]", flush=True)


def fleet_chat():
    """Two PREFIX_SYSTEM-token system prompts (A: ``chat_tokens``'s; B: its
    bytes shifted) and, per conversation, PREFIX_TURNS user turns
    (``chat_tokens``'s); conversations 0..3 open with A, 4..7 with B."""
    system_a, users = chat_tokens()
    system_b = [32 + (t - 32 + 17) % 95 if 32 <= t < 127 else t for t in system_a]
    systems = [system_a, system_b]
    per = N_REQUESTS // FLEET_SYSTEMS
    return [systems[c // per] for c in range(N_REQUESTS)], users


def fleet_run(card: str) -> list:
    """(c) Two replicas at Llama-2-7B widths behind one ``ReplicaSet``,
    served by the component app's ``/v1/generate``: each loaded with the
    same seed (so the same weights, checked leaf by leaf), int8 weights over
    a bf16 KV pool of FLEET_POOL_PAGES pages, the prefix cache on, a graph
    batcher of N_REQUESTS slots each (built under
    ``set_sync_debug_mode("error")``). Traffic: FLEET_SYSTEMS system
    prompts of PREFIX_SYSTEM tokens, N_REQUESTS conversations (half on
    each) x PREFIX_TURNS turns, every turn of all conversations at once.
    Every dispatch's probes are recorded (each replica's cached-prefix
    length and load): the choice is the longest prefix, then the least
    load, then the lowest index; every turn 2 and 3 lands on a replica
    holding its system prompt; both replicas serve; every chunk and
    dispatch on both is a replay; tokens teacher-forced, and equal up to a
    near-tie to one server's run of the same requests (replica 0 alone,
    its cache cleared); the fleet app's scrape equals the merged
    ``llm_stats``. Then one gRPC GenerateStream through the fleet equal to
    SSE's, ``ReplicaSet.generate`` equal to each replica's own, and the
    membership cycle: a drain while the replica holds a request in flight
    (it completes; new traffic goes to the other only), ``collect_drained``
    detaching it on the second idle sighting, ``add_replica`` bringing it
    back (a new batcher on its first request); then the faults part
    (``fleet_faults``). Returns the launch records of the chat (counts
    zeroed just before turn 1, read just after turn 3) and of the faults
    part."""
    import gc

    import torch

    from seldon_core_tpu_torch.runtime.engine import ReplicaSet
    from seldon_core_tpu_torch.servers.llmserver import LLMServer
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    class RecordingFleet(ReplicaSet):
        """Records, for every prefix-aware pick, each dispatchable
        replica's probe (match, load) and the choice."""

        def __init__(self, replicas):
            super().__init__(replicas)
            self.records = []
            self._rec_lock = threading.Lock()
            self._last = threading.local()

        def _probe(self, prompt, reps):
            out = super()._probe(prompt, reps)
            self._last.value = (prompt, reps, out)
            return out

        def pick_for(self, prompt):
            chosen = super().pick_for(prompt)
            ids, reps, out = self._last.value
            with self._rec_lock:
                self.records.append((tuple(ids), [replicas.index(r) for r in reps], out,
                                     replicas.index(chosen)))
            return chosen

    label = "fleet"
    t_phase = time.perf_counter()
    release_server_memory()
    torch.cuda.reset_peak_memory_stats()
    replicas = []
    for i in range(2):
        t0 = time.perf_counter()
        r = LLMServer(model="transformer", model_kwargs=dict(LLAMA2_7B, fused_norm=True),
                      init_random=True, param_dtype="auto", continuous_batching=N_REQUESTS,
                      max_new_tokens=MAX_NEW, temperature=0.0, eos_id=-1, seed=0,
                      device="cuda", **FLEET_KNOBS)
        r.load()
        torch.cuda.synchronize()
        print(f"[{label} replica {i}] load_s {time.perf_counter() - t0:.2f} (Llama-2-7B widths, "
              f"int8 weights from seed 0); device memory allocated "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB [{card}]", flush=True)
        replicas.append(r)
    a_leaves = [*replicas[0]._module.parameters(), *replicas[0]._module.buffers()]
    b_leaves = [*replicas[1]._module.parameters(), *replicas[1]._module.buffers()]
    if len(a_leaves) != len(b_leaves) or not all(torch.equal(x, y)
                                                 for x, y in zip(a_leaves, b_leaves)):
        fail(f"[{label}] the two replicas drew different weights from one seed")
    services = []
    for i, r in enumerate(replicas):
        svc, httpd, _, build_s = build_service(f"{label} replica {i}", r)
        httpd.shutdown()
        httpd.server_close()
        r.clear_prefix_cache()
        services.append((svc, build_s))
    rs = RecordingFleet(replicas)
    httpd, _ = start(make_component_app(rs, device="cuda"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    systems, users = fleet_chat()
    prompts, served, ttfts = {}, {}, []
    torch.cuda.synchronize()
    for r in replicas:
        zero_counts(r)
        r._decode_replays = r._decode_eager = r._cow_replays = r._cow_eager = 0
    before = [r._batcher_service.batcher._radix.stats() for r in replicas]
    t_chat = time.perf_counter()
    for t in range(PREFIX_TURNS):
        for c in range(N_REQUESTS):
            prompts[c, t] = (systems[c] + users[c][0] if t == 0 else
                             prompts[c, t - 1] + served[c, t - 1] + users[c][t])
        marks = [len(r._ttft_times) for r in replicas]
        results, _ = post_all(url, [prompts[c, t] for c in range(N_REQUESTS)])
        for c, toks in enumerate(served_tokens(label, results)):
            served[c, t] = toks
        ttfts.append(sorted(x for r, m in zip(replicas, marks)
                            for x in list(r._ttft_times)[m:]))
    chat_s = time.perf_counter() - t_chat
    counts = {k: v for k, v in read_counts(replicas[0]).items() if k.startswith("k")}
    after = [r._batcher_service.batcher._radix.stats() for r in replicas]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    samples = scrape(url)
    merged = rs.llm_stats()
    # dispatch: every pick the longest prefix, then the least load, then the
    # lowest index; turns 2 and 3 on a replica holding their system prompt
    by_prompt = {tuple(p): key for key, p in prompts.items()}
    picks = {}
    sys_len = PREFIX_SYSTEM // 64 * 64
    for ids, reps, out, chosen in rs.records:
        key = by_prompt.get(ids)
        if key is None:
            fail(f"[{label}] a dispatch of an unknown prompt ({len(ids)} tokens)")
        best = min(range(len(reps)), key=lambda i: (-out[i][0], out[i][1], i))
        if reps[best] != chosen:
            fail(f"[{label}] conversation {key[0]} turn {key[1] + 1}: picked replica {chosen}, "
                 f"the probes {out} say replica {reps[best]}")
        if key[1] > 0 and out[reps.index(chosen)][0] < sys_len:
            fail(f"[{label}] conversation {key[0]} turn {key[1] + 1} landed on replica "
                 f"{chosen}, which holds {out[reps.index(chosen)][0]} of its tokens (its system "
                 f"prompt is {PREFIX_SYSTEM})")
        picks[key] = (chosen, out)
    if len(picks) != N_REQUESTS * PREFIX_TURNS:
        fail(f"[{label}] {len(picks)} dispatches recorded for "
             f"{N_REQUESTS * PREFIX_TURNS} requests")
    per_replica = [sum(1 for ch, _ in picks.values() if ch == i) for i in range(2)]
    if min(per_replica) == 0:
        fail(f"[{label}] one replica served nothing: requests by replica {per_replica}")
    for i, r in enumerate(replicas):
        if r._prefill_eager or r._decode_eager or r._cow_eager or not (
                r._prefill_replays and r._decode_replays):
            fail(f"[{label}] replica {i}: chunks {r._prefill_replays} replayed / "
                 f"{r._prefill_eager} eager, dispatches {r._decode_replays} / "
                 f"{r._decode_eager}, CoW {r._cow_replays} / {r._cow_eager}")
    if counts["k1"] <= 0 or counts["k2"] <= 0 or counts["k4"] <= 0 or counts["k4_wgmma"] <= 0:
        fail(f"[{label}] launches {counts}: K1, K2 and K4's decode and prefill kernels must "
             f"all run")
    hits = [a["prefix_hit_tokens"] - b["prefix_hit_tokens"] for a, b in zip(after, before)]
    # the scrape reads the merged llm_stats
    n_req = N_REQUESTS * PREFIX_TURNS
    checks = {"ttft count": (sample(samples, "seldon_llm_ttft_seconds_count"), n_req),
              "kv_pages_total": (sample(samples, "seldon_llm_kv_pages_total"),
                                 merged["kv_pages_total"]),
              "kv_pages_in_use": (sample(samples, "seldon_llm_kv_pages_in_use"),
                                  merged["kv_pages_in_use"]),
              "prefix_hit_blocks": (sample(samples, "seldon_llm_prefix_hit_blocks_total"),
                                    merged["prefix_hit_blocks"])}
    for what, (got, want) in checks.items():
        if got != want:
            fail(f"[{label}] the fleet app's /metrics {what} {got}, the merged llm_stats "
                 f"{want}")
    if merged["kv_pages_total"] != sum(r.llm_stats()["kv_pages_total"] for r in replicas):
        fail(f"[{label}] merged kv_pages_total {merged['kv_pages_total']} is not the sum")
    # tokens: teacher-forced, and one server's run of the same requests
    for t in range(PREFIX_TURNS):
        teacher_check(f"{label} turn {t + 1}", card, replicas[0],
                      [prompts[c, t] for c in range(N_REQUESTS)],
                      [served[c, t] for c in range(N_REQUESTS)])
    solo_svc = replicas[0]._batcher_service
    replicas[0].clear_prefix_cache()
    equal = 0
    for t in range(PREFIX_TURNS):
        futs = [solo_svc.submit(prompts[c, t], MAX_NEW) for c in range(N_REQUESTS)]
        plain = [f.result(600) for f in futs]
        equal += near_tie_check(f"{label} turn {t + 1}", card, replicas[0],
                                [prompts[c, t] for c in range(N_REQUESTS)],
                                [served[c, t] for c in range(N_REQUESTS)], plain)
    # gRPC GenerateStream vs SSE through the fleet, each from cold caches
    text = prompt_text(11)
    grpc_line = fleet_grpc_check(label, rs, replicas, url, text)
    # ReplicaSet.generate = each replica's own generate()
    gen = rs.generate([text], max_new_tokens=MAX_NEW)["tokens"][0]
    own = [r.generate([text], max_new_tokens=MAX_NEW)["tokens"][0] for r in replicas]
    if any(o != gen for o in own) or len(gen) != MAX_NEW:
        fail(f"[{label}] ReplicaSet.generate {gen} vs the replicas' own {own}")
    # membership: drain a replica holding a request in flight
    member_line = fleet_membership(label, card, rs, replicas, url)
    fault_counts = fleet_faults(card, rs, replicas, url)
    # [controlplane] (a): the autoscaler over the same fleet
    cp_counts = controlplane_fleet(card, rs, replicas, url)
    httpd.shutdown()
    httpd.server_close()
    for r in replicas:
        svc = getattr(r, "_batcher_service", None)
        if svc is not None:
            svc.close()
            r._batcher_service = None
    ttft_text = "; ".join(f"turn {t + 1} {statistics.median(v) * 1e3:.1f} / {max(v) * 1e3:.1f}"
                          for t, v in enumerate(ttfts))
    print(f"[{label}] (c) two Llama-2-7B replicas (int8 weights from one seed, bf16 KV pool of "
          f"{FLEET_POOL_PAGES} pages each, prefix cache on, batchers built in "
          f"{' / '.join(f'{b:.2f}' for _, b in services)} s) behind one ReplicaSet on the "
          f"component app: {N_REQUESTS} conversations x {PREFIX_TURNS} turns over "
          f"{FLEET_SYSTEMS} system prompts of {PREFIX_SYSTEM} tokens in {chat_s:.2f} s; TTFT "
          f"median / max ms {ttft_text}; requests by replica {per_replica}; hit tokens by "
          f"replica {hits}; every pick the longest cached prefix, then the least load, then "
          f"the lowest index ({len(picks)} probes recorded), every turn 2 and 3 on a replica "
          f"holding its system prompt; every chunk and dispatch a replay (chunks "
          f"{[r._prefill_replays for r in replicas]}, dispatches "
          f"{[r._decode_replays for r in replicas]}, CoW {[r._cow_replays for r in replicas]}); "
          f"launches {counts}; tokens teacher-forced, {equal} of {n_req} equal to replica 0 "
          f"alone (the rest up to a near-tie); the scrape = the merged llm_stats "
          f"({', '.join(f'{k} {v[0]:.0f}' for k, v in checks.items())}); peak device memory "
          f"{peak_gb:.2f} GB [{card}]", flush=True)
    print(f"[{label}] (c) {grpc_line}; ReplicaSet.generate = each replica's own generate() "
          f"({MAX_NEW} tokens); {member_line} [{card}]", flush=True)
    del rs, replicas, services
    gc.collect()
    release_server_memory()
    print(f"[{label}] phase_s {time.perf_counter() - t_phase:.1f} [{card}]", flush=True)
    return [("fleet", counts), ("fleet faults", fault_counts), ("controlplane (a)", cp_counts)]


def fleet_phase(card: str) -> list:
    """``fleet_run``, then its device memory checked: once the phase has
    returned, nothing of the fleet (its replicas, pools and graphs) may
    stay allocated, whatever held it (a dispatch thread, a crashed loop's
    exception): the next phase loads its own model beside what is left."""
    import torch

    release_server_memory()
    before = torch.cuda.memory_allocated()
    records = fleet_run(card)
    release_server_memory()
    left = (torch.cuda.memory_allocated() - before) / 1e9
    if left > 0.5:
        fail(f"[fleet] {left:.3f} GB still allocated after the fleet phase returned")
    print(f"[fleet] allocated after the phase returned: {left:+.3f} GB [{card}]", flush=True)
    return records


def fleet_grpc_check(label: str, rs, replicas, url: str, text: str) -> str:
    """SSE and gRPC ``Model/GenerateStream`` of ``text`` through the fleet,
    each after both replicas' caches are cleared (so both take the same
    cold path on the same replica): equal events."""
    from seldon_core_tpu_torch.contracts.payload import SeldonMessage
    from seldon_core_tpu_torch.transport import grpc_client
    from seldon_core_tpu_torch.transport.grpc_server import make_component_server

    for r in replicas:
        r.clear_prefix_cache()
    sse = streamed_tokens(label, sse_client(url, {"prompt": text}))
    for r in replicas:
        r.clear_prefix_cache()
    srv = make_component_server(rs, host="127.0.0.1", port=None)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        events = [m.json_data for m in grpc_client.call_stream(
            f"127.0.0.1:{port}", "GenerateStream", SeldonMessage.from_json_data({"prompt": text}),
            timeout_s=600)]
    finally:
        srv.stop(None)
    toks = [e["token"] for e in events[:-1]]
    if toks != sse or events[-1].get("tokens") != sse:
        fail(f"[{label}] gRPC GenerateStream through the fleet {toks} differs from SSE's {sse}")
    return f"one gRPC GenerateStream through the fleet = SSE's {len(sse)} tokens"


def fleet_membership(label: str, card: str, rs, replicas, url: str) -> str:
    """A request in flight on the replica it lands on; that replica drained
    after its first token: it stays attached while busy, its request
    completes, N_REQUESTS // 2 new requests all go to the other replica,
    ``collect_drained`` detaches it on the second idle sighting, and after
    ``add_replica`` a cold request builds its new batcher and is served."""
    first = threading.Event()
    ids = replicas[0]._tokenizer.encode(prompt_text(21))
    n_before = len(rs.records)
    fut = rs.submit(ids, MAX_NEW, on_token=lambda t: first.set())
    if not first.wait(600):
        fail(f"[{label}] membership: the in-flight request never produced a token")
    x = replicas[rs.records[n_before][3]]
    other = replicas[1 - replicas.index(x)]
    if rs.drain_replica(x) is not x:
        fail(f"[{label}] membership: drain_replica refused")
    in_flight = not fut.done()
    busy = [rs.collect_drained(), rs.collect_drained()]
    n_mark = len(rs.records)
    results, _ = post_all(url, [prompt_text(30 + i) for i in range(N_REQUESTS // 2)])
    served_tokens(label, results)
    went = {replicas[r[3]] is other for r in rs.records[n_mark:]}
    toks = fut.result(600)
    if not in_flight or busy != [[], []] or went != {True} or len(toks) != MAX_NEW:
        fail(f"[{label}] membership: in flight at the drain {in_flight}, sweeps while busy "
             f"{busy}, new traffic to the other replica {went}, the request's tokens {toks}")
    svc = x._batcher_service
    sweeps = [rs.collect_drained(), rs.collect_drained()]
    if sweeps != [[], [x]] or rs.members() != [other] or x._batcher_service is not None:
        fail(f"[{label}] membership: sweeps after idle {sweeps}, members {rs.members()}")
    del svc
    import gc

    gc.collect()
    rs.add_replica(x)
    n_mark = len(rs.records)
    # a prompt no cache holds a token of ("request ..." prompts share 8)
    code, body = post(url + "/v1/generate", {"prompt": "zz " + prompt_text(40)})
    if code != 200 or len(body.get("tokens", [])) != MAX_NEW or \
            replicas[rs.records[n_mark][3]] is not x or x._batcher_service is None:
        fail(f"[{label}] membership: after add_replica the cold request answered {code} on "
             f"replica {rs.records[n_mark][3] if len(rs.records) > n_mark else None}")
    return (f"membership: replica {replicas.index(x)} drained with a request in flight (it "
            f"completed, {MAX_NEW} tokens), {N_REQUESTS // 2} new requests all on replica "
            f"{replicas.index(other)}, collect_drained detached it on the second idle sweep, "
            f"add_replica brought it back (a new batcher on its first request)")


# ---------------------------------------------------------------------------
# [fleet faults]: the fleet's fault tolerance on the fleet phase's replicas
# ---------------------------------------------------------------------------
FAULT_TEMPERATURE = 0.8
FAULT_TOP_K = 20
FAULT_SEEDS = tuple(range(301, 301 + N_REQUESTS))


def kernel_counts() -> dict:
    """Every kernel's launch counter now (the wrappers' tallies)."""
    from seldon_core_tpu_torch.ops.fused_norm import fused_residual_rmsnorm
    from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul
    from seldon_core_tpu_torch.ops.paged_attention import paged_attention

    return {"k1": paged_attention.launches, "k1_int8": paged_attention.launches_int8,
            "k2": fused_residual_rmsnorm.launches, "k4": int8_matmul.launches,
            "k4_wgmma": int8_matmul.launches_wgmma}


def zero_kernel_counts() -> None:
    from seldon_core_tpu_torch.ops.fused_norm import fused_residual_rmsnorm
    from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul
    from seldon_core_tpu_torch.ops.paged_attention import paged_attention

    paged_attention.launches = paged_attention.launches_int8 = 0
    fused_residual_rmsnorm.launches = 0
    int8_matmul.launches = int8_matmul.launches_wgmma = 0


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def program_counts(r) -> list:
    """A replica's [chunk replays, chunk eager runs, decode replays, decode
    eager runs, CoW replays, CoW eager copies]."""
    return [r._prefill_replays, r._prefill_eager, r._decode_replays, r._decode_eager,
            r._cow_replays, r._cow_eager]


def sampled_gaps(server, prompts_ids, tokens, seeds) -> list:
    """The seeded draw, teacher-forced. The sampler ranks the top-k logits
    over the temperature plus Gumbel noise that belongs to each RANK
    position of the top k, drawn from the key ``fast_forward_key(seed,
    n)`` (the key a slot holds after n tokens). Over a teacher-forced
    prefill of request i's prompt and the tokens before its token n: 0 when
    that token is the draw; else how far below the draw's score the token
    scores at best at a rank whose teacher logit is within TIE_TOL of its
    own (logits that close may sit in either order on the serving path's
    numerics, and the noise goes with the rank); inf when no rank of the
    top k is that close (it could not have been in the served top k)."""
    import torch

    from seldon_core_tpu_torch.servers.llmserver import (_GOLDEN, _M32, _mix32,
                                                         fast_forward_key, split_keys)

    logits = teacher_logits(server, [p + t for p, t in zip(prompts_ids, tokens)]).float()
    temp = torch.clamp(torch.full((), float(server.temperature), dtype=torch.float32,
                                  device="cuda"), min=1e-6)
    k = min(int(server.top_k), logits.shape[-1])
    j = torch.arange(k, device="cuda", dtype=torch.int64)
    out = []
    for i, (p, toks, seed) in enumerate(zip(prompts_ids, tokens, seeds)):
        gaps = []
        for n, tok in enumerate(toks):
            row = logits[i, len(p) + n - 1]
            _, sub = split_keys(fast_forward_key(seed, n))
            topv, topi = torch.topk(row, k)
            bits = _mix32((sub + j * _GOLDEN) & _M32)
            u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
            noise = -torch.log(-torch.log(u))
            score = topv / temp + noise
            best = int(score.argmax())
            if int(topi[best]) == int(tok):
                gaps.append(0.0)
                continue
            near = (topv - row[int(tok)]).abs() <= TIE_TOL
            gaps.append(float("inf") if not bool(near.any()) else max(
                (score[best] - (row[int(tok)] / temp + noise[near]).max()).item(), 0.0))
        out.append(gaps)
    return out


def sampled_check(label: str, card: str, server, texts, served, plain, seeds) -> int:
    """Seeded sampled tokens: every served token the teacher-forced draw
    with its fast-forwarded key, or a near-tie of it (``sampled_gaps``:
    within 2 x TIE_TOL / temperature of the draw's score at a rank its
    logit could take: its logit and the draw's may each sit TIE_TOL off
    the teacher's); and each request equal to ``plain`` (the unfaulted
    run), or equal up to a first difference where both tokens are such
    near-ties. Returns the requests equal throughout."""
    tol = 2 * TIE_TOL / float(server.temperature)
    pids = [prompt_ids(server, t) for t in texts]
    gaps = sampled_gaps(server, pids, served, seeds)
    worst = max(max(g) for g in gaps)
    drawn = sum(g == 0 for row in gaps for g in row)
    print(f"[{label}] teacher-forced draw of all {len(texts)} x {MAX_NEW} served tokens with "
          f"the fast-forwarded keys: {drawn} are the draw, the rest near-ties (a logit within "
          f"{TIE_TOL} of a top-{server.top_k} rank); worst gap to the draw's score {worst:.4f} "
          f"(tie tolerance {tol:.4f} = 2 x {TIE_TOL} / T) [{card}]", flush=True)
    if worst > tol:
        i = max(range(len(gaps)), key=lambda r: max(gaps[r]))
        fail(f"[{label}] request {i} token {gaps[i].index(worst)}: served token sits {worst:.4f} "
             f"below the teacher-forced draw (tolerance {tol:.4f})")
    equal = 0
    for i, (a, b_) in enumerate(zip(served, plain)):
        t = next((j for j, (x, y) in enumerate(zip(a, b_)) if x != y), None)
        if t is None:
            equal += 1
            continue
        at = [sampled_gaps(server, [pids[i]], [tok[:t + 1]], [seeds[i]])[0][t] for tok in (a, b_)]
        print(f"[{label}] request {i}: tokens equal to the unfaulted run's for {t} of "
              f"{MAX_NEW}, then {a[t]} vs {b_[t]}; gaps to the teacher-forced draw "
              f"{at[0]:.4f} / {at[1]:.4f} (tolerance {tol:.4f}) [{card}]", flush=True)
        if max(at) > tol:
            fail(f"[{label}] request {i} leaves the unfaulted run's tokens at {t} without a "
                 f"near-tie")
    return equal


def fault_kill(label: str, card: str, rs, replicas, url: str, texts, seeds=None) -> dict:
    """One kill: N_REQUESTS SSE streams of MAX_NEW tokens through the fleet
    app (seeded when ``seeds`` is given); a ``BatcherKiller(busiest=True)``
    on both batchers fires once every stream has 2 tokens. Checks: one kill;
    every stream MAX_NEW tokens equal to its done event's, with no
    duplicate and no hole, and at most one ``resumed`` event, whose
    ``tokens_delivered`` is the token events before it (at least one stream
    resumed); the victim ejected, its crash path leaving zero ``LeakSweep``
    residue and its free pages as before the kill; the scrape's
    ``seldon_fleet_resumes_total`` up by the markers, journal depth 0; on
    both replicas every chunk, decode and CoW a replay (the survivor's
    re-admissions included); tokens teacher-forced and equal to the
    survivor's unfaulted run of the same requests up to a near-tie. With
    the batchers' flight recorders on, each stream also carries a sampled
    ``traceparent`` (``trace_ids``) and ``fault_timelines`` checks and
    splits the timelines. Returns the run's launches (zeroed before the
    streams, read after them), the victim and survivor indices, the free
    pages before the kill, the loop threads before it and the line's
    numbers."""
    import torch

    from seldon_core_tpu_torch.testing.faults import BatcherKiller, LeakSweep

    batchers = [r._batcher_service.batcher for r in replicas]
    for r in replicas:
        r.clear_prefix_cache()
    free_before = [b._allocator.free_count() for b in batchers]
    progress = [0] * len(texts)
    kill_t = []

    class TimedKiller(BatcherKiller):
        def __call__(self, b):
            try:
                super().__call__(b)
            except Exception:
                kill_t.append(time.perf_counter())
                raise

    killer = TimedKiller(trigger=lambda b: all(p >= 2 for p in progress),
                         busiest=True).install(*batchers)
    drains = [[] for _ in batchers]
    for b, d in zip(batchers, drains):
        def drain(_real=b._drain_one, _d=d):
            _real()
            _d.append(time.perf_counter())
        b._drain_one = drain
    progs = [program_counts(r) for r in replicas]
    hits = [b._radix.stats()["prefix_hit_tokens"] for b in batchers]
    resumes0 = sample(scrape(url), "seldon_fleet_resumes_total")
    results = [None] * len(texts)
    traced_run = batchers[0]._flight is not None
    parents = [trace_ids(i, 200 if seeds is None else 201) for i in range(len(texts))]

    def client(i):
        def on_event(ev):
            if "token" in ev:
                progress[i] += 1

        body = {"prompt": texts[i]}
        if seeds is not None:
            body["seed"] = seeds[i]
        results[i] = sse_client(url, body, on_event=on_event,
                                headers=traceparent(parents[i]) if traced_run else None)

    torch.cuda.synchronize()
    zero_kernel_counts()
    threads_before = [b._thread for b in batchers]
    clients = [threading.Thread(target=client, args=(i,)) for i in range(len(texts))]
    for t in clients:
        t.start()
    for t in clients:
        t.join(600)
    counts = kernel_counts()
    for b in batchers:
        b._chaos = None
        del b._drain_one
    if killer.kills != 1 or not kill_t:
        fail(f"[{label}] the killer fired {killer.kills} times")
    v = batchers.index(killer.killed)
    victim, survivor = replicas[v], replicas[1 - v]
    served, markers, resumed_idx, kill_to_marker, t_end = [], [], [], [], kill_t[0]
    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            fail(f"[{label}] stream {i} answered {res and res[0]}: {res and res[2]}")
        events = res[2]
        marks = [(k, e) for k, (_, e) in enumerate(events) if "resumed" in e]
        evs = [(t, e) for k, (t, e) in enumerate(events) if "resumed" not in e]
        toks = streamed_tokens(label, (200, res[1], evs, res[3]))
        served.append(toks)
        if len(marks) > 1:
            fail(f"[{label}] stream {i} carries {len(marks)} resumed events")
        if marks:
            k, e = marks[0]
            before = sum(1 for _, x in events[:k] if "token" in x)
            if e.get("tokens_delivered") != before or e.get("resumed") is not True:
                fail(f"[{label}] stream {i}: resumed event {e} after {before} token events")
            markers.append(e["tokens_delivered"])
            resumed_idx.append(i)
            kill_to_marker.append(events[k][0] - kill_t[0])
            t_end = max(t_end, events[k + 1][0])
    if not markers:
        fail(f"[{label}] the kill resumed no stream")
    if rs.ejected_members() != [victim] or victim in rs._dispatchable():
        fail(f"[{label}] the victim (replica {v}) is not the one ejected: "
             f"{[replicas.index(r) for r in rs.ejected_members()]}")
    vb = batchers[v]
    killer.killed_thread.join(60)  # the crash path's end
    split = (fault_timelines(label, vb, batchers[1 - v], parents, resumed_idx, markers,
                             kill_t[0]) if traced_run else None)
    if vb.crashed is None or vb._thread is not None:
        fail(f"[{label}] the victim's loop: crashed {vb.crashed!r}, thread {vb._thread}")
    residue = LeakSweep(vb).residue()
    if any(residue.values()) or vb._allocator.free_count() != free_before[v]:
        fail(f"[{label}] the victim's crash path left residue {residue}, free pages "
             f"{vb._allocator.free_count()} (before the kill {free_before[v]})")
    survivor_residue = LeakSweep(batchers[1 - v]).residue()
    if any(survivor_residue.values()):
        fail(f"[{label}] the survivor holds residue {survivor_residue} after every stream ended")
    samples = scrape(url)
    resumed = sample(samples, "seldon_fleet_resumes_total") - resumes0
    depth = sample(samples, "seldon_fleet_resume_journal_depth")
    if resumed != len(markers) or depth != 0:
        fail(f"[{label}] the scrape: resumes {resumed} for {len(markers)} markers, journal "
             f"depth {depth}")
    delta = [[a - b for a, b in zip(program_counts(r), p)] for r, p in zip(replicas, progs)]
    sd = delta[1 - v]
    if any(d[1] or d[3] or d[5] for d in delta) or sd[0] < len(markers) or sd[2] <= 0:
        fail(f"[{label}] (chunk replays, eager, decode replays, eager, CoW replays, eager) by "
             f"replica {delta}: every program must be a replay, and the survivor's "
             f"re-admissions chunk replays")
    gaps = gaps_in(drains[1 - v], kill_t[0], t_end)
    steady = gaps_in(drains[1 - v], kill_t[0] - 0.5, kill_t[0])
    hit = batchers[1 - v]._radix.stats()["prefix_hit_tokens"] - hits[1 - v]
    # tokens: teacher-forced, and the survivor's unfaulted run
    if seeds is None:
        teacher_check(label, card, survivor, texts, served)
    survivor.clear_prefix_cache()
    svc = survivor._batcher_service
    futs = [svc.submit(t, MAX_NEW, seed=None if seeds is None else seeds[i])
            for i, t in enumerate(texts)]
    plain = [f.result(600) for f in futs]
    equal = (near_tie_check(label, card, survivor, texts, served, plain) if seeds is None
             else sampled_check(label, card, survivor, texts, served, plain, seeds))
    return {"counts": counts, "victim": v, "free_before": free_before,
            "threads_before": threads_before, "markers": markers, "resumed": resumed_idx,
            "kill_to_marker_ms": [x * 1e3 for x in kill_to_marker],
            "gaps_ms": [x * 1e3 for x in gaps], "steady_ms": [x * 1e3 for x in steady],
            "equal": equal, "hit_tokens": hit, "survivor_chunks": sd[0], "split": split}


def fault_timelines(label: str, vb, sb, parents, resumed, markers, kill_t: float) -> dict:
    """The traced kill's timelines. The victim's crash path left no open
    segment, and every resumed request's victim timeline completed
    "error"; on the survivor (no open segment either) each resumed request
    has one timeline with a ``resume`` event, exactly one, whose tokens are
    the tokens its client had, just before its ``first_token``; the fleet's
    ``llm.resume`` span is in that request's trace, under its caller's
    span. Returns the split of kill -> resumed, in ms on one clock (the
    kill on perf_counter, the timelines' wall stamps mapped back through
    the span clock): the victim's error completion, the survivor's submit,
    its queue wait, admission to the first token (its chunks: count, host
    enqueue wall), and the first token."""
    from seldon_core_tpu_torch.tracing import get_tracer, now

    offset = now() - time.perf_counter()   # wall - perf_counter (both monotonic)
    kill_wall = kill_t + offset
    if vb._flight.live_slots() or sb._flight.live_slots():
        fail(f"[{label}] open segments after the kill: victim {vb._flight.live_slots()}, "
             f"survivor {sb._flight.live_slots()}")
    dead = {t["trace_id"]: t for t in vb._flight.timelines(256) if t["status"] == "error"}
    ids = {p[0] for p in parents}
    if not set(dead) <= ids or any(parents[i][0] not in dead for i in resumed):
        fail(f"[{label}] the victim's error timelines {sorted(dead)} vs the resumed requests "
             f"{[parents[i][0] for i in resumed]}")
    spans = [s for s in get_tracer().drain()
             if s.name == "llm.resume" and "tokens_delivered" in s.tags]
    out = {"victim_error_ms": [], "submit_ms": [], "queue_ms": [], "admit_ms": [],
           "chunks": [], "chunk_ms": [], "first_token_ms": []}
    for i, n in zip(resumed, markers):
        tid, sid = parents[i]
        tls = [t for t in sb._flight.timelines(256) if t["trace_id"] == tid and
               any(e["kind"] == "resume" for e in t["events"])]
        if len(tls) != 1:
            fail(f"[{label}] request {i}: {len(tls)} survivor timelines carry a resume event")
        tl = tls[0]
        kinds = [e["kind"] for e in tl["events"]]
        res = [e for e in tl["events"] if e["kind"] == "resume"]
        if len(res) != 1 or res[0]["tokens"] != n or \
                kinds.index("resume") != kinds.index("first_token") - 1 or \
                tl["status"] != "done" or \
                not (tl["token_events_sum"] == tl["tokens"] == MAX_NEW - n):
            fail(f"[{label}] request {i}'s survivor timeline: resume events {res} (its client "
                 f"had {n} tokens), kinds {kinds}, status {tl['status']}, tokens {tl['tokens']}")
        mine = [sp for sp in spans if sp.trace_id == tid]
        if len(mine) != 1 or mine[0].parent_id != sid or mine[0].tags["tokens_delivered"] != n:
            fail(f"[{label}] request {i}: llm.resume spans in its trace {mine}")
        ev = {e["kind"]: e for e in tl["events"]}
        chunks = [e for e in tl["events"] if e["kind"] == "prefill_chunk"]
        end = dead[tid]["t_submit_wall"] + dead[tid]["total_s"]
        out["victim_error_ms"].append((end - kill_wall) * 1e3)
        out["submit_ms"].append((tl["t_submit_wall"] - kill_wall) * 1e3)
        out["queue_ms"].append(tl["queue_wait_s"] * 1e3)
        out["admit_ms"].append((ev["first_token"]["t_s"] - tl["queue_wait_s"]) * 1e3)
        out["chunks"].append(len(chunks))
        out["chunk_ms"].append(sum(e["dur_s"] for e in chunks) * 1e3)
        out["first_token_ms"].append((tl["t_submit_wall"] + ev["first_token"]["t_s"]
                                      - kill_wall) * 1e3)
    return out


def split_text(split: dict) -> str:
    """A fault's kill -> resumed split, each figure over the resumed
    requests as a range."""
    def rng(key, fmt=".1f"):
        xs = split[key]
        return f"{format(min(xs), fmt)}–{format(max(xs), fmt)}"

    return (f"split of kill -> resumed from the timelines (ms after the kill, host clock): the "
            f"victim's error completion {rng('victim_error_ms')}, the survivor's submit "
            f"{rng('submit_ms')}, its queue wait {rng('queue_ms')} ms, admission to the first "
            f"token {rng('admit_ms')} ms ({rng('chunks', 'd')} chunks, enqueue "
            f"{rng('chunk_ms', '.2f')} ms), the first token {rng('first_token_ms')}")


def fault_line(label: str, card: str, what: str, r: dict) -> None:
    gaps, steady = r["gaps_ms"], r["steady_ms"]
    print(f"[{label}] {what}: {N_REQUESTS} SSE streams x {MAX_NEW} tokens, the busiest replica "
          f"(replica {r['victim']}) killed once every stream had 2 tokens; {len(r['markers'])} "
          f"streams (requests {r['resumed']}) resumed on the survivor after {r['markers']} "
          f"tokens, one resumed event each, "
          f"every stream {MAX_NEW} tokens with no duplicate and no hole; kill to the resumed "
          f"event {' / '.join(f'{x:.1f}' for x in r['kill_to_marker_ms'])} ms; the survivor's "
          f"decode gap while it re-admits p50 {pctl(gaps, 0.5):.2f} / max "
          f"{max(gaps, default=float('nan')):.2f} ms ({len(gaps)} gaps; before the kill p50 "
          f"{pctl(steady, 0.5):.2f} ms); its chunks {r['survivor_chunks']} replays (its own "
          f"admissions and the re-admissions; prefix hit tokens {r['hit_tokens']}), every "
          f"decode a replay, no eager program; "
          f"the victim ejected, its crash path's LeakSweep residue all 0 and its free pages as "
          f"before the kill; scrape seldon_fleet_resumes_total +{len(r['markers'])}, journal "
          f"depth 0; tokens {r['equal']} of {N_REQUESTS} equal to the survivor's unfaulted run "
          f"(the rest up to a near-tie); launches {r['counts']} [{card}]", flush=True)
    if r["split"] is not None:
        print(f"[{label}] {what}, traced: no open segment on either replica, every resumed "
              f"request's victim timeline completed \"error\", one survivor timeline with one "
              f"resume event of the delivered tokens each, llm.resume in its trace; "
              f"{split_text(r['split'])} [{card}]", flush=True)


def fleet_faults(card: str, rs, replicas, url: str) -> dict:
    """``fleet_faults_traced`` with the process tracer on (``traced``)."""
    with traced():
        return fleet_faults_traced(card, rs, replicas, url)


def fleet_faults_traced(card: str, rs, replicas, url: str) -> dict:
    """[fleet faults], on the fleet phase's two replicas behind its app,
    both batchers rebuilt first with the tracer on (a flight recorder each):
    (a) a kill under 8 greedy SSE streams (``fault_kill``, its timelines
    checked and split by ``fault_timelines``); (c) the fleet's
    FaultClock advanced past ``reinstate_after_s``: the next request
    probes the victim, whose loop restarts on a new thread over the same
    captured graphs (no new capture), answers the survivor's tokens for the
    same request and is reinstated, with zero LeakSweep residue and its
    free pages as before the kill; (b) both batchers rebuilt at
    FAULT_TEMPERATURE / FAULT_TOP_K (the weights stay loaded), a kill
    under 8 seeded streams, checked against the teacher-forced draw with
    the fast-forwarded key; (d) with the retry budget spent, a kill
    answers 503 with ``Retry-After``. Returns the launches of every run
    (counts zeroed just before each, read just after)."""
    import torch

    from seldon_core_tpu_torch.runtime.resilience import RetryBudget
    from seldon_core_tpu_torch.testing.faults import BatcherKiller, FaultClock, LeakSweep

    label = "fleet faults"
    t_part = time.perf_counter()
    launches: dict = {}
    # one clock for the fleet, its breakers and its budget, from now: the
    # loops' heartbeats (monotonic) stay younger than it, and a probe waits
    # for it to be advanced
    clk = FaultClock(start=time.monotonic())
    rs.clock = clk
    for br in rs._health.values():
        br.clock = clk
    # a budget that covers every stream of a kill ((d) spends it)
    rs.retry_budget = RetryBudget(ratio=1.0, min_retries=2 * N_REQUESTS, clock=clk)

    def rebuild(temperature: float, top_k: int) -> list:
        """Both batchers rebuilt on the loaded weights, under the tracer;
        returns the build seconds."""
        builds = []
        for r in replicas:
            r._batcher_service.close()
            r._batcher_service = None
        release_server_memory()
        for i, r in enumerate(replicas):
            r.temperature, r.top_k = temperature, top_k
            with r._lock:
                r._decode_cache.clear()  # the step programs hold top_k
            svc, httpd, _, build_s = build_service(f"{label} replica {i}", r)
            httpd.shutdown()
            httpd.server_close()
            if svc.batcher._flight is None:
                fail(f"[{label}] replica {i}'s batcher was built without a flight recorder")
            builds.append(build_s)
        return builds

    builds = rebuild(replicas[0].temperature, replicas[0].top_k)
    print(f"[{label}] both batchers rebuilt with the tracer on (a flight recorder each) in "
          f"{' / '.join(f'{x:.2f}' for x in builds)} s [{card}]", flush=True)
    # (a) greedy
    texts = [prompt_text(60 + i) for i in range(N_REQUESTS)]
    a = fault_kill(f"{label} (a)", card, rs, replicas, url, texts)
    add_counts(launches, a["counts"])
    fault_line(label, card, "(a) kill, greedy", a)
    # (c) the probe reinstates (a)'s victim
    v = a["victim"]
    victim, survivor = replicas[v], replicas[1 - v]
    vb = victim._batcher_service.batcher
    graphs = (dict(vb._graphs), dict(vb._prefill_graphs), vb._cow_graph)
    for r in replicas:
        r.clear_prefix_cache()
    text = prompt_text(80)
    want = survivor._batcher_service.submit_sync(text, MAX_NEW)
    survivor.clear_prefix_cache()
    rein0 = sample(scrape(url), "seldon_fleet_reinstatements_total")
    progs = program_counts(victim)
    clk.advance(rs.reinstate_after_s + 0.1)
    torch.cuda.synchronize()
    zero_kernel_counts()
    res = sse_client(url, {"prompt": text})
    counts = kernel_counts()
    add_counts(launches, counts)
    got = streamed_tokens(f"{label} (c)", res)
    first = next(t for t, e in res[2] if "token" in e)
    # the probe's commit, the victim's only one since the kill (before a
    # scrape drains the series)
    ttft = victim._ttft_times[-1]
    delta = [x - y for x, y in zip(program_counts(victim), progs)]
    rein = sample(scrape(url), "seldon_fleet_reinstatements_total") - rein0
    if got != want:
        fail(f"[{label} (c)] the probe answered {got}, the survivor {want}")
    if rs.ejected_members() != [] or rein != 1 or vb.crashed is not None:
        fail(f"[{label} (c)] after the probe: ejected {rs.ejected_members()}, reinstatements "
             f"+{rein}, crashed {vb.crashed!r}")
    if vb._thread is None or not vb._thread.is_alive() or vb._thread is a["threads_before"][v]:
        fail(f"[{label} (c)] the victim's loop did not restart on a new thread")
    same = (all(vb._graphs[k] is g for k, g in graphs[0].items()) and vb._graphs.keys() ==
            graphs[0].keys() and all(vb._prefill_graphs[k] is g for k, g in graphs[1].items())
            and vb._prefill_graphs.keys() == graphs[1].keys() and vb._cow_graph is graphs[2])
    if not same or delta[1] or delta[3] or delta[5] or delta[0] <= 0 or delta[2] <= 0:
        fail(f"[{label} (c)] the restarted loop: same captured graphs {same}, (chunk replays, "
             f"eager, decode replays, eager, CoW replays, eager) {delta}")
    residue = LeakSweep(vb).residue()
    victim.clear_prefix_cache()
    if any(residue.values()) or vb._allocator.free_count() != a["free_before"][v]:
        fail(f"[{label} (c)] after the probe: residue {residue}, free pages "
             f"{vb._allocator.free_count()} (before the kill {a['free_before'][v]})")
    print(f"[{label}] (c) reinstatement: the fleet's FaultClock advanced "
          f"{rs.reinstate_after_s + 0.1:.1f} s; the next request probed replica {v}, whose loop "
          f"restarted on a new thread over its captured graphs (no new capture; chunks "
          f"{delta[0]}, decode dispatches {delta[2]} replayed, none eager) and answered the "
          f"survivor's {MAX_NEW} tokens for the same request; reinstated (scrape "
          f"seldon_fleet_reinstatements_total +1); LeakSweep residue {residue}, free pages "
          f"{vb._allocator.free_count()} = before the kill; the probe's TTFT "
          f"{(first - res[1]) * 1e3:.1f} ms at the client, {ttft * 1e3:.1f} ms on the server; "
          f"launches {counts} "
          f"[{card}]", flush=True)
    # (b) seeded: both batchers rebuilt at the sampling temperature
    builds = rebuild(FAULT_TEMPERATURE, FAULT_TOP_K)
    texts = [prompt_text(70 + i) for i in range(N_REQUESTS)]
    b = fault_kill(f"{label} (b)", card, rs, replicas, url, texts, seeds=FAULT_SEEDS)
    add_counts(launches, b["counts"])
    fault_line(label, card, f"(b) kill, seeded (temperature {FAULT_TEMPERATURE}, top_k "
                            f"{FAULT_TOP_K}; batchers rebuilt at it in "
                            f"{' / '.join(f'{x:.2f}' for x in builds)} s)", b)
    # (d) the budget spent: the kill answers 503 with Retry-After
    live = [r for r in replicas if r not in rs.ejected_members()]
    rs.retry_budget = RetryBudget(ratio=0.0, min_retries=0, clock=clk)
    for r in live:
        r.clear_prefix_cache()
    killer = BatcherKiller(trigger=lambda bt: any(s.active and s.n_new >= 2 for s in bt._slots))
    killer.install(*(r._batcher_service.batcher for r in live))
    shed0 = sample(scrape(url), "seldon_fleet_retry_budget_exhausted_total")
    torch.cuda.synchronize()
    zero_kernel_counts()
    code, headers, body = post_headers(url + "/v1/generate", {"prompt": prompt_text(90)})
    add_counts(launches, kernel_counts())
    for r in live:
        r._batcher_service.batcher._chaos = None
    shed = int(sample(scrape(url), "seldon_fleet_retry_budget_exhausted_total") - shed0)
    retry = headers.get("Retry-After")
    if code != 503 or retry is None or killer.kills != 1 or shed != 1:
        fail(f"[{label} (d)] a kill with the budget spent answered {code} (Retry-After "
             f"{retry}), kills {killer.kills}, scrape exhausted +{shed}: {body}")
    print(f"[{label}] (d) budget spent: the kill answered {code} with Retry-After {retry} "
          f"({body.get('status', {}).get('info')}); scrape "
          f"seldon_fleet_retry_budget_exhausted_total +{shed} [{card}]", flush=True)
    print(f"[{label}] part_s {time.perf_counter() - t_part:.1f}; launches {launches} [{card}]",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# Disaggregated prefill / decode (runtime/disagg.py): prefill workers on
# streams and graphs of their own beside the decode batcher, on this card
# ---------------------------------------------------------------------------
# (a), (c), (d): 8 prompts of mixed length, two over 1,024 tokens (the 2048
# bucket: chunks of 256)
DISAGG_LENGTHS = (1400, 1100, 600, 300, 124, 124, 48, 24)
# (b): DISAGG_STREAMS streams of DISAGG_STREAM_NEW tokens decoding, then a
# burst of prompts of about 2,048 tokens; DISAGG_SLOTS_B slots, so the burst
# is admitted while every stream decodes
DISAGG_STREAMS = 8
DISAGG_STREAM_NEW = 256
DISAGG_BURST = (2000, 1980, 2040, 1960)
DISAGG_SLOTS_B = DISAGG_STREAMS + len(DISAGG_BURST)
# (b) runs each setting this many times, the order of the settings reversed
# every other round, so a spread is read beside each number (two rounds,
# so that the full run stays well inside its time limit)
DISAGG_B_ROUNDS = 2
# (e): DISAGG_CHATS conversations over one PREFIX_SYSTEM-token system prompt,
# two turns of PREFIX_USER user tokens
DISAGG_CHATS = 4


def pctl(v, q: float) -> float:
    """The q-quantile of ``v`` (nearest rank; nan when empty)."""
    v = sorted(v)
    return v[min(len(v) - 1, int(q * len(v)))] if v else float("nan")


def disagg_service(label: str, server, slots: int = N_REQUESTS, **batcher_kw):
    """``build_service`` (the peak memory counted from just before it) with
    the batcher's drains and slot commits timestamped (host clock, after
    each drain and at each commit): the decode step gaps of a window are the
    gaps between its drains. Returns (service, httpd, url, build seconds,
    drain times, commit times)."""
    import gc

    import torch

    # the last run's batcher (held by its instrumentation's reference
    # cycle) goes before this one is built
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    svc, httpd, url, build_s = build_service(label, server, slots=slots, **batcher_kw)
    b = svc.batcher
    drains, commits = [], []
    real_drain, real_commit = b._drain_one, b._commit_slot

    def drain():
        real_drain()
        drains.append(time.perf_counter())

    def commit(*args, **kwargs):
        commits.append(time.perf_counter())
        return real_commit(*args, **kwargs)

    b._drain_one, b._commit_slot = drain, commit
    return svc, httpd, url, build_s, drains, commits


def gaps_in(drains, t0: float, t1: float):
    ts = [t for t in drains if t0 <= t <= t1]
    return [b - a for a, b in zip(ts, ts[1:])]


def zero_disagg_counts(server, b) -> None:
    zero_counts(server)
    server._handoff_times.clear()
    if b._remote is not None:
        for w in b._remote.workers:
            w.replays = w.eager_runs = 0


def read_disagg_counts(server, b) -> dict:
    """``read_counts``, the prefill chunks the workers ran standing in for
    the server's own where prefill is remote."""
    counts = read_counts(server)
    if b._remote is not None:
        counts["replays"] = sum(w.replays for w in b._remote.workers)
        counts["eager"] = sum(w.eager_runs for w in b._remote.workers) + counts["eager"]
    return counts


def import_cost(b, n_tokens: int) -> dict:
    """The decode side's import of one handoff of ``n_tokens`` tokens, on
    the batcher's pool: a bucket exported from fresh pages (the pow2 cover),
    imported back into them. Device time in turns (``time_turns``: a spin
    kernel ahead, so the launches' host gaps do not count) of four forms of
    the same copy: the served eager import; the same copy over each
    tensor's own elements; and two CUDA graphs of it captured here for this
    bucket alone, ``graph`` (the copies from a landing buffer at a fixed
    address: what a graph import costs if the bucket already lay there) and
    ``graph+land`` (the bucket copied into the landing buffer first: what a
    graph import costs when each handoff brings a fresh bucket, as the
    workers' do); each form's host enqueue time, and the host time of one
    served call. Launches a call: the kernel nodes of the captured copies
    (a capture holds every launch; torch.profiler drops events, its count
    is kept beside) plus the one copy of the targets to the card. Bounds,
    bytes over the card's rate: the valid pages (their bucket rows read,
    the pages written: what the function needs) and the whole bucket (what
    it moves, its TRASH rows too). The pages are freed after."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.transformer import NULL_PAGE, RESERVED_PAGES, TRASH_PAGE
    from seldon_core_tpu_torch.servers.llmserver import _page_words

    R = RESERVED_PAGES
    n = -(-n_tokens // b.page_size)
    pages = b._allocator.alloc(n)
    graphs = []
    try:
        bucket, _ = b._export_pages(pages)
        m = bucket[0][0].shape[0] - R
        row = np.full((b.n_pages,), NULL_PAGE, np.int64)
        row[:n] = pages
        imp = b.server._get_handoff_import(b.n_pages, m)
        tgt = np.where(np.arange(m) < n, row[:m], TRASH_PAGE).astype(np.int64)
        tgt_dev = torch.from_numpy(tgt).cuda()
        land = [tuple(t.clone() for t in layer) for layer in bucket]

        def call():
            imp(b._caches, bucket, row, n)

        def native():   # the same copy, each tensor over its own elements
            idx = torch.from_numpy(tgt).pin_memory().to("cuda", non_blocking=True)
            for pool_layer, staged_layer in zip(b._caches, bucket):
                for pool, st in zip(pool_layer, staged_layer):
                    pool.index_copy_(0, idx, st[R:R + m])

        def copies():   # the import's copies from the landing buffer
            for pool_layer, staged_layer in zip(b._caches, land):
                for pool, st in zip(pool_layer, staged_layer):
                    _page_words(pool).index_copy_(0, tgt_dev, _page_words(st)[R:R + m])

        def landed():   # the fresh bucket into the landing buffer, then the copies
            for dst_layer, src_layer in zip(land, bucket):
                for dst, src in zip(dst_layer, src_layer):
                    dst.copy_(src)
            copies()

        stream = torch.cuda.Stream()
        for fn in (copies, landed):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                fn()
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph(keep_graph=True)
            # thread-local: the service's threads stay live meanwhile
            with torch.cuda.graph(g, stream=stream, capture_error_mode="thread_local"):
                fn()
            graphs.append(g)
        nodes = [[kind for _, kind in graph_node_list(g)] for g in graphs]
        (dev_ms, enq_ms), (native_ms, _), (graph_ms, graph_enq), (land_ms, land_enq) = \
            time_turns([call, native, graphs[0].replay, graphs[1].replay])
        host_ms, _, ops, _ = profile_step(call, "-")
        torch.cuda.synchronize()
    finally:
        for g in graphs:
            g.reset()
        b._allocator.free(pages)
    n_tensors = sum(len(layer) for layer in bucket)
    page_bytes = sum(t[0].numel() * t.element_size() for layer in bucket for t in layer)
    return {"pages": n, "bucket_pages": m, "bucket_bytes": page_bytes * (m + R),
            "dev_ms": dev_ms, "native_ms": native_ms, "enqueue_ms": enq_ms, "host_ms": host_ms,
            "graph_ms": graph_ms, "graph_enqueue_ms": graph_enq, "land_ms": land_ms,
            "land_enqueue_ms": land_enq, "land_nodes": len(nodes[1]),
            "land_max_bytes": page_bytes * (R + b.n_pages),
            "bound_ms": 2 * n * page_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_bucket_ms": 2 * m * page_bytes / HBM_BYTES_PER_S * 1e3,
            "launches": len(nodes[0]) + 1, "kernel_nodes": nodes[0].count("kernel"),
            "n_tensors": n_tensors,
            "profiler_launches": sum(e.count for e in ops),
            "kernels": sorted({e.key for e in ops})}


def handoff_split(label: str, b) -> dict:
    """Every timeline in ``b``'s recorder (a remote-prefill batcher): the
    handoff events ``handoff_staged``, ``handoff_compute``,
    ``handoff_transfer``, ``handoff_import`` in that order, then
    ``first_token``. Returns the medians (ms) of: staged to the worker's
    start, the worker's compute, compute end to the transfer's start
    (network: the frame's encode and the wire), the transfer (device: the
    move's enqueue; network: the receiver's decode and copies), its end to
    the import's start (until the loop takes the handoff), the import, and
    the import's end to the first token, over the timelines after the
    first (the service's warm-up request), and the sum of the three walls
    the handoff wall (``_handoff_times``) is made of: compute, transfer,
    import."""
    stages = ["handoff_staged", "handoff_compute", "handoff_transfer", "handoff_import"]
    keys = ("wait_ms", "compute_ms", "ship_ms", "transfer_ms", "pickup_ms", "import_ms",
            "commit_ms")
    rows = {k: [] for k in keys}
    tls = b._flight.timelines(256)
    rows["wall_ms"] = []
    for j, tl in enumerate(tls):
        kinds = [e["kind"] for e in tl["events"]]
        if [k for k in kinds if k.startswith("handoff")] != stages or \
                kinds.index("handoff_import") > kinds.index("first_token"):
            fail(f"[{label}] a remote request's events {kinds}")
        if j == 0:
            continue  # the warm-up request
        ev = {e["kind"]: e for e in tl["events"]}
        st, co, tr, im = (ev[k] for k in stages)
        for key, v in zip(keys, (co["t_s"] - co["dur_s"] - st["t_s"], co["dur_s"],
                                 tr["t_s"] - tr["dur_s"] - co["t_s"], tr["dur_s"],
                                 im["t_s"] - im["dur_s"] - tr["t_s"], im["dur_s"],
                                 ev["first_token"]["t_s"] - im["t_s"])):
            rows[key].append(v * 1e3)
        rows["wall_ms"].append((co["dur_s"] + tr["dur_s"] + im["dur_s"]) * 1e3)
    return dict({k: statistics.median(v) for k, v in rows.items()}, n=len(tls) - 1)


def disagg_run(label: str, card: str, server, texts, quantized: bool, int8_kv: bool,
               **batcher_kw):
    """``texts`` over REST (``POST /v1/generate``, all at once) on a new
    8-slot service with ``batcher_kw`` (disaggregation and the transport).
    Counts zeroed just before, read just after, checked against the chunks
    the prompts make (every chunk a replay: the batcher's own graphs, or a
    worker's). Returns (served tokens, counts, metrics: TTFT, the decode
    step gaps while admissions run, the handoff walls and bytes, and with
    remote prefill the workers' staging and graph-pool bytes, the import's
    cost and, over the network, the frame numbers and the scrape)."""
    import torch

    from seldon_core_tpu_torch.codec import framing

    svc, httpd, url, build_s, drains, commits = disagg_service(label, server, **batcher_kw)
    b = svc.batcher
    m = {"build_s": build_s}
    try:
        zero_disagg_counts(server, b)
        framing.frame_stats()
        del drains[:], commits[:]
        h0 = b.handoff_stats()   # the warm-up request's handoff is not this run's
        t0 = time.perf_counter()
        results, m["wall_s"] = post_all(url, texts)
        counts = read_disagg_counts(server, b)
        gaps = gaps_in(drains, t0, max(commits))
        h1 = b.handoff_stats()
        m.update(ttft_med_ms=statistics.median(server._ttft_times) * 1e3,
                 ttft_max_ms=max(server._ttft_times) * 1e3, gaps=len(gaps),
                 gap_p50_ms=pctl(gaps, 0.5) * 1e3, gap_p99_ms=pctl(gaps, 0.99) * 1e3,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                 handoff={k: h1[k] - h0[k] for k in h1 if k.endswith("_total")},
                 network_total=h1["handoff_network_bytes_total"])
        if b._remote is not None:
            walls = sorted(server._handoff_times)
            ws = b._remote.workers
            m.update(handoff_med_ms=statistics.median(walls) * 1e3, handoff_max_ms=walls[-1] * 1e3,
                     staging_gb=[w.staging_bytes() / 1e9 for w in ws],
                     graph_gb=[graph_pool_gb(w.graphs().values()) for w in ws],
                     shared_weights=all(w._params is server._module for w in ws) and all(
                         p.data_ptr() == q.data_ptr() for w in ws for p, q in zip(
                             w._params.parameters(), server._module.parameters())))
            if not m["shared_weights"]:
                fail(f"[{label}] a worker on the server's card holds weights of its own")
            if b._flight is not None:
                m["split"] = handoff_split(label, b)
                sp = m["split"]
                print(f"[{label}] traced: every timeline's handoff events staged, compute, "
                      f"transfer, import in that order, then its first token; the handoff "
                      f"split, median of {sp['n']} requests (host walls, ms): staged to the "
                      f"worker's start {sp['wait_ms']:.2f}, compute (the chunks and the "
                      f"first token's sync) {sp['compute_ms']:.2f}, compute end to the "
                      f"transfer's start {sp['ship_ms']:.2f}, transfer {sp['transfer_ms']:.2f}, "
                      f"to the import's start {sp['pickup_ms']:.2f}, import (host enqueue) "
                      f"{sp['import_ms']:.2f}, to the first token {sp['commit_ms']:.2f}; "
                      f"compute + transfer + import median {sp['wall_ms']:.2f} beside the "
                      f"handoff wall median {statistics.median(server._handoff_times) * 1e3:.2f}"
                      f" [{card}]", flush=True)
            m["import"] = import_cost(b, max(len(prompt_ids(server, t)) for t in texts))
            if b.handoff_transport == "network":
                st = framing.frame_stats()
                n = max(m["handoff"]["handoffs_total"], 1)
                m.update(frame_bytes=m["handoff"]["handoff_network_bytes_total"] / n,
                         encode_ms=statistics.median(st["frame_encode_times_s"]) * 1e3,
                         decode_ms=statistics.median(st["frame_decode_times_s"]) * 1e3,
                         scraped=sample(scrape(url), "seldon_llm_handoff_network_bytes_total"))
                if m["scraped"] != m["network_total"]:
                    fail(f"[{label}] scraped network bytes {m['scraped']} != the receiver's "
                         f"{m['network_total']}")
                # the same requests again: the pinned host buffers of each
                # frame size are cached now (a first allocation pins pages)
                server._ttft_times.clear()
                again, _ = post_all(url, texts)
                st = framing.frame_stats()
                m.update(warm_ttft_med_ms=statistics.median(server._ttft_times) * 1e3,
                         warm_ttft_max_ms=max(server._ttft_times) * 1e3,
                         warm_encode_ms=statistics.median(st["frame_encode_times_s"]) * 1e3)
                if served_tokens(label, again) != served_tokens(label, results):
                    fail(f"[{label}] the repeated requests gave other tokens")
    finally:
        stop_service(label, server, svc, httpd)
    served = served_tokens(label, results)
    chunks = [c for t in texts for c in chunks_of(b, len(prompt_ids(server, t)))]
    check_launches(label, card, counts, chunks, quantized, int8_kv, eager=False)
    if b._remote is not None and m["handoff"]["handoffs_total"] != len(texts):
        fail(f"[{label}] {m['handoff']['handoffs_total']} handoffs for {len(texts)} requests")
    return served, counts, m


def burst_texts():
    """(b)'s stream prompts (124 tokens each) and burst prompts."""
    return ([prompt_text(200 + i) for i in range(DISAGG_STREAMS)],
            [prompt_text(300 + i, n) for i, n in enumerate(DISAGG_BURST)])


def burst_run(label: str, card: str, server, **batcher_kw):
    """(b) DISAGG_STREAMS streams of DISAGG_STREAM_NEW tokens over REST,
    then, once all decode, the burst (DISAGG_BURST prompts at once) on a
    DISAGG_SLOTS_B-slot service: the decode step gaps before the burst and
    while it is admitted (from the burst to its last first token), and the
    burst's TTFT. Returns (stream tokens, burst tokens, counts, metrics)."""
    svc, httpd, url, build_s, drains, commits = disagg_service(
        label, server, slots=DISAGG_SLOTS_B, **batcher_kw)
    b = svc.batcher
    streams, burst = burst_texts()
    out = [None] * DISAGG_STREAMS

    def stream(i):
        out[i] = post(url + "/v1/generate", {"prompt": streams[i],
                                            "max_new_tokens": DISAGG_STREAM_NEW})

    try:
        zero_disagg_counts(server, b)
        threads = [threading.Thread(target=stream, args=(i,)) for i in range(DISAGG_STREAMS)]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 120
        while not (len(commits) >= DISAGG_STREAMS
                   and sum(d > commits[DISAGG_STREAMS - 1] for d in drains) >= 20):
            if time.perf_counter() > deadline:
                fail(f"[{label}] the streams did not all start decoding")
            time.sleep(0.005)
        t_ready = commits[DISAGG_STREAMS - 1]
        server._ttft_times.clear()
        t_b = time.perf_counter()
        results, _ = post_all(url, burst)
        for t in threads:
            t.join(600)
        counts = read_disagg_counts(server, b)
        steady = gaps_in(drains, t_ready, t_b)
        during = gaps_in(drains, t_b, max(commits))
        m = {"build_s": build_s, "steady_p50_ms": pctl(steady, 0.5) * 1e3,
             "gap_p50_ms": pctl(during, 0.5) * 1e3, "gap_p99_ms": pctl(during, 0.99) * 1e3,
             "gap_max_ms": max(during) * 1e3 if during else float("nan"), "gaps": len(during),
             "ttft_med_ms": statistics.median(server._ttft_times) * 1e3,
             "ttft_max_ms": max(server._ttft_times) * 1e3,
             "window_s": max(commits) - t_b}
    finally:
        stop_service(label, server, svc, httpd)
    for i, res in enumerate(out):
        if res is None or res[0] != 200 or len(res[1].get("tokens", ())) != DISAGG_STREAM_NEW:
            fail(f"[{label}] stream {i}: {res and (res[0], str(res[1])[:200])}")
    stream_tokens = [res[1]["tokens"] for res in out]
    burst_tokens = served_tokens(label, results)
    chunks = [c for t in streams + burst for c in chunks_of(b, len(prompt_ids(server, t)))]
    check_launches(label, card, counts, chunks, False, False, eager=False)
    return stream_tokens, burst_tokens, counts, m


def chat_run(label: str, card: str, server, stages, **batcher_kw):
    """(e) The chat's stages over REST on an 8-slot service with the trie
    on: stage i's token-id prompts are ``stages(i, tokens so far)``, sent at
    once; per stage the prefill chunks run (the batcher's graphs, or the
    workers') and the trie's hit tokens after it. Returns (prompts and
    tokens per stage, chunks per stage, hit tokens per stage, counts)."""
    svc, httpd, url, _, _, _ = disagg_service(label, server, **batcher_kw)
    b = svc.batcher
    prompts, toks, chunks, hits = [], [], [], []
    try:
        server.clear_prefix_cache()   # nothing of the warm-up request stays cached
        zero_disagg_counts(server, b)
        for i in range(3):
            prompts.append(stages(i, toks))
            before = read_disagg_counts(server, b)
            results, _ = post_all(url, prompts[-1])
            toks.append(served_tokens(label, results))
            after = read_disagg_counts(server, b)
            chunks.append(after["replays"] + after["eager"] - before["replays"] - before["eager"])
            hits.append(b._radix.stats()["prefix_hit_tokens"])
        counts = read_disagg_counts(server, b)
        server.clear_prefix_cache()   # the trie's pages back to the pool
    finally:
        stop_service(label, server, svc, httpd)
    return (prompts, toks), chunks, hits, counts


def disagg_phase(card: str, traced_only: bool = False):
    """The disaggregation slice on this card at Llama-2-7B width and depth
    (``load_llm``: random weights from a seed), every service through the
    component app's ``POST /v1/generate``:

    (a) the 8 DISAGG_LENGTHS prompts on a bf16 server, local chunked
        prefill, then ``remote_prefill`` with one worker (device transport):
        tokens equal to local (or a near-tie) and teacher-forced; TTFT, the
        decode step gaps while the admissions run, the handoff walls, the
        bucket bytes, the staging pool and the worker graph pool, the
        import's cost (device time, launches, host time);
    (c) the same prompts over the network transport (127.0.0.1): tokens,
        frame bytes, encode and decode time a handoff, the scraped network
        bytes;
    (b) the burst over live decode: local, then remote with 1 and 2 workers,
        DISAGG_B_ROUNDS rounds (the settings' order reversed every other);
    (e) the chat with the trie on, local and remote: chunks a stage, hit
        tokens, tokens;
    (d) int8 weights + int8 KV: local, then remote, tokens.

    The remote runs of (a) and (c) run traced (``traced``): their batchers
    carry flight recorders, whose timelines ``handoff_split`` checks and
    splits. ``traced_only`` stops after them (``--tracing``).

    Returns the launch records of every served run (counts zeroed just
    before each, read just after) and the metrics."""
    import gc

    import torch

    t_phase = time.perf_counter()
    records, runs = [], {}
    release_server_memory()
    server, _ = load_llm("disagg bf16", card, {})
    texts = [prompt_text(100 + i, n) for i, n in enumerate(DISAGG_LENGTHS)]
    local, counts, runs["a local"] = disagg_run("disagg (a) local", card, server, texts,
                                                False, False, disaggregation="off")
    records.append(("disagg (a) local", counts))
    for key, kw in (("a remote", dict(prefill_workers=1)),
                    ("c network", dict(prefill_workers=1, handoff_transport="network"))):
        lab = f"disagg ({key})"
        with traced():   # the batcher built with a flight recorder: handoff_split
            served, counts, runs[key] = disagg_run(lab, card, server, texts, False, False,
                                                   disaggregation="remote_prefill", **kw)
        records.append((lab, counts))
        runs[key]["equal"] = near_tie_check(lab, card, server, texts, served, local)
        if key == "a remote":
            teacher_check(lab, card, server, texts, served)
        gc.collect()
        torch.cuda.empty_cache()
    if traced_only:
        del server
        release_server_memory()
        return records, runs
    # [controlplane] (c): rebalance_disagg under the autoscaler, on this server
    records.append(("controlplane (c)", controlplane_rebalance(card, server, texts, local)))
    streams, burst = burst_texts()
    base = None
    settings = (("b local", dict(disaggregation="off")),
                ("b remote 1", dict(disaggregation="remote_prefill", prefill_workers=1)),
                ("b remote 2", dict(disaggregation="remote_prefill", prefill_workers=2)))
    for rnd in range(DISAGG_B_ROUNDS):
        for key, kw in (settings if rnd % 2 == 0 else settings[::-1]):
            lab = f"disagg ({key}, round {rnd})"
            st, bt, counts, m = burst_run(lab, card, server, **kw)
            records.append((lab, counts))
            if base is None:
                base = (st, bt)
            else:
                m["equal"] = (near_tie_check(lab, card, server, streams, st, base[0])
                              + near_tie_check(lab, card, server, burst, bt, base[1]))
            runs.setdefault(key, []).append(m)
            gc.collect()
            torch.cuda.empty_cache()
    # (e): conversation 0's turn 1 alone (it fills the trie), the other turn
    # 1s (hits on the system prompt), then every turn 2 (hits on the system
    # prompt and its own turn 1), built on the local run's answers
    server.prefix_cache_size = PREFIX_CACHE_SIZE
    system = prompt_ids(server, prompt_text(400, PREFIX_SYSTEM))
    turn1 = [system + prompt_ids(server, prompt_text(410 + c, PREFIX_USER))
             for c in range(DISAGG_CHATS)]
    user2 = [prompt_ids(server, prompt_text(420 + c, PREFIX_USER)) for c in range(DISAGG_CHATS)]
    answers = {}

    def stages(i, toks):
        if i < 2:
            return turn1[:1] if i == 0 else turn1[1:]
        ans = answers.get("local") or (toks[0] + toks[1])
        return [turn1[c] + ans[c] + user2[c] for c in range(DISAGG_CHATS)]

    chats = {}
    for key, kw in (("e local", dict(disaggregation="off")),
                    ("e remote", dict(disaggregation="remote_prefill", prefill_workers=1))):
        lab = f"disagg ({key})"
        chats[key] = chat_run(lab, card, server, stages, **kw)
        records.append((lab, chats[key][3]))
        if key == "e local":
            answers["local"] = chats[key][0][1][0] + chats[key][0][1][1]
    server.prefix_cache_size = 0
    (prompts_e, toks_r), (_, toks_l) = chats["e remote"][0], chats["e local"][0]
    runs["e"] = {"chunks": {k: v[1] for k, v in chats.items()},
                 "hits": {k: v[2] for k, v in chats.items()},
                 "equal": sum(near_tie_check("disagg (e) remote", card, server, p, got, want)
                              for p, got, want in zip(prompts_e, toks_r, toks_l)),
                 "n": DISAGG_CHATS * 2}
    full = [sum(-(-len(p) // PREFILL_CHUNKS[-1]) for p in stage) for stage in prompts_e]
    if not all(r < f for r, f in zip(runs["e"]["chunks"]["e remote"][1:], full[1:])):
        fail(f"[disagg (e) remote] chunks a stage {runs['e']['chunks']['e remote']}: the "
             f"hits did not prefill their suffixes only (cold: {full})")
    runs["e"]["cold_chunks"] = full
    del server
    release_server_memory()
    server, _ = load_llm("disagg int8", card, dict(quantize="int8", kv_cache_dtype="int8"))
    local8, counts, runs["d local"] = disagg_run("disagg (d) local", card, server, texts,
                                                 True, True, disaggregation="off")
    records.append(("disagg (d) local", counts))
    served, counts, runs["d remote"] = disagg_run("disagg (d) remote", card, server, texts,
                                                  True, True, disaggregation="remote_prefill",
                                                  prefill_workers=1)
    records.append(("disagg (d) remote", counts))
    runs["d remote"]["equal"] = near_tie_check("disagg (d) remote", card, server, texts, served,
                                               local8)
    del server
    release_server_memory()
    runs["phase_s"] = time.perf_counter() - t_phase
    return records, runs


def print_disagg(card: str, runs: dict) -> None:
    """The disaggregation phase's lines, each beside the card."""
    def ms(x):
        return f"{x:.1f}"

    def gap_tail(r):   # p50 / p99 of the gaps, and what the p99 is
        n = r["gaps"]
        return (f"{r['gap_p50_ms']:.2f} / {r['gap_p99_ms']:.2f} ms ("
                + (f"{n} gaps, so the p99 is their max)" if n < 100 else f"{n} gaps)"))

    a_loc, a_rem, net = runs["a local"], runs["a remote"], runs["c network"]
    print(f"[disagg (a)] Llama-2-7B bf16, {N_REQUESTS} requests of {list(DISAGG_LENGTHS)} tokens "
          f"at once over REST, 8 slots: TTFT median / max local chunked prefill "
          f"{ms(a_loc['ttft_med_ms'])} / {ms(a_loc['ttft_max_ms'])} ms, remote_prefill (1 "
          f"worker, device transport) {ms(a_rem['ttft_med_ms'])} / {ms(a_rem['ttft_max_ms'])} "
          f"ms; decode step gap while the admissions run p50 / p99 local "
          f"{gap_tail(a_loc)}, remote {gap_tail(a_rem)}; "
          f"handoff wall median / max {ms(a_rem['handoff_med_ms'])} / "
          f"{ms(a_rem['handoff_max_ms'])} ms; bucket bytes a handoff "
          f"{a_rem['handoff']['handoff_transfer_bytes_total'] / N_REQUESTS / 1e6:.1f} MB; tokens "
          f"equal to local {a_rem['equal']} of {N_REQUESTS}; peak memory local "
          f"{a_loc['peak_gb']:.2f} GB, remote {a_rem['peak_gb']:.2f} GB; worker staging pool "
          f"{a_rem['staging_gb'][0]:.3f} GB, worker graph pool {gb_text(a_rem['graph_gb'][0])}; "
          f"the worker's weights are the server's tensors (data_ptr equal) [{card}]", flush=True)
    for tag, r in (("(a)", a_rem), ("(d) int8", runs["d remote"])):
        imp = r["import"]
        print(f"[disagg {tag}] the import of one handoff of {imp['pages']} pages (bucket of "
              f"{imp['bucket_pages']}, {imp['bucket_bytes'] / 1e6:.1f} MB), device time in "
              f"turns behind a spin kernel, median of {REPS}: served eager {imp['dev_ms']:.4f} "
              f"ms (pages as 8-byte words; each tensor's own elements {imp['native_ms']:.4f}); "
              f"as a CUDA graph from a landing buffer {imp['graph_ms']:.4f} ms, with the fresh "
              f"bucket copied into it first {imp['land_ms']:.4f} ms ({imp['land_nodes']} nodes); "
              f"bound {imp['bound_ms']:.4f} ms for the {imp['pages']} valid pages, "
              f"{imp['bound_bucket_ms']:.4f} ms for the whole bucket (bytes); host enqueue eager "
              f"{imp['enqueue_ms']:.4f} ms (a call with the card drained {imp['host_ms']:.4f}), "
              f"graph {imp['graph_enqueue_ms']:.4f}, graph with the landing copy "
              f"{imp['land_enqueue_ms']:.4f}; landing buffer {imp['bucket_bytes'] / 1e6:.1f} MB "
              f"for this bucket, {imp['land_max_bytes'] / 1e6:.1f} MB for the largest; "
              f"{imp['launches']} launches a call ({imp['kernel_nodes']} kernel nodes in a "
              f"capture of the copies of {imp['n_tensors']} pool tensors, + the targets' copy "
              f"to the card; torch.profiler saw {imp['profiler_launches']}, it drops events) "
              f"[{card}]", flush=True)
    print(f"[disagg (c)] network transport over 127.0.0.1, the same prompts: tokens equal to "
          f"local {net['equal']} of {N_REQUESTS}; TTFT median / max {ms(net['ttft_med_ms'])} / "
          f"{ms(net['ttft_max_ms'])} ms, the same requests again (pinned buffers cached) "
          f"{ms(net['warm_ttft_med_ms'])} / {ms(net['warm_ttft_max_ms'])} ms; frame bytes a "
          f"handoff {net['frame_bytes'] / 1e6:.1f} MB; encode {net['encode_ms']:.2f} ms (again "
          f"{net['warm_encode_ms']:.2f}), decode {net['decode_ms']:.2f} ms a handoff "
          f"(median); handoff wall median / max {ms(net['handoff_med_ms'])} / "
          f"{ms(net['handoff_max_ms'])} ms; seldon_llm_handoff_network_bytes_total "
          f"{net['scraped']:.0f} (scraped) [{card}]", flush=True)
    for key in ("b local", "b remote 1", "b remote 2"):
        for rnd, r in enumerate(runs[key]):
            eq = (f"; tokens equal to local {r['equal']} of {DISAGG_SLOTS_B}" if "equal" in r
                  else "")
            print(f"[disagg ({key}, round {rnd})] {DISAGG_STREAMS} streams x "
                  f"{DISAGG_STREAM_NEW} tokens decoding, then {len(DISAGG_BURST)} prompts of "
                  f"{list(DISAGG_BURST)} tokens at once, {DISAGG_SLOTS_B} slots: decode step gap "
                  f"before the burst p50 {r['steady_p50_ms']:.2f} ms, during it p50 / p99 "
                  f"{gap_tail(r)} over {r['window_s']:.3f} s; burst TTFT median / max "
                  f"{ms(r['ttft_med_ms'])} / {ms(r['ttft_max_ms'])} ms{eq} [{card}]", flush=True)
        rs = runs[key]
        print(f"[disagg ({key})] over {len(rs)} rounds: gap during the burst p50 "
              f"{[round(r['gap_p50_ms'], 2) for r in rs]} ms (median "
              f"{statistics.median(r['gap_p50_ms'] for r in rs):.2f}), max "
              f"{[round(r['gap_max_ms'], 2) for r in rs]} ms (gaps {[r['gaps'] for r in rs]}); "
              f"burst TTFT median {[round(r['ttft_med_ms'], 1) for r in rs]} ms, max "
              f"{[round(r['ttft_max_ms'], 1) for r in rs]} ms [{card}]", flush=True)
    e = runs["e"]
    print(f"[disagg (e)] {DISAGG_CHATS} chats over one {PREFIX_SYSTEM}-token system prompt, the "
          f"trie on: prefill chunks a stage (turn 1 of chat 0; the other turn 1s; every turn 2) "
          f"local {e['chunks']['e local']}, remote {e['chunks']['e remote']} (cold "
          f"{e['cold_chunks']}); hit tokens after each stage local {e['hits']['e local']}, "
          f"remote {e['hits']['e remote']}; tokens equal to local {e['equal']} of {e['n']} "
          f"[{card}]", flush=True)
    d_loc, d_rem = runs["d local"], runs["d remote"]
    print(f"[disagg (d)] int8 weights + int8 KV, the (a) prompts: tokens equal to local "
          f"{d_rem['equal']} of {N_REQUESTS}; TTFT median / max local {ms(d_loc['ttft_med_ms'])} / "
          f"{ms(d_loc['ttft_max_ms'])} ms, remote {ms(d_rem['ttft_med_ms'])} / "
          f"{ms(d_rem['ttft_max_ms'])} ms; gap while admitting p50 / p99 local "
          f"{gap_tail(d_loc)}, remote {gap_tail(d_rem)}; bucket bytes a handoff "
          f"{d_rem['handoff']['handoff_transfer_bytes_total'] / N_REQUESTS / 1e6:.1f} MB; "
          f"worker staging pool {d_rem['staging_gb'][0]:.3f} GB, graph pool "
          f"{gb_text(d_rem['graph_gb'][0])} [{card}]", flush=True)
    print(f"[disagg] phase_s {runs['phase_s']:.1f} [{card}]", flush=True)


# ---------------------------------------------------------------------------
# [controlplane]: the autoscaler over the fleet, canary and shadow routing,
# rebalance_disagg on this card, validate / render / operator
# ---------------------------------------------------------------------------
CP_FLOOD = 3 * N_REQUESTS      # (a): the flood that holds queued work / slot >= 1
CP_CANARY_LATENCY_S = 0.05     # (b): the faulty candidate's added latency
CP_CANARY_REQUESTS = 40        # (b): one-image predictions a healthy candidate holds through
CP_CANARY_MAX = 96             # (b): the slowed candidate's, at most, until it rolls back
CP_STREAM_NEW = 256            # (c): the streams decoding through each swap


class _ShiftedClock:
    """The host's clock plus what a FaultClock has been advanced by: the
    engine times each routed branch on it, so a FaultyComponent's injected
    latency adds to the branch's real wall."""

    def __init__(self, fault_clock):
        self.fault_clock = fault_clock
        self.start = fault_clock.now()

    def __call__(self) -> float:
        return time.perf_counter() + (self.fault_clock.now() - self.start)


def controlplane_fleet(card: str, rs, replicas, url: str) -> dict:
    """[controlplane] (a), on the fleet phase's ReplicaSet after its faults
    part: both batchers rebuilt greedy, the fleet's health state reset, then
    an ``Autoscaler`` (min 2, max 3 replicas, up after 2 ticks over one
    queued request a slot, down after 2 ticks under 0.25, a 30 s cooldown on
    a FaultClock) ticked by hand:

    - a flood of CP_FLOOD requests over REST holds queued work per slot >= 1
      for 2 ticks: SCALE_UP builds a third int8 replica from the same seed
      (its weights equal replica 0's leaf by leaf), which takes a wave of
      N_REQUESTS requests sent while the flood decodes, every chunk and
      step of it a replay;
    - quiet: SCALE_DOWN drains the newest replica, collected on its second
      idle sighting;
    - a ``BatcherKiller`` kills replica 0 under N_REQUESTS requests (they
      resume on the survivor): the next tick is SCALE_UP with "ejected" in
      its reason, and the warm spare (the collected third replica) comes
      back and serves a wave;
    - every request answers 200 with MAX_NEW tokens, equal to one server's
      run of the same requests up to a near-tie; the fleet app's /metrics
      carries ``seldon_autoscaler_*`` with the applied actions' tallies.

    Returns the launches of the part (counts zeroed just before its first
    request, read after its last)."""
    import inspect

    import torch

    from seldon_core_tpu_torch.controlplane.autoscaler import (SCALE_DOWN, SCALE_UP,
                                                               Autoscaler, AutoscalerConfig)
    from seldon_core_tpu_torch.observability.timeline import scaling_snapshot
    from seldon_core_tpu_torch.runtime.resilience import RetryBudget
    from seldon_core_tpu_torch.servers.llmserver import LLMServer
    from seldon_core_tpu_torch.testing.faults import BatcherKiller, FaultClock

    label = "controlplane (a)"
    t_part = time.perf_counter()
    # the fleet as the chat left it: greedy batchers, nobody ejected
    for r in replicas:
        if r._batcher_service is not None:
            r._batcher_service.close()
            r._batcher_service = None
    with rs._lock:
        rs._ejected.clear()
        rs._draining.clear()
        rs._idle_once.clear()
        rs._health.clear()
    rs.clock = time.monotonic
    rs.retry_budget = RetryBudget(ratio=1.0, min_retries=4 * N_REQUESTS)
    release_server_memory()
    top_k0 = inspect.signature(LLMServer).parameters["top_k"].default
    for i, r in enumerate(replicas):
        r.temperature, r.top_k = 0.0, top_k0
        with r._lock:
            r._decode_cache.clear()
        _, httpd, _, _ = build_service(f"{label} replica {i}", r)
        httpd.shutdown()
        httpd.server_close()
    base = list(replicas)
    ref_leaves = [*base[0]._module.parameters(), *base[0]._module.buffers()]
    spares, built = [], []

    def factory():
        if spares:
            return spares.pop()
        t0 = time.perf_counter()
        r = LLMServer(model="transformer", model_kwargs=dict(LLAMA2_7B, fused_norm=True),
                      init_random=True, param_dtype="auto", continuous_batching=N_REQUESTS,
                      max_new_tokens=MAX_NEW, temperature=0.0, eos_id=-1, seed=0,
                      device="cuda", **FLEET_KNOBS)
        r.load()
        leaves = [*r._module.parameters(), *r._module.buffers()]
        if len(leaves) != len(ref_leaves) or not all(torch.equal(x, y)
                                                     for x, y in zip(leaves, ref_leaves)):
            fail(f"[{label}] the factory's replica drew other weights than replica 0")
        built.append(time.perf_counter() - t0)
        replicas.append(r)   # the recording fleet indexes its picks in this list
        return r

    clk = FaultClock()
    # down on queued work alone: the prefix trie keeps finished requests' pages
    auto = Autoscaler(rs, config=AutoscalerConfig(
        min_replicas=2, max_replicas=3, up_queue_per_slot=1.0, up_stable_ticks=2,
        down_queue_per_slot=0.25, down_page_pressure=1.0, down_stable_ticks=2,
        cooldown_s=30.0), replica_factory=factory, clock=clk)
    rs.autoscaler = auto   # the fleet app's scrape reads it (sync_controlplane)
    decisions = []

    def tick():
        d = auto.tick()
        decisions.append((d.action, d.target, d.reason))
        clk.advance(1.0)
        return d

    texts = [prompt_text(700 + i) for i in range(CP_FLOOD)]
    wave = [f"{chr(65 + i)}{chr(97 + i)} " + prompt_text(740 + i) for i in range(N_REQUESTS)]
    killed = [f"{chr(75 + i)}{chr(107 + i)} " + prompt_text(760 + i) for i in range(N_REQUESTS)]
    after = [f"{chr(85 + i % 5)}{chr(117 + i % 5)}{i} " + prompt_text(780 + i)
             for i in range(N_REQUESTS)]
    for r in replicas:
        r.clear_prefix_cache()
    torch.cuda.synchronize()
    zero_kernel_counts()
    out = {}

    def post_bg(key, batch):
        th = threading.Thread(target=lambda: out.__setitem__(key, post_all(url, batch)[0]))
        th.start()
        return th

    # the flood: two ticks while queued work per slot >= 1
    flood = post_bg("flood", texts)
    deadline = time.perf_counter() + 120
    while True:
        snaps = [scaling_snapshot(r) for r in rs.members()]
        queued = sum(s["queue_depth"] + s["active_slots"] for s in snaps)
        if queued >= sum(max(s["total_slots"], 1) for s in snaps):
            break
        if time.perf_counter() > deadline:
            fail(f"[{label}] the flood never filled the fleet's slots ({snaps})")
        time.sleep(0.002)
    t_up = time.perf_counter()
    first, second = tick(), tick()
    up_s = time.perf_counter() - t_up
    if first.action != "hold" or second.action != SCALE_UP or len(rs.members()) != 3:
        fail(f"[{label}] under the flood: {decisions} with {len(rs.members())} replicas")
    third = rs.members()[-1]
    third_rec = len(rs.records)
    wave_th = post_bg("wave", wave)
    flood.join(600)
    wave_th.join(600)
    took = sum(1 for rec in rs.records[third_rec:] if replicas[rec[3]] is third)
    if took == 0 or third._prefill_eager or third._decode_eager or not (
            third._prefill_replays and third._decode_replays):
        fail(f"[{label}] the new replica took {took} requests: chunks "
             f"{third._prefill_replays} replayed / {third._prefill_eager} eager, dispatches "
             f"{third._decode_replays} / {third._decode_eager}")
    # quiet: past the cooldown, two calm ticks drain the newest; collected on
    # its second idle sighting
    clk.advance(31.0)
    tick()
    down = tick()
    drained = rs.draining_members()
    if down.action != SCALE_DOWN or drained != [third] or third not in rs.members():
        fail(f"[{label}] quiet: {decisions[-2:]}, draining {len(drained)}")
    tick()
    if third in rs.members() or third._batcher_service is not None:
        fail(f"[{label}] the drained replica was not collected on its second idle sighting")
    spares.append(third)
    # a kill, then the next tick replaces the dead replica
    clk.advance(31.0)
    victim_b = base[0]._batcher_service.batcher
    killer = BatcherKiller(trigger=lambda b: any(s.active and s.n_new >= 2 for s in b._slots))
    killer.install(victim_b)
    out["killed"] = post_all(url, killed)[0]
    victim_b._chaos = None
    replace = tick()
    if killer.kills != 1 or replace.action != SCALE_UP or "ejected" not in replace.reason or \
            rs.ejected_members() != [base[0]] or third not in rs.members():
        fail(f"[{label}] after the kill ({killer.kills} kills): {decisions[-1]}, ejected "
             f"{len(rs.ejected_members())}, the spare back {third in rs.members()}")
    back_rec = len(rs.records)
    out["after"] = post_all(url, after)[0]
    back = sum(1 for rec in rs.records[back_rec:] if replicas[rec[3]] is third)
    counts = kernel_counts()
    stats = auto.autoscaler_stats()
    samples = scrape(url)
    # every client answered; tokens against one server's run
    served = {k: served_tokens(f"{label} {k}", out[k]) for k in ("flood", "wave", "killed",
                                                                  "after")}
    solo = base[1]._batcher_service
    base[1].clear_prefix_cache()
    equal, n_req = 0, 0
    for key, batch in (("flood", texts), ("wave", wave), ("killed", killed), ("after", after)):
        plain = [f.result(600) for f in [solo.submit(t, MAX_NEW) for t in batch]]
        equal += near_tie_check(f"{label} {key}", card, base[1], batch, served[key], plain)
        n_req += len(batch)
    want = {"scale_up": 2, "scale_down": 1, "collect": 1}
    tallies = {a: stats[f"autoscaler_{a}s_total" if a != "collect" else
                        "autoscaler_collected_total"] for a in want}
    scraped = {a: sample(samples, "seldon_autoscaler_scale_events_total", f'action="{a}"')
               for a in want}
    if tallies != want or scraped != {a: float(v) for a, v in want.items()} or \
            sample(samples, "seldon_autoscaler_replicas") != len(rs.members()):
        fail(f"[{label}] tallies {tallies}, scrape {scraped}, expected {want}")
    if counts["k1"] <= 0 or counts["k2"] <= 0 or counts["k4"] <= 0:
        fail(f"[{label}] launches {counts}")
    del rs.autoscaler
    print(f"[{label}] the autoscaler over the fleet (greedy batchers rebuilt after the faults "
          f"part): a flood of {CP_FLOOD} requests, ticks {[d[0] for d in decisions[:2]]} -> a "
          f"third int8 replica from seed 0 (weights equal to replica 0's leaf by leaf; load "
          f"{built[0]:.2f} s, the scale-up tick {up_s:.2f} s), which took {took} of a wave of "
          f"{N_REQUESTS} (its chunks {third._prefill_replays} and dispatches "
          f"{third._decode_replays} replays, none eager); quiet: {decisions[3][0]} drained it, "
          f"collected on the next tick (its second idle sighting); a BatcherKiller kill of "
          f"replica 0 under {N_REQUESTS} requests, then the next tick: {replace.action} "
          f"('{replace.reason}'), the warm spare back, {back} of {N_REQUESTS} on it; "
          f"{n_req} requests, all 200 with {MAX_NEW} tokens, {equal} equal to one server's "
          f"run (the rest up to a near-tie); tallies = the scrape {scraped}; launches "
          f"{counts}; part_s {time.perf_counter() - t_part:.1f} [{card}]", flush=True)
    return counts


def controlplane_canary(card: str, model) -> int:
    """[controlplane] (b) canary: a ``CanaryRouter`` (fraction 0.25, windows
    of 4, an evaluation every 4 candidate samples, its Mahalanobis detector
    on the card) over two ResNet-50 ``JAX_SERVER`` leaves (``model``, seed
    50, and seed 52, through checkpoints), each wrapped in a
    ``FaultyComponent``; the engine times each routed branch on the host
    clock plus the FaultClock's injected latency. A candidate CP_CANARY_LATENCY_S
    slower rolls back within its evaluation windows: every request 200,
    every later one on the baseline, the candidate untouched after, the
    engine app's /metrics ``seldon_canary_phase`` 2 (within CP_CANARY_MAX
    requests: a first window whose baseline caught a host hiccup may hold).
    An unslowed candidate holds, or promotes after 3 clean evaluations,
    through CP_CANARY_REQUESTS. Each evaluation's wall
    (the fold and the frozen score on the card, with their copies to the
    host) is timed. Returns K3's launches."""
    import tempfile

    import numpy as np
    import torch

    from seldon_core_tpu_torch.analytics.canary import PROMOTED, ROLLED_BACK, CanaryRouter
    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.runtime.engine import GraphEngine
    from seldon_core_tpu_torch.runtime.resilience import ResilienceConfig
    from seldon_core_tpu_torch.servers.torchserver import TorchServer, export_checkpoint
    from seldon_core_tpu_torch.testing.faults import FaultClock, FaultSchedule, FaultyComponent
    from seldon_core_tpu_torch.transport.rest import make_engine_app, start

    label = "controlplane (b) canary"
    t_part = time.perf_counter()
    dev = torch.device("cuda")
    model_b = get_model("resnet50", fused=True, device="cuda")
    model_b.init_params(torch.Generator(device=dev).manual_seed(52))
    with tempfile.TemporaryDirectory(prefix="canary-ckpts-") as root:
        leaves = []
        for name, m in zip(("base", "cand"), (model, model_b)):
            export_checkpoint(os.path.join(root, name), "resnet50", {"params": m.param_tree()},
                              kwargs={"fused": True}, input_shape=[224, 224, 3])
            s = TorchServer(model_uri=os.path.join(root, name), device="cuda")
            s.load()
            leaves.append(s)
    del model_b
    rng = np.random.default_rng(23)
    images = [np.round(rng.standard_normal((1, 224, 224, 3)), 2).astype(np.float32)
              for _ in range(8)]
    graph = {"name": "cr", "type": "ROUTER",
             "children": [{"name": "base", "type": "MODEL"}, {"name": "cand", "type": "MODEL"}]}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per1 = k3_forward_launches(1, sms)
    runs, launches = {}, 0
    for case, latency, kw in (("slow", CP_CANARY_LATENCY_S, {}),
                              ("healthy", 0.0, dict(promote_after=3))):
        fc = FaultClock()
        router = CanaryRouter(fraction=0.25, min_samples=4, eval_every=4, device="cuda", **kw)
        evals = []
        real_eval = router._evaluate_locked

        def timed_eval(_real=real_eval, _evals=evals):
            t0 = time.perf_counter()
            _real()
            _evals.append(time.perf_counter() - t0)

        router._evaluate_locked = timed_eval
        base = FaultyComponent(FaultSchedule.always_ok(), clock=fc, inner=leaves[0])
        cand = FaultyComponent(FaultSchedule.always_ok(latency_s=latency), clock=fc,
                               inner=leaves[1])
        engine = GraphEngine(graph_spec(graph), components={"cr": router, "base": base,
                                                            "cand": cand},
                             resilience=ResilienceConfig(clock=_ShiftedClock(fc)), device="cuda")
        httpd, _ = start(make_engine_app(engine, device="cuda"))
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        routes = []
        for leaf in leaves:   # first-use effects out of the latency windows
            for image in images[:3]:
                leaf.predict(image, [])
        try:
            k3_0 = k3_count()
            n = 0
            for i in range(CP_CANARY_MAX if case == "slow" else CP_CANARY_REQUESTS):
                code, resp = post(url + "/api/v0.1/predictions",
                                  body_for(images[i % len(images)], f"canary-{case}-{i}"))
                if code != 200:
                    fail(f"[{label}] {case} request {i} answered {code}: {resp}")
                routes.append(resp["meta"]["routing"]["cr"])
                n += 1
                if router.phase != "canary":
                    break
            cand_calls = cand.calls
            for i in range(8 if case == "slow" else 0):
                code, resp = post(url + "/api/v0.1/predictions",
                                  body_for(images[i], f"canary-after-{i}"))
                if code != 200 or resp["meta"]["routing"]["cr"] != 0:
                    fail(f"[{label}] after the rollback request {i} answered {code}, routed "
                         f"{resp.get('meta', {}).get('routing')}")
                n += 1
            k3 = k3_count() - k3_0
            samples = scrape(url)
        finally:
            httpd.shutdown()
            httpd.server_close()
        if k3 != n * per1:
            fail(f"[{label}] {case}: {k3} K3 launches for {n} one-image requests, each through "
                 f"its routed leaf: expected {n} x {per1}")
        launches += k3
        phase = sample(samples, "seldon_canary_phase", 'node="cr"')
        stats = router.canary_stats()
        if case == "slow":
            if router.phase != ROLLED_BACK or "outlier" not in router.rollback_reason or \
                    cand.calls != cand_calls or phase != 2 or stats["canary_rollbacks_total"] != 1:
                fail(f"[{label}] the slow candidate: phase {router.phase} "
                     f"({router.rollback_reason!r}), scrape phase {phase}, candidate calls "
                     f"{cand_calls} -> {cand.calls}")
        elif router.phase not in ("canary", PROMOTED) or router.rollbacks_total or not evals:
            fail(f"[{label}] the healthy candidate: phase {router.phase} "
                 f"({router.rollback_reason!r}), {len(evals)} evaluations")
        runs[case] = dict(n=n, routes=routes, phase=router.phase, reason=router.rollback_reason,
                          evals=len(evals), eval_med_ms=statistics.median(evals) * 1e3,
                          eval_max_ms=max(evals) * 1e3, scrape_phase=phase,
                          cand_share=sum(routes) / max(len(routes), 1))
        del engine, router
    for case, r in runs.items():
        print(f"[{label}] {case} candidate ({'+%.0f ms injected' % (CP_CANARY_LATENCY_S * 1e3) if case == 'slow' else 'no added latency'}): "
              f"{r['n']} one-image predictions over REST, all 200, {r['cand_share']:.2f} of the "
              f"canary's routes to the candidate; phase {r['phase']}"
              f"{(' (' + repr(r['reason']) + ')') if r['reason'] else ''} after {r['evals']} "
              f"evaluations, scrape seldon_canary_phase {r['scrape_phase']:.0f}; an evaluation "
              f"(fold + frozen score of the candidate window: the detector's inverse on the "
              f"card, its scores copied to the host, under the router's lock on the serving "
              f"thread) median {r['eval_med_ms']:.3f} ms max {r['eval_max_ms']:.3f} ms [{card}]",
              flush=True)
    print(f"[{label}] K3 launches {launches}; part_s {time.perf_counter() - t_part:.1f} "
          f"[{card}]", flush=True)
    del leaves
    release_server_memory()
    return launches


def controlplane_shadow(card: str, server) -> dict:
    """[controlplane] (b) shadow: a ``ShadowNode`` over the loaded bf16 7B
    server, mirroring every ``/v1/generate`` (no continuous batching: the
    dense ``generate()`` path, its graphs) to a second 7B server loaded from
    the same seed: divergence 0 and the mirrors counted on the scrape; the
    primary alone, then the mirrored node, in turns: the mirror's added
    wall on the primary's request; a shadow that raises on every call never
    reaches the client (200, the primary's tokens, its errors counted).
    Returns the launches of the mirrored requests."""
    from seldon_core_tpu_torch.analytics.canary import ShadowNode
    from seldon_core_tpu_torch.components.component import SeldonComponent
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    class Crasher(SeldonComponent):
        def generate(self, *args, **kwargs):
            raise RuntimeError("the shadow crashed")

    label = "controlplane (b) shadow"
    t_part = time.perf_counter()
    twin, _ = load_llm(f"{label} twin", card, {})
    slots = server.continuous_batching
    server.continuous_batching = 0   # generate(): the primary's own dense path
    texts = [prompt_text(820 + i) for i in range(4)]
    node = ShadowNode(server, twin, mirror_fraction=1.0)
    crash = ShadowNode(server, Crasher(), mirror_fraction=1.0)
    apps = {}
    try:
        for key, comp in (("primary", server), ("mirrored", node), ("crashing", crash)):
            httpd, _ = start(make_component_app(comp, device="cuda"))
            apps[key] = (httpd, f"http://127.0.0.1:{httpd.server_address[1]}")
        # first use captures each server's generate graph: warm both, untimed
        for key in ("primary", "mirrored"):
            post(apps[key][1] + "/v1/generate", {"prompt": texts[0]})
        node.mirrors_total, node.latency_delta_s_sum = 0, 0.0   # the warm-up's mirror
        walls = {"primary": [], "mirrored": []}
        answers = {"primary": [], "mirrored": []}
        zero_kernel_counts()
        for i, text in enumerate(texts):
            for key in (("primary", "mirrored") if i % 2 == 0 else ("mirrored", "primary")):
                t0 = time.perf_counter()
                code, body = post(apps[key][1] + "/v1/generate", {"prompt": text})
                walls[key].append(time.perf_counter() - t0)
                if code != 200 or len(body.get("tokens", ())) != MAX_NEW:
                    fail(f"[{label}] {key} request {i} answered {code}: {str(body)[:200]}")
                answers[key].append(body["tokens"])
        counts = kernel_counts()
        samples = scrape(apps["mirrored"][1])
        code, crashed = post(apps["crashing"][1] + "/v1/generate", {"prompt": texts[1]})
    finally:
        for httpd, _ in apps.values():
            httpd.shutdown()
            httpd.server_close()
        server.continuous_batching = slots
    stats = node.shadow_stats()
    if answers["mirrored"] != answers["primary"] or stats["shadow_mirrors_total"] != len(texts) \
            or stats["shadow_divergences_total"] or stats["shadow_errors_total"]:
        fail(f"[{label}] mirrored answers equal {answers['mirrored'] == answers['primary']}, "
             f"stats {stats}")
    if sample(samples, "seldon_shadow_mirrors_total") != len(texts) or \
            sample(samples, "seldon_shadow_divergences_total") != 0:
        fail(f"[{label}] the scrape's shadow series disagree with {stats}")
    if code != 200 or crashed.get("tokens") != answers["primary"][1] or \
            crash.shadow_stats()["shadow_errors_total"] != 1:
        fail(f"[{label}] with a crashing shadow the client got {code}: {str(crashed)[:200]}")
    if counts["k2"] <= 0:
        fail(f"[{label}] launches {counts}")
    p, m = statistics.median(walls["primary"]), statistics.median(walls["mirrored"])
    print(f"[{label}] a ShadowNode over the bf16 Llama-2-7B server mirroring /v1/generate to a "
          f"second 7B server from the same seed: {len(texts)} requests, {MAX_NEW} tokens each "
          f"equal to the primary's alone, divergences 0, scrape seldon_shadow_mirrors_total "
          f"{len(texts)}; request wall median primary alone {p * 1e3:.1f} ms, mirrored "
          f"{m * 1e3:.1f} ms: the mirror adds {(m - p) * 1e3:.1f} ms on the primary's request "
          f"(the shadow runs after it, on the request's thread; the node's latency delta sum "
          f"{stats['shadow_latency_delta_s_sum'] * 1e3:.1f} ms); a shadow raising on every call: "
          f"200 with the primary's tokens, shadow_errors_total 1; launches {counts}; part_s "
          f"{time.perf_counter() - t_part:.1f} [{card}]", flush=True)
    del node, crash, twin
    release_server_memory()
    return counts


def _hold_pool(pool, held: list):
    """Hold every worker of ``pool`` before each job until the returned
    event is set; ``held`` counts the jobs waiting."""
    gate = threading.Event()
    for w in pool.workers:
        real = w._prefill_one

        def hold(req, _real=real):
            held.append(req.job_id)
            gate.wait(600)
            return _real(req)

        w._prefill_one = hold
    return gate


def local_tokens(label: str, server, texts) -> list:
    """``texts`` over REST through a local (non-disaggregated) service,
    stopped before this returns (so nothing of it outlives the call)."""
    svc, httpd, url, _ = build_service(label, server, disaggregation="off")
    try:
        return served_tokens(label, post_all(url, texts)[0])
    finally:
        stop_service(label, server, svc, httpd)


def controlplane_rebalance(card: str, server, texts, local=None) -> dict:
    """[controlplane] (c) ``rebalance_disagg`` on this card: the bf16 7B
    server disaggregated with 2 prefill workers (service of N_REQUESTS
    slots), an ``Autoscaler(rebalance=True, min_decode_devices=0)`` over
    its scaling snapshot (on one card the snapshot reports one decode
    device, so the default floor of 1 would hold every long mix), ticked
    by hand on a FaultClock. Two streams of CP_STREAM_NEW tokens decode
    through both swaps. Up: the old pool's workers held, the DISAGG_LENGTHS
    burst staged, two long-mix ticks move 2 -> 3 workers (the new pool's
    graphs captured while the streams' decode graphs replay; the held jobs
    released by the old pool's close and published into the same queue);
    a second burst goes to the new workers, every chunk a replay. Down: one
    request held on the 3-worker pool, two quiet ticks move back to 2.
    Every burst request's tokens equal the local run's (``local``, else a
    local service's) up to a near-tie; handoffs = the requests; the queue
    ends empty; the card's memory after the part = before it. Returns the
    launches (counts zeroed before the streams, read after the last
    request)."""
    import gc

    import torch

    import seldon_core_tpu_torch.runtime.batcher as batcher_mod
    from seldon_core_tpu_torch.controlplane.autoscaler import (REBALANCE, Autoscaler,
                                                               AutoscalerConfig)
    from seldon_core_tpu_torch.runtime.engine import ReplicaSet
    from seldon_core_tpu_torch.testing.faults import FaultClock

    label = "controlplane (c)"
    t_part = time.perf_counter()
    if local is None:
        local = local_tokens(f"{label} local", server, texts)
    gc.collect()
    release_server_memory()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    builds = []
    real_pool = batcher_mod.PrefillWorkerPool

    class TimedPool(real_pool):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            builds.append(time.perf_counter() - t0)

    batcher_mod.PrefillWorkerPool = TimedPool
    svc, httpd, url, build_s = build_service(label, server, disaggregation="remote_prefill",
                                             prefill_workers=2)
    b = svc.batcher
    served = False
    swaps, staged_at_swap = [], []
    real_reb = b.rebalance_disagg

    def timed_rebalance(n):
        old = b._remote
        real_close = old.close

        def close(*args, **kwargs):   # the swap is done: release the outgoing pool
            staged_at_swap.append(len(held) + old.backlog_depth())
            gates[-1].set()
            return real_close(*args, **kwargs)

        old.close = close
        t0 = time.perf_counter()
        ok = real_reb(n)
        swaps.append(time.perf_counter() - t0)
        return ok

    b.rebalance_disagg = timed_rebalance
    clk = FaultClock()
    auto = Autoscaler(ReplicaSet([server]), config=AutoscalerConfig(
        min_replicas=1, max_replicas=1, rebalance=True, rebalance_backlog_high=1.0,
        rebalance_backlog_low=1.0, rebalance_stable_ticks=2, rebalance_cooldown_s=30.0,
        min_prefill_devices=1, min_decode_devices=0), clock=clk)
    decisions, held, gates = [], [], []   # decisions: the rebalances actuated
    real_act = auto._actuate_rebalance
    auto._actuate_rebalance = lambda d: (decisions.append(d), real_act(d))[1]

    def tick():
        auto.tick()
        clk.advance(1.0)

    streams = [prompt_text(860 + i) for i in range(2)]
    streamed_n = [0, 0]

    def on_token(i):
        def cb(_tok):
            streamed_n[i] += 1
        return cb

    try:
        h0 = b.handoff_stats()
        torch.cuda.synchronize()
        zero_kernel_counts()
        stream_futs = [svc.submit(t, CP_STREAM_NEW, on_token=on_token(i))
                       for i, t in enumerate(streams)]
        deadline = time.perf_counter() + 120
        while min(streamed_n) < 4:   # both streams decoding
            if time.perf_counter() > deadline:
                fail(f"[{label}] the streams never decoded")
            time.sleep(0.002)
        # up: the burst staged on the held 2-worker pool
        gates.append(_hold_pool(b._remote, held))
        burst = [svc.submit(t, MAX_NEW) for t in texts]
        deadline = time.perf_counter() + 120
        while b.handoff_stats()["handoff_queue_depth"] < 4:
            if time.perf_counter() > deadline:
                fail(f"[{label}] the burst was never staged: {b.handoff_stats()}")
            time.sleep(0.002)
        tick()
        tick()
        if auto.autoscaler_stats()["autoscaler_rebalances_total"] != 1 or \
                len(b._remote.workers) != 3:
            fail(f"[{label}] under the burst the split did not move: "
                 f"{[(d.action, d.target, d.reason) for d in decisions]}")
        pool3 = b._remote
        pool3_bytes = (sum(w.staging_bytes() for w in pool3.workers) / 1e9,
                       graph_pool_gb([g for w in pool3.workers for g in w.graphs().values()]))
        up = [f.result(600) for f in burst]
        second = [f.result(600) for f in [svc.submit(t, MAX_NEW) for t in texts]]
        new_counts = (sum(w.replays for w in pool3.workers),
                      sum(w.eager_runs for w in pool3.workers))
        if new_counts[0] == 0 or new_counts[1]:
            fail(f"[{label}] the new workers' chunks: {new_counts[0]} replays, {new_counts[1]} "
                 f"eager")
        # down: quiet, one job staged on the held 3-worker pool
        held.clear()
        gates.append(_hold_pool(b._remote, held))
        clk.advance(31.0)
        last = svc.submit(texts[0], MAX_NEW)
        while b.handoff_stats()["handoff_queue_depth"] < 1:
            time.sleep(0.002)
        tick()
        tick()
        if auto.autoscaler_stats()["autoscaler_rebalances_total"] != 2 or \
                len(b._remote.workers) != 2:
            fail(f"[{label}] once quiet the split did not move back: "
                 f"{[(d.action, d.target, d.reason) for d in decisions]}")
        down = [last.result(600)]
        streamed = [f.result(600) for f in stream_futs]
        counts = kernel_counts()
        h1 = b.handoff_stats()
        released = all(w._staging is None and not w.graphs() for w in pool3.workers)
        served = True
    finally:
        batcher_mod.PrefillWorkerPool = real_pool
        for g in gates:
            g.set()
        if served:
            stop_service(label, server, svc, httpd)
        else:   # an error above: its own traceback, not the pages it left in flight
            httpd.shutdown()
            httpd.server_close()
            svc.close()
            server._batcher_service = None
    # everything that reaches the batcher (its wrapped method, the futures'
    # done callbacks) goes before the measure
    del b.rebalance_disagg
    del b, svc, auto, pool3, burst, stream_futs, last, real_act, real_reb, timed_rebalance
    gc.collect()
    release_server_memory()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - mem0
    n_req = len(streams) + 2 * len(texts) + 1
    handoffs = h1["handoffs_total"] - h0["handoffs_total"]
    if [(d.action, d.target) for d in decisions] != [(REBALANCE, 3), (REBALANCE, 2)] or \
            staged_at_swap[0] < 1 or staged_at_swap[1] < 1 or not released:
        fail(f"[{label}] decisions {[(d.action, d.target) for d in decisions]}, jobs staged on "
             f"the outgoing pool at each swap {staged_at_swap}")
    if handoffs != n_req or h1["handoff_queue_depth"] != 0:
        fail(f"[{label}] {handoffs} handoffs for {n_req} requests, queue depth "
             f"{h1['handoff_queue_depth']}")
    if any(len(s) != CP_STREAM_NEW for s in streamed):
        fail(f"[{label}] the streams' lengths {[len(s) for s in streamed]}")
    if left > 1 << 20:
        fail(f"[{label}] {left / 1e9:.3f} GB more allocated after the part than before it")
    equal = (near_tie_check(f"{label} up", card, server, texts, up, local)
             + near_tie_check(f"{label} second", card, server, texts, second, local)
             + near_tie_check(f"{label} down", card, server, texts[:1], down, local[:1]))
    if counts["k1"] <= 0 or counts["k2"] <= 0:
        fail(f"[{label}] launches {counts}")
    print(f"[{label}] rebalance_disagg under an Autoscaler(rebalance=True, "
          f"min_decode_devices=0) on the bf16 Llama-2-7B server (service built in "
          f"{build_s:.2f} s with 2 workers): rebalances to {[d.target for d in decisions]} "
          f"('{decisions[0].reason}'; '{decisions[1].reason}'); 2 -> 3 under the burst of "
          f"{len(texts)} with {staged_at_swap[0]} jobs staged on the outgoing pool, 3 -> 2 once "
          f"quiet with {staged_at_swap[1]}; swap walls {' / '.join(f'{s:.3f}' for s in swaps)} "
          f"s (the new pool's build and capture {' / '.join(f'{s:.3f}' for s in builds[1:])} s, "
          f"the rest the old pool's drain and close); the 3-worker pool's staging "
          f"{pool3_bytes[0]:.3f} GB and chunk graphs {gb_text(pool3_bytes[1])}, freed when "
          f"it was swapped out; the new "
          f"workers' chunks {new_counts[0]} replays, 0 eager; {CP_STREAM_NEW}-token streams "
          f"decoded through both swaps; {n_req} requests = {handoffs} handoffs, queue 0; "
          f"{equal} of {2 * len(texts) + 1} burst requests equal to the local run (the rest up "
          f"to a near-tie); allocated after the part {left:+d} bytes; launches {counts}; part_s "
          f"{time.perf_counter() - t_part:.1f} [{card}]", flush=True)
    return counts


def controlplane_host(card: str) -> None:
    """[controlplane] (d) host-only: every ``deploy/examples/*.json``
    through the port's CLI ``render --format json``, then ``operator --once``
    over the same CRs into a temporary FileCluster: the objects equal the
    rendered manifests (with the reconciler's owner label) and every CR's
    status is Available. JSON CRs and JSON output need no PyYAML."""
    import contextlib
    import io
    import shutil
    import tempfile

    from seldon_core_tpu_torch.controlplane.operator import OWNER_LABEL, FileCluster
    from seldon_core_tpu_torch.transport.cli import main as cli

    label = "controlplane (d)"
    t_part = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    examples = os.path.join(here, "deploy", "examples")
    files = sorted(f for f in os.listdir(examples) if f.endswith(".json"))
    want = []
    for fn in files:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(["render", os.path.join(examples, fn), "--format", "json"])
        with open(os.path.join(examples, fn)) as f:
            name = json.load(f)["spec"]["name"]
        for m in json.loads(buf.getvalue()):
            m["metadata"].setdefault("labels", {})[OWNER_LABEL] = name
            want.append(m)
    with tempfile.TemporaryDirectory(prefix="operator-") as root:
        crs = os.path.join(root, "crs")
        shutil.copytree(examples, crs)
        cli(["operator", "--crs", crs, "--cluster", os.path.join(root, "cluster"), "--once"])
        got = FileCluster(os.path.join(root, "cluster")).list()
        states = {}
        for fn in os.listdir(os.path.join(crs, ".status")):
            with open(os.path.join(crs, ".status", fn)) as f:
                states[fn] = json.load(f)["state"]
    key = lambda m: (m["kind"], m["metadata"]["namespace"], m["metadata"]["name"])  # noqa: E731
    if sorted(got, key=key) != sorted(want, key=key) or set(states.values()) != {"Available"} \
            or len(states) != len(files):
        fail(f"[{label}] the operator's objects differ from render's, or statuses {states}")
    try:
        import yaml  # noqa: F401
        has_yaml = "present"
    except ImportError:
        has_yaml = "absent"
    print(f"[{label}] {len(files)} example CRs rendered through the port's CLI (render --format "
          f"json: {len(want)} manifests, nvidia.com/gpu requested) and reconciled by operator "
          f"--once into a FileCluster: objects = the rendered manifests, every status "
          f"Available; PyYAML {has_yaml} on this machine; part_s "
          f"{time.perf_counter() - t_part:.1f} [{card}]", flush=True)


# ---------------------------------------------------------------------------
# The MoE FFN: a Mixtral-8x7B-wide model served on one card
# ---------------------------------------------------------------------------
# mistralai/Mixtral-8x7B-v0.1 config.json; random weights from a seed
MIXTRAL_8X7B = dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                    ffn_dim=14336, max_seq_len=32768, rope_theta=1e6, norm_eps=1e-5,
                    n_experts=8, n_experts_per_token=2, dtype="bfloat16")
# (label, LLMServer knobs, layers, why the depth is cut): (a) int8 weights,
# bf16 KV, full depth; (b) bf16 weights, int8 KV, half the depth
MOE_RUNS = (("moe int8", dict(quantize="int8"), 8,
             "reduced to 8 of 32 layers: the phase checks the MoE layer, not the depth, and "
             "the whole run stays inside its time limit"),
            ("moe bf16", dict(kv_cache_dtype="int8"), 8,
             "reduced to 8 of 32 layers (32 layers of bf16 weights are 93.4 GB, more than "
             "the card's 80 GB), as the int8 run"))
# K4's products that no Llama-2-7B forward has: the experts' w1 / w3 and w2,
# and GQA's wk / wv (8 kv heads); at the rows of the 8 slots, a chunk of 32
# and the chunks of 128 and 256
MOE_K4 = (("expert w1/w3", 4096, 14336), ("expert w2", 14336, 4096), ("gqa wk/wv", 4096, 1024))
MOE_K4_ROWS = (8, 32, 128, 256)
MOE_IDLE_GB = 0.5         # device memory the card may hold when the phase starts
# the int8 load's peak may pass the int8 tree plus its largest float32 leaf
# by that leaf's bf16 rounding copy (quantize_into_) and this much
MOE_LOAD_SLACK_GB = 0.25
# a token's k-th and (k+1)-th gate logits closer than this (float32
# recomputation) may pick either expert
MOE_ROUTE_GAP = 1e-3


def moe_load(label: str, card: str, knobs: dict, n_layers: int, why: str):
    """An LLMServer at Mixtral-8x7B widths (random weights from a seed,
    fused_norm=True, param_dtype="auto", paged continuous batching over
    N_REQUESTS slots, the 7B runs' length buckets) at ``n_layers`` layers
    with ``knobs``, loaded. Fails when an int8 load's peak passes the int8
    tree plus its largest float32 leaf (an expert leaf) plus that leaf's
    bf16 copy and MOE_LOAD_SLACK_GB. Returns (server, weight bytes, load
    numbers)."""
    import torch

    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = LLMServer(model="transformer",
                       model_kwargs=dict(MIXTRAL_8X7B, n_layers=n_layers, fused_norm=True),
                       init_random=True, param_dtype="auto", continuous_batching=N_REQUESTS,
                       max_new_tokens=MAX_NEW, temperature=0.0, eos_id=-1, seed=0,
                       device="cuda", **knobs)
    server.load()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in (*server._module.parameters(), *server._module.buffers()))
    cfg = server._cfg
    leaf = cfg.n_experts * cfg.dim * cfg.ffn_dim
    limit = weight_bytes + leaf * 4 + leaf * 2 + MOE_LOAD_SLACK_GB * 1e9
    print(f"[{label}] load_s {load_s:.2f} (Mixtral-8x7B widths, {n_layers} layers"
          f"{'; ' + why if why else ''}; random weights; quantize={server.quantize or 'none'}, "
          f"KV {server.kv_cache_dtype}): weights {weight_bytes / 1e9:.3f} GB, peak device "
          f"memory during load() {peak / 1e9:.3f} GB (the largest float32 leaf, an expert's, "
          f"{leaf * 4 / 1e9:.3f} GB) [{card}]", flush=True)
    if server.quantize == "int8" and peak > limit:
        fail(f"[{label}] load peak {peak / 1e9:.3f} GB > the int8 tree {weight_bytes / 1e9:.3f} "
             f"GB + its largest float32 leaf {leaf * 4 / 1e9:.3f} GB + that leaf's bf16 copy "
             f"{leaf * 2 / 1e9:.3f} GB + {MOE_LOAD_SLACK_GB} GB")
    return server, weight_bytes, {"load_s": load_s, "load_peak_gb": peak / 1e9,
                                  "weight_gb": weight_bytes / 1e9}


def moe_service(label: str, card: str, server, fuse: int):
    """A BatcherService of ``server`` with ``fuse`` steps a dispatch, built
    (warm-up and capture) under set_sync_debug_mode("error"), served over
    REST. Fails unless it holds decode graphs of K = 1 (and ``fuse``) and
    prefill graphs of every chunk length. Returns (service, httpd, url)."""
    import torch

    from seldon_core_tpu_torch.runtime.batcher import BatcherService
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    server.decode_fuse_steps = fuse
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        svc = BatcherService(server, max_slots=N_REQUESTS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    b = svc.batcher
    want = sorted({1, fuse} if fuse > 1 else {1})
    if sorted(b._graphs) != want or sorted(b._prefill_graphs) != sorted(PREFILL_CHUNKS):
        fail(f"[{label}] graphs of K = {sorted(b._graphs)}, chunks "
             f"{sorted(b._prefill_graphs)}: expected {want} and {sorted(PREFILL_CHUNKS)}")
    print(f"[{label}] batcher built in {time.perf_counter() - t0:.3f} s: decode graphs of K = "
          f"{want} ({gb_text(graph_pool_gb(b._graphs.values()))}), prefill graphs of chunks "
          f"{sorted(PREFILL_CHUNKS)} ({gb_text(graph_pool_gb(b._prefill_graphs.values()))}), "
          f"captured under set_sync_debug_mode('error'); KV pool "
          f"{sum(t.numel() * t.element_size() for la in b._caches for t in la) / 1e9:.3f} GB "
          f"({b.n_pages} pages of {b.page_size} a slot's table) [{card}]", flush=True)
    server._batcher_service = svc
    httpd, _ = start(make_component_app(server, device="cuda"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    code, body = post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 4})
    if code != 200:
        fail(f"[{label}] warm-up request answered {code}: {body}")
    return svc, httpd, url


def moe_requests(label: str, card: str, server, url: str, texts, ranks: int = 1,
                 partial: bool = False) -> tuple:
    """The N_REQUESTS texts at once over REST /v1/generate, every counter
    zeroed just before and read just after: every chunk a prefill-graph
    replay and every dispatch a decode-graph replay (``check_launches`` at
    the model's widths, ``ranks`` mesh ranks, K1's ``partial`` mode on a
    'seq' mesh). Returns (served tokens, launch counts, metrics)."""
    import torch

    torch.cuda.synchronize()
    zero_counts(server)
    server._decode_replays = server._decode_eager = 0
    results, wall = post_all(url, texts)
    counts = read_counts(server)
    dispatches = (server._decode_replays, server._decode_eager)
    steps = sorted(server._decode_step_times)
    m = {"wall_s": wall, "step_ms": statistics.median(steps) * 1e3,
         "ttft_med_ms": statistics.median(server._ttft_times) * 1e3,
         "ttft_max_ms": max(server._ttft_times) * 1e3,
         "dispatch_ms": statistics.median(server._decode_dispatch_times) * 1e3,
         "sync_ms": statistics.median(server._decode_sync_times) * 1e3,
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "steps": len(steps),
         "dispatches": dispatches[0]}
    served = served_tokens(label, results)
    check_launches(label, card, counts, [128] * N_REQUESTS, server.quantize == "int8",
                   server.kv_cache_dtype == "int8", eager=False, cfg=server._cfg, ranks=ranks,
                   partial=partial)
    if dispatches[0] == 0 or dispatches[1]:
        fail(f"[{label}] decode dispatches as (graph replays, eager runs) {dispatches}: every "
             f"dispatch must be a replay")
    print(f"[{label}] {N_REQUESTS} requests x {MAX_NEW} tokens over REST in {wall:.3f} s: TTFT "
          f"median {m['ttft_med_ms']:.1f} ms max {m['ttft_max_ms']:.1f} ms; decode step wall "
          f"(drain to drain) median {m['step_ms']:.2f} ms = "
          f"{N_REQUESTS / m['step_ms'] * 1e3:.1f} tok/s at {N_REQUESTS} slots ({len(steps)} "
          f"steps in {dispatches[0]} dispatches, all graph replays; host time a dispatch median "
          f"{m['dispatch_ms']:.3f} ms, host wait a drain {m['sync_ms']:.3f} ms); peak device "
          f"memory since the load {m['peak_gb']:.2f} GB [{card}]", flush=True)
    return served, counts, m


def moe_generate(label: str, card: str, server, url: str, texts) -> tuple:
    """One {"prompts": texts} request: generate() through its own decode
    graph (captured at this first use): every decode step a replay.
    Returns (tokens, launch counts, metrics)."""
    import torch

    zero_counts(server)
    server._generate_replays = server._generate_eager = 0
    t0 = time.perf_counter()
    code, body = post(url + "/v1/generate", {"prompts": list(texts)})
    wall = time.perf_counter() - t0
    counts = read_counts(server)
    if code != 200:
        fail(f"[{label}] generate(): {{'prompts': ...}} answered {code}: {body}")
    toks = body.get("tokens")
    if not (isinstance(toks, list) and len(toks) == len(texts)
            and all(len(t) == MAX_NEW for t in toks)):
        fail(f"[{label}] generate(): expected {len(texts)} x {MAX_NEW} tokens, got {toks!r}")
    reps = (server._generate_replays, server._generate_eager)
    if reps != (MAX_NEW - 1, 0):
        fail(f"[{label}] generate() decode steps as (replays, eager) {reps}, expected "
             f"({MAX_NEW - 1}, 0)")
    if counts["k2"] == 0 or counts["k1"] or counts["k1_int8"] or (
            server.quantize == "int8") != (counts["k4"] > 0):
        fail(f"[{label}] generate() launches {counts}")
    step_ms = server._decode_step_times[-1] * 1e3
    pool = graph_pool_gb(server._generate_graphs.values())
    print(f"[{label}] generate(): {len(texts)} prompts x {MAX_NEW} tokens in one request, "
          f"{wall:.3f} s (the decode graph captured in it); decode {step_ms:.2f} ms a step, "
          f"{reps[0]} replays, {reps[1]} eager steps; dense buffer "
          f"{server._dense.nbytes() / 1e9:.3f} GB, generate pool {gb_text(pool)}; launches "
          f"{ {k: counts[k] for k in ('k2', 'k4', 'k4_wgmma')} } [{card}]", flush=True)
    torch.cuda.synchronize()
    return toks, counts, {"wall_s": wall, "step_ms": step_ms, "pool_gb": pool}


def moe_route_check(label: str, card: str, server, texts, served, ranks: int = 1) -> list:
    """One teacher-forced prefill of the served sequences (prompts + served
    tokens) with every layer's ``MoEFFN.gates`` recorded: the experts each
    layer chose on the card against a float32 recomputation on the CPU
    from the same activations (the dequantized router), equal except where
    the k-th and (k+1)-th recomputed logits lie within MOE_ROUTE_GAP. Also
    counts the tokens each layer routed to each expert. Returns the counts
    summed over layers."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.transformer import MoEFFN, dequantize_array
    from seldon_core_tpu_torch.ops.quantize import QuantizedTensor

    cfg = server._cfg
    k = min(cfg.n_experts_per_token, cfg.n_experts)
    seqs = [prompt_ids(server, t) + s for t, s in zip(texts, served)]
    lens = torch.tensor([len(s) for s in seqs])
    calls = []
    real_gates = MoEFFN.gates

    def recording(module, x):
        gates, topi = real_gates(module, x)
        calls.append((module, x.detach().float().cpu(), topi.cpu()))
        return gates, topi

    MoEFFN.gates = recording
    try:
        teacher_logits(server, seqs)
    finally:
        MoEFFN.gates = real_gates
    if len(calls) != cfg.n_layers * ranks:
        fail(f"[{label}] the routing check saw {len(calls)} MoE layer calls, expected "
             f"{cfg.n_layers} x {ranks} ranks")
    real = (torch.arange(max(lens))[None] < lens[:, None]).reshape(-1).numpy()
    counts = np.zeros(cfg.n_experts, np.int64)
    differ = near = 0
    for module, x, topi in calls:
        router = module.router
        router = dequantize_array(router) if isinstance(router, QuantizedTensor) else router
        logits = (x.reshape(-1, cfg.dim).numpy().astype(np.float32)
                  @ router.detach().float().cpu().numpy())[real]
        order = np.argsort(-logits, axis=-1, kind="stable")
        chosen = topi.reshape(-1, k).numpy()[real]
        srt = np.take_along_axis(logits, order, -1)
        tie = (srt[:, k - 1] - srt[:, k]) < MOE_ROUTE_GAP
        same = (np.sort(chosen, -1) == np.sort(order[:, :k], -1)).all(-1)
        differ += int((~same & ~tie).sum())
        near += int((~same & tie).sum())
        counts += np.bincount(chosen.reshape(-1), minlength=cfg.n_experts)
    n_tok = int(real.sum())
    print(f"[{label}] routing: {cfg.n_layers} layers x {n_tok} tokens of one teacher-forced "
          f"prefill of the served sequences: the experts chosen on the card equal a float32 "
          f"recomputation on the CPU from the same activations for all but {near} token-layers "
          f"(each a near-tie, k-th and (k+1)-th logits within {MOE_ROUTE_GAP}) and {differ} "
          f"others; tokens routed to each expert over the layers {counts.tolist()} (top-{k} of "
          f"{cfg.n_experts}) [{card}]", flush=True)
    if differ:
        fail(f"[{label}] {differ} token-layers routed to other experts than the float32 "
             f"recomputation without a near-tie")
    return counts.tolist()


def moe_split(label: str, card: str, server, b, weight_bytes: int) -> dict:
    """Where one decode step's device time goes (a torch.profiler trace of
    one K = 1 replay on the live state ``step_phase`` left): K4 on the
    experts (in launch order, the 3 x e K4 kernels after each layer's K2),
    the other K4, cuBLAS, K1, K2 and the rest; beside the step's byte bound
    (its weights read once). A bf16 model's expert products are cuBLAS:
    they are also timed alone, one layer's three batched products as a CUDA
    graph at the step's rows, times the layers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = server._cfg
    replay = b._graphs[1].replay
    replay()
    torch.cuda.synchronize()
    evs = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            replay()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.time_range.start)
        del prof
        if evs:
            break
    split = dict.fromkeys(("k4_experts", "k4_other", "cublas", "k1", "k2", "rest"), 0.0)
    n = dict.fromkeys(split, 0)
    left, last_k4 = 0, "k4_other"
    for e in evs:
        name = e.name
        if K2_KERNEL in name:
            key, left = "k2", 3 * cfg.n_experts
        elif "paged_attention" in name:
            key = "k1"
        elif "splitk_reduce" in name:
            key = last_k4
        elif "int8_matmul" in name:
            key = last_k4 = "k4_experts" if left > 0 else "k4_other"
            left -= left > 0
        elif any(t in name.lower() for t in ("gemm", "gemv", "nvjet", "cutlass", "xmma",
                                              "cublas")):
            key = "cublas"
        else:
            key = "rest"
        split[key] += (e.time_range.end - e.time_range.start) / 1e3
        n[key] += 1
    total = sum(split.values())
    bound = weight_bytes / HBM_BYTES_PER_S * 1e3
    experts_alone = None
    if server.quantize != "int8":
        moe = server._module.layer_0.moe
        dt = cfg.dtype
        x2 = torch.randn((b.S, cfg.dim), device="cuda").to(dt)

        def products():
            h = torch.matmul(x2, moe.w1) * torch.matmul(x2, moe.w3)
            return torch.matmul(h, moe.w2)

        graph = torch.cuda.CUDAGraph()
        products()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            products()
        experts_alone = events_ms(graph.replay) * cfg.n_layers
        del graph
    parts = ", ".join(f"{key} {split[key]:.3f} ms ({n[key]} kernels)" for key in split)
    alone = ("" if experts_alone is None else
             f"; the experts' three batched cuBLAS products of a layer alone (a CUDA graph at "
             f"{b.S} rows, the multiply between them included) x {cfg.n_layers} layers "
             f"{experts_alone:.3f} ms")
    print(f"[{label}] one decode step's device time at {b.S} slots (torch.profiler, one K = 1 "
          f"replay): {total:.3f} ms in {len(evs)} kernels = {parts}{alone}; byte bound (the "
          f"{weight_bytes / 1e9:.2f} GB of weights read once at {HBM_BYTES_PER_S / 1e12:.2f} "
          f"TB/s) {bound:.3f} ms, kernels/bound {total / bound:.2f}x [{card}]", flush=True)
    return {"split": split, "kernels": len(evs), "total_ms": total, "bound_ms": bound,
            "experts_alone_ms": experts_alone}


def moe_kernel_cases(card: str, flush, b) -> dict:
    """K4 at the new products' shapes (MOE_K4 x MOE_K4_ROWS, ``k4_case``:
    against int8_matmul_ref within K4's tolerance, timed beside its bound
    and torch.matmul on the bf16 weight) and K1 at the served GQA shape
    (8 slots, 32 heads on 8 kv heads, the batcher ``b``'s table of
    n_pages x page_size, 156 keys: a prompt of 124 and 32 tokens), both
    pools. Returns the K4 rows by label."""
    import torch

    out = {}
    for name, k, n in MOE_K4:
        for m in MOE_K4_ROWS:
            r = k4_case(m, k, n, torch.bfloat16, seed=m + k + n, flush=flush)
            out[f"{name} M={m}"] = r
            route = "prefill kernel (TMA + wgmma)" if r["decode_ms"] is not None else \
                f"decode kernel, plan (width, splits, stages) {r['plan']}"
            print(f"K4 int8_matmul MoE {name} [{m},{k}]x[{k},{n}] -> bfloat16 ({route}): "
                  f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}) library_ms {r['library_ms']:.4f} "
                  f"(torch.matmul on a dequantized bf16 copy of the weight); kernel/bound "
                  f"{r['ms'] / r['bound_ms']:.2f}x, kernel/library "
                  f"{r['ms'] / r['library_ms']:.2f}x; max_abs_err {r['err']:.3e} "
                  f"({K4_TOL_REASON}) [{card}]", flush=True)
    for kv in ("bf16", "int8"):
        r = k1_case(b=N_REQUESTS, h=MIXTRAL_8X7B["n_heads"], kvh=MIXTRAL_8X7B["n_kv_heads"],
                    hd=MIXTRAL_8X7B["dim"] // MIXTRAL_8X7B["n_heads"], ps=b.page_size,
                    n_pages=b.n_pages, ctx=124 + MAX_NEW, null_row=None, seed=5, flush=flush,
                    kv=kv)
        out[f"k1 {kv}"] = r
        print(f"K1 paged_attention {kv} pool at the served GQA shape b={N_REQUESTS} h=32 "
              f"kvh=8 hd=128 ps={b.page_size} n_pages={b.n_pages} ctx={124 + MAX_NEW}: "
              f"S={r['splits']} kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) library_ms {r['library_ms']:.4f} (SDPA); "
              f"max_abs_err {r['err']:.3e} ({K1_TOL_REASON}) [{card}]", flush=True)
    return out


def moe_phase(card: str, ref_nodes: Optional[dict] = None) -> list:
    """The [moe] phase: a Mixtral-8x7B-wide model through the port's main
    path, in runs MOE_RUNS (each loaded for it and dropped after), each
    served over REST through the graph batcher at K = 1 and at K = FUSED_K
    and through generate() ({"prompts": ...}), with: every chunk and
    dispatch a replay; decode and chunk replays bit-equal to the eager
    programs on live state (``step_phase``, ``prefill_phase``); every
    served token within TIE_TOL of a teacher-forced prefill's top logit;
    the batcher's tokens == generate()'s up to a near-tie; the routing
    against a float32 recomputation; the int8 load's peak. The K4 and K1
    cases at the new shapes run once, after (a)'s first batcher.
    ``ref_nodes`` (label -> kernel nodes of the 7B K = 1 decode graph, from
    the serving phase) sets the step's kernels beside the 7B step's.
    Returns launch records."""
    import torch

    t_phase = time.perf_counter()
    release_server_memory()
    held = torch.cuda.memory_allocated() / 1e9
    reserved = torch.cuda.memory_reserved() / 1e9
    print(f"[moe] device memory before the phase: {held:.3f} GB allocated, {reserved:.3f} GB "
          f"reserved (at most {MOE_IDLE_GB} GB) [{card}]", flush=True)
    if held > MOE_IDLE_GB:
        fail(f"[moe] the card still holds {held:.3f} GB before the MoE loads")
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    records, summary = [], {}
    for label, knobs, n_layers, why in MOE_RUNS:
        t_run = time.perf_counter()
        server, weight_bytes, load = moe_load(label, card, knobs, n_layers, why)
        torch.cuda.reset_peak_memory_stats()
        texts = prompts(N_REQUESTS)
        run = dict(load)
        for fuse in (0, FUSED_K):
            sub = label if fuse == 0 else f"{label} K={fuse}"
            svc, httpd, url = moe_service(sub, card, server, fuse)
            b = svc.batcher
            try:
                served, counts, m = moe_requests(sub, card, server, url, texts)
                records.append((sub, counts))
                run[fuse] = m
                if fuse == 0:
                    run["decode_pool_gb"] = graph_pool_gb(b._graphs.values())
                    run["prefill_pool_gb"] = graph_pool_gb(b._prefill_graphs.values())
                    gen, gcounts, gm = moe_generate(sub, card, server, url, texts)
                    records.append((f"{sub} generate", gcounts))
                    run["generate"] = gm
            finally:
                httpd.shutdown()
                httpd.server_close()
                httpd = None     # the app it serves holds the server
            if b.page_stats()["kv_pages_in_use"] != 0:
                fail(f"[{sub}] pages still held after every request finished: "
                     f"{b.page_stats()}")
            svc.close()
            server._batcher_service = None
            teacher_check(sub, card, server, texts, served)
            if fuse == 0:
                equal = near_tie_check(f"{sub} batcher vs generate()", card, server, texts,
                                       served, gen)
                print(f"[{sub}] batcher vs generate(): {equal} of {N_REQUESTS} requests equal "
                      f"throughout, the rest up to a near-tie [{card}]", flush=True)
                run["routed"] = moe_route_check(sub, card, server, texts, served)
                run["prefill"] = prefill_phase(sub, card, server, b)
                if "kernels" not in summary:
                    summary["kernels"] = moe_kernel_cases(card, lambda: scratch.fill_(1), b)
            else:
                run["step"] = step_phase(sub, card, server, b, texts, weight_bytes)
                run["split"] = moe_split(sub, card, server, b, weight_bytes)
            del svc, b
            release_server_memory()
        run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        summary[label] = run
        del server
        release_server_memory()
        left = torch.cuda.memory_allocated() / 1e9
        print(f"[{label}] run_s {time.perf_counter() - t_run:.1f}; device memory after the "
              f"server is dropped {left:.3f} GB [{card}]", flush=True)
        if left > MOE_IDLE_GB:
            fail(f"[{label}] the dropped server still holds {left:.3f} GB")
    del scratch
    for label, _, n_layers, why in MOE_RUNS:
        run = summary[label]
        k1, k8 = run[0], run[FUSED_K]
        st = run["step"]
        sp = run["split"]
        ref = (ref_nodes or {}).get("int8" if "int8" in label else "bf16")
        ref_text = (f"the Llama-2-7B {'int8' if 'int8' in label else 'bf16'} step's "
                    f"{ref}" if ref else "the Llama-2-7B step's not measured in this call (the "
                    "full run prints it)")
        print(f"  {label} ({n_layers} layers{'; ' + why if why else ''}): load {run['load_s']:.1f} "
              f"s, weights {run['weight_gb']:.3f} GB, load peak {run['load_peak_gb']:.3f} GB, "
              f"peak over the run {run['peak_gb']:.3f} GB; TTFT median {k1['ttft_med_ms']:.1f} / "
              f"max {k1['ttft_max_ms']:.1f} ms; step wall drain to drain K=1 "
              f"{k1['step_ms']:.2f} ms = {N_REQUESTS / k1['step_ms'] * 1e3:.1f} tok/s, K={FUSED_K} "
              f"{k8['step_ms']:.2f} ms = {N_REQUESTS / k8['step_ms'] * 1e3:.1f} tok/s; host a "
              f"dispatch K=1 {k1['dispatch_ms']:.3f} ms, K={FUSED_K} {k8['dispatch_ms']:.3f} ms; "
              f"replay device K=1 {st[1]['dev_ms']:.3f} ms; split {sp['split']}; kernels a step "
              f"{st[1]['nodes']} graph kernel nodes ({ref_text}); byte bound "
              f"{sp['bound_ms']:.3f} ms; generate() {run['generate']['step_ms']:.2f} ms a step; "
              f"routed {run['routed']}; pools: decode {gb_text(run['decode_pool_gb'])}, prefill "
              f"{gb_text(run['prefill_pool_gb'])}, generate {gb_text(run['generate']['pool_gb'])} "
              f"[{card}]", flush=True)
    print(f"[moe] phase_s {time.perf_counter() - t_phase:.1f} [{card}]", flush=True)
    return records


# [parallel]: tensor, sequence and data parallelism over a mesh whose ranks
# share this card (models/sharded.py): Llama-2-7B at tensor_parallel = 2
# through the graph batcher (bf16; int8 weights + int8 KV), generate() on a
# 4-rank {"data": 1, "seq": 2, "model": 2} mesh, Mixtral-8x7B widths cut to
# PAR_MOE_LAYERS layers at tp = 2 (int8 weights), TorchServer over a mesh,
# and K4 / K1 alone at the rank's shapes
PAR_TP = 2
PAR_GEN_MESH = {"data": 1, "seq": 2, "model": 2}
PAR_MOE_LAYERS = 2
# (label, K, N) of each product a rank runs: column shards cut N, row
# shards K (Llama-2-7B at tp = 2, then at tp = 4; a Mixtral-8x7B expert's
# w2 at tp = 2). A row shard runs with both outputs: bf16, and the float32
# partials the served int8 ranks write (f32_partials)
PAR_K4 = [("wq/wk/wv col tp=2", 4096, 2048), ("w1/w3 col tp=2", 4096, 5504),
          ("lm_head col tp=2", 4096, 16000), ("wo row tp=2", 2048, 4096),
          ("w2 row tp=2", 5504, 4096), ("Mixtral expert w2 row tp=2", 7168, 4096),
          ("wq/wk/wv col tp=4", 4096, 1024),
          ("w1/w3 col tp=4", 4096, 2752), ("lm_head col tp=4", 4096, 8000),
          ("wo row tp=4", 1024, 4096), ("w2 row tp=4", 2752, 4096)]
PAR_K4_ROWS = {"tp=2": (8, 32, 128, 256), "tp=4": (8, 128)}
# K1 at a rank's heads: (label, h, kvh) — Llama-2-7B at tp = 2 and 4
PAR_K1 = [("7B tp=2 rank", 16, 16), ("7B tp=4 rank", 8, 8)]


def par_topology(n: int):
    from seldon_core_tpu_torch.parallel.topology import Topology

    return Topology(devices=["cuda"] * n)


def par_load(label: str, card: str, knobs: dict, params=None, **kw):
    """An LLMServer at Llama-2-7B widths and depth with ``knobs`` (and a
    mesh in ``kw``), its weights ``params`` (another server's tree) or
    random from the seed. Returns (server, weight bytes a rank)."""
    import torch

    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = LLMServer(model="transformer", model_kwargs=dict(LLAMA2_7B, fused_norm=True),
                       init_random=True, param_dtype="auto",
                       continuous_batching=kw.pop("continuous_batching", N_REQUESTS),
                       max_new_tokens=MAX_NEW, temperature=0.0, eos_id=-1, seed=0,
                       device="cuda", **knobs, **kw)
    server.load(params=params)
    torch.cuda.synchronize()
    m = server._module
    per_rank = (m.weight_bytes() if hasattr(m, "weight_bytes") else
                [sum(t.numel() * t.element_size() for t in (*m.parameters(), *m.buffers()))])
    mesh = getattr(server, "mesh", None)
    print(f"[{label}] load_s {time.perf_counter() - t0:.2f} (Llama-2-7B widths, 32 layers, the "
          f"weights {'of the loaded server' if params is not None else 'from the seed'}; "
          f"quantize={server.quantize or 'none'}, KV {server.kv_cache_dtype}; mesh "
          f"{dict(mesh.shape) if mesh is not None else None}, its ranks on one card): weight "
          f"bytes a rank {[round(b / 1e9, 3) for b in per_rank]} GB; peak device memory during "
          f"load() {torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{card}]", flush=True)
    return server, per_rank[0]


def par_collective_ms(card: str, server, rows: int):
    """One decode step's collectives alone at ``rows`` rows (the tp = 2
    model's: an all-reduce of the embedding, two a layer, the logits'
    all-gather, each over the 2 ranks' partials), as a CUDA graph: its
    device time from torch.profiler (the kernels' sum) and from CUDA events
    around the replay. Returns (profiler ms or None, events ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from seldon_core_tpu_torch.parallel import collectives

    cfg = server._cfg
    g = torch.Generator(device="cuda").manual_seed(9)
    parts = [torch.randn((rows, 1, cfg.dim), generator=g, device="cuda").to(cfg.dtype)
             for _ in range(PAR_TP)]
    heads = [torch.randn((rows, 1, cfg.vocab_size // PAR_TP), generator=g, device="cuda")
             for _ in range(PAR_TP)]

    def step():
        for _ in range(2 * cfg.n_layers + 1):
            collectives.all_reduce(parts)
        return collectives.all_gather(heads)[0]

    step()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    ev = events_ms(graph.replay)
    prof_ms = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        del prof
        if evs:
            prof_ms = sum(e.time_range.end - e.time_range.start for e in evs) / 1e3
            break
    del graph
    return prof_ms, ev


def par_replays(label: str, card: str, server, b, texts) -> dict:
    """On live state (the served prompts admitted again, loop stopped):
    the K = 1 decode replay and each chunk graph's replay (the adapted
    programs on an adapter pool, slot 0's pages of its data rank's pools
    for a chunk) against the same sharded program run eagerly from
    identical copies of every rank's pools and the slot state, bit for bit
    (the pools on every page but TRASH),
    and with a prefix trie a copy-on-write replay against the eager copy;
    the decode graph's kernel nodes by name (one K1 and one K2 a layer a
    rank, one K4 a product a rank in the int8 model) and all of them; the
    replay's device time (CUDA events)."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.transformer import NULL_PAGE, PAD_POS, TRASH_PAGE
    from seldon_core_tpu_torch.runtime.batcher import cow_page_copy

    lora = bool(b._lora(None))
    # every page but TRASH: over 'seq' (and 'data', for a chunk) the ranks
    # that do not hold a token's page write it there, several to one
    # offset, in no set order
    keep = torch.ones(b._caches[0][0].shape[0], dtype=torch.bool, device="cuda")
    keep[TRASH_PAGE] = False

    def pools_equal(copy):
        return all(torch.equal(x[keep], y[keep]) for la, lb in zip(b._caches, copy)
                   for x, y in zip(la, lb))

    admit_now(b, texts, ahead=64)
    copy = state_copy(b)
    toks = b._graphs[1].replay().clone()
    eager = server._get_decode_step_paged(b.S, b.n_pages, 1, lora)(
        *copy, b._temp, b._block_tables, **b._lora(b._adapter_ids))
    torch.cuda.synchronize()
    if not (torch.equal(toks, eager) and state_equal(b, copy, pools=False)
            and pools_equal(copy[0])):
        fail(f"[{label}] the decode replay and the eager sharded step differ")
    del copy, eager
    if b._cow_graph is not None:
        # a full page of slot 0 copied into a fresh page of the same pool
        src = b._slots[0].pages[0]
        dst = b._alloc_pages(0, 0, 1)[0]
        b._cow_args.copy_(torch.tensor([src, dst, b.page_size - 3], device="cuda"))
        copy = [tuple(t.clone() for t in layer) for layer in b._caches]
        b._cow_graph.replay()
        a = b._cow_args
        cow_page_copy(copy, a[0:1], a[1:2], a[2:3], server._module)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for la, lb in zip(b._caches, copy) for x, y in zip(la, lb)):
            fail(f"[{label}] the copy-on-write replay and the eager sharded copy differ")
        b._allocator.free([dst])
        del copy
    text = server._tokenizer.encode(" ".join(prompts(N_REQUESTS)))
    for C in sorted(b._prefill_graphs):
        pages = b._alloc_pages(0, 0, -(-C // b.page_size))
        b._reset_pages(pages)
        row = np.full((1, b.n_pages), NULL_PAGE, np.int32)
        row[0, :len(pages)] = pages
        b._row.copy_(b._to_device(row))
        toks_c = np.zeros((1, C), np.int64)
        toks_c[0] = text[:C]
        b._chunk_tokens[:, :C].copy_(b._to_device(toks_c))
        b._chunk_pos[:, :C].copy_(b._to_device(np.arange(C, dtype=np.int32)[None]))
        copy = [tuple(t.clone() for t in layer) for layer in b._caches]
        got = b._prefill_graphs[C].replay().clone()
        want = server._get_prefill_chunk(C, b.n_pages, lora)(
            copy, b._row, b._chunk_tokens[:, :C], b._chunk_pos[:, :C],
            **b._lora(b._chunk_adapter))
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and pools_equal(copy)):
            fail(f"[{label}] the chunk-{C} replay and the eager sharded chunk differ")
        b._allocator.free(pages)
        del copy, got, want
    torch.cuda.empty_cache()
    cfg = server._cfg
    ranks = server.mesh.size if server.mesh is not None else 1
    names = graph_kernel_names(b._graphs[1].graph)
    seen = node_counts(names)
    k4 = k4_per_forward(cfg) if server.quantize == "int8" else 0
    want = (cfg.n_layers * ranks, 0, k4 * ranks, cfg.n_layers * ranks)
    if seen != want:
        fail(f"[{label}] the decode graph holds (K2, K4 prefill, K4 decode, K1) kernel nodes "
             f"{seen}, expected {want}")
    dev_ms = events_ms(b._graphs[1].replay)
    print(f"[{label}] replay vs eager from identical copies of every rank's pools and the slot "
          f"state: the K = 1 decode step"
          f"{', a copy-on-write copy' if b._cow_graph is not None else ''} and chunks "
          f"{sorted(b._prefill_graphs)} bit-equal; the "
          f"decode graph holds {len(names)} kernel nodes, (K2, K4 prefill, K4 decode, K1) "
          f"{seen}; replay device time {dev_ms:.3f} ms (CUDA events, median of {REPS}) "
          f"[{card}]", flush=True)
    return {"nodes": len(names), "dev_ms": dev_ms}


def par_serve(label: str, card: str, server, texts, ranks: int, partial: bool = False) -> tuple:
    """``server``'s graph batcher over REST (``moe_service``), the
    N_REQUESTS texts at once (``moe_requests``: every chunk and dispatch a
    replay, the launches a rank's work times ``ranks``, K1's ``partial``
    mode on a 'seq' mesh), then the replays against the eager programs on
    live state. Returns (served tokens, launch counts, metrics)."""
    svc, httpd, url = moe_service(label, card, server, 0)
    b = svc.batcher
    try:
        served, counts, m = moe_requests(label, card, server, url, texts, ranks=ranks,
                                         partial=partial)
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd = None
    if b._radix is not None:
        b._radix.clear()   # the trie's pages back to the pool
    if b.page_stats()["kv_pages_in_use"] != 0:
        fail(f"[{label}] pages still held after every request finished: {b.page_stats()}")
    svc.close()
    server._batcher_service = None
    m.update(par_replays(label, card, server, b, texts))
    m["pool_gb"] = sum(t.numel() * t.element_size() for la in b._caches for t in la) / 1e9
    del svc, b
    release_server_memory(workspaces=False)
    return served, counts, m


def par_batcher_runs(card: str, base, texts, tree) -> tuple:
    """(a): bf16, then int8 weights + int8 KV: the tp = 1 server's batcher
    (``base``; int8: a copy of its weights quantized) and the tp = 2
    server's, from the same weights; the tp = 2 tokens teacher-forced and
    equal to the tp = 1 tokens up to a near-tie; the step's collectives."""
    import torch

    records, out = [], {}
    for model, knobs in (("bf16", {}), ("int8", dict(quantize="int8", kv_cache_dtype="int8"))):
        if model == "bf16":
            ref = base
        else:
            ref, _ = par_load("parallel int8 tp=1", card, knobs, params=tree)
        plain, pcounts, pm = par_serve(f"parallel {model} tp=1", card, ref, texts, 1)
        if model != "bf16":
            del ref
            release_server_memory(workspaces=False)
        server, rank_bytes = par_load(f"parallel {model} tp={PAR_TP}", card, knobs, params=tree,
                                      tensor_parallel=PAR_TP, topology=par_topology(PAR_TP))
        label = f"parallel {model} tp={PAR_TP}"
        served, counts, m = par_serve(label, card, server, texts, PAR_TP)
        records.append((label, counts))
        teacher_check(label, card, server, texts, served)
        equal = near_tie_check(f"{label} vs tp=1", card, server, texts, served, plain)
        prof_ms, ev_ms = par_collective_ms(card, server, N_REQUESTS)
        # K1 launches a decode dispatch (K = 1: a step), tp = 2 over tp = 1
        k1 = "k1_int8" if model == "int8" else "k1"
        ratio = (counts[k1] / m["dispatches"]) / (pcounts[k1] / pm["dispatches"])
        out[model] = dict(m, tp1=pm, equal=equal, coll_prof_ms=prof_ms, coll_ev_ms=ev_ms,
                          served_tp1=plain,
                          rank_gb=rank_bytes / 1e9, k1_ratio=ratio,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"[{label}] vs tp=1 on this card: tokens equal for {equal} of {N_REQUESTS} "
              f"requests throughout, the rest up to a near-tie; step wall (drain to drain) "
              f"median {m['step_ms']:.2f} ms vs {pm['step_ms']:.2f} ms; decode replay device "
              f"{m['dev_ms']:.3f} vs {pm['dev_ms']:.3f} ms; graph kernel nodes a step "
              f"{m['nodes']} vs {pm['nodes']}; K1 launches a step {ratio:.1f}x tp=1's; the "
              f"step's collectives alone ({2 * server._cfg.n_layers + 1} all-reduces of "
              f"[{N_REQUESTS}, 1, 4096] over {PAR_TP} partials + the logits' all-gather) "
              f"{'not measured' if prof_ms is None else f'{prof_ms:.3f} ms'} (torch.profiler, "
              f"kernels' sum), {ev_ms:.3f} ms (CUDA events); weights a rank "
              f"{rank_bytes / 1e9:.3f} GB; KV pool {m['pool_gb']:.3f} GB (both ranks); peak "
              f"device memory {out[model]['peak_gb']:.2f} GB [{card}]", flush=True)
        if ratio != PAR_TP:
            fail(f"[{label}] K1 launches a step {ratio}x tp=1's, expected {PAR_TP}x")
        del server
        release_server_memory(workspaces=False)
    return records, out


def par_generate(card: str, base, texts, tree) -> tuple:
    """(b): generate() on the 4-rank {"data": 1, "seq": 2, "model": 2}
    mesh over REST ({"prompts": texts}): every decode step a replay of its
    graph (the rank loop captured), the tokens teacher-forced and equal to
    the tp = 1 generate()'s up to a near-tie."""
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    label = "parallel generate seq=2 model=2"
    # the eager switch: in the full run earlier phases freed the cuBLAS
    # workspaces the tp = 1 server's generate graphs were captured over
    want = base.generate(texts, _eager=True)["tokens"]
    server, rank_bytes = par_load(label, card, {}, params=tree, continuous_batching=0,
                                  mesh=par_topology(4).mesh(PAR_GEN_MESH))
    httpd, _ = start(make_component_app(server, device="cuda"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        toks, counts, gm = moe_generate(label, card, server, url, texts)
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd = None
    teacher_check(label, card, server, texts, toks)
    equal = near_tie_check(f"{label} vs tp=1", card, server, texts, toks, want)
    names = graph_kernel_names(next(iter(server._generate_graphs.values())).graph)
    print(f"[{label}] vs the tp=1 generate(): {equal} of {N_REQUESTS} equal throughout, the "
          f"rest up to a near-tie; decode graph {len(names)} kernel nodes a step (4 ranks); "
          f"each rank's cache {server._dense.nbytes() / 4e9:.3f} GB of the dense buffer's "
          f"{server._dense.nbytes() / 1e9:.3f} GB [{card}]", flush=True)
    out = dict(gm, equal=equal, nodes=len(names), rank_gb=rank_bytes / 1e9)
    del server
    release_server_memory(workspaces=False)
    return [(label, counts)], out


def par_moe(card: str, texts) -> tuple:
    """(c): Mixtral-8x7B widths cut to PAR_MOE_LAYERS layers, int8 weights,
    at tp = 1 and tp = 2 (the same seed, the same weights): the tp = 2
    graph batcher's tokens teacher-forced and equal to tp = 1's up to a
    near-tie, and each rank's routing equal to a float32 recomputation."""
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    def load(label, **mesh_kw):
        t0 = time.perf_counter()
        server = LLMServer(model="transformer", model_kwargs=dict(
            MIXTRAL_8X7B, n_layers=PAR_MOE_LAYERS, fused_norm=True), init_random=True,
            param_dtype="auto", continuous_batching=N_REQUESTS, max_new_tokens=MAX_NEW,
            temperature=0.0, eos_id=-1, seed=0, device="cuda", quantize="int8", **mesh_kw)
        server.load()
        print(f"[{label}] load_s {time.perf_counter() - t0:.2f} (Mixtral-8x7B widths reduced to "
              f"{PAR_MOE_LAYERS} of 32 layers: the phase checks the sharded MoE layer, not the "
              f"depth; random weights, int8) [{card}]", flush=True)
        return server

    ref = load("parallel moe tp=1")
    plain, _, pm = par_serve("parallel moe tp=1", card, ref, texts, 1)
    del ref
    release_server_memory(workspaces=False)
    label = f"parallel moe tp={PAR_TP}"
    server = load(label, tensor_parallel=PAR_TP, topology=par_topology(PAR_TP))
    served, counts, m = par_serve(label, card, server, texts, PAR_TP)
    teacher_check(label, card, server, texts, served)
    equal = near_tie_check(f"{label} vs tp=1", card, server, texts, served, plain)
    routed = moe_route_check(label, card, server, texts, served, ranks=PAR_TP)
    print(f"[{label}] vs tp=1: {equal} of {N_REQUESTS} equal throughout, the rest up to a "
          f"near-tie; step wall {m['step_ms']:.2f} vs {pm['step_ms']:.2f} ms; graph kernel "
          f"nodes a step {m['nodes']} vs {pm['nodes']}; routed {routed} [{card}]", flush=True)
    del server
    release_server_memory(workspaces=False)
    return [(label, counts)], dict(m, tp1=pm, equal=equal, routed=routed)


def par_kernel_cases(card: str, flush) -> dict:
    """(e): K4 at every product a rank runs at tp = 2 and tp = 4, K1 at a
    rank's heads, both pools, K1's partial mode at a 'seq' rank's, and the
    tied int8 head through K4, each against its plain version."""
    import torch

    out = {}
    for name, k, n in PAR_K4:
        dts = ((torch.float32,) if name.startswith("lm_head") else
               (torch.bfloat16, torch.float32) if " row " in name else (torch.bfloat16,))
        for m, dt in [(m, dt) for m in PAR_K4_ROWS[name.split()[-1]] for dt in dts]:
            r = k4_case(m, k, n, dt, seed=m + k + n + 1, flush=flush)
            out[f"{name} M={m}" + (" f32" if " row " in name and dt == torch.float32
                                   else "")] = r
            route = ("prefill kernel (TMA + wgmma)" if r["decode_ms"] is not None else
                     f"decode kernel, plan (width, splits, stages) {r['plan']}")
            print(f"K4 int8_matmul shard {name} [{m},{k}]x[{k},{n}] -> "
                  f"{str(dt).split('.')[-1]} ({route}): kernel_ms {r['ms']:.4f} plain_ms "
                  f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"library_ms {r['library_ms']:.4f} (torch.matmul on a dequantized bf16 copy); "
                  f"kernel/bound {r['ms'] / r['bound_ms']:.2f}x, kernel/library "
                  f"{r['ms'] / r['library_ms']:.2f}x; max_abs_err {r['err']:.3e} "
                  f"({K4_TOL_REASON}) [{card}]", flush=True)
    for name, h, kvh in PAR_K1:
        for kv in ("bf16", "int8"):
            r = k1_case(b=N_REQUESTS, h=h, kvh=kvh, hd=128, ps=64, n_pages=4, ctx=124 + MAX_NEW,
                        null_row=None, seed=h + kvh, flush=flush, kv=kv)
            out[f"k1 {name} {kv}"] = r
            print(f"K1 paged_attention {kv} pool at the {name}'s heads b={N_REQUESTS} h={h} "
                  f"kvh={kvh} hd=128 ps=64 n_pages=4 ctx={124 + MAX_NEW}: S={r['splits']} "
                  f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}) library_ms {r['library_ms']:.4f} "
                  f"(SDPA); max_abs_err {r['err']:.3e} ({K1_TOL_REASON}) [{card}]", flush=True)
    for kv in ("bf16", "int8"):
        out[f"k1p seq2 rank {kv}"] = par_k1_partial_case(kv, flush)
    out["tied llama-tiny"] = par_tied_head_case("llama-tiny", 256, 64, flush)
    out["tied 7b-wide"] = par_tied_head_case("7B-wide", LLAMA2_7B["vocab_size"],
                                             LLAMA2_7B["dim"], flush)
    return out


# The paged graph batcher on the other serving meshes, (f)-(j): Llama-2-7B
# widths and depth, the ranks on this card
PAR_DATA_MESH = {"data": 2, "model": 2}
PAR_SEQ_MESH = {"data": 1, "seq": 2, "model": 2}
PAR_ADAPTERS = 3


def par_mesh(card: str, label: str, knobs: dict, tree, axes: dict, plain, tp2: dict,
             **server_kw) -> tuple:
    """(f) / (g): the graph batcher over ``axes`` with ``knobs`` over REST
    (``par_serve``: every chunk and dispatch a replay, bit-equal to the
    eager sharded programs on live state, K1 launches a step = ranks x
    layers, every page back); the tokens teacher-forced and equal to tp =
    1's (``plain``) up to a near-tie; the step wall, replay device time and
    graph nodes beside tp = 2's (``tp2``). Returns ([(label, counts)],
    metrics)."""
    import math

    ranks = math.prod(axes.values())
    server, rank_bytes = par_load(label, card, knobs, params=tree,
                                  mesh=par_topology(ranks).mesh(axes), **server_kw)
    texts = prompts(N_REQUESTS)
    served, counts, m = par_serve(label, card, server, texts, ranks,
                                  partial=axes.get("seq", 1) > 1)
    teacher_check(label, card, server, texts, served)
    equal = near_tie_check(f"{label} vs tp=1", card, server, texts, served, plain)
    print(f"[{label}] vs tp=1: {equal} of {N_REQUESTS} equal throughout, the rest up to a "
          f"near-tie; step wall {m['step_ms']:.2f} ms vs tp=2 {tp2['step_ms']:.2f} ms; replay "
          f"device {m['dev_ms']:.3f} vs {tp2['dev_ms']:.3f} ms; graph kernel nodes a step "
          f"{m['nodes']} vs {tp2['nodes']}; weights a rank {rank_bytes / 1e9:.3f} GB; KV pools "
          f"{m['pool_gb']:.3f} GB ({server._module.page_pools()} (data, seq) pools) [{card}]",
          flush=True)
    del server
    release_server_memory(workspaces=False)
    return [(label, counts)], dict(m, equal=equal, rank_gb=rank_bytes / 1e9)


def par_adapter_weights(names) -> dict:
    """Random rank-LORA_RANK factors at 7B widths (``write_adapters``'
    distributions, numpy's seeded generator), in memory."""
    import numpy as np

    from seldon_core_tpu_torch.runtime.adapters import projection_dims

    rng = np.random.default_rng(25)
    L, r = LLAMA2_7B["n_layers"], LORA_RANK
    return {name: {proj: (rng.standard_normal((L, din, r), np.float32) / np.sqrt(din),
                          rng.standard_normal((L, r, dout), np.float32) * LORA_B_STD)
                   for proj, (din, dout) in projection_dims(lora_cfg()).items()}
            for name in names}


def par_lora(card: str, tree, tp2: dict) -> tuple:
    """(h): PAR_ADAPTERS adapters and base traffic in one batch at tp = 1
    and tp = 2 (the same weights and factors), over REST through the
    adapted graph batcher: every chunk and dispatch a replay, K1 / K2
    launches a step = ranks x layers; the tokens teacher-forced through
    each request's adapter and tp = 2's equal to tp = 1's up to a near-tie;
    tp = 2's replays bit-equal to the eager adapted programs on live
    state. Returns ([(label, counts)], metrics)."""
    import statistics

    names = [f"tenant-{i}" for i in range(PAR_ADAPTERS)]
    weights = par_adapter_weights(names)
    texts = prompts(N_REQUESTS)
    assign = [None if i % 4 == 3 else names[i % PAR_ADAPTERS] for i in range(N_REQUESTS)]
    served, records, out = {}, [], {}
    for tp in (1, PAR_TP):
        label = f"parallel lora tp={tp}"
        mesh_kw = {} if tp == 1 else dict(tensor_parallel=tp, topology=par_topology(tp))
        server, _ = par_load(label, card, {}, params=tree, lora_rank=LORA_RANK,
                             lora_max_adapters=PAR_ADAPTERS + 1, **mesh_kw)
        for name in names:
            server.adapter_registry.load(name, weights[name], alpha=LORA_ALPHA)
        svc, httpd, url, _ = build_service(label, server)
        b = svc.batcher
        try:
            served[tp], counts, disp, steps, _, peak, wall = lora_served_run(
                label, card, server, url, texts, assign)
        finally:
            stop_service(label, server, svc, httpd)
        check_launches(label, card, counts, [128] * N_REQUESTS, False, False, eager=False,
                       cfg=server._cfg, ranks=tp)
        if disp[0] == 0 or disp[1]:
            fail(f"[{label}] decode dispatches as (replays, eager) {disp}: every dispatch must "
                 f"be a replay")
        ids = [0 if a is None else server.adapter_registry.resolve(a) for a in assign]
        teacher_check(label, card, server, texts, served[tp], adapter_ids=ids)
        m = {"step_ms": statistics.median(steps) * 1e3, "wall_s": wall, "peak_gb": peak}
        if tp > 1:
            records.append((label, counts))
            m["equal"] = near_tie_check(f"{label} vs tp=1", card, server, texts, served[tp],
                                        served[1], adapter_ids=ids)
            m.update(par_replays(label, card, server, b, texts))
        out[tp] = m
        del server, svc, b
        release_server_memory(workspaces=False)
    m = out[PAR_TP]
    print(f"[parallel lora tp={PAR_TP}] {PAR_ADAPTERS} adapters of rank {LORA_RANK} + base: "
          f"{m['equal']} of {N_REQUESTS} equal to tp=1 throughout, the rest up to a near-tie; "
          f"step wall {m['step_ms']:.2f} ms vs tp=1 adapted {out[1]['step_ms']:.2f} ms and tp=2 "
          f"plain {tp2['step_ms']:.2f} ms; replay device {m['dev_ms']:.3f} vs tp=2 plain "
          f"{tp2['dev_ms']:.3f} ms; graph kernel nodes a step {m['nodes']} vs {tp2['nodes']} "
          f"[{card}]", flush=True)
    return records, dict(m, tp1=out[1])


def par_spec(card: str, tree, plain, tp2: dict) -> tuple:
    """(i): n-gram speculation at tp = 2 over REST: every verify dispatch a
    replay of the spec graph, K1 launches = verify dispatches x layers x
    ranks (the K + 1 columns folded into rows at a rank's heads); the
    tokens teacher-forced and equal to tp = 1's plain greedy (``plain``) up
    to a near-tie; on live state a replay at full caps bit-equal to the
    eager sharded spec step from identical copies. Returns ([(label,
    counts)], metrics)."""
    import torch

    label = f"parallel spec ngram tp={PAR_TP}"
    server, _ = par_load(label, card, {}, params=tree, tensor_parallel=PAR_TP,
                         topology=par_topology(PAR_TP))
    texts = prompts(N_REQUESTS)
    b, served, launches, m = rest_serve(label, card, server, texts, spec_mode="ngram",
                                        spec_k=SPEC_K)
    replays, eager = m["dispatches"]
    n = server._cfg.n_layers * PAR_TP
    want = {"k1": replays * n, "k1_int8": 0, "k1p": 0, "k1p_int8": 0,
            "k2": (replays + N_REQUESTS) * n, "replays": N_REQUESTS, "eager": 0}
    if (b._graphs or b._spec_graph is None or replays == 0 or eager
            or {k: launches[k] for k in want} != want):
        fail(f"[{label}] verify dispatches (replays, eager) {m['dispatches']}, launches "
             f"{launches}, expected {want}")
    teacher_check(label, card, server, texts, served)
    equal = near_tie_check(f"{label} vs tp=1 plain", card, server, texts, served, plain)
    admit_now(b, texts, ahead=768)
    prog = server._get_spec_step(b.S, SPEC_K, b.hist_len, mode="ngram", n_pages=b.n_pages)
    b._draft_cap.fill_(SPEC_K)
    copy = spec_state(b, pools=True)
    out = b._spec_graph.replay().clone()
    ref = prog(copy[0], *copy[1:4], b._temp, b._block_tables, copy[4], b._draft_cap, copy[5])
    torch.cuda.synchronize()
    if not (torch.equal(out, ref) and spec_equal(b, copy)):
        fail(f"[{label}] the spec graph's replay and the eager sharded spec step differ")
    del copy, out, ref
    nodes = len(graph_kernel_names(b._spec_graph.graph))
    dev_ms = events_ms(b._spec_graph.replay)
    print(f"[{label}] accept {m['accept']:.4f}, tokens a forward {m['tokens_per_forward']:.4f}; "
          f"{equal} of {N_REQUESTS} equal to tp=1's plain greedy throughout, the rest up to a "
          f"near-tie; verify replay bit-equal to the eager sharded step at caps {SPEC_K}; step "
          f"wall {m['step_ms']:.2f} ms a verify dispatch vs tp=2 plain {tp2['step_ms']:.2f} ms; "
          f"replay device {dev_ms:.3f} vs {tp2['dev_ms']:.3f} ms; graph kernel nodes {nodes} vs "
          f"{tp2['nodes']} [{card}]", flush=True)
    del server, b
    release_server_memory(workspaces=False)
    return [(label, launches)], dict(m, equal=equal, dev_ms=dev_ms, nodes=nodes)


def par_decode_slice(card: str, base, plain) -> tuple:
    """(j): ``decode_devices=2`` on the tp = 1 server ``base``, disaggregated
    (one prefill worker on this card): the decode slice names the card
    twice and decodes on it; over REST every dispatch a replay and the
    tokens equal to tp = 1's local batcher (``plain``) up to a near-tie;
    the scaling snapshot counts 2 decode devices, so the autoscaler's
    ``decide_rebalance`` moves a backlog up under the default
    ``min_decode_devices``, and ``rebalance_disagg`` to its target serves
    the same requests again. Returns ([(label, counts)], metrics)."""
    import statistics

    from seldon_core_tpu_torch.controlplane import autoscaler as auto
    from seldon_core_tpu_torch.observability.timeline import scaling_snapshot

    label = "parallel disagg decode_devices=2"
    texts = prompts(N_REQUESTS)
    base.decode_devices = 2
    records, served = [], []
    try:
        svc, httpd, url, build_s = build_service(label, base, disaggregation="remote_prefill",
                                                 prefill_workers=1)
        b = svc.batcher
        try:
            for turn in (0, 1):
                zero_counts(base)
                base._decode_replays = base._decode_eager = 0
                results, wall = post_all(url, texts)
                served.append(served_tokens(label, results))
                counts = read_counts(base)
                disp = (base._decode_replays, base._decode_eager)
                if disp[0] == 0 or disp[1]:
                    fail(f"[{label}] decode dispatches as (replays, eager) {disp}")
                records.append((f"{label} turn {turn}", counts))
                snap = scaling_snapshot(base, batcher=b)
                if (snap["decode_devices"], snap["prefill_devices"]) != (2, 1 + turn):
                    fail(f"[{label}] scaling snapshot {snap}: expected 2 decode and "
                         f"{1 + turn} prefill devices")
                if turn == 0:
                    step_ms = statistics.median(base._decode_step_times) * 1e3
                    sig = [auto.ReplicaSignals.from_scaling(dict(snap, handoff_queue_depth=6))]
                    d, _ = auto.decide_rebalance(sig, auto.AutoscalerConfig(
                        rebalance=True, rebalance_stable_ticks=1, rebalance_cooldown_s=0.0),
                        auto.ControllerState(), 0.0)
                    if (d.action, d.target) != (auto.REBALANCE, 2) or not b.rebalance_disagg(
                            d.target):
                        fail(f"[{label}] decide_rebalance on the backlog: {d}")
        finally:
            stop_service(label, base, svc, httpd)
    finally:
        base.decode_devices = 0
    equal = [near_tie_check(f"{label} turn {t} vs tp=1 local", card, base, texts, served[t],
                            plain) for t in (0, 1)]
    print(f"[{label}] decode slice of 2 (this card twice), decoding on it: built in "
          f"{build_s:.3f} s; {equal} of {N_REQUESTS} equal to the local batcher throughout, the "
          f"rest up to a near-tie; step wall {step_ms:.2f} ms; the snapshot's decode_devices 2 "
          f"let decide_rebalance move the backlog up (REBALANCE to 2 prefill workers), and "
          f"rebalance_disagg served the second turn [{card}]", flush=True)
    return records, {"step_ms": step_ms, "equal": equal}


def par_k1_partial_case(kv: str, flush) -> dict:
    """K1's partial mode at a {seq 2, model 2} rank's heads (b = 8, h = kvh
    = 16, hd 128, pages of 64, 4 a row, ctx 156; row 7 one page of 41 keys,
    so 'seq' rank 1 holds none of it): each rank's columns through the
    kernel, the two merged by ``softmax_merge``, held to K1's tolerance of
    the plain version over the whole table, the empty rank's state (max
    -FLT_MAX, sum 0) checked; rank 0's launch timed beside its plain
    version and SDPA over its keys."""
    import torch
    import torch.nn.functional as F

    from seldon_core_tpu_torch.models.transformer import NULL_PAGE, gather_paged_view
    from seldon_core_tpu_torch.ops.paged_attention import (paged_attention_partial,
                                                           paged_attention_partial_ref,
                                                           paged_attention_ref)
    from seldon_core_tpu_torch.parallel.collectives import softmax_merge

    b, h, kvh, hd, ps, n_pages, ctx, sp = 8, 16, 16, 128, 64, 4, 124 + MAX_NEW, 2
    q, cache, cache32, bt, positions, used = k1_inputs(b, h, kvh, hd, ps, n_pages, ctx, None,
                                                       seed=71, kv=kv)
    bt[7, 1:] = NULL_PAGE
    positions[7] = 40
    label = f"K1 partial {kv} sp={sp} b={b} h={h} kvh={kvh} ctx={ctx}"
    tables = [bt[:, s::sp].contiguous() for s in range(sp)]
    counter = "launches_int8" if kv == "int8" else "launches"
    before = getattr(paged_attention_partial, counter)
    parts = [paged_attention_partial(q, cache, tables[s], positions, sp, s) for s in range(sp)]
    torch.cuda.synchronize()
    if getattr(paged_attention_partial, counter) != before + sp:
        fail(f"{label}: the wrapper did not count its launches")
    m1, l1, acc1 = parts[1]
    if not ((l1[7] == 0).all() and (acc1[7] == 0).all() and (m1[7] < -1e38).all()):
        fail(f"{label}: the rank holding no page of row 7 did not write the empty state")
    ref32 = paged_attention_ref(q.float(), cache32, bt, positions)
    merged = softmax_merge(parts, torch.float32)[0]
    err = k1_check(label, merged.to(torch.bfloat16), ref32)
    t0 = tables[0]
    ms = time_ms(lambda: paged_attention_partial(q, cache, t0, positions, sp, 0), flush)
    plain_ms = time_ms(lambda: paged_attention_partial_ref(q, cache, t0, positions, sp, 0), flush)
    walked = -(-used // sp)          # rank 0's pages of a full row
    k_all, v_all, pos_view = gather_paged_view(cache, t0[:, :walked].contiguous(), q.dtype)
    qs, ks, vs = q.transpose(1, 2), k_all.transpose(1, 2), v_all.transpose(1, 2)
    mask = (pos_view <= positions)[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
                         flush)
    # rank 0's work: the keys of its pages each row attends (pages 0 and 2
    # of a full row: 64 + 28 keys; row 7: 41), their position rows and table
    # entries, q, the positions and the float32 state out
    keys = (b - 1) * (ps + ctx - 2 * ps) + 41
    kv_row = 2 * (hd + 4) if kv == "int8" else 2 * hd * 2
    nbytes = (keys * kvh * kv_row + ((b - 1) * walked + 1) * (ps * 4 + 4) + b * h * hd * 2
              + b * 4 + b * h * (hd + 2) * 4)
    flops = 4 * h * keys * hd
    bytes_s, flops_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    print(f"{label}: rank 0 kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{max(bytes_s, flops_s) * 1e3:.4f} library_ms {library_ms:.4f} (SDPA over its keys); "
          f"merged over {sp} ranks max_abs_err {err:.3e} ({K1_TOL_REASON}); the empty rank's "
          f"state checked", flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_s, flops_s) * 1e3,
                bound_by="bytes" if bytes_s >= flops_s else "operations")


def par_tied_head_case(name: str, vocab: int, dim: int, flush) -> dict:
    """The tied int8 head through K4 (``tied_int8_logits``: the transposed
    int8 copy, the K scale folded into the activations as a bf16 head and
    remainder, 2M rows of one launch) at M = 8, against its plain version
    ``x.float() @ dequantize(emb).float().t()`` within K4's tolerance;
    timed beside it and torch.matmul on a dequantized bf16 copy."""
    import torch

    from seldon_core_tpu_torch.models.transformer import tied_int8_logits, tied_int8_logits_ref
    from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul
    from seldon_core_tpu_torch.ops.quantize import quantize_array

    g = torch.Generator(device="cuda").manual_seed(vocab + dim)
    emb = quantize_array(torch.randn((vocab, dim), generator=g, device="cuda") * 0.02)
    head_t = (emb.q.t().contiguous(), torch.ones(vocab, dtype=torch.float32, device="cuda"))
    x = torch.randn((8, 1, dim), generator=g, device="cuda").to(torch.bfloat16)
    before = int8_matmul.launches
    got = tied_int8_logits(x, emb, head_t)
    torch.cuda.synchronize()
    if int8_matmul.launches != before + 1:
        fail(f"tied int8 head {name}: expected one K4 launch, {int8_matmul.launches - before}")
    want = tied_int8_logits_ref(x, emb)
    tol = K4_RTOL * (x.float().abs() @ (emb.q.float() * emb.scale).abs().t())
    diff = (got - want).abs()
    err = diff.max().item()
    if not torch.isfinite(got).all() or (diff > tol).any():
        fail(f"tied int8 head {name}: max_abs_err {err} beyond {K4_TOL_REASON}")
    ms = time_ms(lambda: tied_int8_logits(x, emb, head_t), flush)
    plain_ms = time_ms(lambda: tied_int8_logits_ref(x, emb), flush)
    w = (emb.q.float() * emb.scale).to(torch.bfloat16).t()
    library_ms = time_ms(lambda: x @ w, flush)
    # the int8 codes once, the scale, x and the float32 logits
    nbytes = vocab * dim + dim * 4 + 8 * dim * 2 + 8 * vocab * 4
    bytes_s, flops_s = nbytes / HBM_BYTES_PER_S, 2 * 8 * vocab * dim / BF16_FLOPS_PER_S
    print(f"tied int8 head {name} [8,{dim}] x [{dim},{vocab}] -> float32 (K4 on the transposed "
          f"codes, 16 rows): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{max(bytes_s, flops_s) * 1e3:.4f} library_ms {library_ms:.4f} (torch.matmul on a "
          f"dequantized bf16 copy); max_abs_err {err:.3e} ({K4_TOL_REASON})", flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_s, flops_s) * 1e3,
                bound_by="bytes" if bytes_s >= flops_s else "operations")


def parallel_phase(card: str, base=None) -> tuple:
    """The [parallel] phase, parts (a), (f)-(j), (b), (c) and (e) ((d) is
    ``parallel_predict``). ``base`` is the loaded tp = 1 bf16 7B server
    (the serving phase's), else one is loaded. Returns (launch records,
    summary)."""
    import torch

    t_phase = time.perf_counter()
    release_server_memory(workspaces=False)
    own = base is None
    if own:
        base, _ = load_llm("parallel bf16 tp=1", card, {})
    base.decode_fuse_steps = 0
    texts = prompts(N_REQUESTS)
    tree = base._module.param_tree()
    records, summary = [], {}
    rec, summary["batcher"] = par_batcher_runs(card, base, texts, tree)
    records += rec
    bf16, int8 = summary["batcher"]["bf16"], summary["batcher"]["int8"]
    rec, summary["data2"] = par_mesh(card, "parallel bf16 data=2 model=2", {}, tree,
                                     PAR_DATA_MESH, bf16["served_tp1"], bf16,
                                     prefix_cache_size=8)
    records += rec
    rec, summary["seq2"] = par_mesh(card, "parallel int8 seq=2 model=2",
                                    dict(quantize="int8", kv_cache_dtype="int8"), tree,
                                    PAR_SEQ_MESH, int8["served_tp1"], int8)
    records += rec
    rec, summary["lora"] = par_lora(card, tree, bf16)
    records += rec
    rec, summary["spec"] = par_spec(card, tree, bf16["served_tp1"], bf16)
    records += rec
    rec, summary["slice"] = par_decode_slice(card, base, bf16["served_tp1"])
    records += rec
    rec, summary["generate"] = par_generate(card, base, texts, tree)
    records += rec
    del tree
    if own:
        del base
    release_server_memory(workspaces=False)
    rec, summary["moe"] = par_moe(card, texts)
    records += rec
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    summary["kernels"] = par_kernel_cases(card, lambda: scratch.fill_(1))
    del scratch
    if own:
        release_server_memory()
    for model in ("bf16", "int8"):
        r = summary["batcher"][model]
        coll = ("not measured" if r["coll_prof_ms"] is None else f"{r['coll_prof_ms']:.3f} ms")
        print(f"  parallel {model}: tp={PAR_TP} step wall {r['step_ms']:.2f} ms vs tp=1 "
              f"{r['tp1']['step_ms']:.2f} ms; replay device {r['dev_ms']:.3f} vs "
              f"{r['tp1']['dev_ms']:.3f} ms; kernel nodes a step {r['nodes']} vs "
              f"{r['tp1']['nodes']}; collectives a step {coll} (torch.profiler) "
              f"/ {r['coll_ev_ms']:.3f} ms (events); weights a rank {r['rank_gb']:.3f} GB; "
              f"peak {r['peak_gb']:.2f} GB [{card}]", flush=True)
    for key, what in (("data2", f"bf16 {PAR_DATA_MESH}"), ("seq2", f"int8 {PAR_SEQ_MESH}"),
                      ("lora", f"LoRA x {PAR_ADAPTERS} tp={PAR_TP}"),
                      ("spec", f"n-gram spec tp={PAR_TP} (a verify dispatch)")):
        r = summary[key]
        ref = summary["batcher"]["int8" if key == "seq2" else "bf16"]
        print(f"  parallel {what}: step wall {r['step_ms']:.2f} ms vs tp={PAR_TP} "
              f"{ref['step_ms']:.2f} ms; replay device {r['dev_ms']:.3f} vs {ref['dev_ms']:.3f} "
              f"ms; kernel nodes a step {r['nodes']} vs {ref['nodes']} [{card}]", flush=True)
    print(f"  parallel decode_devices=2 (tp=1, disaggregated): step wall "
          f"{summary['slice']['step_ms']:.2f} ms [{card}]", flush=True)
    g = summary["generate"]
    print(f"  parallel generate on {PAR_GEN_MESH}: {g['step_ms']:.2f} ms a decode step, "
          f"{g['nodes']} kernel nodes a step, weights a rank {g['rank_gb']:.3f} GB [{card}]",
          flush=True)
    print(f"[parallel] phase_s {time.perf_counter() - t_phase:.1f} [{card}]", flush=True)
    return records, summary


def parallel_predict(card: str, model) -> int:
    """(d): TorchServer with tensor_parallel = 2 over an explicit
    co-located topology (the process topology, set for the call), reached
    through a GraphEngine spec's typed parameters with strict_sharding: on
    the folded ResNet-50 leaf ``model`` the strict error (no logical axes:
    replicated), then over 'data' = 2 without it, its logits within FWD_TOL
    of the unsharded forward; on a small transformer checkpoint, its logits
    within FWD_TOL of the unsharded forward's (bf16 partials summed in
    float32). Returns K3's launches."""
    import asyncio
    import tempfile

    import numpy as np
    import torch

    from seldon_core_tpu_torch.contracts.payload import SeldonMessage
    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.models.resnet_infer import resnet_serve_forward
    from seldon_core_tpu_torch.ops.fused_resnet import fused_identity_chain
    from seldon_core_tpu_torch.parallel.topology import set_topology
    from seldon_core_tpu_torch.runtime.engine import GraphEngine
    from seldon_core_tpu_torch.servers.torchserver import export_checkpoint

    def unit(uri, strict):
        return {"name": "m", "type": "MODEL", "implementation": "JAX_SERVER", "modelUri": uri,
                "parameters": [{"name": "tensor_parallel", "value": str(PAR_TP), "type": "INT"},
                               {"name": "strict_sharding", "value": str(strict).lower(),
                                "type": "BOOL"}]}

    prev = set_topology(par_topology(2 * PAR_TP))
    try:
        with tempfile.TemporaryDirectory(prefix="parallel-ckpt-") as root:
            rn = os.path.join(root, "resnet50")
            export_checkpoint(rn, "resnet50", {"params": model.param_tree()},
                              kwargs={"fused": True}, input_shape=[224, 224, 3])
            x = np.round(np.random.default_rng(8).standard_normal(
                (PREDICT_BATCH, 224, 224, 3)), 2).astype(np.float32)
            body = {"data": {"tensor": {"shape": list(x.shape), "values": x.ravel().tolist()}}}
            try:
                engine = GraphEngine(graph_spec(unit(rn, True)), device="cuda")
                asyncio.run(engine.predict(SeldonMessage.from_dict(body)))
                fail("[parallel] (d) strict_sharding on a replicated ResNet-50 did not raise")
            except ValueError as e:
                if "every param leaf is replicated" not in str(e):
                    raise
                strict_msg = str(e)
            engine = GraphEngine(graph_spec(unit(rn, False)), device="cuda")
            leaf = engine.state.root.component
            fused_identity_chain.launches = 0
            out = asyncio.run(engine.predict(SeldonMessage.from_dict(body))).to_dict()
            k3 = k3_count()
            got = torch.from_numpy(logits_of(out)).float()
            with torch.no_grad():
                ref = resnet_serve_forward(model, torch.from_numpy(x).cuda(),
                                           pallas_stages=()).float().cpu()
            err, bound, clear, agree = check_logits("[parallel] (d) ResNet-50 over data=2",
                                                    got, ref)
            if k3 == 0:
                fail("[parallel] (d) K3 never launched over the 'data' ranks")
            print(f"[parallel] (d) TorchServer tensor_parallel={PAR_TP} through a GraphEngine "
                  f"spec over {dict(leaf.mesh.shape)} (4 ranks on this card): strict_sharding "
                  f"on the ResNet-50 leaf raised ({strict_msg.split(' (report')[0]}); without "
                  f"it, {PREDICT_BATCH} images in buckets {leaf.batch_buckets} ran each 'data' "
                  f"rank's half through K3 ({k3} launches): max |logit diff| vs the unsharded "
                  f"cuDNN chain {err:.4g} (bound {bound:.4g}), top-1 equal in {agree} of {clear} "
                  f"clear rows [{card}]", flush=True)
            del engine, leaf
            tiny = get_model("transformer", device="cuda", **dict(
                LLAMA2_7B, n_layers=2, dim=1024, n_heads=8, n_kv_heads=8, ffn_dim=2816))
            tiny.init_params(torch.Generator(device="cuda").manual_seed(4))
            tk = os.path.join(root, "tiny")
            export_checkpoint(tk, "transformer", {"params": tiny.param_tree()},
                              kwargs=dict(LLAMA2_7B, n_layers=2, dim=1024, n_heads=8,
                                          n_kv_heads=8, ffn_dim=2816), input_shape=[16],
                              input_dtype="int32")
            engine = GraphEngine(graph_spec(unit(tk, True)), device="cuda")
            toks = np.random.default_rng(9).integers(0, 32000, size=(4, 16))
            body = {"data": {"tensor": {"shape": [4, 16], "values": toks.ravel().tolist()}}}
            out = asyncio.run(engine.predict(SeldonMessage.from_dict(body))).to_dict()
            got = torch.from_numpy(logits_of(out)).float()
            with torch.no_grad():
                ref = tiny(torch.from_numpy(toks).cuda())[0].float().cpu()
            err, bound, clear, agree = check_logits(
                "[parallel] (d) 2-layer transformer over tp=2", got.reshape(-1, 32000),
                ref.reshape(-1, 32000))
            print(f"[parallel] (d) a 2-layer transformer checkpoint (d=1024, 8 heads, vocab "
                  f"32000) through the same spec with strict_sharding (it shards): logits "
                  f"[4, 16, 32000], max |diff| vs the unsharded forward {err:.4g} (bound "
                  f"{bound:.4g} = {FWD_TOL} x max|logit|: bf16 partials summed in float32), "
                  f"top-1 equal in {agree} of {clear} clear rows [{card}]", flush=True)
            del engine, tiny
    finally:
        set_topology(prev)
    release_server_memory(workspaces=False)
    return k3


# [train]: the training path (parallel/train.py, ops/ring_attention.py,
# parallel/pipeline.py) at Llama-2-7B widths on one card. The depth is cut:
# float32 master weights, their gradients and AdamW's two moments are 16
# bytes a param, ~17.2 GB at 4 layers (1.07 B params) where 32 layers would
# need ~108 GB. bf16 compute, fused_norm=True (K2 under autograd), a batch
# of TRAIN_ROWS x TRAIN_SEQ tokens, adamw(TRAIN_LR) with optax's defaults.
TRAIN_LAYERS = 4
TRAIN_ROWS, TRAIN_SEQ = 2, 2048
TRAIN_STEPS = 5
TRAIN_LR = 1e-4
TRAIN_SEED = 11
# (a) the graph-cut check: each leaf's gradient through K2 within
# TRAIN_GRAD_RTOL of the same step through K2's plain version on the same
# tensors, as |g - g_plain| / |g_plain| (Frobenius norms). K2's o is within
# one bf16 ulp of the plain o, its backward adds in float32 where autograd
# rounds to bf16 first, and bf16 products carry both through the layers (a
# CPU rehearsal at tiny widths: ~1e-2 of max|g| elementwise); a graph cut at
# K2 leaves a leaf's gradient 0 or ~100 % off
TRAIN_GRAD_RTOL = 0.05
# (a) K2's explicit backward on one saved input against autograd through
# the plain version: within TRAIN_BWD_ULPS bf16 ulps of max|g| (autograd
# rounds the norm's cotangent to bf16 before it adds the residual's; the
# formula adds in float32 and rounds once)
TRAIN_BWD_ULPS = 2
# (b) the ring over a co-located mesh against the unsharded step (ring too:
# one block), TRAIN_MESH_LAYERS layers: the loss within TRAIN_LOSS_RTOL and
# grad_norm within TRAIN_NORM_RTOL relative (bf16 row-parallel partials over
# 'model' are summed in float32 and rounded once, where the unsharded
# product rounds its whole sum once)
TRAIN_MESH = {"seq": 2, "model": 2}
TRAIN_MESH_LAYERS = 2
TRAIN_LOSS_RTOL = 5e-3
TRAIN_NORM_RTOL = 5e-2
# (c) GPipe over {pipe 2}, two 7B-wide blocks as stages, TRAIN_MICRO
# microbatches of one row: bit-equal to the stages applied in order to the
# same microbatches; within TRAIN_PIPE_RTOL * max|y| of the whole batch at
# once (other row counts take other GEMM kernels, which round differently)
TRAIN_MICRO = 4
TRAIN_PIPE_RTOL = 2e-2
# --train: 8 layers and more steps; the {data 2, seq 2, model 2} mesh (full
# and ring attention); the MoE FFN at Mixtral-8x7B widths, one layer, over
# {expert 2, seq 2, model 2}
TRAIN_FULL_LAYERS, TRAIN_FULL_STEPS = 8, 10
TRAIN_FULL_MESH = {"data": 2, "seq": 2, "model": 2}
TRAIN_MOE_MESH = {"expert": 2, "seq": 2, "model": 2}
TRAIN_IDLE_GB = 0.1   # device memory the phase may leave allocated


def train_model(cfg: dict, seed: int):
    """A float32-stored transformer on the card, weights drawn from ``seed``."""
    import torch

    from seldon_core_tpu_torch.models import get_model

    model = get_model("transformer", device="cuda", **cfg)
    model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    return model


def train_tokens(seed: int, rows: int = TRAIN_ROWS):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, LLAMA2_7B["vocab_size"], (rows, TRAIN_SEQ), generator=g,
                         device="cuda")


@contextlib.contextmanager
def k2_swapped(fn):
    """``fn`` in the place of K2's wrapper while the block runs (the models
    import the wrapper at each call): K2's plain version as the graph-cut
    check's reference. Never a path of the port itself."""
    from seldon_core_tpu_torch.ops import fused_norm

    wrapper = fused_norm.fused_residual_rmsnorm
    fused_norm.fused_residual_rmsnorm = fn
    try:
        yield
    finally:
        fused_norm.fused_residual_rmsnorm = wrapper


def timed_step(step, state, tokens):
    """One training step: (state, loss, grad_norm, wall ms to the metrics
    on the host)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, tokens)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    return state, loss, gnorm, (time.perf_counter() - t0) * 1e3


def k2_grad_check(label: str, x, hh, w) -> float:
    """K2's Function on one saved input: the forward through the kernel
    (y bit-equal, o within one bf16 ulp of the plain version), then its
    explicit backward against autograd through the plain version on the
    same tensors and cotangents. Returns the worst error over max|g|."""
    import torch

    from seldon_core_tpu_torch.ops.fused_norm import (fused_residual_rmsnorm,
                                                      residual_rmsnorm_ref)

    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    d_y = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
    d_o = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
    leaves = [t.clone().requires_grad_() for t in (x, hh, w)]
    y, o = fused_residual_rmsnorm(*leaves, K2_EPS)
    if y.grad_fn is None or o.grad_fn is None:
        fail(f"{label}: K2 under grad returned outputs without a grad_fn")
    ref_leaves = [t.clone().requires_grad_() for t in (x, hh, w)]
    y_ref, o_ref = residual_rmsnorm_ref(*ref_leaves, K2_EPS)
    k2_check(label, y.detach(), o.detach(), y_ref.detach(), o_ref.detach())
    got = torch.autograd.grad((y, o), leaves, (d_y, d_o))
    want = torch.autograd.grad((y_ref, o_ref), ref_leaves, (d_y, d_o))
    worst = 0.0
    for name, a, b in zip(("d_x", "d_h", "d_weight"), got, want):
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        if not torch.isfinite(a.float()).all() or err > TRAIN_BWD_ULPS * 2.0 ** -8 * scale:
            fail(f"{label}: the explicit backward's {name} is {err:.3e} from autograd through "
                 f"the plain version (max |g| {scale:.3e})")
        worst = max(worst, err / scale)
    return worst


def k2_train_case(flush) -> dict:
    """K2 at the training shape [TRAIN_ROWS * TRAIN_SEQ, dim] bf16 with a
    float32 weight (the master weight): checked, timed in turns with its
    plain version; its explicit backward (plain PyTorch) timed for
    information."""
    import torch

    from seldon_core_tpu_torch.ops.fused_norm import (fused_residual_rmsnorm,
                                                      residual_rmsnorm_backward,
                                                      residual_rmsnorm_ref)

    rows, d = TRAIN_ROWS * TRAIN_SEQ, K2_D
    x, hh, _ = k2_inputs(rows, d, seed=rows)
    w = 1.0 + 0.1 * torch.randn((d,), device="cuda")
    label = f"K2 [{rows},{d}] bf16, float32 weight"
    y, o = fused_residual_rmsnorm(x, hh, w, K2_EPS)
    err = k2_check(label, y, o, *residual_rmsnorm_ref(x, hh, w, K2_EPS))
    (ms, _), (plain_ms, _) = time_turns([lambda: fused_residual_rmsnorm(x, hh, w, K2_EPS),
                                         lambda: residual_rmsnorm_ref(x, hh, w, K2_EPS)], flush)
    y32 = y.float()
    rstd = torch.rsqrt(torch.mean(y32 * y32, dim=-1, keepdim=True) + K2_EPS)
    del y32
    d_y, d_o = torch.randn_like(x), torch.randn_like(x)
    bwd_ms = time_ms(lambda: residual_rmsnorm_backward(y, w, rstd, d_y, d_o), flush)
    nbytes = 4 * rows * d * 2 + d * 4
    bytes_s, flops_s = nbytes / HBM_BYTES_PER_S, 5 * rows * d / BF16_FLOPS_PER_S
    # the backward reads y, d_y, d_o, rstd and the weight, writes d_x and d_w
    bwd_bound = (3 * rows * d * 2 + rows * 4 + d * 4 + rows * d * 2 + d * 4) / HBM_BYTES_PER_S
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=max(bytes_s, flops_s) * 1e3,
                bound_by="bytes" if bytes_s >= flops_s else "operations",
                bwd_ms=bwd_ms, bwd_bound_ms=bwd_bound * 1e3)


def train_single(card: str, layers: int, steps: int) -> tuple:
    """(a): Llama-2-7B widths at ``layers`` layers on one card. The
    graph-cut check, K2's explicit backward on the first layer's saved
    input, then ``steps`` AdamW steps on one repeated batch (counts zeroed
    just before, read just after: K2 once a layer a forward, no other
    kernel; the loss falls), then one profiled step. Returns (counts,
    summary)."""
    import torch

    from seldon_core_tpu_torch.ops import fused_norm
    from seldon_core_tpu_torch.parallel import train

    label = f"[train] (a) 7B widths x {layers} layers"
    model = train_model(dict(LLAMA2_7B, n_layers=layers, fused_norm=True), TRAIN_SEED)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = train_tokens(TRAIN_SEED)
    tx = train.adamw(TRAIN_LR)
    state = train.init_train_state(model, tx, device="cuda")
    names, params = zip(*model.named_parameters())
    with torch.no_grad():   # layer 0's K2 input: the embedding and its attention output
        layer = model.layer_0
        x0 = model._embed(tokens)
        pos = torch.arange(TRAIN_SEQ, device="cuda")[None, :].expand(TRAIN_ROWS, -1)
        saved = (x0, layer.attention(layer.attention_norm(x0), pos)[0],
                 layer.ffn_norm.weight.detach().clone())
    g_kernel = torch.autograd.grad(train.next_token_loss(model, tokens), params)
    with k2_swapped(fused_norm.residual_rmsnorm_ref):
        g_plain = torch.autograd.grad(train.next_token_loss(model, tokens), params)
    worst, worst_max, zero = (0.0, ""), 0.0, []
    for name, a, b in zip(names, g_kernel, g_plain):
        if not torch.isfinite(a).all():
            fail(f"{label}: {name}'s gradient through K2 is not finite")
        if a.abs().max().item() == 0:
            zero.append(name)
        worst = max(worst, ((a - b).norm().item() / b.norm().item(), name))
        worst_max = max(worst_max, (a - b).abs().max().item() / b.abs().max().item())
    del g_kernel, g_plain
    if zero:
        fail(f"{label}: the gradient through K2 is zero for {zero} (a cut graph)")
    if worst[0] > TRAIN_GRAD_RTOL:
        fail(f"{label}: {worst[1]}'s gradient through K2 is {worst[0]:.3e} (relative, "
             f"Frobenius) from the plain-K2 step's (tolerance {TRAIN_GRAD_RTOL})")
    bwd_err = k2_grad_check(f"{label} K2 backward", *saved)
    del saved, x0
    step = train.make_train_step(tx)
    release_server_memory(workspaces=False)
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    losses, norms, walls = [], [], []
    for _ in range(steps):
        state, loss, gnorm, ms = timed_step(step, state, tokens)
        losses.append(loss)
        norms.append(gnorm)
        walls.append(ms)
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if counts["k2"] != layers * steps or counts["k1"] or counts["k1_int8"] or counts["k4"]:
        fail(f"{label}: launches {counts} over {steps} steps, expected K2 {layers * steps} "
             f"(one a layer a forward) and no other kernel")
    if not all(map(math.isfinite, losses + norms)) or not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall over {steps} steps on one batch: {losses}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, _, _, prof_ms = timed_step(step, state, tokens)
    split = profile_split(prof)
    del prof
    # the step's halves on the host clock, the card drained around each:
    # loss and gradients (forward + backward), then the optimizer's update
    tensors = [t for _, t, _ in train.trained_tensors(state.params)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads = torch.autograd.grad(train.next_token_loss(model, tokens), tensors)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    updates, _ = tx.update(grads, state.opt_state, tensors)
    train.apply_updates(tensors, updates)
    torch.cuda.synchronize()
    fwd_bwd_ms, opt_ms = (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
    del tensors, grads, updates
    wall = statistics.median(walls[1:])
    tokens_n = TRAIN_ROWS * TRAIN_SEQ
    flops = 6 * n_params * tokens_n
    print(f"{label} ({n_params / 1e9:.3f} B params, float32 master weights, bf16 compute, "
          f"batch {TRAIN_ROWS} x {TRAIN_SEQ}, adamw({TRAIN_LR})): graph-cut check: every "
          f"leaf's gradient through K2 finite, non-zero and within {worst[0]:.3e} (relative, "
          f"Frobenius; worst {worst[1]}; tolerance {TRAIN_GRAD_RTOL}) of the plain-K2 step, "
          f"elementwise within {worst_max:.3e} x max|g|; K2's explicit "
          f"backward on layer 0's input within {bwd_err:.3e} x max|g| of autograd through the "
          f"plain version; losses {' '.join(f'{v:.4f}' for v in losses)}; grad_norm "
          f"{' '.join(f'{v:.4f}' for v in norms)}; step wall {wall:.1f} ms (median of steps "
          f"2-{steps}; first {walls[0]:.1f}) = {tokens_n / wall * 1e3:.0f} tokens/s, "
          f"{flops / wall / 1e9:.1f} TFLOP/s of products (6 x params x tokens); peak "
          f"{peak:.2f} GB; K2 launches {counts['k2']} = {layers} layers x {steps} forwards; "
          f"one profiled step ({prof_ms:.1f} ms wall): {split}; a step's halves: forward + "
          f"backward {fwd_bwd_ms:.1f} ms, the optimizer's update {opt_ms:.1f} ms [{card}]",
          flush=True)
    del state, model, params, step
    return counts, dict(layers=layers, params_b=n_params / 1e9, losses=losses, wall_ms=wall,
                        tokens_s=tokens_n / wall * 1e3, peak_gb=peak, grad_rtol=worst[0],
                        grad_max=worst_max, bwd_err=bwd_err, split=split,
                        fwd_bwd_ms=fwd_bwd_ms, opt_ms=opt_ms)


def profile_split(prof) -> str:
    """A profiled step's device time by kernel class (the trace's device
    rows: kernels, copies): GEMMs (cuBLAS), K2, softmax and the loss, the
    rest (elementwise, the optimizer's, copies)."""
    classes = {"gemm": 0.0, "K2": 0.0, "softmax / cross-entropy": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        name = e.key.lower()
        if "fused_residual_rmsnorm" in name:
            key = "K2"
        elif any(k in name for k in ("gemm", "nvjet", "cutlass", "sm90_xmma", "gemv")):
            key = "gemm"
        elif "softmax" in name or "nll" in name:
            key = "softmax / cross-entropy"
        else:
            key = "other"
        classes[key] += dev_us(e) / 1e3
    total = sum(classes.values())
    if total == 0:
        return "not measured (the trace holds no device event)"
    return f"kernels {total:.1f} ms: " + ", ".join(f"{k} {v:.1f} ms" for k, v in classes.items())


def train_mesh(card: str, label: str, axes: dict, cfg: dict, seed: int, rows: int = TRAIN_ROWS
               ) -> tuple:
    """(b): one step of ``cfg`` over the co-located mesh ``axes`` against
    the same step unsharded, from the same weights and tokens (the sharded
    state first, dropped before the unsharded one is made): the loss within
    TRAIN_LOSS_RTOL and grad_norm within TRAIN_NORM_RTOL relative. K2 once
    a layer a rank, then once a layer. Returns (counts, summary)."""
    import torch

    from seldon_core_tpu_torch.parallel import train

    model = train_model(cfg, seed)
    tokens = train_tokens(seed + 1, rows)
    tx = train.adamw(TRAIN_LR)
    ranks = math.prod(axes.values())
    step = train.make_train_step(tx)
    release_server_memory(workspaces=False)
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    state = train.init_train_state(model, tx, par_topology(ranks).mesh(axes), device="cuda")
    state, loss_s, norm_s, ms_s = timed_step(step, state, tokens)
    counts = kernel_counts()
    peak_s = torch.cuda.max_memory_allocated() / 1e9
    del state
    release_server_memory(workspaces=False)
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    state = train.init_train_state(model, tx, device="cuda")
    state, loss_u, norm_u, ms_u = timed_step(step, state, tokens)
    unsharded = kernel_counts()
    peak_u = torch.cuda.max_memory_allocated() / 1e9
    del state, model
    layers = cfg["n_layers"]
    if counts["k2"] != ranks * layers or unsharded["k2"] != layers:
        fail(f"{label}: K2 launches {counts['k2']} sharded / {unsharded['k2']} unsharded, "
             f"expected {ranks * layers} / {layers}")
    loss_rel, norm_rel = abs(loss_s - loss_u) / abs(loss_u), abs(norm_s - norm_u) / norm_u
    if not (math.isfinite(loss_s) and math.isfinite(norm_s)) or loss_rel > TRAIN_LOSS_RTOL \
            or norm_rel > TRAIN_NORM_RTOL:
        fail(f"{label}: loss {loss_s} / grad_norm {norm_s} over the mesh against {loss_u} / "
             f"{norm_u} unsharded (relative {loss_rel:.3e} / {norm_rel:.3e}, tolerances "
             f"{TRAIN_LOSS_RTOL} / {TRAIN_NORM_RTOL})")
    print(f"{label}: one step over {axes} ({ranks} ranks on this card) loss {loss_s:.5f} "
          f"grad_norm {norm_s:.5f} vs unsharded {loss_u:.5f} / {norm_u:.5f} (relative "
          f"{loss_rel:.3e} / {norm_rel:.3e}; tolerances {TRAIN_LOSS_RTOL} / {TRAIN_NORM_RTOL}); "
          f"step wall {ms_s:.1f} ms vs {ms_u:.1f} ms; peak {peak_s:.2f} / {peak_u:.2f} GB; K2 "
          f"launches {counts['k2']} / {unsharded['k2']} [{card}]", flush=True)
    add_counts(counts, unsharded)
    return counts, dict(loss_rel=loss_rel, norm_rel=norm_rel, ms=ms_s, unsharded_ms=ms_u,
                        peak_gb=peak_s)


def train_pipeline(card: str) -> tuple:
    """(c): two 7B-wide blocks (bf16 compute) as the stages of
    ``pipeline_apply`` over {pipe 2}, TRAIN_MICRO microbatches of one row of
    TRAIN_SEQ positions, under no_grad: bit-equal to the stages applied in
    order to the same microbatches, within TRAIN_PIPE_RTOL * max|y| of the
    whole batch at once; K2 once a stage a microbatch. Returns (counts,
    summary)."""
    import torch
    from torch.func import functional_call

    from seldon_core_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params

    label = "[train] (c) GPipe"
    model = train_model(dict(LLAMA2_7B, n_layers=2, fused_norm=True), TRAIN_SEED + 3)
    blocks = model.layers()
    stacked = stack_stage_params([dict(b.named_parameters()) for b in blocks])
    template = blocks[0]
    per_stage = [{k: v[s] for k, v in stacked.items()} for s in range(2)]

    def stage_fn(p, hh):
        pos = torch.arange(hh.shape[1], device=hh.device)[None, :].expand(hh.shape[0], -1)
        return functional_call(template, p, (hh, pos))[0]

    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED + 4)
    x = torch.randn((TRAIN_MICRO, TRAIN_SEQ, K2_D), generator=g, device="cuda").to(
        torch.bfloat16)
    mesh = par_topology(2).mesh({"pipe": 2})
    with torch.no_grad():
        zero_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pipeline_apply(stage_fn, stacked, x, mesh, TRAIN_MICRO)
        torch.cuda.synchronize()
        pipe_ms = (time.perf_counter() - t0) * 1e3
        counts = kernel_counts()
        t0 = time.perf_counter()
        seq = torch.cat([stage_fn(per_stage[1], stage_fn(per_stage[0], mb))
                         for mb in x.chunk(TRAIN_MICRO)])
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
        whole = stage_fn(per_stage[1], stage_fn(per_stage[0], x))
    if counts["k2"] != 2 * TRAIN_MICRO:
        fail(f"{label}: K2 launches {counts['k2']}, expected {2 * TRAIN_MICRO}")
    if not torch.equal(got, seq):
        fail(f"{label}: the pipelined output is not bit-equal to the stages applied in order")
    err = (got.float() - whole.float()).abs().max().item()
    scale = whole.float().abs().max().item()
    if not torch.isfinite(got.float()).all() or err > TRAIN_PIPE_RTOL * scale:
        fail(f"{label}: {err:.3e} from the whole batch at once (max |y| {scale:.3e})")
    print(f"{label} over {{pipe 2}}, two 7B-wide blocks, {TRAIN_MICRO} microbatches of 1 x "
          f"{TRAIN_SEQ}: bit-equal to the stages applied in order to the same microbatches; "
          f"{err:.3e} from the whole batch at once (max |y| {scale:.3e}, tolerance "
          f"{TRAIN_PIPE_RTOL} x); {TRAIN_MICRO + 1} schedule steps {pipe_ms:.1f} ms wall vs the "
          f"stages in order {seq_ms:.1f} ms; K2 launches {counts['k2']} [{card}]", flush=True)
    del model, stacked, per_stage, x, got, seq, whole
    return counts, dict(err=err, pipe_ms=pipe_ms, seq_ms=seq_ms)


def train_phase(card: str, full: bool = False) -> tuple:
    """The [train] phase: (a), (b), (c); ``full`` (``--train``) adds the
    deeper run, the {data 2, seq 2, model 2} mesh and the MoE case. Returns
    (one launch record, summary); nothing is left allocated."""
    import torch

    t_phase = time.perf_counter()
    release_server_memory()
    total, summary = {}, {}
    counts, summary["a"] = train_single(card, TRAIN_LAYERS, TRAIN_STEPS)
    add_counts(total, counts)
    release_server_memory(workspaces=False)
    mesh_cfg = dict(LLAMA2_7B, n_layers=TRAIN_MESH_LAYERS, fused_norm=True, attention_impl="ring")
    counts, summary["b"] = train_mesh(card, "[train] (b) ring, 7B widths x "
                                      f"{TRAIN_MESH_LAYERS} layers", TRAIN_MESH, mesh_cfg,
                                      TRAIN_SEED + 1)
    add_counts(total, counts)
    release_server_memory(workspaces=False)
    counts, summary["c"] = train_pipeline(card)
    add_counts(total, counts)
    release_server_memory(workspaces=False)
    if full:
        counts, summary["a_full"] = train_single(card, TRAIN_FULL_LAYERS, TRAIN_FULL_STEPS)
        add_counts(total, counts)
        release_server_memory(workspaces=False)
        for impl in ("full", "ring"):
            counts, summary[f"b_{impl}"] = train_mesh(
                card, f"[train] --train {impl}, 7B widths x {TRAIN_MESH_LAYERS} layers",
                TRAIN_FULL_MESH, dict(mesh_cfg, attention_impl=impl), TRAIN_SEED + 5)
            add_counts(total, counts)
            release_server_memory(workspaces=False)
        counts, summary["moe"] = train_mesh(
            card, "[train] --train MoE, Mixtral-8x7B widths x 1 layer", TRAIN_MOE_MESH,
            dict(MIXTRAL_8X7B, n_layers=1, fused_norm=True), TRAIN_SEED + 7, rows=1)
        add_counts(total, counts)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    summary["k2"] = k2 = k2_train_case(lambda: scratch.fill_(1))
    del scratch
    print(f"K2 fused_residual_rmsnorm [{TRAIN_ROWS * TRAIN_SEQ},{K2_D}] bf16 (float32 weight, "
          f"the training shape): kernel_ms {k2['ms']:.4f} plain_ms {k2['plain_ms']:.4f} "
          f"bound_ms {k2['bound_ms']:.4f} ({k2['bound_by']}) library_ms null; its explicit "
          f"backward (plain PyTorch) {k2['bwd_ms']:.4f} ms, bound {k2['bwd_bound_ms']:.4f}; "
          f"max_abs_err {k2['err']:.3e} (y bit-equal, o within 1 bf16 ulp) [{card}]", flush=True)
    release_server_memory()
    left = torch.cuda.memory_allocated() / 1e9
    if left > TRAIN_IDLE_GB:
        fail(f"[train]: {left:.3f} GB left allocated after the phase")
    summary["k2"]["launches"] = total["k2"]
    print(f"[train] phase_s {time.perf_counter() - t_phase:.1f}; K2 launches {total['k2']} "
          f"[{card}]", flush=True)
    return ("train", total), summary



# [vit]: the predict path's remainder: ViT-B/16 at 224 x 224 (its
# published widths: 12 layers of d = 768, 12 heads, mlp 3,072, patch 16,
# 1,000 classes) and the MLP through TorchServer in bf16 and int8, a folded
# ResNet-50 in int8, SaliencyExplainer over them, and the ViT over a
# co-located {data 1, model 2} mesh. Weights are seeded random weights
# written by the port's export_checkpoint; nothing is downloaded.
VIT_INPUT = [224, 224, 3]
VIT_SEED = 16
VIT_PRODUCTS = 12 * 4 + 1   # K4 launches an int8 forward: 4 products a block + the head
MLP_KW = dict(features=[128, 128], num_classes=3)
MLP_BATCHES = (8, 128)
# saliency: the kernels' attributions against autograd through their plain
# versions on the same tensors: within SALIENCY_RTOL, relative Frobenius.
# Where the attribution itself is ill-conditioned in bf16 (a random ResNet-50's
# input gradient at few steps: relus after the first K3 chain flip with one
# ulp, and the flips compound over the chains; the distance falls about as
# 1/sqrt(steps)), both bf16 paths lie farther than that from each other.
# There, where K3 ran, the kernels' attributions must lie no farther (times
# 1 + SALIENCY_RTOL) from a float32 witness than the plain versions' do:
# autograd through a float32-compute forward of the same folded weights.
SALIENCY_RTOL = 0.05
SALIENCY_STEPS = (1, 8, 32)
VIT_MESH = {"data": 1, "model": 2}


@contextlib.contextmanager
def plain_kernels():
    """K3's and K4's plain versions in the place of their wrappers while
    the block runs (the forwards look the wrappers up at each call): the
    saliency check's reference, autograd through ``identity_chain_ref`` and
    ``int8_matmul_ref``. Never a path of the port itself."""
    from seldon_core_tpu_torch.models import resnet_infer
    from seldon_core_tpu_torch.ops import quantize
    from seldon_core_tpu_torch.ops.fused_resnet import identity_chain_ref
    from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul_ref

    def dense_ref(x, qt, out_dtype=None):
        y = int8_matmul_ref(x.reshape(-1, x.shape[-1]), qt.q, qt.scale,
                            out_dtype or qt.orig_dtype)
        return y.reshape(*x.shape[:-1], y.shape[-1])

    saved = resnet_infer.fused_identity_chain, quantize.int8_dense
    resnet_infer.fused_identity_chain = lambda x, blocks: identity_chain_ref(x, blocks)
    quantize.int8_dense = dense_ref
    try:
        yield
    finally:
        resnet_infer.fused_identity_chain, quantize.int8_dense = saved


def k4_counts():
    from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul

    return int8_matmul.launches, int8_matmul.launches_wgmma


def serve_rest(server, bodies):
    """``bodies`` POSTed at once to /api/v0.1/predictions of a component app
    over ``server``, after one warm-up request: [(code, body)], the walls
    (s)."""
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    httpd, _ = start(make_component_app(server, device="cuda"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}/api/v0.1/predictions"
    results, walls = [None] * len(bodies), [None] * len(bodies)
    try:
        code, body = post(url, bodies[0])
        if code != 200:
            fail(f"[vit] warm-up request answered {code}: {body}")

        def client(i):
            t = time.perf_counter()
            results[i] = post(url, bodies[i])
            walls[i] = time.perf_counter() - t

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        httpd.shutdown()
        httpd.server_close()
    return results, walls


def tensor_body(x, puid: str) -> dict:
    return {"meta": {"puid": puid},
            "data": {"tensor": {"shape": list(x.shape), "values": x.ravel().tolist()}}}


def check_rest(label: str, results, xs, n_classes: int):
    """Every response 200 with the JAX package's names (t:0..) and the
    request's puid; returns the logits as tensors."""
    import numpy as np
    import torch

    names = [f"t:{i}" for i in range(n_classes)]
    out = []
    for i, (res, x) in enumerate(zip(results, xs)):
        if res is None:
            fail(f"{label}: request {i} did not complete")
        code, body = res
        data = body.get("data", {})
        if code != 200 or data.get("names") != names:
            fail(f"{label}: request {i} answered {code} with names {data.get('names')}")
        if body.get("meta", {}).get("puid") != f"{label}-{i}":
            fail(f"{label}: request {i}'s meta {body.get('meta')} does not echo its puid")
        got = np.asarray(data["tensor"]["values"]).reshape(data["tensor"]["shape"])
        if got.shape != (x.shape[0], n_classes):
            fail(f"{label}: request {i}'s logits shaped {got.shape}")
        out.append(torch.from_numpy(got).float())
    return out


def load_server(uri: str, **knobs):
    """A TorchServer as the CLI builds it (typed unit parameters), loaded;
    its load wall (s) and the load's peak device memory above what was
    allocated before it (GB)."""
    import torch

    from seldon_core_tpu_torch.contracts.parameters import parse_parameters
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    params = [{"name": "model_uri", "value": uri, "type": "STRING"}]
    params += [{"name": k, "value": v, "type": "STRING"} for k, v in knobs.items()]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = TorchServer(device="cuda", **parse_parameters(json.dumps(params)))
    server.load()
    torch.cuda.synchronize()
    return server, time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - base) / 1e9


def vit_images(n: int, seed: int):
    import numpy as np

    return np.round(np.random.default_rng(seed).standard_normal((n, *VIT_INPUT)), 2).astype(
        np.float32)


def rel_frobenius(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def float32_attribution(explainer, x):
    """The witness of a folded ResNet's explanation: the same attribution
    through a float32-compute forward of the explainer's own folded weights
    (cuDNN convs and the head in float32, TF32 off; no kernel), autograd
    for the input gradient."""
    import torch

    from seldon_core_tpu_torch.models.resnet_infer import forward_operands, serving_operands

    m = explainer._module
    ops32 = serving_operands(m.param_tree(), m.stage_sizes, x.device, torch.float32)
    saved = (explainer._fn, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    explainer._fn = lambda _, xx: forward_operands(ops32, xx.float(), m.stage_sizes,
                                                   torch.float32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return explainer.attribute(x)
    finally:
        (explainer._fn, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def saliency_case(label: str, card: str, explainer, x, want_k3: int, want_k4: int) -> dict:
    """One explanation of ``x`` (on the card) through the kernels: every
    attribution finite and non-zero, K3's and K4's launches as the forwards
    say, and within SALIENCY_RTOL of autograd through the plain versions
    on the same tensors (where it is not and K3 ran: no farther, times 1 +
    SALIENCY_RTOL, from ``float32_attribution`` than the plain versions'
    attributions lie), over the rows whose explained class is clear: the
    same top-1 through the kernels and the plain versions, its margin over
    the second above FWD_TOL x max|logit| (where the two are near a tie,
    "max" may explain another class). Returns its numbers."""
    import torch

    from seldon_core_tpu_torch.ops.fused_resnet import fused_identity_chain

    k3, (k4, _) = fused_identity_chain.launches, k4_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = explainer.attribute(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3, k4 = fused_identity_chain.launches - k3, k4_counts()[0] - k4
    if not torch.isfinite(got).all() or got.abs().max().item() == 0:
        fail(f"[vit] (d) {label}: attributions not finite or all zero")
    if (k3, k4) != (want_k3, want_k4):
        fail(f"[vit] (d) {label}: K3 / K4 launched {k3} / {k4} times, the forwards say "
             f"{want_k3} / {want_k4}")
    with torch.no_grad():
        logits = explainer._fn(explainer._module, x).float()
    with plain_kernels():
        want = explainer.attribute(x)
        with torch.no_grad():
            plain = explainer._fn(explainer._module, x).float()
    top2 = plain.topk(2, dim=-1).values
    clear = (((top2[:, 0] - top2[:, 1]) > FWD_TOL * plain.abs().max())
             & (logits.argmax(-1) == plain.argmax(-1)))
    rows = ((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).tolist()
    rel = rel_frobenius(got[clear], want[clear]) if clear.any() else float("nan")
    witness, ok = "", rel <= SALIENCY_RTOL
    if k3 and not ok and clear.any():   # is bf16 the noisy side? the float32 witness says
        w32 = float32_attribution(explainer, x)[clear]
        e_k, e_p = rel_frobenius(got[clear], w32), rel_frobenius(want[clear], w32)
        ok = e_k <= (1 + SALIENCY_RTOL) * e_p
        witness = (f"; from the float32 witness: the kernels {e_k:.4g}, the plain versions "
                   f"{e_p:.4g} (kernels <= {(1 + SALIENCY_RTOL) * e_p:.4g})")
    print(f"[vit] (d) saliency {label}: {wall * 1e3:.1f} ms (gradient x input over "
          f"{x.shape[0]} inputs, steps {explainer.steps}); K3 {k3} / K4 {k4} launches, as the "
          f"forwards say; attributions finite, max |a| {got.abs().max().item():.4g}; against "
          f"autograd through the plain versions: {rel:.4g} (relative, Frobenius) over the "
          f"{int(clear.sum())} rows of a clear class (<= {SALIENCY_RTOL}), "
          f"{rel_frobenius(got, want):.4g} over all, by row "
          f"{' '.join(f'{r:.3g}' for r in rows)}{witness} [{card}]", flush=True)
    return dict(ms=wall * 1e3, rel=rel, k3=k3, k4=k4,
                ok=2 * int(clear.sum()) >= len(rows) and ok)


def vit_phase(card: str, model, full: bool = False) -> dict:
    """[vit] (a)-(e) on the folded ResNet-50 ``model`` (live weights) and a
    seeded ViT-B/16 and MLP. Returns the launches of K3 and both K4 routes
    in the phase, and its numbers."""
    import tempfile

    import numpy as np
    import torch

    from seldon_core_tpu_torch.analytics.explainers import SaliencyExplainer
    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.models.convert import params_from_jax
    from seldon_core_tpu_torch.models.resnet_infer import (dequantize_operands,
                                                           resnet_serve_forward)
    from seldon_core_tpu_torch.ops.fused_resnet import fused_identity_chain
    from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul
    from seldon_core_tpu_torch.ops.quantize import dequantize_params, quantized_bytes
    from seldon_core_tpu_torch.parallel.topology import Topology
    from seldon_core_tpu_torch.servers.torchserver import TorchServer, export_checkpoint
    from seldon_core_tpu_torch.transport.cli import build_component

    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    fused_identity_chain.launches = 0
    int8_matmul.launches = int8_matmul.launches_wgmma = 0
    with tempfile.TemporaryDirectory(prefix="vit-ckpt-") as root:
        # ---- (a) ViT-B/16, bf16 compute, over REST
        vit = get_model("vit-b16", input_shape=VIT_INPUT, device="cuda")
        vit.init_params(torch.Generator(device="cuda").manual_seed(VIT_SEED))
        vit_uri = os.path.join(root, "vit-b16")
        t0 = time.perf_counter()
        export_checkpoint(vit_uri, "vit-b16", {"params": vit.param_tree()}, input_shape=VIT_INPUT)
        export_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in vit.parameters())
        del vit
        bf16, load_s, load_gb = load_server(vit_uri)
        xs = [vit_images(PREDICT_BATCH, 20 + i) for i in range(PREDICT_REQUESTS)]
        results, walls = serve_rest(bf16, [tensor_body(x, f"vit-bf16-{i}")
                                           for i, x in enumerate(xs)])
        served = check_rest("vit-bf16", results, xs, 1000)
        x8 = torch.from_numpy(xs[0]).cuda()
        f32 = get_model("vit-b16", dtype="float32", input_shape=VIT_INPUT, device="cuda")
        f32.load_state_dict(bf16._module.state_dict())
        with torch.no_grad():
            ref32 = f32(x8).cpu()
            mine = bf16._module(x8).float().cpu()
        del f32
        err, bound, clear, agree = check_logits("[vit] (a) bf16 vs the float32 forward", mine, ref32)
        check_logits("[vit] (a) REST vs the in-process forward", served[0], mine)
        x128 = torch.from_numpy(vit_images(RESNET_BATCH, 30)).cuda()
        with torch.no_grad():
            (ms, enq), = time_turns([lambda: bf16._module(x128)])
        print(f"[vit] (a) ViT-B/16 bf16 ({n_params / 1e6:.1f} M params, float32 storage; "
              f"checkpoint export {export_s:.2f} s, TorchServer load {load_s:.2f} s, load peak "
              f"{load_gb:.3f} GB): forward at B={RESNET_BATCH} 224x224 {ms:.3f} ms = "
              f"{RESNET_BATCH / ms * 1e3:.1f} images/s (host enqueue {enq:.3f} ms); "
              f"{PREDICT_REQUESTS} concurrent POSTs of {PREDICT_BATCH} images: latency median "
              f"{statistics.median(walls) * 1e3:.1f} ms max {max(walls) * 1e3:.1f} ms, every "
              f"response 200 with names t:0..t:999 and its puid; logits at B={PREDICT_BATCH} "
              f"within {err:.4g} of the float32 forward (bound {bound:.4g} = {FWD_TOL} x "
              f"max|logit|), top-1 equal in {agree} of {clear} clear rows [{card}]", flush=True)
        out["a"] = dict(ms=ms, ips=RESNET_BATCH / ms * 1e3, lat_med_ms=statistics.median(walls)
                        * 1e3, err=err)

        # ---- (b) ViT-B/16 int8: K4 on every product and the head
        int8, load8_s, load8_gb = load_server(vit_uri, quantize="int8")
        auto, _, _ = load_server(vit_uri, param_dtype="auto")
        wbytes = {k: quantized_bytes(s._module) / 1e9
                  for k, s in (("float32", bf16), ("bf16", auto), ("int8", int8))}
        del auto
        deq = get_model("vit-b16", input_shape=VIT_INPUT, device="cuda")
        params_from_jax({k: v for k, v in dequantize_params(int8._module).items()}, deq)
        before = k4_counts()
        with torch.no_grad():
            got8 = int8._module(x8).float().cpu()
            torch.cuda.synchronize()
            per_fwd = k4_counts()[0] - before[0]
            wg = k4_counts()[1] - before[1]
            ref8 = deq(x8).float().cpu()
        del deq
        if per_fwd != VIT_PRODUCTS:
            fail(f"[vit] (b) int8 ViT-B/16: {per_fwd} K4 launches a forward, the model runs "
                 f"{VIT_PRODUCTS} products")
        err8, bound8, clear8, agree8 = check_logits("[vit] (b) int8 vs bf16 over the dequantized "
                                                    "weights", got8, ref8)
        rest8 = ""
        if full:   # the int8 ViT over REST too (the default run's REST is (a)'s)
            results, walls8 = serve_rest(int8, [tensor_body(x, f"vit-int8-{i}")
                                                for i, x in enumerate(xs)])
            check_rest("vit-int8", results, xs, 1000)
            rest8 = f"; REST latency median {statistics.median(walls8) * 1e3:.1f} ms"
        with torch.no_grad():
            (ms8, _), (msb, _) = time_turns([lambda: int8._module(x128),
                                             lambda: bf16._module(x128)])
        print(f"[vit] (b) ViT-B/16 int8 (load {load8_s:.2f} s, load peak {load8_gb:.3f} GB): "
              f"weights on the device {wbytes['int8']:.4f} GB int8 vs {wbytes['bf16']:.4f} GB "
              f"bf16 (param_dtype=auto) vs {wbytes['float32']:.4f} GB float32; K4 {per_fwd} "
              f"launches a forward ({wg} on the prefill route at M = {PREDICT_BATCH} x 197), = "
              f"the products it runs; logits within {err8:.4g} of the bf16 forward over the "
              f"dequantized weights (bound {bound8:.4g}), top-1 equal in {agree8} of {clear8} "
              f"clear rows; forward at B={RESNET_BATCH} {ms8:.3f} ms vs bf16 {msb:.3f} ms, in "
              f"turns{rest8} [{card}]", flush=True)
        out["b"] = dict(ms=ms8, bf16_ms=msb, gb=wbytes, load_gb=load8_gb, err=err8)
        # the MLP at its shapes (K = 4, N = 3), bf16 and int8, over REST
        mlp = get_model("mlp", input_shape=[4], device="cuda", **MLP_KW)
        mlp.init_params(torch.Generator(device="cuda").manual_seed(VIT_SEED + 1))
        mlp_uri = os.path.join(root, "mlp")
        export_checkpoint(mlp_uri, "mlp", {"params": mlp.param_tree()}, kwargs=MLP_KW,
                          input_shape=[4])
        del mlp
        rng = np.random.default_rng(40)
        mx = [rng.standard_normal((b, 4)).astype(np.float32) for b in MLP_BATCHES]
        answers = {}
        for label, knobs in (("mlp-bf16", {}), ("mlp-int8", dict(quantize="int8"))):
            srv, _, _ = load_server(mlp_uri, **knobs)
            before = k4_counts()[0]
            results, _ = serve_rest(srv, [tensor_body(x, f"{label}-{i}")
                                          for i, x in enumerate(mx)])
            answers[label] = check_rest(label, results, mx, 3)
            k4 = k4_counts()[0] - before
            want = 3 * (len(MLP_BATCHES) + 1) if knobs else 0   # + the warm-up request
            if k4 != want:
                fail(f"[vit] (b) {label}: {k4} K4 launches over {len(MLP_BATCHES) + 1} "
                     f"requests, expected {want}")
        mlp_err = max((a - b).abs().max().item()
                      for a, b in zip(answers["mlp-int8"], answers["mlp-bf16"]))
        if not mlp_err <= FWD_TOL:
            fail(f"[vit] (b) the int8 MLP's probabilities are {mlp_err:.4g} from bf16's")
        print(f"[vit] (b) MLP (4 -> 128 -> 128 -> 3) over REST at B = {MLP_BATCHES}: bf16 and "
              f"int8 answer 200 with names t:0..t:2; int8 through K4 at [B,4]x[4,128], "
              f"[B,128]x[128,128], [B,128]x[128,3] (3 launches a request); probabilities within "
              f"{mlp_err:.3g} of bf16's [{card}]", flush=True)

        # ---- (c) ResNet-50 int8: codes on the device, K3 on the dequantized operands
        rn_uri = os.path.join(root, "resnet50")
        export_checkpoint(rn_uri, "resnet50", {"params": model.param_tree()},
                          kwargs={"fused": True}, input_shape=VIT_INPUT)
        rn8, rn_load_s, rn_load_gb = load_server(rn_uri, quantize="int8")
        m8 = rn8._module
        xr = torch.from_numpy(vit_images(PREDICT_BATCH, 50)).cuda()
        k3 = fused_identity_chain.launches
        with torch.no_grad():
            got = m8(xr).float()
            torch.cuda.synchronize()
            k3 = fused_identity_chain.launches - k3
            ref = resnet_serve_forward(m8, xr, pallas_stages=()).float()
            ops = m8.serving_operands(xr.device)
            deq_ms = time_ms(lambda: dequantize_operands(ops, torch.bfloat16))
            (fwd8_ms, _), (fwd_bf16_ms, _) = time_turns([lambda: m8(xr), lambda: model(xr)])
        if k3 != k3_forward_launches(PREDICT_BATCH, sms):
            fail(f"[vit] (c) int8 ResNet-50: {k3} K3 launches, expected_launches says "
                 f"{k3_forward_launches(PREDICT_BATCH, sms)}")
        errc, boundc, clearc, agreec = check_logits("[vit] (c) int8 ResNet-50 K3 vs the cuDNN "
                                                    "chain on the same dequantized weights",
                                                    got.cpu(), ref.cpu())
        print(f"[vit] (c) ResNet-50 folded int8 (load {rn_load_s:.2f} s, peak {rn_load_gb:.3f} "
              f"GB; weights on the device {quantized_bytes(m8) / 1e9:.4f} GB vs "
              f"{quantized_bytes(model) / 1e9:.4f} GB float32): K3 {k3} launches at "
              f"B={PREDICT_BATCH}, as expected_launches says; logits within {errc:.4g} of the "
              f"cuDNN chain over the same dequantized weights (bound {boundc:.4g}), top-1 equal "
              f"in {agreec} of {clearc} clear rows; the per-forward dequantize alone {deq_ms:.4f} "
              f"ms; forward {fwd8_ms:.3f} ms vs bf16 weights {fwd_bf16_ms:.3f} ms, in turns "
              f"[{card}]", flush=True)
        out["c"] = dict(deq_ms=deq_ms, ms=fwd8_ms, bf16_ms=fwd_bf16_ms, err=errc)
        del rn8, m8, ops

        # ---- (d) saliency through K3's and K4's backward
        sal = {}
        rexp = SaliencyExplainer(model_uri=rn_uri, device="cuda")
        rexp.load()
        per = k3_forward_launches(PREDICT_BATCH, sms)
        for steps in SALIENCY_STEPS:
            rexp.steps = steps
            sal[f"resnet50 steps {steps}"] = saliency_case(
                f"ResNet-50 B={PREDICT_BATCH} steps {steps}", card, rexp, xr, steps * per, 0)
        # the int8 ViT's explainer: the same weights, quantize="int8" in its
        # config.json (the explainer's server reads the checkpoint alone)
        vit8_uri = os.path.join(root, "vit-b16-int8")
        os.makedirs(vit8_uri)
        os.symlink(os.path.join(vit_uri, "params.msgpack"),
                   os.path.join(vit8_uri, "params.msgpack"))
        with open(os.path.join(vit_uri, "config.json")) as fh:
            cfg = dict(json.load(fh), quantize="int8")
        with open(os.path.join(vit8_uri, "config.json"), "w") as fh:
            json.dump(cfg, fh)
        vexp = SaliencyExplainer(model_uri=vit8_uri, device="cuda")
        vexp.load()
        sal["vit-b16 int8 steps 1"] = saliency_case(f"ViT-B/16 int8 B={PREDICT_BATCH} steps 1",
                                                    card, vexp, x8, 0, VIT_PRODUCTS)
        bad = [k for k, v in sal.items() if not v["ok"]]
        if bad:
            fail(f"[vit] (d) saliency beyond {SALIENCY_RTOL} of the plain versions and "
                 f"farther than they are from the float32 witness, or under half its rows of "
                 f"a clear class: {bad}")
        del rexp, vexp
        prev = os.environ.get("PREDICTIVE_UNIT_PARAMETERS")
        os.environ["PREDICTIVE_UNIT_PARAMETERS"] = json.dumps(
            [{"name": "model_uri", "value": rn_uri, "type": "STRING"}])
        try:
            comp = build_component("seldon_core_tpu_torch.analytics.explainers.SaliencyExplainer",
                                   "cuda")
        finally:
            if prev is None:
                os.environ.pop("PREDICTIVE_UNIT_PARAMETERS")
            else:
                os.environ["PREDICTIVE_UNIT_PARAMETERS"] = prev
        xe = vit_images(2, 60)
        results, ewalls = serve_rest(comp, [tensor_body(xe, "explain-0")])
        code, body = results[0]
        if code != 200 or body["data"]["tensor"]["shape"] != [2, *VIT_INPUT]:
            fail(f"[vit] (d) the explainer microservice answered {code}")
        attr = np.asarray(body["data"]["tensor"]["values"])
        if not np.isfinite(attr).all() or np.abs(attr).max() == 0:
            fail("[vit] (d) the explainer microservice's attributions are not finite or zero")
        print(f"[vit] (d) SaliencyExplainer built by the CLI's microservice from its class path "
              f"over the ResNet-50 checkpoint: POST of 2 images answered 200 with attributions "
              f"[2, 224, 224, 3] in {ewalls[0] * 1e3:.1f} ms [{card}]", flush=True)
        out["d"] = sal
        del comp

        # ---- (e) ViT-B/16 over a co-located {data 1, model 2}
        for axes in ((VIT_MESH, {"data": 2, "model": 2}) if full else (VIT_MESH,)):
            mesh = Topology(devices=["cuda"] * (axes["data"] * axes["model"])).mesh(axes)
            tp = TorchServer(model_uri=vit_uri, mesh=mesh, strict_sharding=True, device="cuda")
            tp.load()
            with torch.no_grad():
                got = tp._module(x8).float().cpu()
            erre, bounde, cleare, agreee = check_logits(f"[vit] (e) {axes} vs unsharded", got,
                                                        mine)
            print(f"[vit] (e) ViT-B/16 bf16 over a co-located {axes} (every rank on this card, "
                  f"strict_sharding): logits within {erre:.4g} of the unsharded forward (bound "
                  f"{bounde:.4g}), top-1 equal in {agreee} of {cleare} clear rows [{card}]",
                  flush=True)
            del tp
        if full:
            vit_full_extras(card, model, rn_uri, bf16, int8)
        del bf16, int8
    out["launches"] = dict(k3=fused_identity_chain.launches, k4=int8_matmul.launches,
                           k4_wgmma=int8_matmul.launches_wgmma)
    release_server_memory(workspaces=False)
    out["s"] = time.perf_counter() - t_phase
    print(f"[vit] phase {out['s']:.1f} s; launches in it: K3 {out['launches']['k3']}, K4 "
          f"{out['launches']['k4']} ({out['launches']['k4_wgmma']} on the prefill route) "
          f"[{card}]", flush=True)
    return out


def vit_full_extras(card: str, model, rn_uri: str, bf16, int8) -> None:
    """``--vit``: the forwards at B = 1, 8 and 128 for both models in both
    weight types (in turns per batch), and ResNet-50 served with
    ``param_dtype="bfloat16"`` against its float32-stored weights."""
    import torch

    rn8, _, _ = load_server(rn_uri, quantize="int8")
    rnb, _, _ = load_server(rn_uri, param_dtype="bfloat16")
    xs = torch.from_numpy(vit_images(RESNET_BATCH, 70)).cuda()
    with torch.no_grad():
        err, bound, _, _ = check_logits("[vit] --vit ResNet-50 param_dtype=bfloat16",
                                        rnb._module(xs[:PREDICT_BATCH]),
                                        model(xs[:PREDICT_BATCH]))
        for b in (1, PREDICT_BATCH, RESNET_BATCH):
            x = xs[:b].contiguous()
            t = time_turns([lambda: bf16._module(x), lambda: int8._module(x),
                            lambda: model(x), lambda: rn8._module(x)])
            print(f"[vit] --vit B={b}: ViT-B/16 bf16 {t[0][0]:.3f} ms, int8 {t[1][0]:.3f} ms; "
                  f"ResNet-50 bf16 weights {t[2][0]:.3f} ms, int8 {t[3][0]:.3f} ms (in turns) "
                  f"[{card}]", flush=True)
    print(f"[vit] --vit ResNet-50 param_dtype=bfloat16: logits within {err:.4g} of the "
          f"float32-stored weights' (bound {bound:.4g}) [{card}]", flush=True)
    del rn8, rnb


# K4 at the int8 predict path's products (label, M, K, N, out dtype): ViT-B/16's
# block products at B = 8 and 128 (197 tokens an image), its float32 head,
# the MLP's three products at B = 8 and 128
K4_PREDICT = ([(f"vit {name} M={8 * 197 if b == 8 else 128 * 197}", 197 * b, k, n, "bfloat16")
               for b in (PREDICT_BATCH, RESNET_BATCH)
               for name, k, n in (("wqkv", 768, 2304), ("wo", 768, 768), ("w1", 768, 3072),
                                  ("w2", 3072, 768))]
              + [(f"vit head M={b}", b, 768, 1000, "float32") for b in (PREDICT_BATCH,
                                                                        RESNET_BATCH)]
              + [(f"mlp [{k},{n}] M={b}", b, k, n, "bfloat16") for b in MLP_BATCHES
                 for k, n in ((4, 128), (128, 128), (128, 3))])


def predict_kernel_cases(card: str, flush) -> dict:
    """K4 at ``K4_PREDICT`` (``k4_case``: the kernel against its plain
    version, bound, library call); the explicit backward of K4 (at ViT's
    wqkv, B = 8) and of K3 (the four ResNet-50 chains at B = 8), each timed
    beside its bound and the library's backward: plain PyTorch, no kernel
    of their own."""
    import torch

    from seldon_core_tpu_torch.ops.fused_resnet import identity_chain_backward
    from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul_backward

    out = {}
    for i, (label, m, k, n, dt) in enumerate(K4_PREDICT):
        r = k4_case(m, k, n, getattr(torch, dt), seed=100 + i, flush=flush)
        out[label] = r
        print(f"K4 int8_matmul {label} [{m},{k}]x[{k},{n}] -> {dt} ({'prefill' if r['decode_ms'] is not None else 'decode'} "
              f"route): kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) library_ms {r['library_ms']:.4f} "
              f"(torch.matmul on a dequantized bf16 copy) max_abs_err {r['err']:.3e} "
              f"({K4_TOL_REASON}) [{card}]", flush=True)
    # K4's backward: dy @ (q * scale)^T in bf16, the weight dequantized per call
    g = torch.Generator(device="cuda").manual_seed(7)
    m, k, n = 197 * PREDICT_BATCH, 768, 2304
    q = torch.randint(-128, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
    scale = (torch.rand((n,), generator=g, device="cuda") + 0.5) / 127
    dy = torch.randn((m, n), generator=g, device="cuda").to(torch.bfloat16)
    w = q.to(torch.bfloat16) * scale.to(torch.bfloat16)
    (ms, _), (lib, _) = time_turns([lambda: int8_matmul_backward(dy, q, scale, torch.bfloat16),
                                    lambda: dy @ w.t()], flush)
    nbytes = m * n * 2 + k * n + n * 4 + m * k * 2
    bytes_s, flops_s = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / BF16_FLOPS_PER_S
    out["k4 backward"] = dict(ms=ms, library_ms=lib, bound_ms=max(bytes_s, flops_s) * 1e3,
                              bound_by="bytes" if bytes_s >= flops_s else "operations")
    print(f"K4 backward (int8_matmul_backward, plain PyTorch: the weight dequantized in bf16, "
          f"then dy @ w^T) at ViT-B/16 wqkv, dy [{m},{n}]: {ms:.4f} ms, bound "
          f"{out['k4 backward']['bound_ms']:.4f} ms ({out['k4 backward']['bound_by']}), "
          f"torch.matmul on a dequantized bf16 copy {lib:.4f} ms, in turns [{card}]", flush=True)
    # K3's backward: identity_chain_ref recomputed from x, autograd for dx
    for hw, c, f, n_blocks in RESNET50_CHAINS:
        x, blocks = k3_chain_inputs(PREDICT_BATCH, hw, c, f, n_blocks, seed=hw)
        dyc = torch.randn(x.shape, generator=g, device="cuda").to(torch.bfloat16)
        xg = x.clone().requires_grad_()
        y_lib = cudnn_chain_fn(xg, blocks)()
        (ms, _), (lib, _) = time_turns([
            lambda: identity_chain_backward(x, blocks, dyc),
            lambda: torch.autograd.grad(y_lib, xg, dyc, retain_graph=True)], flush)
        mm = PREDICT_BATCH * hw * hw
        nbytes = 3 * x.numel() * 2 + n_blocks * (2 * c * f + 9 * f * f) * 2
        flops = 2 * 2 * mm * (2 * c * f + 9 * f * f) * n_blocks   # recompute + input grad
        bytes_s, flops_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        out[f"k3 backward {hw}"] = dict(ms=ms, library_ms=lib, bound_ms=max(bytes_s, flops_s)
                                        * 1e3, bound_by="bytes" if bytes_s >= flops_s
                                        else "operations")
        print(f"K3 backward (identity_chain_backward, plain PyTorch: identity_chain_ref "
              f"recomputed in float32 from x, autograd for dx) {hw}x{hw}x{c} F={f} x{n_blocks} "
              f"blocks, B={PREDICT_BATCH}: {ms:.4f} ms, bound "
              f"{out[f'k3 backward {hw}']['bound_ms']:.4f} ms "
              f"({out[f'k3 backward {hw}']['bound_by']}), autograd's backward through the "
              f"cuDNN chain {lib:.4f} ms, in turns [{card}]", flush=True)
        del x, blocks, xg, y_lib
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
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} capability {torch.cuda.get_device_capability(0)}",
          flush=True)
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
    sweeps = {"--k4-sweep": k4_sweep, "--k4-decode-sweep": k4_decode_sweep,
              "--k1-sweep": k1_sweep, "--k3-sweep": k3_sweep, "--k2-sweep": k2_sweep}
    if len(sys.argv) >= 2 and sys.argv[1] in sweeps:
        scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        extra = ([lambda: scratch.view(torch.int32).sum()] if sys.argv[1] == "--k4-decode-sweep"
                 else [])
        sweeps[sys.argv[1]](card, lambda: scratch.fill_(1), *extra, *sys.argv[2:])
        return 0
    if sys.argv[1:] == ["--prefix"]:
        print_prefix_runs(card, prefix_runs_phase(card)[1])
        return 0
    if sys.argv[1:] == ["--lora"]:
        print_lora_runs(card, lora_runs_phase(card)[1])
        return 0
    if sys.argv[1:] == ["--predict"]:
        model, _ = resnet_forward_phase(card)
        resnet_serving_phase(card, model)
        return 0
    if sys.argv[1:] == ["--engine"]:
        model, _ = resnet_forward_phase(card)
        engine_phase(card, model)
        del model
        server, _ = load_llm("bf16", card, {})
        engine_llm_phase(card, server)
        return 0
    if sys.argv[1:] == ["--remote"]:
        model, _ = resnet_forward_phase(card)
        remote_phase(card, model)
        del model
        persistence_phase(card)
        servers_phase(card)
        print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
        return 0
    if sys.argv[1:] == ["--fleet"]:
        fleet_phase(card)
        print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
        return 0
    if sys.argv[1:] == ["--disagg"]:
        print_disagg(card, disagg_phase(card)[1])
        print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
        return 0
    if sys.argv[1:] == ["--controlplane"]:
        model, _ = resnet_forward_phase(card)
        controlplane_canary(card, model)
        del model
        server, _ = load_llm("bf16", card, {})
        controlplane_shadow(card, server)
        controlplane_rebalance(card, server, [prompt_text(100 + i, n)
                                              for i, n in enumerate(DISAGG_LENGTHS)])
        del server
        release_server_memory()
        fleet_phase(card)
        controlplane_host(card)
        print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
        return 0
    if sys.argv[1:] == ["--parallel"]:
        parallel_phase(card)
        model, _ = resnet_forward_phase(card)
        parallel_predict(card, model)
        print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
        return 0
    if sys.argv[1:] == ["--dense"]:
        records, dense_runs = dense_flag_phase(card)
        print_dense(card, dense_runs, records)
        print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
        return 0
    if sys.argv[1:] == ["--vit"]:
        scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        predict_kernel_cases(card, lambda: scratch.fill_(1))
        del scratch
        model, _ = resnet_forward_phase(card)
        vit_phase(card, model, full=True)
        print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
        return 0
    if sys.argv[1:] == ["--train"]:
        train_phase(card, full=True)
        print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
        return 0
    if sys.argv[1:] == ["--moe"]:
        moe_phase(card)
        print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
        return 0
    if sys.argv[1:] == ["--tracing"]:
        server, _ = load_llm("bf16", card, {})
        tracing_phase(card, server)
        del server
        release_server_memory()
        fleet_phase(card)
        disagg_phase(card, traced_only=True)
        print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
        return 0

    # 3. kernel phase
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.fill_(1)

    k1 = {}
    for kv in ("bf16", "int8"):
        for label, kw in K1_SHAPES:
            r = k1_case(seed=len(k1) % 3, flush=flush, kv=kv, **K1_FIXED, **kw)
            k1[kv, label] = r
            print(f"K1 paged_attention {kv} pool {label} b=8 h={kw['h']} kvh={kw['kvh']} "
                  f"hd=128 ps=64 n_pages=32 (row 7 all-NULL): S={r['splits']} (the plan's "
                  f"split) kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
                  f"{r['bound_ms']:.4f} library_ms {r['library_ms']:.4f} (SDPA on the bf16 "
                  f"view of the attended pages, gathered untimed); kernel/library "
                  f"{r['ms'] / r['library_ms']:.2f}x, kernel/bound "
                  f"{r['ms'] / r['bound_ms']:.2f}x; one call = 1 kernel (CUDA graph of the call); "
                  f"max_abs_err {r['err']:.3e} ({K1_TOL_REASON}; vs the bf16 plain chain "
                  f"{r['err_bf16']:.3e}) [{card}]", flush=True)
    for kv in ("bf16", "int8"):
        r = k1_verify_case(kv, flush)
        k1[kv, "verify"] = r
        print(f"{r['label']} hd=128 ps=64 n_pages=32 (the verify's folded rows): kernel_ms "
              f"{r['ms']:.4f} vs the JAX package's verify read (gather each sequence's whole "
              f"table, masked einsum of its {SPEC_K + 1} columns) {r['jax_form_ms']:.4f}, in "
              f"turns ({r['jax_form_ms'] / r['ms']:.2f}x); plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) library_ms {r['library_ms']:.4f} (SDPA, "
              f"{N_REQUESTS} sequences x {SPEC_K + 1} queries over each attended view, gathered "
              f"untimed); one call = 1 kernel (CUDA graph of the call); max_abs_err "
              f"{r['err']:.3e} ({K1_TOL_REASON}); the JAX form's {r['jax_form_err']:.3e} "
              f"[{card}]", flush=True)
    k2 = {}
    for rows, d in [(rows, K2_D) for rows in K2_SHAPES] + list(K2_DRAFT):
        r = k2_case(rows, d, seed=rows if d == K2_D else rows + d, flush=flush)
        k2[rows if d == K2_D else (rows, d)] = r
        print(f"K2 fused_residual_rmsnorm [{rows},{d}] bf16 (bf16 weight): plan (threads, "
              f"slots, chunks) {r['plan']}; kernel_ms {r['ms']:.4f} trivial kernel "
              f"(out.zero_(), the timing floor) "
              f"{r['floor_ms']:.4f} x + h then F.rms_norm (two library calls, for information) "
              f"{r['pair_ms']:.4f}, in turns; plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) library_ms null (no single PyTorch call); "
              f"host enqueue per call {r['enqueue_ms']:.4f} ms (median of 200); one call = 1 "
              f"kernel (CUDA graph of the call), bit-equal to its replay and to a second call; "
              f"max_abs_err {r['err']:.3e} (y bit-equal, o within 1 bf16 ulp) [{card}]",
              flush=True)
        for what, key, mm in (("h = x @ W (cuBLAS, bf16)", "stream", "mm_ms"),
                              ("h = int8_matmul(x, q, s) (K4)", "stream8", "mm8_ms")):
            a = r[key]
            print(f"K2 [{rows},{d}] in a dense stream (a CUDA graph of {STREAM_PAIRS} x "
                  f"[{what}, {r[mm]:.4f} ms; then one call]), added per call: kernel "
                  f"{a[0]:.4f} ms, trivial kernel (h.zero_()) {a[1]:.4f} [{card}]",
                  flush=True)
    k4 = {}
    # 8 serving slots; the served prefill chunks; generate()'s decode steps
    # of 1 and 4 rows and dense prefills of 4 and 8 rows x 128
    for m in K4_SHAPES:
        for name, k, n, dt in K4_FAMILIES:
            label = k4_label(name, m)
            dt = getattr(torch, dt)
            r = k4_case(m, k, n, dt, seed=len(k4), flush=flush)
            k4[label] = r
            line = (f"K4 int8_matmul {label} [{m},{k}]x[{k},{n}] -> {str(dt).split('.')[-1]}: "
                    f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
                    f"{r['bound_ms']:.4f} ({r['bound_by']}) library_ms {r['library_ms']:.4f} "
                    f"(torch.matmul on a dequantized bf16 copy of the weight) max_abs_err "
                    f"{r['err']:.3e} ({K4_TOL_REASON})")
            if r["decode_ms"] is None:
                line += (f"; kernel/library {r['ms'] / r['library_ms']:.2f}x, kernel/bound "
                         f"{r['ms'] / r['bound_ms']:.2f}x; plan (width, splits, stages) "
                         f"{r['plan']}; one call = 1 kernel (CUDA graph of the call), bit-equal "
                         f"to its replay and to a second call; host enqueue per call "
                         f"{r['enqueue_ms']:.4f} ms")
            if r["decode_ms"] is not None:
                line += (f"; one call = {r['nodes']} kernel node(s) of a CUDA graph of the "
                         f"call (the kernel, + the split-K reduce when the plan splits), "
                         f"bit-equal to its replay and to a second call"
                         f"; prefill kernel (TMA + wgmma) vs the decode kernel at this shape, "
                         f"in turns: {r['ms']:.4f} vs {r['decode_ms']:.4f} ms "
                         f"({r['decode_ms'] / r['ms']:.2f}x faster), "
                         f"{r['ms'] / r['library_ms']:.2f}x the library call, "
                         f"{r['ms'] / r['bound_ms']:.2f}x the bound; decode kernel max_abs_err "
                         f"{r['decode_err']:.3e}; host enqueue per call {r['enqueue_ms']:.4f} "
                         f"vs {r['decode_enqueue_ms']:.4f} ms")
            print(f"{line} [{card}]", flush=True)
    # one forward's 225 products: 32 layers x (wq, wk, wv, wo, w1, w3, w2)
    # + lm_head
    n_layers = LLAMA2_7B["n_layers"]

    def step_sum(key, suffix=""):
        return n_layers * (4 * k4["wq/wk/wv/wo" + suffix][key] + 2 * k4["w1/w3" + suffix][key]
                           + k4["w2" + suffix][key]) + k4["lm_head" + suffix][key]

    print(f"K4 over one int8 decode step's {K4_PER_FORWARD} products (from the shapes above): "
          f"kernel {step_sum('ms'):.3f} ms, bound {step_sum('bound_ms'):.3f} ms, "
          f"torch.matmul on bf16 weights {step_sum('library_ms'):.3f} ms [{card}]", flush=True)
    for m, what in ((1, "generate() decode step"), (4, "generate() decode step"),
                    (32, "prefill forward"), (SPEC_ROWS, "speculative verify forward")):
        sfx = k4_label("", m)
        print(f"K4 over one {what}'s {K4_PER_FORWARD} products at M = {m} (from the "
              f"shapes above): decode kernel {step_sum('ms', sfx):.3f} ms, bound "
              f"{step_sum('bound_ms', sfx):.3f} ms, torch.matmul on bf16 weights "
              f"{step_sum('library_ms', sfx):.3f} ms [{card}]", flush=True)
    for m in (128, 256, 512, 1024):
        sfx = k4_label("", m)
        print(f"K4 over one prefill forward's {K4_PER_FORWARD} products at M = {m} (from the "
              f"shapes above): prefill kernel {step_sum('ms', sfx):.3f} ms, decode kernel "
              f"{step_sum('decode_ms', sfx):.3f} ms, bound {step_sum('bound_ms', sfx):.3f} ms, "
              f"torch.matmul on bf16 weights {step_sum('library_ms', sfx):.3f} ms [{card}]",
              flush=True)
    k3 = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # batch 128, then the served batches: 8 images a request and 1 (split K)
    for batch in (RESNET_BATCH, PREDICT_BATCH, 1):
        for hw, c, f, n in RESNET50_CHAINS:
            r = k3_case(batch, hw, c, f, n, seed=hw + batch, flush=flush, sms=sms)
            k3[batch, hw] = r
            print(f"K3 fused_identity_chain {hw}x{hw}x{c} F={f} x{n} blocks, B={batch} bf16: "
                  f"kernel_ms {r['ms']:.4f} ({r['launches']} launches; plan (width, splits, "
                  f"steps per split) per conv {r['plan']}; host enqueue {r['enqueue_ms']:.4f} "
                  f"ms) cudnn_ms {r['cudnn_ms']:.4f} (the eager cuDNN chain: F.conv2d + bf16 "
                  f"bias + relu, {3 * n} convs, several calls; max diff from the plain version "
                  f"{r['cudnn_err']:.3e}), in turns; plain_ms {r['plain_ms']:.4f} bound_ms "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}) library_ms null (no single PyTorch "
                  f"call); the design's own byte floor (y1, y2 through device memory) "
                  f"{r['floor_ms']:.4f} ms; max_abs_err {r['err']:.3e}, graph replay "
                  f"{r['graph_err']:.3e} <= tolerance {r['tol']:.3e} ({K3_TOL_REASON}); one "
                  f"call = {r['launches']} kernel nodes (CUDA graph of the call) [{card}]",
                  flush=True)
        rows = [k3[batch, hw] for hw, *_ in RESNET50_CHAINS]
        print(f"K3 over one ResNet-50 forward's {K3_BLOCKS} identity blocks at B={batch}: "
              f"kernel {sum(r['ms'] for r in rows):.3f} ms ({sum(r['launches'] for r in rows)} "
              f"launches), cuDNN chain {sum(r['cudnn_ms'] for r in rows):.3f} ms, bound "
              f"{sum(r['bound_ms'] for r in rows):.3f} ms [{card}]", flush=True)
    # K4 at the int8 predict path's shapes; K3's and K4's backward
    kp = predict_kernel_cases(card, flush)
    del scratch

    # [train]: the training path (the train step, ring attention, GPipe)
    train_record, train_summary = train_phase(card)

    # 4. serving phase: per model, the eager programs first, then the graphs;
    # bf16 also with K = FUSED_K fused steps a dispatch; bf16 is freed before
    # int8 weights + int8 KV load
    runs, spec_runs, spec_launches = {}, {}, [train_record]
    par_records, par_summary = [], {}
    dense_runs, dense_records = {}, []
    for model, knobs, fuses in (("bf16", {}, (0, FUSED_K)),
                                ("int8", dict(quantize="int8", kv_cache_dtype="int8"), (0,))):
        server, weight_bytes = load_llm(model, card, knobs)
        runs[f"{model} eager"] = serve(f"{model} eager", card, server, weight_bytes, eager=True)
        for fuse in fuses:
            label = model if fuse <= 1 else f"{model} K={fuse}"
            runs[label] = serve(label, card, server, weight_bytes, fuse=fuse)
        # (a) / (b): the n-gram spec batcher on the same loaded server
        server.decode_fuse_steps = 0
        if model == "bf16":  # the engine phase's (c): the LLM as a graph's component
            spec_launches.append(("bf16 engine", engine_llm_phase(card, server)))
            # [controlplane] (b): a shadow node over the 7B component
            spec_launches.append(("controlplane (b) shadow", controlplane_shadow(card, server)))
            # request tracing and the flight recorder on the bf16 graph path
            spec_launches += tracing_phase(card, server)
            # [parallel] (a), (b), (c), (e): meshes whose ranks share this card,
            # the tp = 2 servers built from this server's weights
            par_records, par_summary = parallel_phase(card, server)
            spec_launches += par_records
        label = f"{model} spec ngram"
        records, spec_runs[label] = spec_phase(label, card, server, "ngram",
                                               plain=runs[model][1])
        spec_launches += records
        # [dense]: the dense batcher layout on the same loaded server
        records, runs_d = dense_phase(card, server, model, runs, spec_runs)
        spec_launches += records
        dense_records += records
        dense_runs.update(runs_d)
        del server
        release_server_memory()
    # (c) the perfect drafter (a draft configured like the target: a copy)
    # and (d) a TinyLlama-1.1B-wide draft, each loaded beside a bf16 target
    for label, draft_kw in (("bf16 spec draft perfect", dict(LLAMA2_7B, fused_norm=True)),
                            ("bf16 spec draft tinyllama", TINYLLAMA_1B)):
        server, _ = load_llm(label, card, dict(spec_mode="draft", spec_k=SPEC_K,
                                               draft_model="transformer",
                                               draft_model_kwargs=draft_kw,
                                               continuous_batching_max_len=SPEC_MAX_LEN))
        records, spec_runs[label] = spec_phase(label, card, server, "draft")
        spec_launches += records
        del server
        release_server_memory()
    records, prefix_runs = prefix_runs_phase(card)
    spec_launches += records
    records, lora_runs = lora_runs_phase(card)
    spec_launches += records
    # the replica fleet: two int8-weight 7B replicas behind one ReplicaSet,
    # then its faults part on the same replicas
    spec_launches += fleet_phase(card)
    # disaggregated prefill: workers beside the decode batcher on this card
    records, disagg_runs = disagg_phase(card)
    spec_launches += records
    # the MoE FFN: a Mixtral-8x7B-wide model, int8 weights at full depth,
    # then bf16 weights at half depth
    spec_launches += moe_phase(card, {m: runs[m][1]["step"][1]["nodes"]
                                      for m in ("bf16", "int8")})
    print("serving runs (Llama-2-7B, 8 concurrent requests x 32 tokens; step wall drain to "
          f"drain; host = one dispatch's enqueue or replay on the same live state) [{card}]:",
          flush=True)
    for label, (_, m) in runs.items():
        st = m.get("step", {})
        graphs = " ".join(f"replay K={k} host {v['host_ms']:.4f} ms device {v['dev_ms']:.3f} ms;"
                          for k, v in st.items() if isinstance(k, int))
        eager = (f"eager step host {st['eager_host_ms']:.3f} ms device {st['eager_dev_ms']:.3f} "
                 f"ms; " if st else "")
        chunks = " ".join(f"chunk {c}: eager host {v['eager_host_ms']:.3f} / kernels "
                          f"{v['eager_dev_ms']:.3f} ms, replay host {v['host_ms']:.4f} / device "
                          f"{v['dev_ms']:.3f} ms;" for c, v in m.get("prefill", {}).items())
        g = m.get("generate")
        gen = (f"generate(): per-step wall eager {g['eager_step_ms']:.3f} / graph "
               f"{g['graph_step_ms']:.3f} ms, replay host {g['host_ms']:.4f} / device "
               f"{g['dev_ms']:.3f} ms vs eager step host {g['eager_host_ms']:.3f} / kernels "
               f"{g['eager_dev_ms']:.3f} ms, dense buffer {g['dense_gb']:.3f} GB, pool "
               f"{gb_text(g['pool_gb'])}, {g['graphs']} graphs;" if g else "")
        sm = m.get("stream")
        stream = (f"streamed: first event {sm['ttfe_med_ms']:.1f} / {sm['ttfe_max_ms']:.1f} ms "
                  f"(server TTFT {sm['ttft_med_ms']:.1f} / {sm['ttft_max_ms']:.1f}), gap "
                  f"{sm['gap_med_ms']:.2f} / {sm['gap_p90_ms']:.2f} / {sm['gap_max_ms']:.2f} ms, "
                  f"burst median {sm['burst_med']} max {sm['burst_max']}, step "
                  f"{sm['step_ms']:.2f} ms;" if sm else "")
        print(f"  {label:12s} step {m['step_ms']:.2f} ms = {N_REQUESTS / m['step_ms'] * 1e3:.1f} "
              f"tok/s; TTFT {m['ttft_med_ms']:.1f} / {m['ttft_max_ms']:.1f} ms; mixed TTFT "
              f"{' / '.join(f'{t:.1f}' for t in m['mixed_ttft_ms'])} ms, step "
              f"{m['mixed_step_ms']:.2f} ms; peak {m['peak_gb']:.2f} GB (mixed "
              f"{m['mixed_peak_gb']:.2f}); graph pools: prefill {gb_text(m['prefill_pool_gb'])}, "
              f"decode {gb_text(m['decode_pool_gb'])}; {eager}{graphs} {chunks} {gen} {stream} "
              f"[{card}]",
              flush=True)

    print(f"speculative runs (Llama-2-7B target, {N_REQUESTS} concurrent requests x {MAX_NEW} "
          f"tokens, K = {SPEC_K}; step wall drain to drain a verify dispatch) [{card}]:",
          flush=True)
    for label, m in spec_runs.items():
        draft = (f", draft forwards {m['draft_ms']:.3f} ms as a graph, "
                 f"{m['draft_eager_ms']:.3f} ms of eager kernels" if "draft_ms" in m else "")
        print(f"  {label:26s} wall {m['wall_s']:.4f} s vs plain {m['plain_wall_s']:.4f} s "
              f"({m['plain_wall_s'] / m['wall_s']:.3f}x end to end); accept {m['accept']:.4f}, "
              f"tokens/forward {m['tokens_per_forward']:.4f}, overhead {m['overhead']:.4f}; step "
              f"{m['step_ms']:.2f} ms = {m['per_token_ms']:.2f} ms a token (plain step "
              f"{m['plain_step_ms']:.2f} ms); replay device {m['replay_dev_ms']:.3f} ms vs eager "
              f"kernels {m['eager_dev_ms']:.3f} ms, host {m['replay_host_ms']:.4f} vs "
              f"{m['eager_host_ms']:.3f} ms; pool {gb_text(m['pool_gb'])}, peak "
              f"{m['peak_gb']:.2f} GB{draft} [{card}]", flush=True)

    print_prefix_runs(card, prefix_runs)
    print_lora_runs(card, lora_runs)
    print_disagg(card, disagg_runs)
    print_dense(card, dense_runs, dense_records)

    def total(key):
        # every run's: each counter is one kernel's (K1's bf16 and int8
        # branches count apart), whichever model the run served
        return (sum(launches[key] for launches, _ in runs.values())
                + sum(launches[key] for _, launches in spec_launches))

    # 5. ResNet-50 forward; 6. predict serving
    model, _ = resnet_forward_phase(card)
    k3_launches = resnet_serving_phase(card, model)
    if k3_launches == 0:
        fail("predict serving: K3 (csrc/fused_resnet_wgmma.cu) never launched")
    # 7. the graph engine over ResNet-50 leaves: (a), (b), (d)
    launches, router = engine_phase(card, model)
    k3_launches += launches
    # 8. the leaf as a remote node, and micro-batching; the router persisted
    k3_launches += remote_phase(card, model)
    # [parallel] (d): TorchServer over a co-located mesh, through a spec
    k3_launches += parallel_predict(card, model)
    # [vit]: ViT-B/16 and the MLP in bf16 and int8, int8 ResNet-50, the
    # saliency explainer, the ViT over a mesh (its own counts)
    vit = vit_phase(card, model)
    del model
    persistence_phase(card, router)
    servers_phase(card)
    # [controlplane] (d): validate / render / operator through the CLI
    controlplane_host(card)

    def entry(name, route, source, replaces, launches, r):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    def par_total(key):
        # the [parallel] runs' launches: every kernel at a rank's shapes
        return sum(launches[key] for _, launches in par_records)

    print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
    kernels = [
        entry("paged_attention", "cuda", "seldon_core_tpu_torch/csrc/paged_attention.cu",
              "seldon_core_tpu/ops/paged_attention.py:253", total("k1"),
              k1["bf16", "ctx160"]),
        entry("paged_attention (int8 pool)", "cuda",
              "seldon_core_tpu_torch/csrc/paged_attention.cu",
              "seldon_core_tpu/ops/paged_attention.py:253", total("k1_int8"),
              k1["int8", "ctx160"]),
        entry("fused_residual_rmsnorm", "cuda", "seldon_core_tpu_torch/csrc/fused_norm.cu",
              "seldon_core_tpu/ops/fused_norm.py:137",
              total("k2"), k2[8]),
        entry("fused_residual_rmsnorm (training: [4096, 4096] bf16, float32 weight, under "
              "autograd)", "cuda", "seldon_core_tpu_torch/csrc/fused_norm.cu",
              "seldon_core_tpu/ops/fused_norm.py:137", train_summary["k2"]["launches"],
              train_summary["k2"]),
        entry("fused_identity_chain", "cuda", "seldon_core_tpu_torch/csrc/fused_resnet_wgmma.cu",
              "seldon_core_tpu/ops/fused_resnet.py:239", k3_launches, k3[RESNET_BATCH, 56]),
        entry("int8_matmul", "cuda", "seldon_core_tpu_torch/csrc/int8_matmul.cu",
              "seldon_core_tpu/ops/pallas_int8.py:127",
              total("k4") - total("k4_wgmma"), k4["wq/wk/wv/wo"]),
        entry("int8_matmul (prefill, wgmma)", "cuda",
              "seldon_core_tpu_torch/csrc/int8_matmul_wgmma.cu",
              "seldon_core_tpu/ops/pallas_int8.py:127", total("k4_wgmma"),
              k4["w1/w3 prefill M=128"]),
        entry("paged_attention (tensor_parallel=2 rank: 16 heads)", "cuda",
              "seldon_core_tpu_torch/csrc/paged_attention.cu",
              "seldon_core_tpu/ops/paged_attention.py:253", par_total("k1"),
              par_summary["kernels"]["k1 7B tp=2 rank bf16"]),
        entry("int8_matmul (tensor_parallel=2 column shard: w1/w3 N=5504)", "cuda",
              "seldon_core_tpu_torch/csrc/int8_matmul.cu",
              "seldon_core_tpu/ops/pallas_int8.py:127",
              par_total("k4") - par_total("k4_wgmma"),
              par_summary["kernels"]["w1/w3 col tp=2 M=8"]),
        entry("paged_attention partial mode (int8 pool, a 'seq' rank: 16 heads)", "cuda",
              "seldon_core_tpu_torch/csrc/paged_attention.cu",
              "seldon_core_tpu/ops/paged_attention.py:253", par_total("k1p_int8"),
              par_summary["kernels"]["k1p seq2 rank int8"]),
    ]
    kernels += [
        entry("int8_matmul (ViT-B/16 int8 predict, prefill route: wqkv [1576,768]x[768,2304])",
              "cuda", "seldon_core_tpu_torch/csrc/int8_matmul_wgmma.cu",
              "seldon_core_tpu/ops/pallas_int8.py:127", vit["launches"]["k4_wgmma"],
              kp["vit wqkv M=1576"]),
        entry("int8_matmul (ViT-B/16 head and MLP, decode route: head [8,768]x[768,1000] -> "
              "f32)", "cuda", "seldon_core_tpu_torch/csrc/int8_matmul.cu",
              "seldon_core_tpu/ops/pallas_int8.py:127",
              vit["launches"]["k4"] - vit["launches"]["k4_wgmma"], kp["vit head M=8"]),
        entry("fused_identity_chain (int8 ResNet-50 predict and saliency, B=8)", "cuda",
              "seldon_core_tpu_torch/csrc/fused_resnet_wgmma.cu",
              "seldon_core_tpu/ops/fused_resnet.py:239", vit["launches"]["k3"],
              k3[PREDICT_BATCH, 56]),
    ]
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        fail(f"kernels of the main path launched no time in the run: {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
