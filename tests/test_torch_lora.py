"""Batched LoRA in the port (``seldon_core_tpu_torch/models/transformer.py``
``lora_delta`` and the adapted forward, ``runtime/adapters.py``) against the
JAX package on the CPU, at the JAX ``tests/test_adapters.py`` widths:

- ``lora_delta`` and the adapted ``Transformer.forward`` (paged chunks and a
  decode step, over a model-dtype pool and an int8 pool) equal JAX's within
  the tolerance ``tests/test_torch_transformer.py`` holds the unadapted
  forward to: float32, ``rtol = atol = 1e-4`` (the same op chain; XLA and
  PyTorch reduce in different orders);
- adapter id 0 is bitwise the unadapted forward, alone and as rows of a
  batch mixing adapters (logits and pools);
- the registry's discipline equals the JAX registry's on the same calls:
  k/v rejection, an unknown projection, a shape mismatch, a pinned evict
  and a pinned reload refused, a full pool, an evicted row zeroed, the
  stats; and a ``load_uri`` round trip (``adapter.json`` + ``weights.npz``)
  gives the JAX pool's rows, float32 and bfloat16."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import get_model as jax_get_model
from seldon_core_tpu.models import transformer as jt
from seldon_core_tpu.runtime.adapters import AdapterRegistry as JaxRegistry
from seldon_core_tpu_torch.models import get_model
from seldon_core_tpu_torch.models import transformer as tt
from seldon_core_tpu_torch.models.convert import params_from_jax
from seldon_core_tpu_torch.runtime.adapters import (ADAPTED_PROJECTIONS, AdapterRegistry,
                                                    projection_dims)

KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)   # as tests/test_torch_transformer.py
FLIP_TOL = dict(rtol=1e-4, atol=1e-3)   # a sequence with a flipped int8 code
RANK = 4
PS = 8


@pytest.fixture(scope="module")
def models():
    jmod = jax_get_model("transformer", **KW)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmod = params_from_jax({"params": params}, get_model("transformer", device="cpu", **KW))
    return jmod, {"params": variables["params"]}, tmod


def factors(cfg, seed, scale=0.25, projs=ADAPTED_PROJECTIONS):
    rng = np.random.default_rng(seed)
    return {p: (rng.normal(size=(cfg.n_layers, din, RANK)) * scale,
                rng.normal(size=(cfg.n_layers, RANK, dout)) * scale)
            for p, (din, dout) in projection_dims(cfg).items() if p in projs}


@pytest.fixture(scope="module")
def pools(models):
    """Both registries with the same three adapters (rows 1..3)."""
    jmod, _, tmod = models
    jreg, treg = JaxRegistry(jmod.cfg, RANK, 6), AdapterRegistry(tmod.cfg, RANK, 6, device="cpu")
    for i in range(3):
        w = factors(tmod.cfg, 10 + i)
        assert jreg.load(f"t{i}", w, alpha=2 * RANK) == treg.load(f"t{i}", w, alpha=2 * RANK)
    return jreg, treg


def _np(t):
    return t.detach().float().numpy()


def test_lora_delta_equals_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    A = rng.normal(size=(4, 16, RANK)).astype(np.float32)
    B = rng.normal(size=(4, RANK, 24)).astype(np.float32)
    A[0] = 0
    B[0] = 0
    scale = np.array([0.0, 0.5, 1.5, 2.0], np.float32)
    ids = np.array([2, 0, 3], np.int32)
    want = jt.lora_delta(*map(jnp.asarray, (x, A, B, ids, scale)))
    got = tt.lora_delta(*map(torch.from_numpy, (x, A, B, ids, scale)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert torch.count_nonzero(got[1]) == 0          # the identity row
    half = tt.lora_delta(*(torch.from_numpy(a).to(torch.bfloat16) if a.dtype == np.float32
                           else torch.from_numpy(a) for a in (x, A, B, ids)),
                         torch.from_numpy(scale))
    assert half.dtype == torch.bfloat16 and torch.count_nonzero(half[1]) == 0


def _tables():
    bt = np.full((3, 4), tt.NULL_PAGE, np.int32)
    bt[0, :3] = [7, 2, 10]
    bt[1, :3] = [4, 11, 3]
    bt[2, :3] = [5, 6, 8]
    return bt


def _paged_run(run, init, ids, kv):
    """Two chunks of 8 (the second padded) then one decode step for 3
    sequences through block tables; ``run(tokens, positions, caches,
    tables)`` is one forward. Returns [logits of each call], caches."""
    bt = _tables()
    toks = np.random.default_rng(2).integers(0, KW["vocab_size"], (3, 13)).astype(np.int32)
    caches = init(kv)
    outs = []
    for start in (0, 8):
        n = min(8, 13 - start)
        chunk = np.zeros((3, 8), np.int32)
        pos = np.full((3, 8), tt.PAD_POS, np.int32)
        chunk[:, :n] = toks[:, start:start + n]
        pos[:, :n] = np.arange(start, start + n)
        logits, caches = run(chunk, pos, caches, bt)
        outs.append(logits[:, :n])
    nxt = np.array([[7], [9], [3]], np.int32)
    logits, caches = run(nxt, np.full((3, 1), 13, np.int32), caches, bt)
    outs.append(logits)
    return outs, caches


def _calls():
    """Two chunks of 8 (the second padded) then one decode step for 3
    sequences: (tokens, positions, n real columns) of each call."""
    toks = np.random.default_rng(2).integers(0, KW["vocab_size"], (3, 13)).astype(np.int32)
    out = []
    for start in (0, 8):
        n = min(8, 13 - start)
        chunk = np.zeros((3, 8), np.int32)
        pos = np.full((3, 8), tt.PAD_POS, np.int32)
        chunk[:, :n] = toks[:, start:start + n]
        pos[:, :n] = np.arange(start, start + n)
        out.append((chunk, pos, n))
    out.append((np.array([[7], [9], [3]], np.int32), np.full((3, 1), 13, np.int32), 1))
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_adapted_paged_forward_equals_jax(models, pools, kv):
    """Each call starts from the JAX pools (copied into the port's), so each
    is held alone: logits within TOL, and the pools it writes within TOL.
    An int8 pool's codes are equal but where a value sits within float
    error of a rounding boundary (XLA's reduction order moves it across):
    at most 2 codes over the run, one step each. A sequence whose codes
    moved reads its own flipped V in the same chunk, so its logits are held
    to FLIP_TOL (one code step of one V element moves them by up to ~5e-4
    at these widths); every other sequence to TOL."""
    jmod, jvars, tmod = models
    jreg, treg = pools
    ids = np.array([2, 0, 3], np.int32)
    bt = _tables()
    jp = jt.init_paged_kv_caches(jmod.cfg, 12, PS, kv)
    tp = tt.init_paged_kv_caches(tmod.cfg, 12, PS, kv, device="cpu")
    flips = 0
    for tokens, pos, n in _calls():
        for tl, jl in zip(tp, jp):
            for t, j in zip(tl, jl):
                t.copy_(torch.from_numpy(np.array(j)))
        want, jp = jmod.apply(jvars, jnp.asarray(tokens), positions=jnp.asarray(pos), caches=jp,
                              block_tables=jnp.asarray(bt), adapters=jreg.pool(),
                              adapter_ids=jnp.asarray(ids))
        plain, _ = jmod.apply(jvars, jnp.asarray(tokens), positions=jnp.asarray(pos),
                              caches=jax.tree_util.tree_map(jnp.copy, jp),
                              block_tables=jnp.asarray(bt))
        with torch.no_grad():
            got, tp = tmod(torch.from_numpy(tokens).long(), positions=torch.from_numpy(pos),
                           caches=tp, block_tables=torch.from_numpy(bt), adapters=treg.pool(),
                           adapter_ids=torch.from_numpy(ids))
        # the adapters are real: the adapted rows differ from the base model's
        assert np.abs(np.asarray(plain[0, :n]) - np.asarray(want[0, :n])).max() > 1e-2
        moved = set()
        for tl, jl in zip(tp, jp):
            for t, j in zip(tl, jl):
                if t.dtype == torch.int8:
                    d = np.abs(t.numpy().astype(int) - np.asarray(j).astype(int))
                    assert d.max() <= 1
                    flips += int(d.sum())
                    pages = set(np.nonzero(d)[0].tolist())
                    moved |= {i for i in range(3) if pages & set(bt[i].tolist())}
                else:
                    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32), **TOL)
        for i in range(3):
            np.testing.assert_allclose(_np(got[i, :n]), np.asarray(want[i, :n]),
                                       **(FLIP_TOL if i in moved else TOL))
    assert flips <= 2, flips


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_identity_id_is_bitwise_unadapted(models, pools, kv):
    _, _, tmod = models
    _, treg = pools

    def runner(ids):
        def run(tokens, pos, caches, bt):
            kw = {} if ids is None else dict(adapters=treg.pool(),
                                             adapter_ids=torch.tensor(ids))
            return tmod(torch.from_numpy(tokens).long(), positions=torch.from_numpy(pos),
                        caches=caches, block_tables=torch.from_numpy(bt), **kw)
        return run

    init = lambda kv: tt.init_paged_kv_caches(tmod.cfg, 12, PS, kv, device="cpu")  # noqa: E731
    with torch.no_grad():
        base, base_pools = _paged_run(runner(None), init, None, kv)
        zero, zero_pools = _paged_run(runner([0, 0, 0]), init, None, kv)
        mixed, _ = _paged_run(runner([2, 0, 3]), init, None, kv)
    for b, z, m in zip(base, zero, mixed):
        assert torch.equal(b, z)
        assert torch.equal(b[1], m[1])              # the identity row of a mixed batch
        assert not torch.equal(b[0], m[0])
    for bl, zl in zip(base_pools, zero_pools):
        for bt_, zt in zip(bl, zl):
            assert torch.equal(bt_, zt)


def test_adapters_without_ids_raise(models, pools):
    _, _, tmod = models
    with pytest.raises(ValueError, match="adapter_ids"):
        tmod(torch.zeros((1, 4), dtype=torch.long), adapters=pools[1].pool())


# ---------------------------------------------------------------------------
# registry discipline, against the JAX registry on the same calls
# ---------------------------------------------------------------------------

def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, KeyError) as e:
        return (type(e).__name__, None)


def _discipline(reg, cfg):
    log = []
    w = factors(cfg, 1)
    kv = dict(factors(cfg, 2, projs=("wq",)), wk=w["wq"])
    log.append(_outcome(lambda: reg.load("kv", kv)))
    log.append(_outcome(lambda: reg.load("bad", {"wz": w["wq"]})))
    log.append(_outcome(lambda: reg.load("shape", {"wq": (w["wq"][0][:1], w["wq"][1])})))
    log.append(_outcome(lambda: reg.load("rank", w, rank=RANK + 1)))
    log.append(_outcome(lambda: reg.load("", w)))
    log.append(_outcome(lambda: reg.load("a", w, alpha=8)))
    log.append(_outcome(lambda: reg.load("b", factors(cfg, 3, projs=("w2", "wo")))))
    aid = reg.resolve_and_pin("a")
    log.append(("pinned", aid, reg.refs_of("a")))
    log.append(_outcome(lambda: reg.evict("a")))
    log.append(_outcome(lambda: reg.load("a", w)))                  # reload while pinned
    log.append(_outcome(lambda: reg.load("c", w)))
    log.append(_outcome(lambda: reg.load("d", w)))                  # pool full (4 rows)
    log.append(_outcome(lambda: reg.resolve("ghost")))
    log.append(_outcome(lambda: reg.resolve_and_pin("ghost")))
    log.append(_outcome(lambda: reg.pin(5)))
    log.append(_outcome(lambda: reg.unpin(reg.resolve("b"))))     # unbalanced
    reg.pin(reg.resolve("b"))
    reg.unpin(reg.resolve("b"))
    reg.unpin(aid)
    log.append(_outcome(lambda: reg.evict("a")))
    log.append(_outcome(lambda: reg.evict("a")))
    log.append(_outcome(lambda: reg.load("d", w, alpha=2)))        # reuses the freed row
    log.append(("names", reg.names(), reg.resolve(None), reg.resolve("")))
    st = reg.stats()
    log.append({k: st[k] for k in ("adapter_loaded", "adapter_capacity",
                                   "adapter_evictions_total", "adapter_loads_total",
                                   "adapter_pool_bytes", "adapter_rank", "adapter_pins")})
    reg.evict("b")
    pool = reg.pool()
    rows = {p: [np.asarray(_to_np(t)) for t in ab] for p, ab in pool.items() if p != "scale"}
    return log, rows, np.asarray(_to_np(pool["scale"]))


def _to_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def test_registry_discipline_equals_jax(models):
    jmod, _, tmod = models
    jlog, jrows, jscale = _discipline(JaxRegistry(jmod.cfg, RANK, 4), jmod.cfg)
    tlog, trows, tscale = _discipline(AdapterRegistry(tmod.cfg, RANK, 4, device="cpu"),
                                      tmod.cfg)
    assert tlog == jlog
    assert tlog[0][0] == tlog[1][0] == tlog[2][0] == "ValueError"
    np.testing.assert_array_equal(tscale, jscale)
    for p in ADAPTED_PROJECTIONS:
        for t, j in zip(trows[p], jrows[p]):
            np.testing.assert_array_equal(t, j)
    b_row = 2   # "b" was evicted: its row is zeros
    assert all(not r[b_row].any() for p in ADAPTED_PROJECTIONS for r in trows[p])
    assert tscale[b_row] == 0 and tscale[1] == 2 / RANK


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_uri_round_trip_equals_jax(models, tmp_path, dtype):
    jmod, _, tmod = models
    w = factors(tmod.cfg, 7, projs=("wq", "w1", "w2"))
    d = tmp_path / "adapter"
    d.mkdir()
    (d / "adapter.json").write_text(json.dumps({"rank": RANK, "alpha": 6}))
    np.savez(d / "weights.npz", **{f"{p}.{part}": ab[i] for p, ab in w.items()
                                   for i, part in enumerate("AB")})
    jreg = JaxRegistry(jmod.cfg, RANK, 3, dtype=jnp.dtype(dtype))
    treg = AdapterRegistry(tmod.cfg, RANK, 3, dtype=dtype, device="cpu")
    assert jreg.load_uri("x", str(d)) == treg.load_uri("x", f"file://{d}") == 1
    for p in ADAPTED_PROJECTIONS:
        for jt_, t in zip(jreg.pool()[p], treg.pool()[p]):
            assert t.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(_to_np(t), np.asarray(jt_, np.float32))
    np.testing.assert_array_equal(_to_np(treg.pool()["scale"]), np.asarray(jreg.pool()["scale"]))
    np.savez(d / "weights.npz", **{"wq.A": w["wq"][0]})
    for reg, uri in ((jreg, str(d)), (treg, f"file://{d}")):
        with pytest.raises(ValueError, match="needs both"):
            reg.load_uri("y", uri)
