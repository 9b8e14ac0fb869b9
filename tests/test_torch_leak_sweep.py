"""The port's error-path leak sweep (``seldon_core_tpu_torch/testing/faults.py``
``LeakSweep``) on the CPU, as JAX ``tests/test_leak_sweep.py`` runs the JAX
package's, plus the crash path the JAX package leaves out:

- a one-shot fault at each acquire boundary of a live batcher (adapter pin,
  page allocation, the radix trie's copy-on-write funding, prefill staging,
  handoff import, the fleet's resume journal), one request driven through
  it, and every count its unwind owns back at zero: pages held by slots,
  raised trie pins, adapter pins, staged remote jobs, undelivered handoffs,
  journal entries; over a local paged batcher with LoRA and the trie, a
  disaggregated paged batcher and a stub fleet; the boundaries each
  configuration lists are the JAX harness's for the same configuration;
- negative controls: a planted adapter pin, a planted journal entry and a
  boundary the drive never reaches all fail the sweep;
- a batcher loop killed mid-decode releases its slots' pages, trie pins and
  adapter pin, and its restarted loop serves with every page free. The JAX
  package's crash path keeps the dead slots' pages (ROADMAP Queue C): the
  same kill leaves them in use there after its loop restarts and serves.
"""

import numpy as np
import pytest

import jax

from seldon_core_tpu.runtime.batcher import ensure_stream_service as jax_stream_service
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu.testing.faults import BatcherKiller as JaxBatcherKiller
from seldon_core_tpu.testing.faults import LeakSweep as JaxLeakSweep
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.runtime.batcher import ensure_stream_service
from seldon_core_tpu_torch.runtime.engine import ReplicaSet
from seldon_core_tpu_torch.runtime.resilience import ShedError
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.testing.faults import BatcherKiller, LeakSweep

KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=4, len_buckets=(16,),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3, continuous_batching=3,
              continuous_batching_max_len=40, kv_page_size=8)
RANK = 4
TIMEOUT = 60.0

# 16 tokens = two full 8-token pages once cached; the CoW probe matches the
# first block and half the second (a partial-block match)
WARM = list(range(1, 17))
COW_PROBE = WARM[:12] + [77]
# full-block prefix reuse and an uncached tail: exhaustion must drop the two
# prefix pins on the unwind
PINNED_TAIL = WARM + [88, 89]
FRESH = [50, 51, 52, 53]


@pytest.fixture(scope="module")
def params():
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    return {"params": jax.tree_util.tree_map(np.asarray, j._params["params"])}


def port_server(params, **extra):
    s = LLMServer(device="cpu", **dict(COMMON, **extra))
    s.load(params=params)
    return s


@pytest.fixture(scope="module")
def local_server(params):
    # one server has three boundaries: the adapter pool, the page pool, the trie
    s = port_server(params, prefix_cache_size=8, lora_rank=RANK, lora_max_adapters=4)
    yield s
    s._batcher_service.close()


def load_one_adapter(server) -> str:
    reg = server.adapter_registry
    if "tenant-0" in reg.names():
        return "tenant-0"
    rng = np.random.default_rng(7)
    cfg = server._cfg
    dims = {"wq": (cfg.dim, cfg.n_heads * cfg.head_dim),
            "wo": (cfg.n_heads * cfg.head_dim, cfg.dim),
            "w1": (cfg.dim, cfg.ffn_dim), "w2": (cfg.ffn_dim, cfg.dim),
            "w3": (cfg.dim, cfg.ffn_dim)}
    w = {proj: (rng.normal(size=(cfg.n_layers, din, RANK)) * 0.25,
                rng.normal(size=(cfg.n_layers, RANK, dout)) * 0.25)
         for proj, (din, dout) in dims.items()}
    reg.load("tenant-0", w, alpha=2 * RANK)
    return "tenant-0"


def test_leak_sweep_local_paged(local_server):
    """The three local admission boundaries on one live batcher; each drive
    states its contained outcome (an error or a success is part of it)."""
    svc = ensure_stream_service(local_server)
    b = svc.batcher
    sweep = LeakSweep(b)
    assert sweep.boundaries() == ["adapter-pin", "page-alloc", "radix-cow"]
    name = load_one_adapter(local_server)
    assert svc.submit_sync(WARM, 4)  # the trie now holds WARM's two blocks
    sweep.assert_clean("warm-up")

    def drive(boundary):
        if boundary == "adapter-pin":
            # the unknown-adapter 400 path: no pin was taken
            with pytest.raises(SeldonError) as e:
                svc.submit_sync(FRESH, 4, adapter=name)
            assert e.value.status_code == 400
        elif boundary == "page-alloc":
            # exhaustion with two prefix pins held: the unwind frees them,
            # and with nothing in flight the admission sheds 503
            with pytest.raises(ShedError):
                svc.submit_sync(PINNED_TAIL, 4)
        else:
            # the CoW-funded allocation fails, the CoW pin is dropped, the
            # retry succeeds (a CoW-less admission would have shed)
            assert len(svc.submit_sync(COW_PROBE, 4)) == 4

    assert sweep.sweep(drive) == sweep.boundaries()
    assert sweep.fired == 3
    assert svc.submit_sync(FRESH, 4)  # still serving
    sweep.assert_clean("serving after the sweep")


def test_leak_sweep_detects_a_planted_leak(local_server):
    """A pin no unwind owns fails the probe and ``assert_clean``."""
    b = ensure_stream_service(local_server).batcher
    name = load_one_adapter(local_server)
    sweep = LeakSweep(b)
    sweep.assert_clean("baseline")
    aid = b._adapters.resolve_and_pin(name)
    try:
        assert sweep.residue()["adapter_pins"] == 1
        with pytest.raises(AssertionError, match="leak residue"):
            sweep.assert_clean("a planted leak")
    finally:
        b._adapters.unpin(aid)
    sweep.assert_clean("after the repair")


def test_leak_sweep_never_fired_is_an_error(local_server):
    sweep = LeakSweep(ensure_stream_service(local_server).batcher)
    with pytest.raises(AssertionError, match="never fired"):
        sweep.sweep(lambda boundary: None, boundaries=["page-alloc"])
    sweep.disarm()
    with pytest.raises(ValueError, match="not applicable"):
        sweep.arm("prefill-stage")  # no prefill workers here


def test_boundaries_equal_jax(params):
    """Each configuration lists the JAX harness's boundaries for it (the
    JAX batcher paged, as the port's always is)."""
    configs = [dict(), dict(prefix_cache_size=8), dict(lora_rank=RANK, lora_max_adapters=4),
               dict(disaggregation="remote_prefill", prefill_devices=1)]
    for extra in configs:
        p = port_server(params, **extra)
        j = JaxLLMServer(init_random=True, kv_cache_layout="paged", **dict(COMMON, **extra))
        j.load()
        pb, jb = ensure_stream_service(p).batcher, jax_stream_service(j).batcher
        try:
            assert LeakSweep(pb).boundaries() == JaxLeakSweep(jb).boundaries(), extra
            assert LeakSweep(pb).residue().keys() == JaxLeakSweep(jb).residue().keys()
        finally:
            p._batcher_service.close()
            j._batcher_service.close()


def test_leak_sweep_disagg_paged(params):
    s = port_server(params, disaggregation="remote_prefill", prefill_workers=2)
    svc = ensure_stream_service(s)
    b = svc.batcher
    sweep = LeakSweep(b)
    assert sweep.boundaries() == ["page-alloc", "prefill-stage", "handoff-import"]
    try:
        assert svc.submit_sync(WARM, 4)
        sweep.assert_clean("warm-up")

        def drive(boundary):
            if boundary == "page-alloc":
                with pytest.raises(ShedError):
                    svc.submit_sync(PINNED_TAIL, 4)
            elif boundary == "prefill-stage":
                # the worker's error handoff; the staged slot released
                with pytest.raises(SeldonError):
                    svc.submit_sync(FRESH, 4)
            else:
                # the import raises whatever the poisoned payload gives
                with pytest.raises(Exception):
                    svc.submit_sync(FRESH, 4)

        assert sweep.sweep(drive) == sweep.boundaries()
        assert svc.submit_sync(FRESH, 4)
        sweep.assert_clean("serving after the sweep")
        assert b.crashed is None
    finally:
        svc.close()


# ---------------------------------------------- the fleet's journal (stubs)
class _StubAllocator:
    def stats(self):
        return (10, 0, 0)


class _StubBatcher:
    def __init__(self):
        self._pending, self._slots, self.paged = [], [], False
        self.crashed, self._thread, self.heartbeat = None, None, 0.0

    def accommodates(self, prompt, max_new_tokens=None):
        return True


class _StubService:
    def __init__(self):
        self.batcher = _StubBatcher()
        self.batcher._allocator = _StubAllocator()
        self.calls = 0

    def submit_sync(self, prompt, max_new_tokens=None, on_token=None, **kw):
        self.calls += 1
        out = list(range(10, 10 + (max_new_tokens or 4)))
        for t in out:
            if on_token is not None:
                on_token(t)
        return out


class _StubReplica:
    def __init__(self):
        self._batcher_service = _StubService()


def test_leak_sweep_journal_record():
    """``ResumeJournal.record`` raising fails the fleet submit before any
    entry exists: depth stays 0, and the fleet serves on."""
    fleet = ReplicaSet([_StubReplica(), _StubReplica()])
    bare = _StubBatcher()  # no page pool: the fleet's boundary alone
    sweep = LeakSweep(bare, engine=fleet)
    assert sweep.boundaries() == ["journal-record"]

    def drive(boundary):
        with pytest.raises(SeldonError, match="journal"):
            fleet.submit_sync([1, 2, 3], 4, seed=5)

    assert sweep.sweep(drive) == ["journal-record"]
    assert fleet.submit_sync([1, 2, 3], 4, seed=5) == [10, 11, 12, 13]
    sweep.assert_clean("a fleet submit after the sweep")


def test_leak_sweep_detects_undischarged_journal_entry():
    fleet = ReplicaSet([_StubReplica()])
    sweep = LeakSweep(_StubBatcher(), engine=fleet)
    real = fleet._journal.discard
    fleet._journal.discard = lambda jid: None  # the planted leak
    try:
        assert fleet.submit_sync([1, 2, 3], 4, seed=5)
        assert sweep.residue()["journal_depth"] == 1
        with pytest.raises(AssertionError, match="journal_depth"):
            sweep.assert_clean("a planted journal entry")
    finally:
        fleet._journal.discard = real
        for jid in list(fleet._journal._entries):
            fleet._journal.discard(jid)
    sweep.assert_clean("after the repair")


# ------------------------------------------------------------ the crash path
LONG = [40, 3, 22, 8, 11, 60, 2, 33, 7, 7, 12, 13]


def kill_mid_decode(svc, stream_after: int, killer_cls, **submit_kw):
    """A request killed once ``stream_after`` of its tokens are out; the
    error it fails with (its loop's crash)."""
    got = []
    killer = killer_cls(trigger=lambda b: len(got) >= stream_after).install(svc.batcher)
    with pytest.raises(Exception, match="chaos") as e:
        svc.submit_sync(LONG, 16, on_token=lambda t: got.append(t), **submit_kw)
    if getattr(killer, "killed_thread", None) is not None:
        killer.killed_thread.join(TIMEOUT)  # the crash path's end
    return e.value


@pytest.mark.parametrize("hit", [False, True], ids=["cold", "trie-hit"])
def test_crash_path_releases_pages_pins_and_adapter(params, hit):
    """A loop killed mid-decode (the slot holding owned pages, shared trie
    pins when its prompt hit the trie, and an adapter pin): every count is
    back at zero before its client is told, and the restarted loop serves
    the solo tokens with every page free."""
    s = port_server(params, prefix_cache_size=8, lora_rank=RANK, lora_max_adapters=4,
                    max_new_tokens=16)
    svc = ensure_stream_service(s)
    b = svc.batcher
    sweep = LeakSweep(b)
    try:
        name = load_one_adapter(s)
        if hit:
            assert svc.submit_sync(LONG[:9], 4)  # the trie holds LONG's first block
        free = b._allocator.free_count()
        err = kill_mid_decode(svc, 3, BatcherKiller, **({} if hit else {"adapter": name}))
        assert b.crashed is err and b._thread is None
        sweep.assert_clean("the kill")
        assert b._allocator.free_count() == free
        assert not any(sl.active or sl.prefilling for sl in b._slots)
        solo = s.generate([FRESH], max_new_tokens=4)["tokens"][0]
        assert svc.submit_sync(FRESH, 4) == solo  # the restarted loop
        assert b.crashed is None
        sweep.assert_clean("serving after the restart")
    finally:
        svc.close()


def test_reference_crash_path_keeps_the_dead_slots_pages(params):
    """The JAX package's fault (ROADMAP Queue C): the same kill leaves the
    dead slot's pages in use after its loop restarts and serves; the
    port's batcher gets them back."""
    j = JaxLLMServer(init_random=True, kv_cache_layout="paged", **dict(COMMON, max_new_tokens=16))
    j.load()
    p = port_server(params, max_new_tokens=16)
    held = {}
    for side, svc, killer_cls in (("jax", jax_stream_service(j), JaxBatcherKiller),
                                  ("port", ensure_stream_service(p), BatcherKiller)):
        try:
            kill_mid_decode(svc, 3, killer_cls)
            assert len(svc.submit_sync(FRESH, 4)) == 4  # the restarted loop
            held[side] = svc.batcher.page_stats()["kv_pages_in_use"]
        finally:
            svc.close()
    assert held["port"] == 0
    assert held["jax"] > 0, held
