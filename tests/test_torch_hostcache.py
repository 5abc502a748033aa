"""The port's host cache tier (``serving/hostcache``) and the engine paths
that use it, on the CPU at reduced widths in float32.

Against the reference's classes, on the same op scripts: the arena's,
the tier's, the staging ring's and the block manager's ``stats_export``
key for key, the crc32 of the same bytes, the contiguous run, the one-shot
park, a corrupt pinned get, the breaker. Against the JAX engine, in two
runs that share the reference's ``save_pytree`` weights and noise key: the
spill-and-restage traffic on reduced qwen3-1.7b and the recurrent
snapshots on reduced rwkv6-7b, their counters equal as integers. Against
the port's own solo sampler, bitwise: every engine run here, on qwen,
rwkv6-7b and jamba-1.5-large-398b cut to four layers."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_pytree as jax_save_pytree
from repro.configs import get_config as jax_get_config
from repro.models.transformer import TransformerLM as JaxLM
from repro.serving import HostArena as JaxArena
from repro.serving import HostTier as JaxTier
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import StagingRing as JaxRing
from repro.serving.blocks import BlockManager as JaxBlocks
from repro.serving.faults import CircuitBreaker as JaxBreaker
from repro.serving.faults import FaultPlan as JaxFaultPlan
from repro.serving.faults import StagingFault as JaxStagingFault
from repro.serving.hostcache.arena import _checksum as jax_checksum
from repro_torch.checkpoint.io import load_pytree, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine.spec_decode import PredictiveSampler
from repro_torch.launch import serve
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.admission import Request
from repro_torch.serving.blocks import BlockManager, chain_hashes
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import (CircuitBreaker, FaultPlan,
                                        StagingFault)
from repro_torch.serving.hostcache import (HostArena, HostTier, StagingRing,
                                           checksum)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's torch work on one thread, put back after it: its many
    small ops lose most of their time to the thread pool when the suite's
    workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = torch.device("cpu")
EPS_SEED = 9
EPS_KEY = jax.random.PRNGKey(EPS_SEED)
KW = dict(batch=1, window_max=4, max_len=48, eps_key=EPS_SEED, block_size=4,
          adaptive=False, device=CPU)


def _blk(fill, shape=(4, 8), dtype=np.float32):
    return np.full(shape, fill, dtype)


BLK_BYTES = _blk(0).nbytes


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the arena, the tier, the ring and the block manager against the reference
# ---------------------------------------------------------------------------

def test_checksum_matches_the_reference_on_the_same_bytes():
    """The crc32 of float32, int64 and bfloat16 tensors equals the
    reference's over the same bytes (a bfloat16 tensor's bytes are its
    uint16 words)."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i64 = rng.integers(-9, 9, (7,))
    bf = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)
                          ).to(torch.bfloat16)
    words = bf.view(torch.int16).numpy().view(np.uint16)
    assert checksum(_t([f32, i64])) == jax_checksum([f32, i64])
    assert checksum([bf]) == jax_checksum([words])
    assert checksum([bf, torch.from_numpy(f32)]) == jax_checksum([words, f32])
    assert checksum([torch.zeros(0)]) == jax_checksum([np.zeros(0)]) == 0


ARENA_SCRIPT = (
    ("put", "a", 1, False), ("put", "b", 2, False), ("put", "c", 3, True),
    ("get", "a"), ("put", "d", 4, False), ("contains", "b"),
    ("put", "a", 1, True), ("put", "e", 5, False), ("unpin", "c"),
    ("put", "f", 6, False), ("drop", "d"), ("put", "g", 7, False),
    ("get", "g"), ("get", "zz"), ("pin", "g"), ("put", "huge", 0, False),
    ("unpin", "g"), ("unpin", "gone"), ("get", "a"), ("get", "e"),
    ("put", "h", 8, False), ("drop", "a"), ("get", "a"),
    ("put", "i", 9, False), ("drop", "i"), ("drop", "h"),
    ("put", "j", 10, False))


def _arena_op(arena, op, as_tensor):
    kind, key = op[0], op[1]
    if kind == "put":
        shape = (64, 64) if key == "huge" else (4, 8)
        arrays = [_blk(op[2], shape), _blk(op[2] + 0.5, (2,))]
        return arena.put(key, _t(arrays) if as_tensor else arrays,
                         pin=op[3])
    if kind == "get":
        got = arena.get(key)
        return None if got is None else [np.asarray(a).tolist() for a in got]
    return getattr(arena, kind)(key)


@pytest.mark.parametrize("faults", [None, "arena_put=@2,arena_corrupt=@1;4"])
def test_arena_matches_the_reference_on_the_same_script(faults):
    """Puts, dedup puts, gets, pins, drops, an oversized put and LRU
    pressure: every answer and ``stats_export`` after every op equal the
    reference's, and the budget holds; with injected ``arena_put`` refusals
    and ``arena_corrupt`` flips the same entries fail in both, pinned ones
    too."""
    cap = 4 * (BLK_BYTES + 8)
    mine = HostArena(cap, faults=FaultPlan.parse(faults) if faults else None)
    ref = JaxArena(cap, faults=JaxFaultPlan.parse(faults) if faults
                   else None)
    for op in ARENA_SCRIPT:
        assert _arena_op(mine, op, True) == _arena_op(ref, op, False), op
        assert mine.stats_export() == ref.stats_export(), op
        assert list(mine._entries) == list(ref._entries), op
        assert mine.bytes_resident + mine.bytes_slab <= cap
    st = mine.stats_export()
    assert st["host_slab_reuses"] > 0 and st["host_evictions"] > 0
    if faults:
        assert st["checksum_failures"] >= 1 and st["host_rejections"] >= 1


def test_corrupt_pinned_get_leaks_no_pin():
    """A corrupt pinned entry is dropped like any other: no pin survives,
    its bytes go to the slab, the arena fills back to capacity, and the pin
    owner's later unpin is a no-op."""
    fired = []
    a = HostArena(4 * BLK_BYTES, on_corruption=fired.append)
    assert a.put("k", _t([_blk(3)]), pin=True)
    a._entries["k"].tensors[0].view(torch.uint8)[0, 0] ^= 0xFF
    assert a.get("k") is None
    assert a.stats.checksum_failures == 1 and fired == ["k"]
    assert a.bytes_resident == 0 and a.bytes_slab == BLK_BYTES
    for i in range(4):
        assert a.put(i, _t([_blk(i)]))
    assert len(a) == 4 and a.stats.rejections == 0
    a.unpin("k")
    assert a.put("again", _t([_blk(9)]))
    assert a.stats.slab_reuses >= 1


def test_tier_matches_the_reference():
    """The tier's clients on both packages: ``kv_run`` stops at the first
    gap and keeps shards apart, a park is pinned under pressure and read
    once, snapshots dedup, and the stats equal the reference's."""
    mine, ref = HostTier(4 * BLK_BYTES, device=CPU), JaxTier(4 * BLK_BYTES)
    for t, conv in ((mine, _t), (ref, list)):
        for k in (101, 102, 104):
            assert t.put_kv(0, k, conv([_blk(k)]))
        assert t.kv_run(0, [101, 102, 103, 104]) == 2
        assert t.kv_run(0, [103, 104]) == 0 and t.kv_run(1, [101]) == 0
        assert t.put_park(7, conv([_blk(9)]))
        assert t.put_rec(0, 55, conv([_blk(5)]))
        assert t.put_rec(0, 55, conv([_blk(5)]))          # dedup
        assert t.has_rec(0, 55) and not t.has_rec(1, 55)
        assert t.put_kv(0, 105, conv([_blk(1)]))          # evicts 101
        assert t.kv_run(0, [101]) == 0
        got = t.take_park(7)
        np.testing.assert_array_equal(np.asarray(got[0]), _blk(9))
        assert t.take_park(7) is None                     # one-shot
        assert t.get_rec(0, 55) is not None
        assert t.pin_kv(0, 102) and not t.pin_kv(0, 999)
        t.unpin_kv(0, 102)
    assert mine.stats_export() == ref.stats_export()


def test_drop_park_is_ungated_while_the_breaker_is_half_open():
    """A parked payload dropped while the breaker is open or mid-probe
    still frees its bytes; an open tier answers every probe as a miss; a
    verified get closes it. The breaker's and the tier's stats equal the
    reference's."""
    tiers = [(HostTier(4 * BLK_BYTES, device=CPU,
                       breaker=CircuitBreaker(threshold=1, cooldown=8)), _t),
             (JaxTier(4 * BLK_BYTES, breaker=JaxBreaker(threshold=1,
                                                        cooldown=8)), list)]
    for t, conv in tiers:
        br = t.breaker
        assert t.put_park(7, conv([_blk(7)])) and t.put_park(8, conv([_blk(8)]))
        assert t.put_kv(0, 1, conv([_blk(1)]))
        br.record_failure()
        assert br.state == "open"
        assert t.drop_park(7)
        assert t.arena.bytes_resident == 2 * BLK_BYTES
        # open: every probe a miss, counted as denied
        assert (t.kv_run(0, [1]), t.get_kv(0, 1), t.has_kv(0, 1),
                t.put_kv(0, 2, conv([_blk(2)]))) == (0, None, False, False)
        br.state = "half_open"
        assert t.drop_park(8) and br.state == "half_open"
        assert t.get_kv(0, 1) is not None and br.state == "closed"
    assert tiers[0][0].stats_export() == tiers[1][0].stats_export()
    assert tiers[0][0].stats_export()["tier_denied_ops"] == 4


def test_staging_ring_matches_the_reference():
    """Depth, FIFO order and accounting against the reference's ring on the
    same script, a clear and the ``stage_drop`` seam; on the CPU nothing
    counts as overlapped and the taken tensors equal their sources."""
    mine = StagingRing(depth=2, faults=FaultPlan.parse("stage_drop=@5"),
                       device=CPU)
    ref = JaxRing(depth=2, faults=JaxFaultPlan.parse("stage_drop=@5"))
    for ring, conv in ((mine, _t), (ref, list)):
        for i in range(5):
            ring.stage(i, conv([_blk(i), _blk(i, (3,), np.int64)]))
        assert len(ring) == 5
        tags = []
        while (item := ring.take()) is not None:
            tag, devs = item
            tags.append(tag)
            np.testing.assert_array_equal(np.asarray(devs[0]), _blk(tag))
        assert tags == [0, 1, 2, 3, 4]
        with pytest.raises((StagingFault, JaxStagingFault)):
            ring.stage(5, conv([_blk(5)]))
        ring.stage(6, conv([_blk(6)]))
        ring.stage(7, conv([_blk(7)]))
        assert ring.clear() == 2 and ring.take() is None
    got, want = mine.stats_export(), ref.stats_export()
    for k in ("h2d_staged", "h2d_staged_bytes", "h2d_dropped"):
        assert got[k] == want[k], k
    assert got["h2d_overlapped"] == 0 and got["h2d_overlap_frac"] == 0.0


def test_blocks_dropped_against_spilled_match_the_reference():
    """Evictions split into spilled (the hook kept them) and dropped, and
    the tiered lookup's host run, on the same script as the reference's
    block manager: equal ids and stats."""
    out = []
    for mgr, tier, conv in (
            (BlockManager(6, 4), HostTier(1 << 20, device=CPU), _t),
            (JaxBlocks(6, 4), JaxTier(1 << 20), list)):
        saved = []

        def hook(b, key, tier=tier, conv=conv, saved=saved):
            saved.append(key)
            return key % 2 == 0 and tier.put_kv(0, key, conv([_blk(key)]))
        mgr.spill_hook = hook
        toks = np.arange(20)
        _, keys = mgr.lookup_prefix(toks, 5)
        blocks = mgr.alloc(5)
        for b, k in zip(blocks, keys):
            mgr.register(b, k)
        mgr.release_all(blocks)
        new = mgr.alloc(5)                   # evicts all five
        mgr.release_all(new)
        hits, keys2, host = mgr.lookup_prefix_tiered(toks, 5, tier=tier)
        out.append((new, hits, host, [k % 2 for k in saved],
                    mgr.stats.export()))
    assert out[0] == out[1]
    st = out[0][4]
    assert st["evictions"] == 5 and st["blocks_spilled"] + st[
        "blocks_dropped"] == 5 and st["blocks_dropped"] >= 1


# ---------------------------------------------------------------------------
# the engine: reduced qwen3-1.7b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Reduced configs in both packages, the reference's weights saved by
    its ``save_pytree`` and read back by the port; rwkv6-7b also, and the
    jamba cut to its first four layers (port only)."""
    out = {}

    def get(arch):
        if arch not in out:
            cfg = get_config(arch, reduced=True)
            jcfg = jax_get_config(arch, reduced=True)
            if arch == "jamba-1.5-large-398b":
                cut = dict(n_layers=4, layer_block=cfg.layer_block[:4])
                cfg = dataclasses.replace(cfg, **cut)
                jcfg = dataclasses.replace(jcfg, **cut)
            jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
            d = tmp_path_factory.mktemp(arch)
            jax_save_pytree(jparams, str(d), step=1)
            out[arch] = (cfg, params_from_numpy(load_pytree(str(d), 1), cfg),
                         jcfg, jparams)
        return out[arch]
    return get


def _solo(cfg, params, req, window=4, max_len=48):
    s = PredictiveSampler(cfg, params, window=window, max_len=max_len,
                          eps_key=EPS_SEED, device=CPU)
    t, _ = s.generate(torch.as_tensor(np.asarray(req.prompt))[None],
                      req.new_tokens, seq_ids=torch.tensor([req.seq_id]))
    return t[0, :len(req.prompt) + req.new_tokens].numpy()


def _assert_solo(cfg, params, done, window=4, max_len=48):
    assert done, "no request finished"
    for r in done:
        assert r.ok, (r.uid, r.error)
        np.testing.assert_array_equal(
            r.result, _solo(cfg, params, r, window, max_len),
            err_msg=f"request {r.uid} differs from its solo run")


def _spill_traffic(cfg, cls=Request):
    """A's two full prompt blocks are evicted by B, whose worst case fills
    the 7-block pool; C shares A's prefix."""
    rng = np.random.default_rng(11)
    pre_a = rng.integers(0, cfg.vocab, 8)
    pre_b = rng.integers(0, cfg.vocab, 9)
    return [cls(uid=0, prompt=np.concatenate([pre_a, [3]]), new_tokens=8),
            cls(uid=1, prompt=pre_b, new_tokens=15),
            cls(uid=2, prompt=np.concatenate([pre_a, [5]]), new_tokens=8)]


def _serve(cfg, params, reqs, **kw):
    eng = ServingEngine(cfg, params, **{**KW, **kw})
    for r in reqs:
        assert eng.submit(r)
    return eng.run(), eng


SPILL_COUNTERS = ("blocks_spilled", "blocks_dropped", "host_hits",
                  "host_puts", "host_staged_blocks", "prefill_calls")


def test_tier_is_on_by_default_and_zero_turns_it_off(models, monkeypatch):
    cfg, params, _, _ = models("qwen3-1.7b")
    eng = ServingEngine(cfg, params, **KW)
    assert eng.tier.arena.capacity_bytes == 256 * 2 ** 20
    assert not eng.tier.arena.pinned and eng.tier.staging.device == CPU
    monkeypatch.setenv("REPRO_HOST_CACHE_MB", "1.5")
    assert ServingEngine(cfg, params, **KW).tier.arena.capacity_bytes == int(
        1.5 * 2 ** 20)
    assert ServingEngine(cfg, params, host_cache_mb=0, **KW).tier is None
    m = ServingEngine(cfg, params, host_cache_mb=0, **KW).export_metrics()
    assert (m["checksum_failures"], m["tier_state"]) == (0, "closed")


def test_engine_refuses_a_tier_of_another_device(models):
    """A tier that stages to another device, or whose arena is pinned for
    another, would copy through the wrong path: the engine refuses it."""
    cfg, params, _, _ = models("qwen3-1.7b")
    with pytest.raises(ValueError, match="host_tier"):
        ServingEngine(cfg, params, host_tier=HostTier(1 << 20,
                                                      device="cuda"), **KW)
    tier = HostTier(1 << 20, device=CPU)
    tier.arena.pinned = True
    with pytest.raises(ValueError, match="host_tier"):
        ServingEngine(cfg, params, host_tier=tier, **KW)


def test_engine_frees_its_pools_without_a_garbage_collection(models):
    """The spill hook and the fault seam hold the tier, the pools and the
    plan, not the engine: a dropped engine frees its device pools and its
    arena at once, with the cyclic collector off."""
    import gc
    import weakref
    cfg, params, _, _ = models("qwen3-1.7b")
    gc.disable()
    try:
        for kw in ({}, {"faults": FaultPlan.parse("alloc=@9")}):
            eng = ServingEngine(cfg, params, **KW, **kw)
            assert eng.pool.manager(0).spill_hook is not None
            refs = [weakref.ref(x) for x in (
                eng, eng.tier, eng.tier.arena,
                TransformerLM.pool_leaves(cfg, eng.paged)[0])]
            del eng
            assert all(r() is None for r in refs), kw
    finally:
        gc.enable()


def test_spill_and_restage_match_the_jax_engine(models):
    """Evicted prefix blocks go D2H into the arena and come back through
    the staging ring for C: the counters equal the JAX engine's on the same
    traffic and budget, tokens equal the port's solo sampler bitwise, and
    the tier-less port engine drops the blocks and prefills more."""
    cfg, params, jcfg, jparams = models("qwen3-1.7b")
    done, eng = _serve(cfg, params, _spill_traffic(cfg), num_blocks=8)
    mine = eng.export_metrics()
    jkw = {k: v for k, v in KW.items() if k not in ("device", "eps_key")}
    jeng = JaxEngine(jcfg, jparams, eps_key=EPS_KEY, num_blocks=8, **jkw)
    for r in _spill_traffic(jcfg, JaxRequest):
        jeng.submit(r)
    jdone = jeng.run()
    ref = jeng.export_metrics()
    for k in SPILL_COUNTERS + ("host_bytes_resident", "h2d_staged",
                               "host_misses", "evictions"):
        assert mine[k] == ref[k], (k, mine[k], ref[k])
    assert [r.prefix_hit_blocks for r in done] == [
        r.prefix_hit_blocks for r in jdone]
    assert mine["blocks_spilled"] >= 2 and mine["host_staged_blocks"] >= 1
    assert done[2].prefix_hit_blocks >= 1
    _assert_solo(cfg, params, done)
    _, nt = _serve(cfg, params, _spill_traffic(cfg), num_blocks=8,
                   host_cache_mb=0)
    m_nt = nt.export_metrics()
    assert m_nt["blocks_dropped"] >= 2
    assert mine["prefill_calls"] < m_nt["prefill_calls"]


def test_parked_prompt_blocks_are_stored_once(models):
    """Two parked sequences share a prompt: the second park pins the shared
    blocks and adds only its private entry; both resume bitwise."""
    cfg, params, _, _ = models("qwen3-1.7b")
    eng = ServingEngine(cfg, params, **{**KW, "batch": 2, "max_len": 64})
    prompt = np.random.default_rng(12).integers(0, cfg.vocab, 13)
    for uid in (0, 1):
        eng.submit(Request(uid=uid, prompt=prompt, new_tokens=24))
    eng.step()
    arena = eng.tier.arena
    n0, b0 = len(arena), arena.bytes_resident
    eng.preempt_slot(0)
    n1, b1 = len(arena), arena.bytes_resident
    eng.preempt_slot(1)
    n2, b2 = len(arena), arena.bytes_resident
    assert n1 - n0 >= 4 and n2 - n1 == 1 and b2 - b1 < b1 - b0
    assert all(e.refs == 2 for k, e in arena._entries.items()
               if k[0] == "kv")
    done = eng.run()
    assert (eng.metrics.preemptions, eng.metrics.resumes) == (2, 2)
    assert arena.stats_export()["host_entries_pinned"] == 0
    _assert_solo(cfg, params, done, max_len=64)


def test_queued_request_prefetches_its_spilled_prefix(models):
    """A request waiting behind a full pool gets its tier-resident prefix
    restaged while queued; its admission merges those copies
    (``prefetch_hits``) and nothing is left prefetched."""
    cfg, params, _, _ = models("qwen3-1.7b")
    a, b, c = _spill_traffic(cfg)
    eng = ServingEngine(cfg, params, num_blocks=8, staging_slots=1, **KW)
    eng.submit(a)
    eng.run()
    eng.submit(b)
    eng.step()
    eng.submit(c)
    for _ in range(4):
        eng.step()
    assert c.uid in eng._prefetched or eng.metrics.prefetch_hits >= 1
    done = eng.run()
    m = eng.export_metrics()
    assert m["blocks_spilled"] >= 2 and m["prefetch_hits"] >= 1
    assert c.prefix_hit_blocks >= 1 and not eng._prefetched
    _assert_solo(cfg, params, [a] + done)


def _park_run(cfg, params, faults=None):
    eng = ServingEngine(cfg, params, faults=faults,
                        **{**KW, "batch": 2, "max_len": 64})
    prompt = np.random.default_rng(12).integers(0, cfg.vocab, 13)
    for uid in (0, 1):
        eng.submit(Request(uid=uid, prompt=prompt, new_tokens=24))
    eng.step()
    eng.preempt_slot(0)
    return {r.uid: r.result for r in eng.run()}, eng


def test_corrupt_park_resumes_cold(models):
    """``arena_corrupt`` on the resume's read of the park entry: the entry
    fails its checksum, the resume recomputes by prefill, the pins are
    released, and the tokens equal the unfaulted run's bitwise."""
    cfg, params, _, _ = models("qwen3-1.7b")
    base, _ = _park_run(cfg, params)
    got, eng = _park_run(cfg, params, FaultPlan.parse("arena_corrupt=@0"))
    m = eng.export_metrics()
    assert (m["resume_recomputes"], m["checksum_failures"]) == (1, 1)
    assert m["faults_fired_arena_corrupt"] == 1 and m["resumes"] == 1
    assert m["host_entries_pinned"] == 0
    assert got.keys() == base.keys()
    for uid in base:
        np.testing.assert_array_equal(got[uid], base[uid])


def test_stage_drop_during_a_restage_prefills_instead(models):
    """``stage_drop`` on C's first upload: the ring is cleared, the error
    counted, C prefills its prefix, and every token equals the solo
    sampler's."""
    cfg, params, _, _ = models("qwen3-1.7b")
    done, eng = _serve(cfg, params, _spill_traffic(cfg), num_blocks=8,
                       faults=FaultPlan.parse("stage_drop=@0"))
    m = eng.export_metrics()
    assert (m["staging_errors"], m["host_staged_blocks"]) == (1, 0)
    assert m["h2d_dropped"] >= 0 and m["faults_fired_stage_drop"] == 1
    assert done[2].prefix_hit_blocks == 0
    _assert_solo(cfg, params, done)


def test_tripped_breaker_answers_every_probe_as_a_miss(models):
    """A tier whose breaker is open refuses the spills (counted as
    dropped), stages nothing and counts the denied operations; the tokens
    are unchanged."""
    cfg, params, _, _ = models("qwen3-1.7b")
    tier = HostTier(1 << 20, device=CPU,
                    breaker=CircuitBreaker(threshold=1, cooldown=10_000))
    tier.record_failure()
    done, eng = _serve(cfg, params, _spill_traffic(cfg), num_blocks=8,
                       host_tier=tier)
    m = eng.export_metrics()
    assert m["tier_state"] == "open" and m["tier_denied_ops"] > 0
    assert (m["host_puts"], m["host_hits"], m["host_staged_blocks"]) == (
        0, 0, 0)
    assert m["blocks_dropped"] >= 2 and m["blocks_spilled"] == 0
    _assert_solo(cfg, params, done)


PLAN = [("submit", (3, 8)), ("submit", (9, 6)), ("step", None),
        ("preempt", 0), ("submit", (9, 10)), ("step", None), ("step", None),
        ("submit", (7, 5)), ("preempt", 1), ("step", None),
        ("submit", (3, 6)), ("preempt", 0)]


def test_tiny_budget_schedule_stays_exact(models):
    """The reference's tiny-budget interleaving (its ``migrate`` steps left
    out, one round a sync) over a 12-block pool and a ~30 KiB arena: parks
    and spills under a budget that evicts cost capacity only, never a
    token."""
    cfg, params, _, _ = models("qwen3-1.7b")
    # one round a sync, so the preempt steps find requests still running
    eng = ServingEngine(cfg, params, host_cache_mb=0.03, num_blocks=12,
                        rounds_per_sync=1,
                        **{**KW, "batch": 2, "max_len": 64})
    assert eng.tier.arena.capacity_bytes < 64 * 1024
    uid = 0
    for op, arg in PLAN:
        if op == "submit":
            L_p, new = arg
            rng = np.random.default_rng(100 + uid)
            eng.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab,
                                                            L_p),
                               new_tokens=new))
            uid += 1
        elif op == "step":
            eng.step()
        else:
            occ = [b for b in range(2) if eng.slots[b] is not None]
            if occ:
                eng.preempt_slot(occ[arg % len(occ)])
    done = eng.run()
    assert len(done) == uid and eng.metrics.preemptions >= 2
    m = eng.export_metrics()
    assert m["host_evictions"] > 0 and m["host_entries_pinned"] == 0
    _assert_solo(cfg, params, done, max_len=64)


# ---------------------------------------------------------------------------
# recurrent snapshots: rwkv6-7b and the jamba cut
# ---------------------------------------------------------------------------

REC_COUNTERS = ("rec_snapshot_captures", "rec_snapshot_restores",
                "prefill_calls", "host_bytes_resident")


def _system(cfg, cls=Request):
    system = np.random.default_rng(13).integers(0, cfg.vocab, 13)
    return (cls(uid=0, prompt=system, new_tokens=8),
            cls(uid=1, prompt=np.concatenate([system, [7, 2]]),
                new_tokens=8))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_recurrent_prefix_reuse_via_snapshots(models, arch):
    """A shared prompt's boundary snapshots are captured on the first
    request and restored on the second: warm equals cold bitwise, both
    equal the solo sampler bitwise; rwkv6-7b's counters equal the JAX
    engine's."""
    cfg, params, jcfg, jparams = models(arch)
    r0, r1 = _system(cfg)
    eng = ServingEngine(cfg, params, **KW)
    assert eng.rec_prefix and not eng.kv_prefix
    assert eng._kv_share == (arch != "rwkv6-7b")
    eng.submit(r0)
    eng.run()
    assert eng.metrics.rec_snapshot_captures >= 3
    eng.submit(r1)
    eng.run()
    m = eng.export_metrics()
    assert m["rec_snapshot_restores"] >= 1 and m["host_hits"] > 0
    assert r1.prefix_hit_blocks >= 3
    cold_req = Request(uid=1, prompt=r1.prompt, new_tokens=8)
    _, cold = _serve(cfg, params, [cold_req])
    assert cold.metrics.rec_snapshot_restores == 0
    np.testing.assert_array_equal(r1.result, cold_req.result)
    _assert_solo(cfg, params, [r0, r1])
    if arch != "rwkv6-7b":
        return
    jkw = {k: v for k, v in KW.items() if k not in ("device", "eps_key")}
    jeng = JaxEngine(jcfg, jparams, eps_key=EPS_KEY, **jkw)
    j0, j1 = _system(jcfg, JaxRequest)
    jeng.submit(j0)
    jeng.run()
    jeng.submit(j1)
    jeng.run()
    ref = jeng.export_metrics()
    for k in REC_COUNTERS + ("host_hits", "host_puts"):
        assert m[k] == ref[k], (k, m[k], ref[k])
    assert r1.prefix_hit_blocks == j1.prefix_hit_blocks


def test_cut_short_staging_releases_the_hits_past_the_snapshot(models):
    """The jamba cut: the second request hits two device blocks, restages
    the third from the tier and restores the snapshot at boundary 3; a
    ``stage_drop`` cuts the restage, and boundary 2's snapshot is gone, so
    the resume falls back to boundary 1. The shared hit past it goes back
    to the pool instead of being rewritten by the prefill, and the tokens
    equal the solo sampler's."""
    cfg, params, _, _ = models("jamba-1.5-large-398b")
    r0, r1 = _system(cfg)
    eng = ServingEngine(cfg, params, faults=FaultPlan.parse("stage_drop=@0"),
                        **KW)
    eng.submit(r0)
    eng.run()
    pool, keys = eng.pool.manager(0), chain_hashes(np.asarray(r1.prompt),
                                                    4, 3)
    held = [pool.block_of[k] for k in keys[:2]]
    for b in held:
        pool.acquire(b)
    # the third block is the only cached-free one: the next eviction
    # spills it into the tier
    extra = pool.alloc(len(pool.free) + 1)
    assert pool.stats.spilled == 1 and keys[2] not in pool.block_of
    pool.release_all(extra + held)
    assert eng.tier.arena.drop(("rec", 0, keys[1]))
    eng.submit(r1)
    eng.step()
    m = eng.export_metrics()
    assert (m["staging_errors"], m["rec_snapshot_restores"]) == (1, 1)
    assert r1.prefix_hit_blocks == 1
    assert eng.owned[0][0] == held[0] and held[1] not in eng.owned[0]
    assert pool.refcount[held[1]] == 0 and pool.block_of[keys[1]] == held[1]
    eng.run()
    _assert_solo(cfg, params, [r0, r1])


def test_serve_help_lists_host_cache_flags(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--host-cache-mb", "--no-host-cache",
                 "--no-integrity-checks"):
        assert flag in out
