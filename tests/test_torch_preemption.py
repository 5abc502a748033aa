"""Priority preemption with exact resume in the port's serving engine, on
the CPU, at reduced widths in float32: the port's counterparts of the
passing tests of ``tests/serving/test_preemption.py`` (migration needs the
mesh, a later slice), and the host-side pieces against the reference's.

Against JAX: ``Request.clock_export``/``clock_rebase`` at a fixed ``now``
and ``BlockManager.spill``'s free and cached-free lists, bitwise; one
preempting run of both engines in lockstep, the port fed JAX's noise:
block tables, the parked ``nb_live``, the done order, each request's
``calls_used`` and ``preemptions`` and the scheduler's counters equal as
integers, tokens under the margin rule (tolerance 1e-4, as the serving
parity test). Against the port's own solo sampler and undisturbed engine,
bitwise: a forced preemption on reduced qwen3-1.7b, deepseek-v3-671b cut to
two MLA layers (latent pools parked) and jamba-1.5-large-398b cut to four
layers (Mamba rows parked beside an attention layer's blocks), the round
count of a preempted request, the progress floor, the prefix re-hit, a
parked request's cancel, the legacy dense round and the deadline poll."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.engine.spec_decode import make_eps_fn as jax_make_eps_fn
from repro.models.transformer import TransformerLM as JaxLM
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.blocks import BlockManager as JaxBlocks
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.admission import Request
from repro_torch.serving.blocks import BlockManager
from repro_torch.serving.engine import ServingEngine


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
KW = dict(batch=2, window_max=4, max_len=48, eps_key=EPS_SEED, block_size=4,
          adaptive=False, device=CPU)
ARCHS = ("qwen3-1.7b", "deepseek-v3-671b", "jamba-1.5-large-398b")


def reduced(arch):
    """The reduced config, deepseek cut to two MLA layers and jamba to the
    first four layers of its block, as the MLA and jamba tests cut them."""
    cfg = get_config(arch, reduced=True)
    if arch == "deepseek-v3-671b":
        cfg = dataclasses.replace(cfg, n_layers=2,
                                  layer_prefix=(("mla", "dense"),) * 2)
    elif arch == "jamba-1.5-large-398b":
        cfg = dataclasses.replace(cfg, n_layers=4,
                                  layer_block=cfg.layer_block[:4])
    return cfg


@pytest.fixture(scope="module")
def models():
    out = {}

    def get(arch):
        if arch not in out:
            cfg = reduced(arch)
            out[arch] = cfg, TransformerLM.init(cfg, seed=0, device=CPU)
        return out[arch]
    return get


def solo(cfg, params, req, window=4, max_len=48):
    s = PredictiveSampler(cfg, params, window=window, max_len=max_len,
                          eps_key=EPS_SEED, device=CPU)
    t, _ = s.generate(torch.as_tensor(np.asarray(req.prompt))[None],
                      req.new_tokens, seq_ids=torch.tensor([req.seq_id]))
    return t[0, :len(req.prompt) + req.new_tokens].numpy()


def assert_solo(cfg, params, done, window=4, max_len=48):
    assert done, "no request finished"
    for r in done:
        assert r.ok, (r.uid, r.error)
        np.testing.assert_array_equal(
            r.result, solo(cfg, params, r, window, max_len),
            err_msg=f"request {r.uid} differs from its solo run")


def _traffic(cfg, n=3, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab,
                                               size=int(rng.integers(2, 7))),
                    new_tokens=int(rng.integers(8, 12)))
            for i in range(n)]


# ---------------------------------------------------------------------------
# the host-side pieces against the reference's
# ---------------------------------------------------------------------------

def test_clock_export_and_rebase_match_the_reference():
    """Exported durations at a fixed ``now``, and the clocks rebased on
    another, equal the reference's to the bit, with and without an
    admission."""
    for admit in (0.0, 104.25):
        mine = Request(uid=1, prompt=np.arange(3), new_tokens=2)
        ref = JaxRequest(uid=1, prompt=np.arange(3), new_tokens=2)
        for r in (mine, ref):
            r.submit_time, r.admit_time = 100.5, admit
        out = mine.clock_export(now=107.125)
        assert out == ref.clock_export(now=107.125)
        assert out["elapsed"] == 6.625
        assert (out["admit_elapsed"] is None) == (admit == 0.0)
        for r in (mine, ref):
            r.clock_rebase(out, now=9.0)
        assert (mine.submit_time, mine.admit_time) == (ref.submit_time,
                                                       ref.admit_time)
    fresh = Request(uid=2, prompt=np.arange(2), new_tokens=1)
    assert fresh.clock_export(now=5.0) == {"elapsed": 0.0,
                                           "admit_elapsed": None}


def test_spill_matches_the_reference():
    """An alloc / register / spill / re-hit script: the same ids, free and
    cached-free lists and counters as the reference's ``BlockManager``;
    spilled prompt blocks stay hittable."""
    rng = np.random.default_rng(4)
    a, b = BlockManager(24, 4), JaxBlocks(24, 4)
    prompts = [rng.integers(0, 60, size=int(rng.integers(9, 19)))
               for _ in range(4)]
    held = []
    for i, p in enumerate(prompts):
        nb_full = (len(p) - 1) // 4
        ha, ka = a.lookup_prefix(p, nb_full)
        hb, kb = b.lookup_prefix(p, nb_full)
        assert ha == hb and ka == kb
        own_a = ha + a.alloc(nb_full - len(ha) + 2)
        own_b = hb + b.alloc(nb_full - len(hb) + 2)
        assert own_a == own_b
        for j in range(len(ha), nb_full):
            a.register(own_a[j], ka[j])
            b.register(own_b[j], kb[j])
        held.append(own_a)
        if i % 2:
            victim = held.pop(0)
            assert a.spill(victim) == b.spill(victim) == len(victim)
        assert a.free == b.free and list(a.cached_free) == list(
            b.cached_free)
    # a spilled prompt's blocks are hit again
    hit_a, _ = a.lookup_prefix(prompts[0], (len(prompts[0]) - 1) // 4)
    hit_b, _ = b.lookup_prefix(prompts[0], (len(prompts[0]) - 1) // 4)
    assert hit_a == hit_b and len(hit_a) > 0
    mine, ref = a.stats.export(), b.stats.export()
    assert mine["blocks_spilled"] == ref["blocks_spilled"] > 0
    assert mine.items() <= ref.items()


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

def test_preempting_run_matches_the_jax_engine():
    """Two priority-5 requests fill both slots; after the first sync a
    priority-0 request arrives and preempts one. Both engines step in
    lockstep on the same weights, the port fed JAX's noise: tables, the
    host lengths and the parked entries' ``nb_live`` after every step,
    then the done order, ``calls_used``, ``preemptions`` and the counters
    equal; tokens equal under the margin rule."""
    cfg = get_config("qwen3-1.7b", reduced=True)
    jcfg = jax_get_config("qwen3-1.7b", reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    key = jax.random.PRNGKey(EPS_SEED)
    jeps = jax.jit(jax_make_eps_fn(key, cfg.vocab))

    def eps_fn(seq_ids, positions):
        return torch.from_numpy(np.array(jeps(
            jnp.asarray(seq_ids.numpy(), jnp.int32),
            jnp.asarray(positions.numpy(), jnp.int32))))

    # one loop length and one prefill width (9-token prompts: one 8-wide
    # chunk) bound the reference's compiles
    kw = dict(batch=2, window_max=4, max_len=64, block_size=4,
              adaptive=False, rounds_per_sync=1)
    eng = ServingEngine(cfg, params, eps_fn=eps_fn, device=CPU,
                        host_cache_mb=0, **kw)
    jeng = JaxEngine(jcfg, jparams, eps_key=key, host_cache_mb=0,
                     adaptive_rounds=False, **kw)
    rng = np.random.default_rng(12)
    lows = [(0, rng.integers(0, cfg.vocab, 9), 30, 5),
            (1, rng.integers(0, cfg.vocab, 9), 24, 5)]
    high = (2, rng.integers(0, cfg.vocab, 9), 6, 0)
    for uid, p, n, pr in lows:
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n, priority=pr))
        jeng.submit(JaxRequest(uid=uid, prompt=p, new_tokens=n, priority=pr))
    steps = 0
    while True:
        more, jmore = eng.step(), jeng.step()
        steps += 1
        assert more == jmore
        np.testing.assert_array_equal(eng.tables, jeng.tables)
        np.testing.assert_array_equal(eng.n_host, jeng.n_host)
        assert {u: p.nb_live for u, p in eng.parked.items()} == {
            u: p.nb_live for u, p in jeng.parked.items()}
        if steps == 1:
            uid, p, n, pr = high
            eng.submit(Request(uid=uid, prompt=p, new_tokens=n, priority=pr))
            jeng.submit(JaxRequest(uid=uid, prompt=p, new_tokens=n,
                                   priority=pr))
        if not more:
            break
    assert [r.uid for r in eng.done] == [r.uid for r in jeng.done]
    assert eng.done[0].uid == 2                # the arrival finished first
    for r, jr in zip(eng.done, jeng.done):
        assert (r.calls_used, r.preemptions, r.prefix_hit_blocks) == (
            jr.calls_used, jr.preemptions, jr.prefix_hit_blocks)
        jeps_row = jax_make_eps_fn(key, jcfg.vocab)

        def margin_at(p, toks=jr.result, sid=jr.uid):
            logits, _, _ = JaxLM.apply(jparams, jcfg,
                                       jnp.asarray(toks[None, :p], jnp.int32))
            e = jeps_row(jnp.asarray([sid], jnp.int32),
                         jnp.asarray([[p]], jnp.int32))
            return top2_margin(np.asarray(logits[0, -1] + e[0, 0]))
        check_token_agreement(jr.result, r.result, margin_at, tol=1e-4,
                              start=len(jr.prompt))
    mine, ref = eng.export_metrics(), jeng.export_metrics()
    for k in ("preemptions", "resumes", "blocks_parked", "host_syncs",
              "rounds", "prefill_calls", "tokens_generated",
              "deadline_missed_in_queue", "prefix_hits", "blocks_spilled",
              "blocks_in_use"):
        assert mine[k] == ref[k], (k, mine[k], ref[k])
    assert mine["preemptions"] == 1 and mine["resumes"] == 1


# ---------------------------------------------------------------------------
# the engine against its own solo sampler and undisturbed runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forced_preempt_is_bit_exact_across_mixers(models, arch):
    """After the first sync the last running slot is preempted: its pool
    blocks (GQA, MLA latents) or Mamba rows are parked and restored, and
    every request equals the undisturbed engine's run, tokens and verify
    rounds, and its solo run bitwise; the rows end clean."""
    cfg, params = models(arch)

    def run(disturb):
        eng = ServingEngine(cfg, params, **KW)
        for r in _traffic(cfg):
            eng.submit(r)
        eng.step()
        if disturb:
            occ = [b for b in range(2) if eng.slots[b] is not None]
            victim = eng.preempt_slot(occ[-1])
            parked = eng.parked[victim.uid]
            assert parked.nb_live == eng.metrics.blocks_parked
            assert victim in eng.queue.requests()
        return {r.uid: r for r in eng.run()}, eng

    ref, _ = run(False)
    got, eng = run(True)
    assert eng.metrics.preemptions == 1 and eng.metrics.resumes == 1
    for uid, r in got.items():
        np.testing.assert_array_equal(r.result, ref[uid].result)
        assert r.calls_used == ref[uid].calls_used
    assert_solo(cfg, params, list(got.values()))
    assert eng.n.tolist() == [1, 1] and eng.seq_ids.tolist() == [0, 0]
    assert eng.pool.blocks_in_use() == 0 and not eng.parked


def test_preemption_keeps_the_round_count(models):
    """A priority arrival preempts the running request; resumed with its
    window, the request's tokens and its count of verify rounds equal an
    uninterrupted run's."""
    cfg, params = models("qwen3-1.7b")
    kw = {**KW, "batch": 1, "max_len": 96}
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, 5)
    eng = ServingEngine(cfg, params, **kw)
    lo = Request(uid=0, prompt=prompt, new_tokens=64, priority=5)
    hi = Request(uid=1, prompt=rng.integers(0, cfg.vocab, 3), new_tokens=6,
                 priority=0)
    eng.submit(lo)
    eng.step()
    eng.submit(hi)
    done = eng.run()
    assert [r.uid for r in done] == [1, 0]
    assert lo.preemptions == 1 and eng.metrics.blocks_parked >= 1
    ref = ServingEngine(cfg, params, **kw)
    lo2 = Request(uid=0, prompt=prompt, new_tokens=64, priority=5)
    ref.submit(lo2)
    ref.run()
    np.testing.assert_array_equal(lo.result, lo2.result)
    assert lo.calls_used == lo2.calls_used
    assert_solo(cfg, params, done, max_len=96)


def test_progress_floor_protects_running_slots(models):
    """With ``preempt_floor=0`` no running slot may be evicted: the
    arrival waits and the running request finishes first."""
    cfg, params = models("qwen3-1.7b")
    eng = ServingEngine(cfg, params, **{**KW, "batch": 1}, preempt_floor=0.0)
    rng = np.random.default_rng(2)
    eng.submit(Request(uid=0, prompt=rng.integers(0, cfg.vocab, 4),
                       new_tokens=24, priority=5))
    eng.step()
    eng.submit(Request(uid=1, prompt=rng.integers(0, cfg.vocab, 3),
                       new_tokens=4, priority=0))
    done = eng.run()
    assert eng.metrics.preemptions == 0 and [r.uid for r in done] == [0, 1]
    assert_solo(cfg, params, done)


def test_no_preempt_engine_waits(models):
    """``preempt=False``: the arrival waits, as under the floor."""
    cfg, params = models("qwen3-1.7b")
    eng = ServingEngine(cfg, params, **{**KW, "batch": 1}, preempt=False)
    rng = np.random.default_rng(2)
    eng.submit(Request(uid=0, prompt=rng.integers(0, cfg.vocab, 4),
                       new_tokens=24, priority=5))
    eng.step()
    eng.submit(Request(uid=1, prompt=rng.integers(0, cfg.vocab, 3),
                       new_tokens=4, priority=0))
    assert [r.uid for r in eng.run()] == [0, 1]
    assert eng.metrics.preemptions == 0


def test_parked_prefix_blocks_are_hit_on_resume(models):
    """A spill leaves the published prompt blocks cached-free: the resume
    hits them instead of uploading their parked copies."""
    cfg, params = models("qwen3-1.7b")
    eng = ServingEngine(cfg, params, **{**KW, "batch": 1, "max_len": 96})
    rng = np.random.default_rng(4)
    lo = Request(uid=0, prompt=rng.integers(0, cfg.vocab, 13), new_tokens=48,
                 priority=5)
    eng.submit(lo)
    eng.step()
    eng.submit(Request(uid=1, prompt=rng.integers(0, cfg.vocab, 3),
                       new_tokens=4, priority=0))
    done = eng.run()
    assert eng.metrics.preemptions == 1 and lo.prefix_hit_blocks >= 3
    assert eng.export_metrics()["blocks_spilled"] >= 3
    assert_solo(cfg, params, done, max_len=96)


def test_cancel_of_a_parked_request(models):
    """A parked request cancelled in the queue finishes as cancelled, its
    payload dropped; the others equal the run without the cancel."""
    cfg, params = models("qwen3-1.7b")

    def run(cancel):
        eng = ServingEngine(cfg, params, **KW)
        for r in _traffic(cfg):
            eng.submit(r)
        eng.step()
        victim = eng.preempt_slot(1)
        if cancel:
            parked = eng.parked[victim.uid]
            assert eng.cancel(victim.uid) and parked.private is None
            assert victim.uid not in eng.parked
        return {r.uid: r for r in eng.run()}, eng, victim.uid

    ref, _, _ = run(False)
    got, eng, uid = run(True)
    assert got[uid].error.code == "cancelled" and got[uid].result is None
    assert eng.metrics.requests_cancelled == 1 and eng.metrics.resumes == 0
    for u, r in got.items():
        if u != uid:
            np.testing.assert_array_equal(r.result, ref[u].result)
    assert eng.pool.blocks_in_use() == 0


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "jamba-1.5-large-398b"))
def test_legacy_dense_round_is_bit_exact(models, arch):
    """``paged_attention=False``: every round gathers the dense view,
    decodes and writes the window back through ``paged_write``; tokens
    equal the solo sampler's and the paged engine's bitwise, a forced
    preemption included."""
    cfg, params = models(arch)

    def run(paged_attention):
        eng = ServingEngine(cfg, params, **KW,
                            paged_attention=paged_attention)
        for r in _traffic(cfg):
            eng.submit(r)
        eng.step()
        eng.preempt_slot(0)
        return {r.uid: r for r in eng.run()}

    dense, paged = run(False), run(True)
    for uid, r in dense.items():
        np.testing.assert_array_equal(r.result, paged[uid].result)
    assert_solo(cfg, params, list(dense.values()))


def test_gather_and_scatter_paged_round_trip(models):
    """``scatter_paged`` writes a dense view's span back into the pools
    (rows with ``active`` false write nothing kept) and ``gather_paged``
    reads it again through the tables."""
    cfg, params = models("qwen3-1.7b")
    g = torch.Generator().manual_seed(0)
    paged = TransformerLM.init_paged_cache(cfg, 2, 9, 4, device=CPU)
    for leaf in TransformerLM.pool_leaves(cfg, paged):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    dense = TransformerLM.gather_paged(cfg, paged, tables, slice(0, 2))
    before = [t.clone() for t in TransformerLM.pool_leaves(cfg, paged)]
    for leaf in TransformerLM.pool_leaves(cfg, dense):
        leaf.add_(1.0)
    start = torch.tensor([3, 6])
    TransformerLM.scatter_paged(cfg, paged, dense, tables, slice(0, 2),
                                start, 5, torch.tensor([True, False]))
    view = TransformerLM.gather_paged(cfg, paged, tables, slice(0, 2))
    for new, old, d, v in zip(TransformerLM.pool_leaves(cfg, paged), before,
                              TransformerLM.pool_leaves(cfg, dense),
                              TransformerLM.pool_leaves(cfg, view)):
        want = old.clone()
        for p in range(3, 8):
            want[int(tables[0, p // 4]), p % 4] = d[0, p]
        # block 0 is the sink the inactive row's lanes land in
        assert torch.equal(new[1:], want[1:])
        assert torch.equal(v[0, 3:8], d[0, 3:8])


def test_deadline_expiries_in_the_queue_are_counted(models):
    """A queued request whose deadline passes before it runs is counted
    once, at the first poll after it expired."""
    cfg, params = models("qwen3-1.7b")
    eng = ServingEngine(cfg, params, **{**KW, "batch": 1})
    rng = np.random.default_rng(5)
    eng.submit(Request(uid=0, prompt=rng.integers(0, cfg.vocab, 4),
                       new_tokens=12))
    late = Request(uid=1, prompt=rng.integers(0, cfg.vocab, 3),
                   new_tokens=4, deadline=0.0)
    eng.submit(late)
    eng.step()
    eng.step()
    assert late.queue_deadline_missed
    eng.run()
    m = eng.export_metrics()
    assert m["deadline_missed_in_queue"] == 1 and m["deadline_miss_count"] == 1
