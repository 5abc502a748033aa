"""Staged adoption inside the round loop in the port's serving engine, on
the CPU, at reduced widths in float32: the port's counterparts of the
passing tests of ``tests/serving/test_staging.py`` (migration needs the
mesh, a later slice), and the host-side pieces against the reference's.

Against JAX, bitwise: ``pack_staged_descriptors``, a ``StagingLedger``
claim and release sequence, and ``RoundsPerSyncController``'s k history
over a scripted feed; one staged run of both engines in lockstep, the port
fed JAX's noise: tables and host lengths after every step, the done order,
``calls_used`` and the scheduler's counters equal as integers, tokens under
the margin rule (tolerance 1e-4, as the serving parity test). Against the
port's own solo sampler and unstaged engine, bitwise: adopted rows on
reduced qwen3-1.7b, deepseek-v3-671b cut to two MLA layers and
jamba-1.5-large-398b cut to four layers (Mamba rows zeroed at adoption),
fewer host syncs than the unstaged engine, a priority arrival that
unstages, the cancel of a queued, parked, staged and running request, an
adaptive k, rows left clean, the legacy dense round, the seed facade
``ContinuousBatcher`` and the CLI with ``--staging-slots``."""
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
from repro.serving.adaptive import RoundsPerSyncController as JaxRounds
from repro.serving.admission import StagedEntry as JaxStagedEntry
from repro.serving.admission import \
    pack_staged_descriptors as jax_pack_staged_descriptors
from repro.serving.blocks import StagingLedger as JaxLedger
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.scheduler import ContinuousBatcher
from repro_torch.engine.spec_decode import PredictiveSampler
from repro_torch.launch import serve as serve_cli
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.adaptive import RoundsPerSyncController
from repro_torch.serving.admission import (Request, StagedEntry,
                                           pack_staged_descriptors)
from repro_torch.serving.blocks import StagingLedger
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
ARCHS = ("qwen3-1.7b", "deepseek-v3-671b", "jamba-1.5-large-398b")
KW = dict(batch=2, window_max=4, max_len=48, eps_key=EPS_SEED, block_size=4,
          adaptive=False, rounds_per_sync=8, device=CPU)


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


def solo(cfg, params, req):
    s = PredictiveSampler(cfg, params, window=4, max_len=48,
                          eps_key=EPS_SEED, device=CPU)
    t, _ = s.generate(torch.as_tensor(np.asarray(req.prompt))[None],
                      req.new_tokens, seq_ids=torch.tensor([req.seq_id]))
    return t[0, :len(req.prompt) + req.new_tokens].numpy()


def assert_solo(cfg, params, done):
    assert done, "no request finished"
    for r in done:
        assert r.ok, (r.uid, r.error)
        np.testing.assert_array_equal(
            r.result, solo(cfg, params, r),
            err_msg=f"request {r.uid} differs from its solo run")


def _traffic(cfg, seed=3, n=8):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab,
                                               size=int(rng.integers(2, 7))),
                    new_tokens=int(rng.integers(8, 13)))
            for i in range(n)]


def _drain(eng, reqs):
    for r in reqs:
        assert eng.submit(r)
    return {r.uid: r for r in eng.run()}


def _staged_uids(eng):
    return [e.req.uid for e in eng.staged]


def _assert_clean(eng):
    """Nothing left staged, claimed or held beyond the prefix cache's
    blocks, and every row the inactive lane."""
    assert not eng.staged and eng.ledger.staged_count(0) == 0
    assert eng.ledger.staged_blocks(0) == 0
    assert all(s is None for s in eng.slots)
    assert eng.n.tolist() == [1] * eng.B and eng.seq_ids.tolist() == [0] * eng.B
    assert eng.plen.tolist() == [0] * eng.B and not eng.tables.any()
    assert eng.pool.blocks_in_use() == 0


# ---------------------------------------------------------------------------
# the host-side pieces against the reference's
# ---------------------------------------------------------------------------

def test_pack_staged_descriptors_matches_the_reference():
    """Two entries of one shard in an area of three: the eight arrays
    equal the reference's, dtype and values."""
    rng = np.random.default_rng(0)
    nb, max_len = 6, 20
    mine, ref = [], []
    for i, L in enumerate((5, 11)):
        prompt = rng.integers(0, 90, L).astype(np.int32)
        table = np.zeros(nb, np.int32)
        table[:3 + i] = rng.integers(1, 30, 3 + i)
        fields = dict(shard=0, prompt=prompt, n0=1 + 4 * i, plen=L,
                      target=L + 7, blocks=list(table[:3 + i]),
                      table_row=table, poison=i, key=(0, float("inf"), i))
        mine.append(StagedEntry(req=Request(uid=i, prompt=prompt,
                                            new_tokens=7,
                                            noise_seed=40 + i), **fields))
        ref.append(JaxStagedEntry(req=JaxRequest(uid=i, prompt=prompt,
                                                 new_tokens=7,
                                                 noise_seed=40 + i),
                                  **fields))
    got = pack_staged_descriptors([mine], 3, nb, max_len)
    want = jax_pack_staged_descriptors([ref], 3, nb, max_len)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0].tolist() == [1, 1, 0] and got[5].tolist() == [40, 41, 0]


def test_staging_ledger_matches_the_reference():
    """A scripted claim / refuse / release sequence: every answer and
    count equals the reference ledger's."""
    mine, ref = StagingLedger(2), JaxLedger(2)
    script = [("claim", 0, 1, 5, 9), ("claim", 0, 2, 5, 4),
              ("claim", 0, 3, 3, 4), ("claim", 0, 4, 1, 9),
              ("release", 0, 1), ("claim", 0, 4, 2, 9),
              ("claim", 1, 7, 6, 6), ("release", 0, 3), ("release", 1, 7)]
    for op in script:
        if op[0] == "claim":
            got = mine.try_claim(*op[1:])
            assert got == ref.try_claim(*op[1:]), op
        else:
            assert mine.release(*op[1:]) == ref.release(*op[1:]), op
        for s in (0, 1):
            assert mine.staged_count(s) == ref.staged_count(s)
            assert mine.staged_blocks(s) == ref.staged_blocks(s)
        assert all(mine.has(s, u) == ref.has(s, u)
                   for s in (0, 1) for u in range(8))


def test_rounds_controller_matches_the_reference():
    """k over 60 scripted syncs — full loops with no idle (k grows),
    loops with idle tails (k shrinks), short loops, an empty backlog, then
    a random feed — equals the reference controller's, history
    included."""
    rng = np.random.default_rng(2)
    for k_max in (8, 6):
        mine, ref = RoundsPerSyncController(k_max=k_max), JaxRounds(
            k_max=k_max)
        for i in range(60):
            k = mine.k
            if i < 14:
                rounds, idle, backlog = k, 0, 3
            elif i < 22:
                rounds, idle, backlog = k, k, 2
            elif i < 26:
                rounds, idle, backlog = k, 0, 0
            else:
                rounds = int(rng.integers(0, k + 1))
                idle = int(rng.integers(0, 2 * rounds + 1))
                backlog = int(rng.integers(0, 3))
            assert mine.observe(rounds, idle, 2, backlog) == ref.observe(
                rounds, idle, 2, backlog)
            assert mine.ewma_idle == ref.ewma_idle
        assert list(mine.history) == list(ref.history)
        hist = list(mine.history)
        assert max(hist) == k_max and min(hist[14:]) < k_max


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

def test_staged_run_matches_the_jax_engine():
    """Seven requests through two slots and two staging slots, k = 8, both
    engines in lockstep on the same weights, the port fed JAX's noise:
    tables and host lengths after every step, the done order,
    ``calls_used``, ``prefix_hit_blocks`` and the counters (adoptions,
    staged requests, idle row-rounds, host syncs) equal; tokens equal under
    the margin rule."""
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

    kw = dict(batch=2, window_max=4, max_len=48, block_size=4,
              adaptive=False, rounds_per_sync=8, staging_slots=2)
    eng = ServingEngine(cfg, params, eps_fn=eps_fn, device=CPU,
                        adaptive_rounds=False, host_cache_mb=0, **kw)
    jeng = JaxEngine(jcfg, jparams, eps_key=key, host_cache_mb=0,
                     adaptive_rounds=False, **kw)
    for r in _traffic(cfg, n=7):
        eng.submit(r)
        jeng.submit(JaxRequest(uid=r.uid, prompt=r.prompt,
                               new_tokens=r.new_tokens))
    while True:
        more, jmore = eng.step(), jeng.step()
        assert more == jmore
        np.testing.assert_array_equal(eng.tables, jeng.tables)
        np.testing.assert_array_equal(eng.n_host, jeng.n_host)
        assert _staged_uids(eng) == [e.req.uid for e in jeng.staged[0]]
        if not more:
            break
    assert [r.uid for r in eng.done] == [r.uid for r in jeng.done]
    jeps_row = jax_make_eps_fn(key, jcfg.vocab)
    for r, jr in zip(eng.done, jeng.done):
        assert (r.calls_used, r.prefix_hit_blocks) == (jr.calls_used,
                                                       jr.prefix_hit_blocks)

        def margin_at(p, toks=jr.result, sid=jr.uid):
            logits, _, _ = JaxLM.apply(jparams, jcfg,
                                       jnp.asarray(toks[None, :p], jnp.int32))
            e = jeps_row(jnp.asarray([sid], jnp.int32),
                         jnp.asarray([[p]], jnp.int32))
            return top2_margin(np.asarray(logits[0, -1] + e[0, 0]))
        check_token_agreement(jr.result, r.result, margin_at, tol=1e-4,
                              start=len(jr.prompt))
    mine, ref = eng.export_metrics(), jeng.export_metrics()
    for k in ("in_loop_adoptions", "staged_sequences", "idle_row_rounds",
              "host_syncs", "rounds", "prefill_calls", "tokens_generated",
              "staging_occupancy", "occupancy_under_backlog",
              "rounds_per_sync_final", "blocks_allocated", "blocks_in_use"):
        assert mine[k] == ref[k], (k, mine[k], ref[k])
    assert mine["in_loop_adoptions"] > 0


# ---------------------------------------------------------------------------
# the engine against its own solo sampler and unstaged runs
# ---------------------------------------------------------------------------

def test_staged_adoption_is_exact_and_syncs_less(models):
    """A deep backlog through the unstaged and the staged engine: every
    request bitwise equal in both and to its solo run, the staged engine
    adopts in the loop and syncs fewer times, and it leaves nothing
    behind."""
    cfg, params = models("qwen3-1.7b")
    base = ServingEngine(cfg, params, **KW)
    ref = _drain(base, _traffic(cfg))
    eng = ServingEngine(cfg, params, staging_slots=2, adaptive_rounds=False,
                        **KW)
    got = _drain(eng, _traffic(cfg))
    assert set(got) == set(ref)
    for uid in ref:
        np.testing.assert_array_equal(got[uid].result, ref[uid].result)
    m = eng.export_metrics()
    assert m["staged_sequences"] > 0 and m["in_loop_adoptions"] > 0
    assert m["host_syncs"] < base.metrics.host_syncs
    assert 0 < m["staging_occupancy"] <= 1 and m["staged_requests"] == 0
    assert_solo(cfg, params, list(got.values()))
    _assert_clean(eng)


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_staged_adoption_is_exact_across_mixers(models, arch):
    """Adopted rows (forced-acceptance prefill through the latent pools,
    Mamba rows zeroed at adoption) equal the solo sampler bitwise."""
    cfg, params = models(arch)
    eng = ServingEngine(cfg, params, staging_slots=2, adaptive_rounds=False,
                        **KW)
    got = _drain(eng, _traffic(cfg, n=6))
    assert eng.metrics.in_loop_adoptions > 0
    assert_solo(cfg, params, list(got.values()))
    _assert_clean(eng)


def test_adaptive_rounds_keep_tokens(models):
    """The adaptive k (the default with staging) changes when the host
    syncs, never a token."""
    cfg, params = models("qwen3-1.7b")
    eng = ServingEngine(cfg, params, staging_slots=1, **KW)
    assert eng.adaptive_rounds
    got = _drain(eng, _traffic(cfg, seed=4, n=6))
    assert len(set(eng.rounds_ctrl.history)) > 1
    assert_solo(cfg, params, list(got.values()))
    _assert_clean(eng)


def test_priority_arrival_unstages(models):
    """A higher-priority arrival does not wait behind staged requests of
    lower priority: the area is unstaged and built again with it first."""
    cfg, params = models("qwen3-1.7b")
    kw = {**KW, "batch": 1, "rounds_per_sync": 1}
    eng = ServingEngine(cfg, params, staging_slots=2, adaptive_rounds=False,
                        preempt=False, **kw)
    rng = np.random.default_rng(5)
    eng.submit(Request(uid=0, prompt=rng.integers(0, cfg.vocab, 4),
                       new_tokens=24, priority=5))
    eng.step()
    for i in range(2):
        eng.submit(Request(uid=1 + i, prompt=rng.integers(0, cfg.vocab, 3),
                           new_tokens=6, priority=5))
    eng.step()
    assert _staged_uids(eng) == [1, 2]
    eng.submit(Request(uid=9, prompt=rng.integers(0, cfg.vocab, 3),
                       new_tokens=6, priority=0))
    eng.step()
    assert _staged_uids(eng)[0] == 9
    done = eng.run()
    order = [r.uid for r in done]
    assert order.index(9) < order.index(1) and order.index(9) < order.index(2)
    assert_solo(cfg, params, done)
    _assert_clean(eng)


def test_cancel_everywhere_leaves_survivors_exact(models):
    """In one staged engine: a request cancelled while queued, one while
    parked, one while staged (its blocks and claim back at once) and one
    while running; the survivors equal a run without the cancels
    bitwise."""
    cfg, params = models("qwen3-1.7b")
    kw = {**KW, "rounds_per_sync": 1}

    def traffic():
        rng = np.random.default_rng(11)
        return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 3 + i % 3),
                        new_tokens=10 + i, priority=5 if i < 2 else 6)
                for i in range(7)]

    def run(cancel):
        eng = ServingEngine(cfg, params, staging_slots=2,
                            adaptive_rounds=False, **kw)
        for r in traffic():
            eng.submit(r)
        eng.step()                       # 0, 1 running; 2, 3 staged
        assert _staged_uids(eng) == [2, 3]
        eng.preempt_slot(1)              # 1 parked: the area unstages
        if cancel:
            assert eng.cancel(1) and 1 not in eng.parked       # parked
            assert eng.cancel(6)                               # queued
        eng.step()                       # 1 resumed (2 admitted if 1 was
        #                                  cancelled), the next two staged
        assert _staged_uids(eng) == ([3, 4] if cancel else [2, 3])
        if cancel:
            free = eng.pool.available()
            assert eng.cancel(3) and _staged_uids(eng) == [4]  # staged
            assert eng.ledger.staged_count(0) == 1
            assert eng.pool.available() > free
            assert eng.cancel(0)                               # running
        return {r.uid: r for r in eng.run()}, eng

    ref, _ = run(False)
    got, eng = run(True)
    cancelled = {0, 1, 3, 6}
    assert {u for u, r in got.items() if r.error is not None} == cancelled
    assert all(got[u].error.code == "cancelled" for u in cancelled)
    assert eng.metrics.requests_cancelled == 4
    for u in set(ref) - cancelled:
        np.testing.assert_array_equal(got[u].result, ref[u].result)
    _assert_clean(eng)


def test_legacy_round_with_staging_is_exact(models):
    """``paged_attention=False`` under staged adoption: the dense round
    gathers through the adopted rows' tables; every request equals its
    solo run."""
    cfg, params = models("qwen3-1.7b")
    eng = ServingEngine(cfg, params, staging_slots=2, adaptive_rounds=False,
                        paged_attention=False, **KW)
    got = _drain(eng, _traffic(cfg, n=5))
    assert eng.metrics.in_loop_adoptions > 0
    assert_solo(cfg, params, list(got.values()))


def test_continuous_batcher_facade(models):
    """The seed's ``ContinuousBatcher(sampler, batch)``: the sampler's
    window and noise, a pinned window, ``state.rounds``, tokens equal to
    the sampler's own."""
    cfg, params = models("qwen3-1.7b")
    sampler = PredictiveSampler(cfg, params, window=4, max_len=48,
                                eps_key=EPS_SEED, device=CPU)
    cb = ContinuousBatcher(sampler, batch=2)
    assert cb.W_max == 4 and not cb.controller.enabled
    got = _drain(cb, _traffic(cfg, n=3))
    assert cb.state.rounds == cb.metrics.rounds > 0
    for r in got.values():
        np.testing.assert_array_equal(r.result, solo(cfg, params, r))


def test_serve_cli_with_staging(capsys):
    serve_cli.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                    "--requests", "5", "--new-tokens", "6", "--max-len",
                    "32", "--block-size", "8", "--staging-slots", "2",
                    "--rounds-per-sync", "8", "--no-adaptive-rounds",
                    "--lookahead", "4", "--preempt-floor", "0.5"])
    out = capsys.readouterr().out
    assert "served 5 requests / 30 tokens" in out
    assert '"in_loop_adoptions": ' in out and '"staged_sequences": ' in out
