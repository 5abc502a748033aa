"""Per-request fault isolation in the port's serving engine, on the CPU, on
reduced qwen3-1.7b in float32: the port's counterparts of the tests of
``tests/serving/test_faults.py`` that need no module the port lacks (the
host tier, staging, preemption, the journal), and ``verify_round``'s
``poison`` and ``prompt_len`` against the reference's.

The fault plan against the reference's: the same specs fire at the same
invocations. The engine under faults against itself and its solo sampler,
bitwise: the healthy requests of a faulted run equal the fault-free run's,
a retried request equals its never-faulted run (a capacity fault) or the
solo sampler on its fresh stream (a quarantine), and the fresh streams are
the reference's walk. ``verify_round`` on the same cache, candidates and
noise as JAX's (the port is fed JAX's eps, so the Gumbel maxima are taken
over the same noise): row stats, tokens, ``n`` and the next candidates
bitwise; the logits the round verifies within 1e-4 (float32 through two
layers, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.engine.spec_decode import PredictiveSampler as JaxSampler
from repro.engine.spec_decode import verify_round as jax_verify_round
from repro.models.transformer import TransformerLM as JaxLM
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.faults import CircuitBreaker as JaxBreaker
from repro.serving.faults import FaultPlan as JaxFaultPlan
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine.spec_decode import PredictiveSampler, verify_round
from repro_torch.launch import serve as serve_cli
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.admission import Request, RequestError
from repro_torch.serving.engine import ServingEngine, fresh_stream_id
from repro_torch.serving.faults import SEAMS, CircuitBreaker, FaultPlan
from repro_torch.serving.faults import RequestError as FaultsRequestError


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


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen3-1.7b", reduced=True)
    jcfg = jax_get_config("qwen3-1.7b", reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    return cfg, jcfg, jparams, params


def _solo(cfg, params, req, window=4, max_len=48):
    s = PredictiveSampler(cfg, params, window=window, max_len=max_len,
                          eps_key=EPS_SEED, device=CPU)
    t, _ = s.generate(torch.as_tensor(np.asarray(req.prompt))[None],
                      req.new_tokens, seq_ids=torch.tensor([req.seq_id]))
    return t[0, :len(req.prompt) + req.new_tokens].numpy()


def _traffic(cfg, n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        size=int(rng.integers(2, 7))),
                    new_tokens=int(rng.integers(8, 12)))
            for i in range(n)]


def _run(cfg, params, reqs=None, **kw):
    eng = ServingEngine(cfg, params, **{**KW, **kw})
    for r in reqs if reqs is not None else _traffic(cfg):
        assert eng.submit(r)
    return {r.uid: r for r in eng.run()}, eng


@pytest.fixture(scope="module")
def fault_free(qwen):
    cfg, _, _, params = qwen
    done, _ = _run(cfg, params, faults=FaultPlan())
    assert all(r.ok for r in done.values())
    return {uid: r.result for uid, r in done.items()}


# ---------------------------------------------------------------------------
# the harness (no engine)
# ---------------------------------------------------------------------------

SPECS = ("seed=7,alloc=@2;5,arena_corrupt=0.25,poison=3;9",
         "seed=8,arena_corrupt=0.25,stage_drop=0.5,alloc=0.1",
         "disk_full=@0;1;4,journal_truncate=0.75")


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_replays_as_the_reference_does(spec):
    """Parsed fields, and the invocations at which each seam fires over
    400 calls of every seam, equal the reference's plan of the same
    spec; and a second parse replays them."""
    plans = [FaultPlan.parse(spec) for _ in range(2)]
    ref = JaxFaultPlan.parse(spec)
    assert plans[0].schedule == ref.schedule and plans[0].rates == ref.rates
    assert plans[0].seed == ref.seed
    assert plans[0].poison_streams == ref.poison_streams
    fires = [[[p.fire(seam) for _ in range(400)] for seam in SEAMS]
             for p in plans + [ref]]
    assert fires[0] == fires[1] == fires[2]
    assert plans[0].fired == ref.fired and plans[0].calls == ref.calls
    assert plans[0].fired_export() == ref.fired_export()
    assert plans[0].total_fired == ref.total_fired > 0


def test_fault_plan_parse_edges():
    plan = FaultPlan.parse("seed=7,alloc=@2;5,poison=3;9")
    assert [plan.fire("alloc") for _ in range(8)] == [
        False, False, True, False, False, True, False, False]
    assert plan.fired == {"alloc": 2} and plan.calls["alloc"] == 8
    assert not any(plan.fire("stage_drop") for _ in range(50))
    assert FaultPlan.parse("") is None and FaultPlan.parse("  ") is None
    with pytest.raises(ValueError, match="unknown fault seam"):
        FaultPlan.parse("bogus_seam=@1")
    # RequestError lives in the faults module, re-exported by admission
    assert RequestError is FaultsRequestError
    err = RequestError("nonfinite", "x", retryable=True, attempts=2)
    assert str(err) == "nonfinite(x)" and str(RequestError("cancelled")) \
        == "cancelled"


def test_fault_plan_from_env(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    assert FaultPlan.from_env() is None
    monkeypatch.setenv("REPRO_FAULT_PLAN", "seed=3,stage_drop=0.5,poison=4")
    plan = FaultPlan.from_env()
    assert plan.rates["stage_drop"] == 0.5
    assert plan.poison_streams == frozenset({4})


def test_circuit_breaker_cycle_as_the_reference():
    """Consecutive failures trip it, the cooldown denies, the half-open
    probe re-opens on failure and closes on success; every step's state
    and counters equal the reference breaker's."""
    ops = ("f", "f", "s", "f", "f", "a", "f", "a", "a", "a", "a", "f",
           "a", "a", "a", "a", "s", "a")
    mine, ref = CircuitBreaker(threshold=3, cooldown=4), JaxBreaker(
        threshold=3, cooldown=4)
    for op in ops:
        for br in (mine, ref):
            if op == "f":
                br.record_failure()
            elif op == "s":
                br.record_success()
            else:
                br.allow()
        assert mine.stats_export() == ref.stats_export()
        assert mine.state == ref.state and mine.failures == ref.failures
    assert mine.stats_export() == {"tier_state": "closed", "tier_tripped": 2,
                                   "tier_denied_ops": 6}


def test_fresh_stream_ids_follow_the_reference_walk(qwen):
    """The streams a request is retried on after each quarantine equal
    those the reference engine's ``_fail_request`` gives, poisoned ones
    skipped."""
    _, jcfg, jparams, _ = qwen
    ref = JaxEngine(jcfg, jparams, batch=1, window_max=4, max_len=16,
                    block_size=4, request_retries=10,
                    faults=JaxFaultPlan(poison_streams=(1, 5, 7)))
    jreq = JaxRequest(uid=5, prompt=np.asarray([1, 2]), new_tokens=2)
    seq, mine = 5, []
    for _ in range(6):
        ref._fail_request(jreq, "nonfinite", retryable=True,
                          fresh_stream=True)
        seq = fresh_stream_id(seq, frozenset({1, 5, 7}))
        mine.append(seq)
        assert jreq.seq_id == seq
    assert len(set(mine)) == 6 and not set(mine) & {0, 1, 5, 7}


# ---------------------------------------------------------------------------
# the engine under faults
# ---------------------------------------------------------------------------

def test_injected_alloc_fault_fails_only_offending_request(qwen, fault_free):
    """The first block allocation fails (``alloc`` @0), in the first
    admission: with no retry budget that request ends with a retryable
    'admission' error; every other request equals the fault-free run and
    its solo run bitwise."""
    cfg, _, _, params = qwen
    got, eng = _run(cfg, params, faults=FaultPlan(schedule={"alloc": (0,)}))
    assert eng.faults.fired == {"alloc": 1}
    m = eng.export_metrics()
    assert m["faults_injected"] == 1 and m["faults_fired_alloc"] == 1
    failed = [r for r in got.values() if not r.ok]
    assert len(failed) == 1 and failed[0].result is None
    err = failed[0].error
    assert err.code == "admission" and err.retryable and err.attempts == 1
    assert "MemoryError" in err.detail
    assert m["requests_failed"] == 1 and m["retries"] == 0
    for uid, r in got.items():
        if r.ok:
            np.testing.assert_array_equal(r.result, fault_free[uid])
            np.testing.assert_array_equal(r.result, _solo(cfg, params, r))
    assert eng.pool.blocks_in_use() == 0


def test_retry_after_capacity_fault_is_bit_exact(qwen, fault_free):
    """Faults at the 1st and 4th allocations, a retry budget of 1: every
    request finishes, the retried ones bitwise equal to the fault-free
    run (a fresh admission replays the same stream)."""
    cfg, _, _, params = qwen
    reqs = _traffic(cfg)
    got, eng = _run(cfg, params, reqs, request_retries=1,
                    faults=FaultPlan(schedule={"alloc": (0, 3)}))
    assert all(r.ok for r in got.values()), [str(r.error) for r in
                                             got.values() if r.error]
    assert eng.metrics.retries == 2 == sum(r.retries for r in reqs)
    assert eng.export_metrics()["retries"] == 2
    for uid, r in got.items():
        np.testing.assert_array_equal(r.result, fault_free[uid])


def test_capacity_fault_while_a_table_grows_fails_only_that_slot(qwen,
                                                                  fault_free):
    """An allocation fault in the round loop's table growth (the seam's
    invocations past admission) fails that running slot, retryably; the
    retry and the other requests equal the fault-free run."""
    cfg, _, _, params = qwen
    # which allocations a fault-free run makes at admission and which as
    # a running slot's table grows: the fault goes to the first growth
    calls, stage = [], ["admit"]
    eng = ServingEngine(cfg, params, **KW)
    admit = eng._admit_pending

    def staged_admit():
        stage[0] = "admit"
        admit()
        stage[0] = "grow"
    eng._admit_pending = staged_admit
    eng.pool.set_fault_hook(lambda: calls.append(stage[0]) or False)
    for r in _traffic(cfg):
        eng.submit(r)
    eng.run()
    grow = calls.index("grow")
    got, eng = _run(cfg, params, request_retries=1,
                    faults=FaultPlan(schedule={"alloc": (grow,)}))
    assert eng.metrics.retries == 1 and all(r.ok for r in got.values())
    for uid, r in got.items():
        np.testing.assert_array_equal(r.result, fault_free[uid])


def test_poisoned_stream_is_quarantined_rest_of_batch_exact(qwen,
                                                            fault_free):
    cfg, _, _, params = qwen
    got, eng = _run(cfg, params, faults=FaultPlan(poison_streams=(2,)))
    bad = got[2]
    assert not bad.ok and bad.result is None
    assert bad.error.code == "nonfinite" and bad.error.retryable
    assert "health bits" in bad.error.detail
    assert eng.metrics.requests_failed == 1
    for uid in (0, 1, 3):
        np.testing.assert_array_equal(got[uid].result, fault_free[uid])
    assert eng.pool.blocks_in_use() == 0


def test_quarantine_retry_uses_a_fresh_noise_stream(qwen, fault_free):
    """With a retry budget the quarantined request runs again on a fresh
    stream and finishes, equal to a solo run on that stream; the others
    equal the fault-free run."""
    cfg, _, _, params = qwen
    reqs = _traffic(cfg)
    got, eng = _run(cfg, params, reqs, request_retries=1,
                    faults=FaultPlan(poison_streams=(2,)))
    assert all(r.ok for r in got.values())
    poisoned = got[2]
    assert poisoned.retries == 1
    assert poisoned.seq_id == fresh_stream_id(2, frozenset({2}))
    np.testing.assert_array_equal(poisoned.result,
                                  _solo(cfg, params, poisoned))
    for uid in (0, 1, 3):
        np.testing.assert_array_equal(got[uid].result, fault_free[uid])


def test_cancel_queued_and_running(qwen):
    cfg, _, _, params = qwen
    eng = ServingEngine(cfg, params, **{**KW, "batch": 1, "max_len": 96})
    rng = np.random.default_rng(6)
    running = Request(uid=0, prompt=rng.integers(0, cfg.vocab, 5),
                      new_tokens=40)
    queued = Request(uid=1, prompt=rng.integers(0, cfg.vocab, 4),
                     new_tokens=8)
    eng.submit(running)
    eng.submit(queued)
    eng.step()
    assert eng.slots[0] is running and len(eng.queue) == 1
    assert not eng.cancel(99)            # unknown uid
    assert eng.cancel(1)                 # queued, never admitted
    assert eng.cancel(0)                 # running: slot freed at once
    assert eng.slots[0] is None and not eng.cancel(0)
    done = {r.uid: r for r in eng.run()}
    assert set(done) == {0, 1}
    assert all(r.error.code == "cancelled" and r.result is None
               and not r.error.retryable for r in done.values())
    m = eng.export_metrics()
    assert m["requests_cancelled"] == 2 and m["blocks_in_use"] == 0


def test_cancelled_neighbor_leaves_survivors_exact(qwen, fault_free):
    cfg, _, _, params = qwen
    eng = ServingEngine(cfg, params, **KW)
    for r in _traffic(cfg):
        eng.submit(r)
    eng.step()
    assert eng.slots[0].uid == 0 and eng.cancel(0)   # batch-mate of uid 1
    got = {r.uid: r for r in eng.run()}
    assert got[0].error.code == "cancelled"
    for uid in (1, 2, 3):
        np.testing.assert_array_equal(got[uid].result, fault_free[uid])
    assert eng.n.tolist() == [1, 1] and eng.seq_ids.tolist() == [0, 0]


def test_round_budget_and_wall_time_abort_runaways(qwen):
    cfg, _, _, params = qwen
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, 4)
    eng = ServingEngine(cfg, params, **{**KW, "batch": 1, "max_len": 64},
                        max_request_rounds=1, request_retries=3)
    eng.submit(Request(uid=0, prompt=prompt, new_tokens=32))
    done = eng.run()
    assert done[0].error.code == "round_budget"
    assert not done[0].error.retryable and eng.metrics.retries == 0
    eng = ServingEngine(cfg, params, **{**KW, "batch": 1, "max_len": 64},
                        max_request_seconds=0.0)
    eng.submit(Request(uid=0, prompt=prompt, new_tokens=32))
    done = eng.run()
    assert done[0].error.code == "timeout"
    assert eng.export_metrics()["requests_failed"] == 1


def test_submit_validation_rejects_malformed_requests(qwen):
    cfg, _, _, params = qwen
    eng = ServingEngine(cfg, params, **{**KW, "max_len": 32})
    cases = [
        (Request(uid=0, prompt=np.zeros(0, np.int64), new_tokens=4),
         "empty_prompt"),
        (Request(uid=1, prompt=np.asarray([1, 2]), new_tokens=0),
         "bad_new_tokens"),
        (Request(uid=2, prompt=np.asarray([1, 2]), new_tokens=10_000),
         "too_long"),
        (Request(uid=3, prompt=np.asarray([1, cfg.vocab]), new_tokens=4),
         "token_out_of_range"),
        (Request(uid=4, prompt=np.asarray([-1, 2]), new_tokens=4),
         "token_out_of_range")]
    for req, code in cases:
        assert eng.submit(req) is False
        assert req.error.code == code and not req.ok, (req.uid, req.error)
    assert len(eng.queue) == 0
    assert {r.uid for r in eng.run()} == {0, 1, 2, 3, 4}
    assert eng.export_metrics()["requests_rejected"] == 5


def test_serve_cli_with_a_fault_plan(capsys):
    serve_cli.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                    "--requests", "3", "--new-tokens", "4", "--max-len",
                    "32", "--request-retries", "1", "--fault-plan",
                    "poison=1,alloc=@0"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out
    assert '"retries": 2' in out and '"faults_fired_alloc": 1' in out


# ---------------------------------------------------------------------------
# verify_round's poison and prompt_len against the reference's
# ---------------------------------------------------------------------------

def _states(qwen, L0, prompts, W, prompt_len):
    """The same state in both packages: each row's first ``L0`` prompt
    tokens prefilled into a dense cache, the whole prompt in ``tokens``,
    and a window whose slots on prompt positions hold the prompt."""
    cfg, jcfg, jparams, params = qwen
    B, max_len = prompts.shape[0], 48
    seq = np.arange(B) + 3
    js = JaxSampler(jcfg, jparams, window=W, max_len=max_len,
                    eps_key=jax.random.PRNGKey(EPS_SEED))
    ps = PredictiveSampler(cfg, params, window=W, max_len=max_len,
                           eps_key=EPS_SEED, device=CPU)
    jst = js.init_state(jnp.asarray(prompts[:, :L0], jnp.int32), B,
                        seq_ids=jnp.asarray(seq, jnp.int32))
    st = ps.init_state(torch.from_numpy(prompts[:, :L0]), B,
                       seq_ids=torch.from_numpy(seq))
    tokens = np.zeros((B, max_len), np.int64)
    cand = np.zeros((B, W), np.int64)
    for b in range(B):
        tokens[b, :prompt_len[b]] = prompts[b, :prompt_len[b]]
        for t in range(W):
            if L0 - 1 + t < prompt_len[b]:
                cand[b, t] = prompts[b, L0 - 1 + t]
    jst = jst._replace(tokens=jnp.asarray(tokens, jnp.int32),
                       cand=jnp.asarray(cand, jnp.int32))
    st = st._replace(tokens=torch.from_numpy(tokens),
                     cand=torch.from_numpy(cand))
    return js, st, jst


def _port_eps(js):
    """The port fed JAX's noise (the floats of two ``log``s otherwise part
    by an ulp; core/random.py)."""
    def eps_fn(seq_ids, positions):
        return torch.from_numpy(np.array(js.eps_fn(
            jnp.asarray(seq_ids.numpy(), jnp.int32),
            jnp.asarray(positions.numpy(), jnp.int32))))
    return eps_fn


def _same(st, jst, stats, jstats):
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))
    for name in ("tokens", "n", "cand", "rounds", "per_seq_calls",
                 "accept_hist"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)


def test_verify_round_poison_matches_reference(qwen):
    """Three rows, the middle one poisoned: row stats (its ``nonfinite``
    column 1, the others 0), tokens, ``n`` and candidates bitwise JAX's
    over two rounds; the cache stays finite, and the unpoisoned rows equal
    a round without ``poison`` bitwise."""
    cfg, jcfg, jparams, params = qwen
    W = 4
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 6))
    plen = np.full(3, 6)
    js, st, jst = _states(qwen, 6, prompts, W, plen)
    clean = st
    eps_fn = _port_eps(js)
    target = torch.full((3,), 20)
    poison = np.array([0, 1, 0])
    for _ in range(2):
        clean_next, clean_stats = verify_round(params, cfg, eps_fn, clean,
                                               target)
        st, stats = verify_round(params, cfg, eps_fn, st, target,
                                 poison=torch.from_numpy(poison))
        jst, jstats = jax_verify_round(jparams, jcfg, js.eps_fn, jst,
                                       jnp.full((3,), 20, jnp.int32),
                                       poison=jnp.asarray(poison, jnp.int32))
        _same(st, jst, stats, jstats)
        assert stats[:, 3].tolist() == [0, 1, 0]
        for name in ("tokens", "n", "cand"):
            a, b = getattr(st, name), getattr(clean_next, name)
            assert torch.equal(a[[0, 2]], b[[0, 2]]), name
        assert all(bool(torch.isfinite(c).all())
                   for layer in st.cache["layers"]
                   for c in layer["mixer"].values())
        clean = clean_next


@pytest.mark.parametrize("L0", [2, 5])
def test_verify_round_prompt_len_matches_reference(qwen, L0):
    """Rows with 9, 4 and ``L0`` prompt tokens of which ``L0`` are in the
    cache: window slots on prompt positions are accepted as the prompt's
    tokens, which the writes keep. Row stats, tokens, ``n``, candidates
    bitwise JAX's over three rounds, and the logits the first round
    verifies within 1e-4; a row with ``prompt_len <= n`` and a call with
    ``prompt_len=None`` are unaffected bitwise."""
    cfg, jcfg, jparams, params = qwen
    W = 4
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (3, 9))
    plen = np.array([9, 4, L0])
    js, st, jst = _states(qwen, L0, prompts, W, plen)
    eps_fn = _port_eps(js)
    logits, _, _ = TransformerLM.decode_window(
        params, cfg, st.cand, st.cache, st.n - 1)
    jlogits, _, _ = JaxLM.decode_window(jparams, jcfg, jst.cand, jst.cache,
                                        jst.n - 1)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    target = torch.full((3,), 20)
    plain = st
    for _ in range(3):
        plain_next, plain_stats = verify_round(params, cfg, eps_fn, plain,
                                               target)
        st, stats = verify_round(params, cfg, eps_fn, st, target,
                                 prompt_len=torch.from_numpy(plen))
        jst, jstats = jax_verify_round(jparams, jcfg, js.eps_fn, jst,
                                       jnp.full((3,), 20, jnp.int32),
                                       prompt_len=jnp.asarray(plen,
                                                              jnp.int32))
        _same(st, jst, stats, jstats)
        # the prompt is kept
        for b in range(3):
            np.testing.assert_array_equal(st.tokens[b, :plen[b]].numpy(),
                                          prompts[b, :plen[b]])
        # the row whose prompt is all in the cache is the plain round's
        assert torch.equal(stats[2], plain_stats[2])
        for name in ("tokens", "n", "cand"):
            assert torch.equal(getattr(st, name)[2],
                               getattr(plain_next, name)[2]), name
        plain = plain_next
    # forced acceptance: the 9-token prompt row went W tokens a round
    # while its window stayed on the prompt
    assert int(st.n[0]) >= min(9, L0 + 3 * (W - 1)) + 1
    # no prompt_len gives the plain round, bitwise
    again, again_stats = verify_round(params, cfg, eps_fn, plain, target,
                                      prompt_len=None)
    ref, ref_stats = verify_round(params, cfg, eps_fn, plain, target)
    assert torch.equal(again_stats, ref_stats)
    assert torch.equal(again.tokens, ref.tokens)
