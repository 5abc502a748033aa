"""The port's contracts (``repro_torch.analysis``): one planted fault per
rule trips that rule and names the op (the reference's green fixtures of
``tests/analysis/test_contract_rules.py`` in torch); the real round,
staged round and prefill of reduced qwen3-1.7b and the round of reduced
rwkv6-7b pass their contracts, with tokens bitwise those of the same
traffic with the checks off; the census of reduced qwen's round gives the
reference's ``check_engine_round`` numbers (pool scatters, host callbacks,
collectives). None of the reference's red tests is an oracle here."""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis import check_engine_round as jax_check_engine_round
from repro.configs import get_config as jax_get_config
from repro.models.transformer import TransformerLM as JaxLM
from repro.serving import ServingEngine as JaxEngine
from repro_torch.analysis import (CONTRACTS, PREFILL_CONTRACT, Census,
                                  Contract,
                                  ContractViolationError,
                                  DonationAliasCovers, MaxLiveBytes,
                                  NoCollectives, NoF64Leaks, NoHostCallbacks,
                                  NoPoolRankedScatters, Program,
                                  RecompileHazard, check_engine_round,
                                  check_program, contracts_enabled,
                                  maybe_check, require, select_contract)
from repro_torch.analysis import contracts as contracts_mod
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.admission import Request
from repro_torch.serving.engine import ServingEngine

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's torch work on one thread, put back after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen3-1.7b", reduced=True)
    return cfg, TransformerLM.init(cfg, seed=0, device=CPU)


def _engine(cfg, params, **kw):
    base = dict(batch=2, window_max=4, max_len=32, block_size=4, eps_key=3,
                adaptive=False, device=CPU)
    base.update(kw)
    return ServingEngine(cfg, params, **base)


# ---- one planted fault per rule ---------------------------------------------

def test_host_callback_fixture_fails():
    def fn(x):
        return x * float(x.sum())              # a scalar read on the host
    rep = check_program(fn, (torch.ones(3),),
                        Contract("T", [NoHostCallbacks()]))
    assert not rep.ok
    (v,) = rep.violations
    assert v.rule == "NoHostCallbacks"
    assert "_local_scalar_dense" in v.evidence["op"]
    assert rep.metrics["host_callbacks"] == 1
    rep = check_program(lambda x: x.nonzero(), (torch.ones(3),),
                        Contract("T", [NoHostCallbacks()]))
    assert [v.site for v in rep.violations] == ["aten.nonzero.default"]


def test_pool_ranked_scatter_fixture_fails_with_rank_evidence():
    def fn(pool, i, val):
        return pool.index_put((i,), val)       # out of place: a new pool
    args = (torch.zeros(4, 2, 8), torch.tensor([1]), torch.ones(1, 2, 8))
    rep = check_program(fn, args,
                        Contract("T", [NoPoolRankedScatters(min_rank=3)]))
    assert not rep.ok
    (v,) = rep.violations
    assert v.rule == "NoPoolRankedScatters" and v.evidence["rank"] == 3
    assert "index_put" in v.evidence["op"]
    # the same program passes a rank-4 threshold: the rule is parameterized
    assert check_program(fn, args, Contract(
        "T", [NoPoolRankedScatters(min_rank=4)])).ok
    # the fused writeback's in-place write into the pool is no violation
    pool = torch.zeros(4, 2, 8)
    assert check_program(lambda i, val: pool.index_put_((i,), val),
                         args[1:], Contract("T", [NoPoolRankedScatters()]),
                         pool=[pool]).ok


def test_unaliased_donation_fixture_fails():
    rule = Contract("T", [DonationAliasCovers()])
    pool = torch.zeros(64, 64)
    x = torch.ones(1)
    # in place: the pool is updated where it lies, the rule passes
    assert check_program(lambda p, x: p.add_(x), (pool, x), rule,
                         pool=[pool]).ok
    # out of place: a second pool-sized tensor, with byte evidence
    rep = check_program(lambda p, x: p + x, (pool, x), rule, pool=[pool])
    assert not rep.ok
    (v,) = rep.violations
    assert v.rule == "DonationAliasCovers"
    assert v.evidence["moved_leaves"] == 0
    assert v.evidence["copy_bytes"] == v.evidence["pool_bytes"] == 64 * 64 * 4
    # the pool moved to new storage (an undonated program's fresh pool)
    rep = check_program(lambda p: p.set_(p.clone()), (pool,), rule,
                        pool=[pool])
    assert rep.violations[0].evidence["moved_leaves"] == 1


def test_f64_leak_fixture_fails():
    rep = check_program(lambda x: x.double() * 2.0, (torch.ones(3),),
                        Contract("T", [NoF64Leaks()]))
    assert not rep.ok
    assert all(v.rule == "NoF64Leaks" for v in rep.violations)
    assert any("float64" in v.evidence["op"] for v in rep.violations)


def test_max_live_bytes_budget():
    args = (torch.ones(64, 64),)
    assert check_program(lambda x: x @ x, args,
                         Contract("T", [MaxLiveBytes(1 << 30)])).ok
    rep = check_program(lambda x: x @ x, args,
                        Contract("T", [MaxLiveBytes(100)]))
    assert not rep.ok
    (v,) = rep.violations
    assert v.rule == "MaxLiveBytes" and v.evidence["live_bytes"] > 100


def test_recompile_hazard_trips_on_shape_churn():
    contract = Contract("T", [RecompileHazard(max_shapes=3)])
    label = "test-torch-recompile-hazard-fixture"
    reports = [check_program(lambda x: x * 2, (torch.ones(n),), contract,
                             label=label) for n in range(1, 6)]
    assert all(r.ok for r in reports[:3])      # within budget
    assert not reports[-1].ok                  # 5th distinct shape trips
    v = reports[-1].violations[0]
    assert v.rule == "RecompileHazard"
    assert v.evidence["distinct_shapes"] == 5


def test_require_raises_structured_error():
    rep = check_program(lambda x: x * float(x.sum()), (torch.ones(3),),
                        Contract("T", [NoHostCallbacks()]))
    with pytest.raises(ContractViolationError) as ei:
        require(rep)
    assert "NoHostCallbacks" in str(ei.value)
    assert ei.value.report is rep
    assert isinstance(ei.value, AssertionError)


def test_seeded_collective_fixture_fails_with_the_op(tmp_path):
    """An all-reduce on a one-rank gloo group (a file store, no socket to
    another host) trips NoCollectives and is counted under the
    reference's spelling."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        def fn(x):
            dist.all_reduce(x)
            return x
        rep = check_program(fn, (torch.arange(8.0),),
                            Contract("SEEDED", [NoCollectives()]))
    finally:
        dist.destroy_process_group()
    assert not rep.ok
    (v,) = rep.violations
    assert v.rule == "NoCollectives" and "allreduce" in v.site
    assert v.evidence["bytes"] == 8 * 4
    assert rep.metrics["collectives"]["all-reduce"] == 1


def test_program_without_a_call_rejects_rules():
    with pytest.raises(ValueError):
        _ = Program(label="no-call").census


def test_scatter_pool_shape_targeting_spares_non_pool_writes():
    def fn(pool, state, i, pv, sv):
        return pool.index_put((i,), pv), state.index_put((i,), sv)
    args = (torch.zeros(4, 2, 8), torch.zeros(4, 1, 16), torch.tensor([1]),
            torch.ones(1, 2, 8), torch.ones(1, 1, 16))
    rep = check_program(fn, args, Contract("T", [NoPoolRankedScatters()]))
    assert len(rep.violations) == 2      # rank proxy: both rank-3 writes
    rep = check_program(fn, args, Contract("T", [
        NoPoolRankedScatters(pool_shapes={(4, 2, 8)})]))
    assert len(rep.violations) == 1      # state write spared, pool caught
    assert rep.violations[0].evidence["shape"] == [4, 2, 8]
    assert check_program(fn, args, Contract("T", [
        NoPoolRankedScatters(pool_shapes=frozenset())])).ok


# ---- the named contracts and the engine seam ---------------------------------

def test_contract_registry_names():
    assert set(CONTRACTS) == {"ROUND_CONTRACT", "STAGED_ROUND_CONTRACT",
                              "PREFILL_CONTRACT", "MIGRATION_COPY_CONTRACT"}
    for c in CONTRACTS.values():
        assert "NoHostCallbacks" in c.rule_names()
        assert "NoF64Leaks" in c.rule_names()
    assert "NoCollectives" not in CONTRACTS["PREFILL_CONTRACT"].rule_names()
    assert (select_contract("round").rule_names()
            == CONTRACTS["ROUND_CONTRACT"].rule_names())
    nod = select_contract("staged_round", donate=False)
    assert "DonationAliasCovers" not in nod.rule_names()
    assert "NoCollectives" in nod.rule_names()
    mig = select_contract("migration_copy")
    assert mig.rule_names() == ["NoHostCallbacks", "NoF64Leaks",
                                "DonationAliasCovers", "RecompileHazard"]
    assert "DonationAliasCovers" not in select_contract(
        "migration_copy", donate=False).rule_names()
    rec = select_contract("round", pool_scatter_shapes={(2, 1, 256)})
    rule = [r for r in rec.rules if r.name == "NoPoolRankedScatters"][0]
    assert (2, 1, 256) in rule.pool_shapes and rule.min_rank == 3


def test_round_contract_passes_on_real_round(qwen):
    cfg, params = qwen
    rep = check_engine_round(_engine(cfg, params))
    assert rep.ok, rep
    assert rep.contract == "ROUND_CONTRACT"
    assert rep.metrics["n_args"] == 5
    assert rep.metrics["pool_scatters"] == 0
    assert rep.metrics["host_callbacks"] == 0
    assert all(c == 0 for c in rep.metrics["collectives"].values())
    assert rep.metrics["aten_ops"] > 0


def test_round_census_shows_the_per_round_window_cat(qwen):
    """The round loop's one small allocation a round, the next window's
    ``torch.cat``, is allowed and shows in the census: one per round."""
    cfg, params = qwen
    eng = _engine(cfg, params)
    _, fn, args = eng._round_program(2, 3)      # W = 2 below W_max = 4
    with Census(watch=eng._paged_leaves()["pool"]) as census:
        fn(*args)
    cats = [r for r in census.ops if r.name == "cat"
            and r.outputs[0].shape == tuple(eng.cand.shape)]
    assert len(cats) == 3
    assert census.op_counts()["cat"] >= 3


def test_staged_round_contract_passes_on_real_staged_round(qwen):
    cfg, params = qwen
    eng = _engine(cfg, params, staging_slots=2, adaptive_rounds=False,
                  rounds_per_sync=4)
    rep = check_engine_round(eng)
    assert rep.ok, rep
    assert rep.contract == "STAGED_ROUND_CONTRACT"
    assert rep.metrics["n_args"] == 8
    assert rep.metrics["pool_scatters"] == 0


def test_prefill_contract_passes_on_real_prefill(qwen):
    cfg, params = qwen
    eng = _engine(cfg, params)
    eng._ensure_capacity(0, 8)
    table_row = torch.from_numpy(eng.tables[0:1].copy())
    args = (table_row, torch.zeros((1, 4), dtype=torch.int64),
            torch.tensor([0], dtype=torch.int32))
    rep = check_program(functools.partial(eng._prefill_chunk, b=0), args,
                        PREFILL_CONTRACT, label="prefill-ut",
                        **eng._paged_leaves())
    assert rep.ok, rep
    assert rep.metrics["host_callbacks"] == 0


def test_round_contract_passes_on_recurrent_arch():
    """rwkv6-7b has no KV pool: pool-shape targeting has nothing to aim at,
    and its per-slot state rows, written in place, keep their storage."""
    cfg = get_config("rwkv6-7b", reduced=True)
    eng = _engine(cfg, TransformerLM.init(cfg, seed=0, device=CPU))
    assert eng._contract_exemptions()["pool_scatter_shapes"] == frozenset()
    rep = check_engine_round(eng)
    assert rep.ok, rep


def test_undonated_engine_copies_its_cache_and_skips_the_rule(qwen):
    cfg, params = qwen
    eng = _engine(cfg, params, donate=False)
    rep = check_engine_round(eng)
    assert rep.ok, rep                  # no false DonationAliasCovers hit
    # the copy is real: held to the donated contract, the cache moved
    kind, fn, args = eng._round_program(eng.controller.window, 1)
    rep = check_program(functools.partial(eng._undonated, fn), args,
                        CONTRACTS["ROUND_CONTRACT"], label="undonated-ut",
                        **eng._paged_leaves())
    (v,) = [v for v in rep.violations if v.rule == "DonationAliasCovers"]
    n_leaves = sum(len(x) for x in eng._paged_leaves().values())
    assert v.evidence["moved_leaves"] == n_leaves


def test_maybe_check_env_gate_and_dedup(qwen, monkeypatch):
    cfg, params = qwen
    eng = _engine(cfg, params)
    kind, fn, args = eng._round_program(eng.controller.window, 2)
    kw = dict(eng._paged_leaves(), **eng._contract_exemptions())
    monkeypatch.setenv("REPRO_CHECK_CONTRACTS", "0")
    assert not contracts_enabled()
    before = len(contracts_mod._CHECKED)
    maybe_check("round", fn, args, **kw)               # gated off: no-op
    assert len(contracts_mod._CHECKED) == before
    monkeypatch.setenv("REPRO_CHECK_CONTRACTS", "1")
    maybe_check("round", fn, args, label="seam-ut", **kw)   # checks
    assert len(contracts_mod._CHECKED) == before + 1
    maybe_check("round", fn, args, label="seam-ut", **kw)   # dedup
    assert len(contracts_mod._CHECKED) == before + 1
    # without the pool named, its in-place writes are scatters like any
    with pytest.raises(ContractViolationError, match="NoPoolRankedScatters"):
        maybe_check("round", fn, args, label="seam-ut-nopool")


def _serve(cfg, params, **kw):
    eng = _engine(cfg, params, max_len=48, **kw)
    rng = np.random.default_rng(7)
    for i in range(4):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab,
                                                      int(rng.integers(2, 9))),
                           new_tokens=int(rng.integers(4, 12))))
    done = {r.uid: r.result for r in eng.run()}
    assert len(done) == 4 and all(v is not None for v in done.values())
    return done, eng


@pytest.mark.parametrize("arch,staging", [("qwen3-1.7b", 0),
                                          ("qwen3-1.7b", 2),
                                          ("rwkv6-7b", 0)])
def test_engine_serves_with_contracts_on_bitwise(arch, staging, monkeypatch):
    """With ``REPRO_CHECK_CONTRACTS=1`` every program an engine dispatches
    is checked at its first dispatch (round or staged round, each prefill
    width) and passes; the tokens equal the same traffic's with the checks
    off, bit for bit."""
    cfg = get_config(arch, reduced=True)
    params = TransformerLM.init(cfg, seed=0, device=CPU)
    monkeypatch.setenv("REPRO_CHECK_CONTRACTS", "0")
    off, _ = _serve(cfg, params, staging_slots=staging)
    monkeypatch.setenv("REPRO_CHECK_CONTRACTS", "1")
    before = set(contracts_mod._CHECKED)
    on, eng = _serve(cfg, params, staging_slots=staging)
    for uid in off:
        np.testing.assert_array_equal(on[uid], off[uid])
    mine = {k[1] for k in contracts_mod._CHECKED - before
            if k[0].endswith(f"@{hex(id(eng))}:0")}
    assert mine == {"staged_round" if staging else "round", "prefill"}


def test_census_equals_the_reference_check_engine_round(qwen):
    """The reference's ``check_engine_round`` on its reduced qwen engine
    and the port's on the same configuration give the same pool scatters,
    host callbacks and collectives (zero, zero, none)."""
    cfg, params = qwen
    jcfg = jax_get_config("qwen3-1.7b", reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    jeng = JaxEngine(jcfg, jparams, batch=2, window_max=4, max_len=32,
                     block_size=4, eps_key=jax.random.PRNGKey(3),
                     adaptive=False)
    want = jax_check_engine_round(jeng)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    got = check_engine_round(_engine(cfg, params))
    assert want.ok and got.ok, (want, got)
    for key in ("pool_scatters", "host_callbacks", "collectives"):
        assert got.metrics[key] == want.metrics[key], key
