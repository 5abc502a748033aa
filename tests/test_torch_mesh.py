"""The data-parallel mesh engine on the CPU, at reduced widths in float32:
the port's counterparts of the reference's ``tests/serving/
test_mesh_engine.py``, whose data=2 runs are red here, so the invariant
they state is held instead: a ``data = D`` engine at batch B (shards on
``("cpu", "cpu")`` and 4 x ``"cpu"``) emits tokens bitwise equal to the
port's single-device engine at batch B / D, whose calls carry the same rows
as each shard's, and to its solo sampler; against the single-device engine
at the same total batch B they agree under the margin rule (a CPU matmul's
rows may round otherwise when the call carries another number of rows).

On reduced qwen3-1.7b with the reference's traffic (6 requests, batch 4,
``window_max=4``, ``block_size=4``, ``max_len=48``, no adaptive W): data 2
and 4 at ``rounds_per_sync`` 4 and 1; routing over the shards; a forced
cross-shard migration and two preemptions; a rebalancing admission; staged
adoption at data 2; the scripted faults (``alloc@0``, ``arena_corrupt``, a
poisoned stream) with the healthy rows bitwise; every shard's round, prefill
and migration-copy dispatch checked against its contract (``conftest.py``
sets ``REPRO_CHECK_CONTRACTS=1``); a forced migration plus resume on the
gemma3-1b, DeepSeek-V3 (two MLA layers) and jamba (four layers) cuts.
Against JAX: one single-device JAX engine run in lockstep with the port's
single-device engine, a same-shard ``migrate_slot`` in both, tables and
allocator state bitwise, the mesh engine's tokens equal to JAX's under the
margin rule (tolerance 1e-4, as the serving parity test). The bound on how
far a CPU matmul's rows move with the row count is here too."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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
from repro_torch.analysis import check_engine_round
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler, make_eps_fn
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.admission import Request
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.topology import ServingTopology

ROOT = Path(__file__).resolve().parents[1]


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
KW = dict(batch=4, window_max=4, max_len=48, eps_key=EPS_SEED, block_size=4,
          adaptive=False)


def mesh(data):
    return ServingTopology(make_host_mesh(data, devices=("cpu",) * data))


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


def main_traffic(vocab, n=6, seed=3, new=(4, 9)):
    """The reference's MAIN_SCRIPT traffic."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, vocab,
                                               size=int(rng.integers(2, 9))),
                    new_tokens=int(rng.integers(*new))) for i in range(n)]


def sched_traffic(vocab, seed=7):
    """The reference's SCHED_SCRIPT traffic: three long requests, a slot
    left free."""
    return main_traffic(vocab, n=3, seed=seed, new=(17, 22))


def drain(eng, reqs, disturb=None):
    for r in reqs:
        assert eng.submit(r)
    if disturb is not None:
        eng.step()
        disturb(eng)
    done = {r.uid: r for r in eng.run()}
    assert all(r.ok for r in done.values()), [r.error for r in done.values()]
    return done


def solo(cfg, params, req):
    s = PredictiveSampler(cfg, params, window=4, max_len=48,
                          eps_key=EPS_SEED, device=CPU)
    t, _ = s.generate(torch.as_tensor(np.asarray(req.prompt))[None],
                      req.new_tokens, seq_ids=torch.tensor([req.seq_id]))
    return t[0, :len(req.prompt) + req.new_tokens].numpy()


def assert_same(got, ref):
    assert sorted(got) == sorted(ref)
    for uid, r in ref.items():
        np.testing.assert_array_equal(got[uid].result, r.result,
                                      err_msg=f"request {uid}")


def assert_margin_rule(cfg, params, got, ref, tol=1e-4):
    """``got``'s tokens against ``ref``'s: equal, or first apart where the
    port's full forward (plus the request's noise) has a top-2 margin below
    ``tol`` at ``ref``'s prefix."""
    assert sorted(got) == sorted(ref)
    eps = make_eps_fn(EPS_SEED, cfg.vocab, device=CPU)
    for uid, r in ref.items():
        def margin_at(p, toks=r.result, sid=r.seq_id):
            logits, _, _ = TransformerLM.apply(
                params, cfg, torch.as_tensor(toks[None, :p]))
            e = eps(torch.tensor([sid]), torch.tensor([[p]]))
            return top2_margin((logits[0, -1] + e[0, 0]).numpy())
        check_token_agreement(r.result, got[uid].result, margin_at, tol=tol,
                              start=len(r.prompt))


def per_call(data, **kw):
    """The single-device engine's arguments whose calls carry one shard's
    rows of a ``data``-shard engine built with ``kw``: batch B / data."""
    return dict(kw, batch=kw.get("batch", KW["batch"]) // data)


def cross_shard_move(eng):
    """Migrate the first running slot to a free slot of another shard."""
    B = eng.B
    for s in [b for b in range(B) if eng.slots[b] is not None]:
        for d in [b for b in range(B) if eng.slots[b] is None]:
            if eng.topo.shard_of_slot(s, B) != eng.topo.shard_of_slot(d, B):
                eng.migrate_slot(s, d)
                return s, d
    raise AssertionError("no cross-shard move possible")


def clean(eng):
    """Every row back to the no-op lane and every block free."""
    assert all(s is None for s in eng.slots) and not eng.parked
    assert eng.pool.blocks_in_use() == 0 and not eng.tables.any()
    n = torch.cat([sh.n for sh in eng.shards])
    assert n.tolist() == [1] * eng.B and not eng.seq_ids.any()


@pytest.fixture(scope="module")
def single(models):
    """The single-device engine's run of the main traffic at a batch, held
    against the solo sampler; one run for each batch."""
    cfg, params = models("qwen3-1.7b")
    runs = {}

    def at(batch):
        if batch not in runs:
            done = drain(ServingEngine(cfg, params, device=CPU,
                                       **dict(KW, batch=batch)),
                         main_traffic(cfg.vocab))
            for r in done.values():
                np.testing.assert_array_equal(r.result, solo(cfg, params, r))
            runs[batch] = done
        return runs[batch]
    return at


# ---------------------------------------------------------------------------
# tokens across shard counts and drive modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,rps", [(2, 4), (2, 1), (4, 4), (4, 1)])
def test_mesh_tokens_equal_the_single_device_engine(models, single, data,
                                                    rps):
    """data 2 and 4, device-resident (4 rounds a sync) and host-driven:
    tokens bitwise the single-device engine's at batch 4 / data (hence the
    solo sampler's), and the batch-4 engine's under the margin rule; the
    loop amortizes syncs; the rows end clean."""
    cfg, params = models("qwen3-1.7b")
    eng = ServingEngine(cfg, params, topology=mesh(data),
                        rounds_per_sync=rps, **KW)
    assert len(eng.shards) == data and eng.B_local == 4 // data
    got = drain(eng, main_traffic(cfg.vocab))
    assert_same(got, single(eng.B_local))
    assert_margin_rule(cfg, params, got, single(4))
    if rps == 4:
        assert eng.metrics.rounds > eng.metrics.host_syncs
    clean(eng)


def test_routing_spreads_over_shards_and_the_round_holds_its_contract(
        models):
    """With empty equal sub-pools the first admission ties to shard 0 and
    the second goes to shard 1; each shard's round is dispatched over its
    own rows only. A drained engine's round programs, every shard's,
    pass the round contract with no pool scatter."""
    cfg, params = models("qwen3-1.7b")
    eng = ServingEngine(cfg, params, topology=mesh(2), **KW)
    rng = np.random.default_rng(5)
    for i in range(2):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, 4),
                           new_tokens=40))
    eng.step()
    assert [b for b in range(4) if eng.slots[b] is not None] == [0, 2]
    assert eng.export_metrics()["blocks_available_by_shard"][0] == \
        eng.export_metrics()["blocks_available_by_shard"][1]
    # each shard holds its own sub-cache (its blocks, its rows), and the
    # engine has no single cache or row state to read
    P = eng.pool.blocks_per_shard
    one = TransformerLM.pool_leaves(cfg, TransformerLM.init_paged_cache(
        cfg, eng.B_local, P, KW["block_size"], device="meta"))
    for sh in eng.shards:
        mine = TransformerLM.pool_leaves(cfg, sh.paged)
        assert [t.shape for t in mine] == [t.shape for t in one]
    for name in ("paged", "tokens", "n", "cand"):
        with pytest.raises(AttributeError, match=rf"shards\[s\]\.{name}"):
            getattr(eng, name)
    n = torch.cat([sh.n for sh in eng.shards])
    assert n.tolist() == [int(x) for x in eng.n_host]
    eng.run()
    clean(eng)
    rep = check_engine_round(eng)
    assert rep.ok, rep
    assert rep.metrics["pool_scatters"] == 0
    assert not any(rep.metrics["collectives"].values())


# ---------------------------------------------------------------------------
# migration, preemption and rebalancing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data", [2, 4])
def test_forced_migration_and_two_preemptions(models, data):
    """After the first sync a running sequence migrates to another shard
    (its blocks copied into the destination's sub-pool, its rows moved),
    then two running slots are preempted and resume (one on another
    shard): tokens bitwise the undisturbed single-device engine's at batch
    4 / data. Every shard's round and prefill, and the migration copy,
    passed their contracts."""
    cfg, params = models("qwen3-1.7b")
    ref = drain(ServingEngine(cfg, params, device=CPU, **per_call(data, **KW)),
                sched_traffic(cfg.vocab))

    def disturb(eng):
        cross_shard_move(eng)
        occ = [b for b in range(eng.B) if eng.slots[b] is not None]
        eng.preempt_slot(occ[0])
        eng.preempt_slot(occ[-1])
    eng = ServingEngine(cfg, params, topology=mesh(data), **KW)
    got = drain(eng, sched_traffic(cfg.vocab), disturb)
    assert_same(got, ref)
    m = eng.export_metrics()
    assert m["migrations"] >= 1 and m["blocks_migrated"] >= 1
    assert m["blocks_migrated_in"] == m["blocks_migrated_out"] == m[
        "blocks_migrated"]
    assert (m["preemptions"], m["resumes"]) == (2, 2)
    assert sum(r.migrations for r in got.values()) == m["migrations"]
    clean(eng)
    if os.environ.get("REPRO_CHECK_CONTRACTS") == "1":
        reps = eng.contract_reports
        assert reps and all(r.ok for r in reps), [str(r) for r in reps]
        kinds = {r.contract for r in reps}
        assert {"ROUND_CONTRACT", "PREFILL_CONTRACT",
                "MIGRATION_COPY_CONTRACT"} <= kinds
        shards = {r.label.rsplit(":", 1)[1] for r in reps
                  if r.contract == "ROUND_CONTRACT"}
        assert len(shards) >= 2, shards


def saturation_mesh(cfg, params, rebalance):
    """The reference's rebalancing scenario (``benchmarks/serving_bench.py:
    saturation_mesh``): per shard 16 usable blocks; a big request (12
    blocks) pins shard 0, two small ones (4 each) go to shard 1 by pool
    pressure, and a mid arrival (6) fits neither shard directly: with
    rebalancing a small resident migrates to shard 0 and the arrival is
    admitted in the same admission pass."""
    rng = np.random.default_rng(33)
    prompts = {0: rng.integers(0, cfg.vocab, 4), 1: rng.integers(0, cfg.vocab, 2),
               2: rng.integers(0, cfg.vocab, 2), 3: rng.integers(0, cfg.vocab, 4)}
    new = {0: 40, 1: 8, 2: 8, 3: 16}
    eng = ServingEngine(cfg, params, topology=mesh(2), rebalance=rebalance,
                        batch=4, window_max=4, max_len=48, block_size=4,
                        eps_key=3, adaptive=False, prefix_cache=False,
                        num_blocks=17)
    for uid in range(4):
        eng.submit(Request(uid=uid, prompt=prompts[uid], new_tokens=new[uid]))
    eng.step()
    admitted_now = len(eng.queue) == 0
    done = {r.uid: r for r in eng.run()}
    return done, admitted_now, eng


def test_rebalance_admits_in_the_same_pass(models):
    cfg, params = models("qwen3-1.7b")
    on, admitted_on, eng = saturation_mesh(cfg, params, True)
    off, admitted_off, _ = saturation_mesh(cfg, params, False)
    assert admitted_on and not admitted_off
    assert eng.metrics.migrations >= 1
    assert_same(on, off)
    clean(eng)


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b"])
def test_migration_and_resume_across_mixers(models, arch):
    """The reference's ARCH_SCRIPT: a forced cross-shard migration (GQA and
    local-window pools, MLA latents, Mamba rows beside an attention
    layer's blocks) and a preemption, on the device-resident loop at data
    2, against the host-driven single-device engine at batch 2: tokens
    bitwise."""
    cfg, params = models(arch)
    kw = dict(KW, max_len=32)

    def traffic():
        rng = np.random.default_rng(3)
        return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, L),
                        new_tokens=n)
                for i, (L, n) in enumerate(((3, 18), (6, 20), (4, 17)))]
    ref = drain(ServingEngine(cfg, params, device=CPU, rounds_per_sync=1,
                              **per_call(2, **kw)), traffic())

    def disturb(eng):
        cross_shard_move(eng)
        occ = [b for b in range(eng.B) if eng.slots[b] is not None]
        eng.preempt_slot(occ[-1])
    eng = ServingEngine(cfg, params, topology=mesh(2), rounds_per_sync=4,
                        **kw)
    got = drain(eng, traffic(), disturb)
    assert_same(got, ref)
    m = eng.metrics
    assert (m.migrations, m.preemptions, m.resumes) == (1, 1, 1)
    clean(eng)


# ---------------------------------------------------------------------------
# staged adoption, faults, the CLI
# ---------------------------------------------------------------------------

def test_staged_adoption_at_data2(models):
    """Ten requests through a data=2 engine with two staging slots a
    shard, against the single-device host-admission engine at batch 2:
    tokens bitwise, and rows adopted inside each shard's loop; every
    shard's staged round passed its contract."""
    cfg, params = models("qwen3-1.7b")
    kw = dict(KW, rounds_per_sync=8)
    traffic = main_traffic(cfg.vocab, n=10, new=(8, 13))
    ref = drain(ServingEngine(cfg, params, device=CPU, **per_call(2, **kw)),
                traffic)
    eng = ServingEngine(cfg, params, topology=mesh(2), staging_slots=2,
                        adaptive_rounds=False, **kw)
    got = drain(eng, main_traffic(cfg.vocab, n=10, new=(8, 13)))
    assert_same(got, ref)
    assert eng.metrics.in_loop_adoptions >= 1
    assert eng.metrics.staged_sequences >= 1
    assert not eng.staged and eng.ledger.staged_count(0) == 0
    clean(eng)
    if os.environ.get("REPRO_CHECK_CONTRACTS") == "1":
        staged = [r for r in eng.contract_reports
                  if r.contract == "STAGED_ROUND_CONTRACT"]
        assert {r.label.rsplit(":", 1)[1] for r in staged} == {"0", "1"}
        assert all(r.ok for r in eng.contract_reports)


def test_scripted_faults_keep_healthy_rows_exact(models):
    """The reference's FAULT_SCRIPT at data 2: the first block allocation
    fails (retried on the same stream), arena reads corrupt at a seeded
    rate (a parked request resumes cold), and request 2's stream is
    poisoned (quarantined, retried on a fresh stream): the healthy rows
    bitwise the fault-free single-device run at batch 2, the poisoned one
    its solo run on its new stream, nothing failed for good."""
    cfg, params = models("qwen3-1.7b")
    kw = dict(KW, host_cache_mb=8, request_retries=1)
    rng = np.random.default_rng(3)
    lens = [(int(rng.integers(3, 8)), int(rng.integers(8, 12)))
            for _ in range(4)]
    prompts = [np.random.default_rng(40 + i).integers(0, cfg.vocab, L)
               for i, (L, _) in enumerate(lens)]

    def traffic():
        return [Request(uid=i, prompt=p, new_tokens=n)
                for i, (p, (_, n)) in enumerate(zip(prompts, lens))]

    def park(eng):
        eng.preempt_slot(next(b for b in range(eng.B)
                              if eng.slots[b] is not None))
    ref = drain(ServingEngine(cfg, params, device=CPU, faults=FaultPlan(),
                              **per_call(2, **kw)), traffic(), park)
    plan = FaultPlan(schedule={"alloc": (0,)},
                     rates={"arena_corrupt": 0.75}, poison_streams=(2,),
                     seed=13)
    eng = ServingEngine(cfg, params, topology=mesh(2), faults=plan, **kw)
    got = drain(eng, traffic(), park)
    for u in (0, 1, 3):
        np.testing.assert_array_equal(got[u].result, ref[u].result)
    assert got[2].seq_id not in plan.poison_streams
    np.testing.assert_array_equal(got[2].result, solo(cfg, params, got[2]))
    m = eng.export_metrics()
    assert m["requests_failed"] == 0 and m["retries"] >= 2
    assert m["faults_injected"] >= 2 and m["checksum_failures"] >= 1
    clean(eng)


def test_serve_cli_on_a_cpu_mesh(capsys, tmp_path):
    serve_cli.main(["--arch", "qwen3-1.7b", "--reduced", "--mesh", "2",
                    "--mesh-devices", "cpu,cpu", "--device", "cpu",
                    "--batch", "4",
                    "--requests", "5", "--new-tokens", "6", "--max-len",
                    "48", "--block-size", "4", "--no-host-cache"])
    out = capsys.readouterr().out
    assert "served 5 requests / 30 tokens" in out
    assert "2 shards on cpu, cpu" in out
    if torch.cuda.device_count() < 2:
        with pytest.raises(SystemExit, match="CUDA devices"):
            serve_cli.main(["--arch", "qwen3-1.7b", "--reduced", "--mesh",
                            "2", "--batch", "4"])
    # a model axis serves durably too: two model ranks, each with two data
    # shards, rank 0 owning the journal and the checkpoint
    ddir = tmp_path / "durable"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-1.7b", "--reduced", "--device", "cpu", "--mesh", "2,2",
         "--mesh-devices", "cpu,cpu", "--batch", "4", "--requests", "4",
         "--new-tokens", "6", "--durable-dir", str(ddir)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 4 requests / 24 tokens" in out.stdout
    assert "2 model ranks (gloo)" in out.stdout
    assert {"journal.wal", "checkpoint.json", "disk", "rank1"} <= set(
        os.listdir(ddir))


# ---------------------------------------------------------------------------
# against JAX, and the rounding fact behind the same-shape rule
# ---------------------------------------------------------------------------

def test_same_shard_migration_and_mesh_tokens_match_jax():
    """The port's and JAX's single-device engines in lockstep on the main
    traffic at one round a sync, the port fed JAX's noise; once the queue
    is empty and a slot is free, a running sequence moves to it (one shard: the blocks stay)
    in both. Tables, host lengths and the allocator's state bitwise after
    every step; then the port's data=2 engine on the same traffic: tokens
    bitwise the port's single-device engine's at batch 2 and, under the
    margin rule, JAX's (one JAX engine run in this file)."""
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

    # host-driven rounds: a sync each round, so a slot frees while others
    # still run
    kw = dict(KW, host_cache_mb=0, rounds_per_sync=1)
    del kw["eps_key"]
    eng = ServingEngine(cfg, params, eps_fn=eps_fn, device=CPU, **kw)
    jeng = JaxEngine(jcfg, jparams, eps_key=key, adaptive_rounds=False, **kw)
    for r in main_traffic(cfg.vocab):
        eng.submit(r)
        jeng.submit(JaxRequest(uid=r.uid, prompt=r.prompt,
                               new_tokens=r.new_tokens))
    moved = None
    while True:
        more, jmore = eng.step(), jeng.step()
        assert more == jmore
        if moved is None and not eng.queue:
            occ = [b for b in range(4) if eng.slots[b] is not None]
            free = [b for b in range(4) if eng.slots[b] is None]
            if occ and free:
                moved = (occ[0], free[-1])
                eng.migrate_slot(*moved)
                jeng.migrate_slot(*moved)
        np.testing.assert_array_equal(eng.tables, jeng.tables)
        np.testing.assert_array_equal(eng.n_host, jeng.n_host)
        assert eng.owned == jeng.owned
        mine, ref = eng.pool.manager(0), jeng.pool.manager(0)
        assert mine.free == ref.free
        assert list(mine.cached_free) == list(ref.cached_free)
        np.testing.assert_array_equal(mine.refcount, ref.refcount)
        assert mine.block_of == ref.block_of
        if not more:
            break
    assert moved is not None
    mine, ref = eng.export_metrics(), jeng.export_metrics()
    for k in ("migrations", "blocks_migrated", "rounds", "host_syncs",
              "prefill_calls", "blocks_in_use", "blocks_migrated_in"):
        assert mine[k] == ref[k], (k, mine[k], ref[k])
    assert mine["migrations"] == 1
    mesh_eng = ServingEngine(cfg, params, eps_fn=eps_fn, topology=mesh(2),
                             **kw)
    got = drain(mesh_eng, main_traffic(cfg.vocab))
    assert_same(got, drain(ServingEngine(cfg, params, eps_fn=eps_fn,
                                         device=CPU, **per_call(2, **kw)),
                           main_traffic(cfg.vocab)))
    jeps_row = jax_make_eps_fn(key, jcfg.vocab)
    for jr in jeng.done:
        def margin_at(p, toks=jr.result, sid=jr.uid):
            logits, _, _ = JaxLM.apply(jparams, jcfg,
                                       jnp.asarray(toks[None, :p], jnp.int32))
            e = jeps_row(jnp.asarray([sid], jnp.int32),
                         jnp.asarray([[p]], jnp.int32))
            return top2_margin(np.asarray(logits[0, -1] + e[0, 0]))
        check_token_agreement(jr.result, got[jr.uid].result, margin_at,
                              tol=1e-4, start=len(jr.prompt))


def test_cpu_matmul_rows_depend_on_the_row_count(models):
    """Why a mesh is held bitwise only at equal rows per call: a verify
    window's logits for the same rows may differ at the rounding level when
    the call carries another number of rows (16 rows against 8; whether
    they do depends on the BLAS build and its threads, ROADMAP §3), but by
    no more than 1e-5, and they agree bitwise at equal counts."""
    cfg, params = models("qwen3-1.7b")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 4)))

    def logits(rows):
        n = rows.shape[0]
        out, _, _ = TransformerLM.decode_window(
            params, cfg, rows, TransformerLM.init_cache(cfg, n, 48),
            torch.zeros(n, dtype=torch.int64))
        return out
    full, halves = logits(toks), torch.cat([logits(toks[:2]),
                                            logits(toks[2:])])
    assert (full - halves).abs().max() < 1e-5
    assert torch.equal(logits(toks[:2]), logits(toks[:2].clone()))
