"""Crash and restore of the port's serving engine on the CPU.

The kill-point matrix of the reference's ``tests/serving/test_recovery.py``
through the port: a child engine (``torch_recovery_driver.py``'s workload
and settings, a process forked by ``torch_tp_driver.py durable``) is
SIGKILLed at a named site, a second child restores from the same durable
directory and drains the work; every request whose submit returned before
the kill is delivered by the two, and every delivered token row equals the
port's solo ``PredictiveSampler`` bitwise. An uninterrupted durable run is
bitwise the volatile run, and its durability counters equal the JAX
engine's on the same workload and weights; a restart in process restores
what the JAX engine's restart restores, with equal counters. Reduced
rwkv6-7b restarted in process: its recurrent snapshots demoted to disk by
a tiny arena bring a new engine's admission back from disk. The serving
CLI's ``--durable-dir`` across a kill and a restart.

On the model axis (data 1 x model 2 over gloo, ``tests/torch_tp_driver.py
durable``, which also runs the model-1 kill matrix, every run a process
forked from the driver): a kill at each point of the matrix and a
restart deliver tokens bitwise across the ranks and equal to an
uninterrupted model-2 durable run, with the model-1 restart's counters; a
durable run at model 2 is bitwise the volatile one, and no rank but 0
writes the journal or the checkpoint; a deadline and
``max_request_seconds`` on a stepped clock, rank 1's skewed, take the
model-1 engine's decisions, and a planted fault (each rank deciding by its
own clock) raises ``RankDivergence``. Against model 1 the tokens hold
under the margin rule at 1e-4 (float32 logits, as in
``test_torch_tensor_parallel.py``)."""
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_pytree as jax_save_pytree
from repro.configs import get_config as jax_get_config
from repro.models.transformer import TransformerLM as JaxLM
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.checkpoint.io import load_pytree, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler, make_eps_fn
from repro_torch.launch import serve
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.admission import Request
from repro_torch.serving.engine import ServingEngine

sys.path.insert(0, os.path.dirname(__file__))
from torch_recovery_driver import (ENGINE_KW, EPS_SEED,  # noqa: E402
                                   METRIC_KEYS, make_requests)
from torch_tp_driver import MATRIX, PLANTED_BLOCK  # noqa: E402

TP_DRIVER = os.path.join(os.path.dirname(__file__), "torch_tp_driver.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# the margin rule's tolerance against model 1: float32 logits, row-parallel
# sums (test_torch_tensor_parallel.py's)
TP_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _child(args, kill: str = "", timeout: int = 600):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("REPRO_KILL_POINT", None)
    if kill:
        env["REPRO_KILL_POINT"] = kill
    proc = subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, timeout=timeout, cwd=ROOT)
    if kill:
        assert proc.returncode == -signal.SIGKILL, (
            f"kill point {kill!r} never fired (rc={proc.returncode}):\n"
            f"{proc.stderr[-2000:]}")
    else:
        assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``torch_tp_driver.py durable``: the kill matrix (the reference's
    points, each landing mid-run, after the first admission and before
    the queue drains) at model 1 and at data 1 x model 2, the
    uninterrupted runs and the clock runs at both; one driver process,
    each run forked from it."""
    out = _child([TP_DRIVER, "durable",
                  str(tmp_path_factory.mktemp("durable"))])
    return json.loads(out.strip().splitlines()[-1])


def _finishes(events) -> dict:
    return {e["uid"]: np.asarray(e["tokens"]) for e in events
            if e["event"] == "finish"}


def _solo(cfg, params, req, window=4, max_len=64):
    s = PredictiveSampler(cfg, params, window=window, max_len=max_len,
                          eps_key=EPS_SEED, device=CPU)
    t, _ = s.generate(torch.as_tensor(np.asarray(req.prompt))[None],
                      req.new_tokens, seq_ids=torch.tensor([req.seq_id]))
    return t[0, :len(req.prompt) + req.new_tokens].numpy()


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen3-1.7b", reduced=True)
    return cfg, TransformerLM.init(cfg, seed=0, device=CPU)


@pytest.fixture(scope="module")
def reference(qwen):
    """Each request's tokens from the port's solo sampler: the ground truth
    every delivered row is held to."""
    cfg, params = qwen
    return {r.uid: _solo(cfg, params, r, ENGINE_KW["window_max"],
                         ENGINE_KW["max_len"]) for r in make_requests(cfg)}


@pytest.mark.parametrize("point,index", MATRIX, ids=[p for p, _ in MATRIX])
def test_kill_point_recovery_bitwise(runs, reference, point, index):
    run = runs["model1_matrix"][point]
    assert run["serve_codes"] == [-signal.SIGKILL], (
        f"kill point {point}:{index} never fired: {run['serve_codes']}")
    (served,), (resumed,) = run["served"], run["resumed"]
    submitted = {e["uid"] for e in served if e["event"] == "submitted"}
    merged = {}
    for e in served + resumed:
        if e["event"] != "finish":
            continue
        tokens = np.asarray(e["tokens"])
        if e["uid"] in merged:
            # a finish delivered before the crash and again after it
            np.testing.assert_array_equal(merged[e["uid"]], tokens)
        merged[e["uid"]] = tokens
    assert submitted, "the child died before accepting anything"
    assert not submitted - set(merged), (
        f"accepted requests lost across the crash: {submitted - set(merged)}")
    for uid, tokens in merged.items():
        np.testing.assert_array_equal(
            tokens, reference[uid],
            err_msg=f"request {uid} differs after a {point} crash")
    (rec,) = [e for e in resumed if e["event"] == "recovered"]
    (m,) = [e for e in resumed if e["event"] == "metrics"]
    assert rec["n"] >= 1 and m["recovered_requests"] == rec["n"]
    if point == "post_sync":
        # the park was checkpointed: it comes back cold, and its prompt
        # blocks from the disk the dead process wrote
        assert m["recovered_parked"] >= 1 and m["resume_recomputes"] >= 1
        assert m["disk_hits"] >= 1 and m["disk_promotes"] >= 1


@pytest.fixture(scope="module")
def shared_weights(tmp_path_factory):
    """The reference's reduced qwen weights, and the port's load of them
    (saved by the reference's ``save_pytree``)."""
    path = str(tmp_path_factory.mktemp("w"))
    jcfg = jax_get_config("qwen3-1.7b", reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    jax_save_pytree(jparams, path, step=1)
    cfg = get_config("qwen3-1.7b", reduced=True)
    return jcfg, jparams, cfg, params_from_numpy(load_pytree(path, 1), cfg)


def test_durable_run_is_the_volatile_one_with_the_jax_engines_counters(
        tmp_path, shared_weights):
    """No crash: the journal, the per-sync checkpoints and the disk spills
    change no token, and the counters of the durable run equal the JAX
    engine's on the same weights."""
    jcfg, jparams, cfg, params = shared_weights

    def run(eng, reqs):
        eng.submit(reqs[0])
        eng.step()
        for r in reqs[1:]:
            eng.submit(r)
        done = {r.uid: r for r in eng.run()}
        eng.close()
        return done, eng.export_metrics()

    kw = dict(ENGINE_KW, eps_key=EPS_SEED, device=CPU)
    vol, mv = run(ServingEngine(cfg, params, **kw), make_requests(cfg))
    dur, md = run(ServingEngine(cfg, params, durable_dir=str(
        tmp_path / "port"), **kw), make_requests(cfg))
    for uid in vol:
        np.testing.assert_array_equal(dur[uid].result, vol[uid].result)
        assert dur[uid].calls_used == vol[uid].calls_used
    assert "journal_appends" not in mv and mv["checkpoints_written"] == 0
    jeng = JaxEngine(jcfg, jparams, eps_key=jax.random.PRNGKey(EPS_SEED),
                     durable_dir=str(tmp_path / "jax"), **ENGINE_KW)
    _, mj = run(jeng, make_requests(jcfg, JaxRequest))
    for k in ("journal_appends", "journal_syncs", "checkpoints_written",
              "disk_spills", "disk_puts", "preemptions", "prefill_calls",
              "resumes", "disk_bytes_written"):
        assert md[k] == mj[k], (k, md[k], mj[k])
    assert md["preemptions"] >= 1 and md["disk_spills"] >= 1
    with open(tmp_path / "port" / "journal.wal", "rb") as f, \
            open(tmp_path / "jax" / "journal.wal", "rb") as g:
        assert len(f.read()) == len(g.read())


def test_restore_matches_the_jax_engines_restore(tmp_path, shared_weights):
    """A restart in process on both packages: serve until the first
    checkpoint that holds a park, drop the engine without ``close``, build
    a new one over the same directory, ``restore`` and drain. What comes
    back (how many requests, how many as cold parks) and what the drain
    re-prefills and reads from disk equal the JAX engine's; the port's
    delivered tokens are bitwise its solo sampler's."""
    jcfg, jparams, cfg, params = shared_weights

    def crash_and_restore(make_engine, reqs):
        first = make_engine()
        first.submit(reqs[0])
        first.step()
        for r in reqs[1:]:
            first.submit(r)
        while not first.parked:
            assert first.step(), "the workload parked nobody"
        del first                  # dies after the sync that holds the park
        second = make_engine()
        n = second.restore()
        done = {r.uid: r for r in second.run()}
        second.close()
        return n, done, second.export_metrics()

    n, done, m = crash_and_restore(
        lambda: ServingEngine(cfg, params, eps_key=EPS_SEED, device=CPU,
                              durable_dir=str(tmp_path / "port"),
                              **ENGINE_KW), make_requests(cfg))
    nj, done_j, mj = crash_and_restore(
        lambda: JaxEngine(jcfg, jparams, eps_key=jax.random.PRNGKey(EPS_SEED),
                          durable_dir=str(tmp_path / "jax"), **ENGINE_KW),
        make_requests(jcfg, JaxRequest))
    assert n == nj and n >= 1
    assert set(done) == set(done_j) == {r.uid for r in make_requests(cfg)}
    for k in ("recovered_requests", "recovered_parked", "resume_recomputes",
              "prefill_calls", "disk_hits", "disk_promotes", "resumes",
              "requests_finished", "journal_appends", "checkpoints_written"):
        assert m[k] == mj[k], (k, m[k], mj[k])
    assert m["recovered_parked"] >= 1 and m["disk_hits"] >= 1
    for r in make_requests(cfg):
        np.testing.assert_array_equal(
            done[r.uid].result, _solo(cfg, params, r, ENGINE_KW["window_max"],
                                      ENGINE_KW["max_len"]))


def test_rwkv_restart_restores_snapshots_from_disk(tmp_path):
    """Reduced rwkv6-7b with an arena of one snapshot: A's boundary
    snapshots go to disk as they are evicted; B, sharing A's prompt, is
    accepted and the process dies before B's admission. A new engine over
    the same directory restores B, starts it from a snapshot it reads from
    disk, and B's tokens, like A's, are bitwise the solo sampler's."""
    cfg = get_config("rwkv6-7b", reduced=True)
    params = TransformerLM.init(cfg, seed=0, device=CPU)
    system = np.random.default_rng(13).integers(0, cfg.vocab, 13)
    kw = dict(batch=1, window_max=4, max_len=48, block_size=4,
              eps_key=EPS_SEED, adaptive=False, host_cache_mb=0.1,
              durable_dir=str(tmp_path), device=CPU)
    first = ServingEngine(cfg, params, **kw)
    a = Request(uid=0, prompt=system, new_tokens=8)
    first.submit(a)
    first.run()
    m = first.export_metrics()
    assert m["rec_snapshot_captures"] == 3 and m["disk_spills"] >= 2
    b = Request(uid=1, prompt=np.concatenate([system, [7, 2]]),
                new_tokens=8)
    assert first.submit(b)
    del first                      # dies with B accepted, never admitted
    second = ServingEngine(cfg, params, **kw)
    assert second.restore() == 1
    done = {r.uid: r for r in second.run()}
    m2 = second.export_metrics()
    assert m2["rec_snapshot_restores"] == 1 and m2["disk_hits"] >= 1
    assert m2["disk_promotes"] >= 1 and done[1].prefix_hit_blocks >= 1
    assert done[0].ok and done[1].ok
    for r in (a, done[0], done[1]):
        np.testing.assert_array_equal(
            r.result, _solo(cfg, params, r, max_len=48))


def test_serve_cli_restores_after_a_kill(tmp_path, capsys):
    """``--durable-dir``: a run killed at its first host sync leaves the
    journal and the checkpoint; the next run over the directory recovers
    its requests and serves its own after them."""
    ddir = str(tmp_path / "durable")
    args = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
            "--requests", "3", "--new-tokens", "8", "--durable-dir", ddir]
    _child(["-m", "repro_torch.launch.serve"] + args, kill="post_sync:0")
    assert {"journal.wal", "checkpoint.json", "disk"} <= set(os.listdir(ddir))
    serve.main(args + ["--journal-fsync-every", "2"])
    out = capsys.readouterr().out
    assert f"recovered 3 journaled requests from {ddir}" in out
    assert "served 6 requests" in out
    with pytest.raises(SystemExit):
        serve.main(["--help"])
    assert "--no-disk-tier" in capsys.readouterr().out


def _margin_fn(cfg, params, toks, sid):
    """The model-1 margin at position ``p`` of ``toks``: its logits (the
    dense solo path) plus stream ``sid``'s noise, top-2 gap."""
    eps = make_eps_fn(EPS_SEED, cfg.vocab)

    def margin_at(p):
        logits, _, _ = TransformerLM.decode_window(
            params, cfg, torch.as_tensor(toks[None, :p]),
            TransformerLM.init_cache(cfg, 1, p),
            torch.zeros(1, dtype=torch.int64))
        e = eps(torch.tensor([sid]), torch.tensor([[p]]))
        return top2_margin((logits[0, -1] + e[0, 0]).numpy())
    return margin_at


@pytest.mark.parametrize("point", [p for p, _ in MATRIX])
def test_kill_point_recovery_on_a_model_axis(runs, point):
    """Data 1 x model 2: both ranks carry the kill point; rank 0 (the one
    the client reads) dies there, and the other dies there too or fails
    on its dead peer. The restart on both ranks delivers every request
    rank 0 accepted, bitwise across the ranks and bitwise the
    uninterrupted model-2 durable run; rank 0's counters after the
    restart equal the model-1 restart's at the same point, and rank 1's
    do but for the journal's and the checkpoints', which only rank 0
    writes (rank 1 counts no checkpoint)."""
    run = runs["model2_matrix"][point]
    assert run["serve_codes"][0] == -signal.SIGKILL, run["serve_codes"]
    whole = {int(u): np.asarray(t)
             for u, t in runs["model2"][0]["durable"].items()}
    served, resumed = run["served"], run["resumed"]
    submitted = {e["uid"] for e in served[0] if e["event"] == "submitted"}
    assert submitted, "rank 0 died before accepting anything"
    merged = {}
    for events in (served[0], resumed[0]):
        for uid, tokens in _finishes(events).items():
            if uid in merged:
                np.testing.assert_array_equal(merged[uid], tokens)
            merged[uid] = tokens
    assert not submitted - set(merged), (
        f"accepted requests lost: {submitted - set(merged)}")
    for uid, tokens in merged.items():
        np.testing.assert_array_equal(
            tokens, whole[uid], err_msg=f"request {uid} after {point}")
    for phase in (served, resumed):
        for uid, tokens in _finishes(phase[1]).items():
            np.testing.assert_array_equal(tokens, merged[uid])
    assert _finishes(resumed[0]).keys() == _finishes(resumed[1]).keys()
    want = [e for e in runs["model1_matrix"][point]["resumed"][0]
            if e["event"] == "metrics"][0]
    for rank, events in enumerate(resumed):
        (m,) = [e for e in events if e["event"] == "metrics"]
        for k in METRIC_KEYS:
            if rank == 0 or not k.startswith(("journal_", "checkpoints_")):
                assert m[k] == want[k], (rank, k, m[k], want[k])
        assert rank == 0 or m["checkpoints_written"] == 0
    assert want["recovered_requests"] >= 1


def test_durable_model_axis_is_the_volatile_one_and_rank_0_owns_the_files(
        runs):
    """Uninterrupted, data 1 x model 2: the durable run's tokens are
    bitwise the volatile run's and the ranks', and its counters the
    model-1 durable run's (rank 1 counts no checkpoint: it writes none);
    rank 0 wrote ``journal.wal`` and ``checkpoint.json``, rank 1 neither,
    only its own disk tier under ``rank1/``; a restore over the directory leaves both ranks' disk tiers
    holding the same entries, the model-1 run's, though one was planted
    on rank 1 alone."""
    r0, r1 = runs["model2"]
    (one,) = runs["model1"]
    for r in (r0, r1):
        assert r["durable"] == r["volatile"] == r0["durable"]
    for k in ("checkpoints_written", "disk_spills", "disk_puts",
              "preemptions", "prefill_calls", "resumes", "requests_finished"):
        assert r0["durable_metrics"][k] == one["durable_metrics"][k], k
        if k != "checkpoints_written":
            assert r1["durable_metrics"][k] == one["durable_metrics"][k], k
    assert one["durable_metrics"]["checkpoints_written"] >= 1
    assert r1["durable_metrics"]["checkpoints_written"] == 0
    for k in ("journal_appends", "journal_syncs"):
        assert r0["durable_metrics"][k] == one["durable_metrics"][k], k
        assert k not in r1["durable_metrics"]
    assert r0["durable_metrics"]["disk_spills"] >= 1
    assert {"journal.wal", "checkpoint.json"} <= set(r0["wrote"])
    assert all(not w.startswith("rank1") for w in r0["wrote"])
    assert r1["wrote"] and all(w.startswith(os.path.join("rank1", "disk"))
                               for w in r1["wrote"])
    # a restore keeps on each rank only the disk entries every rank holds:
    # the one planted on rank 1 alone is dropped, the run's spills stay
    assert r0["restored"] == r1["restored"] == 0
    assert r0["disk_after_restore"] == r1["disk_after_restore"]
    assert r0["disk_after_restore"] == one["disk_after_restore"] != []
    assert PLANTED_BLOCK not in r1["disk_after_restore"]


def test_a_skewed_rank_clock_changes_no_decision(runs):
    """A deadline request, a priority-1 one submitted after the first step
    that misses its deadline queued, and ``max_request_seconds`` cutting
    a long one, on a stepped clock with rank 1's running 7x from 1000;
    the clock moves while the engine idles before each batch of submits
    and within each step, so a stale reading would move a decision: the
    ranks take the model-1 engine's decisions (the queue order after the
    first step, the cut, the missed deadlines, each request's latency and
    queue wait, and the counters) and deliver the same tokens. The
    planted fault, each rank deciding by its own clock, is caught by the
    next host sync's digest on both ranks."""
    r0, r1 = runs["model2"]
    (one,) = runs["model1"]
    want = one["clock"]
    assert r0["clock"] == r1["clock"]
    got = r0["clock"]
    assert got["order_after_step_1"] == want["order_after_step_1"]
    assert got["metrics"] == want["metrics"]
    assert want["metrics"]["requests_failed"] == 1
    assert want["metrics"]["deadline_missed_in_queue"] == 1
    for uid, w in want["outcomes"].items():
        g = got["outcomes"][uid]
        for k in ("error", "missed_deadline", "queue_deadline_missed",
                  "latency", "queue_wait"):
            assert g[k] == w[k], (uid, k)
        assert (g["result"] is None) == (w["result"] is None)
    # rank 0's reading on the model axis: one host broadcast as the engine
    # is built, one a submit, one at a step's top and one after its host
    # sync; none at model 1
    assert got["broadcasts"] == {"model": 1 + got["submits"] + got["steps"]
                                 + got["metrics"]["host_syncs"]}
    assert want["broadcasts"] == {} and want["steps"] == got["steps"]
    assert want["outcomes"]["0"]["error"] == "timeout"
    assert want["outcomes"]["3"]["missed_deadline"]
    assert want["outcomes"]["4"]["queue_deadline_missed"]
    for r in (r0, r1):
        assert r["own_clock"].startswith("RankDivergence: host sync"), \
            r["own_clock"]
    assert one["own_clock"] == "no divergence"


def test_model_axis_tokens_against_model1_under_the_margin_rule(runs, qwen):
    """The model-2 runs' tokens (the durable recovery workload and the
    clock run's) against the model-1 runs', under the margin rule at
    ``TP_TOL`` (row-parallel sums round otherwise than one product)."""
    cfg, params = qwen
    (one,) = runs["model1"]
    got = runs["model2"][0]
    pairs = [(one["durable"], got["durable"])]
    pairs.append(({u: o["result"] for u, o in one["clock"]["outcomes"]
                   .items() if o["result"] is not None},
                  {u: o["result"] for u, o in got["clock"]["outcomes"]
                   .items() if o["result"] is not None}))
    for ref, mine in pairs:
        assert ref.keys() == mine.keys()
        for uid, toks in ref.items():
            toks = np.asarray(toks)
            check_token_agreement(toks, np.asarray(mine[uid]),
                                  _margin_fn(cfg, params, toks, int(uid)),
                                  tol=TP_TOL)
