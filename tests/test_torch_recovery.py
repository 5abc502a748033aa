"""Crash and restore of the port's serving engine on the CPU.

The kill-point matrix of the reference's ``tests/serving/test_recovery.py``
through the port: a child engine (``torch_recovery_driver.py serve``) is
SIGKILLed at a named site, a second child restores from the same durable
directory and drains the work; every request whose submit returned before
the kill is delivered by the two, and every delivered token row equals the
port's solo ``PredictiveSampler`` bitwise. An uninterrupted durable run is
bitwise the volatile run, and its durability counters equal the JAX
engine's on the same workload and weights; a restart in process restores
what the JAX engine's restart restores, with equal counters. Reduced
rwkv6-7b restarted in process: its recurrent snapshots demoted to disk by
a tiny arena bring a new engine's admission back from disk. The serving
CLI's ``--durable-dir`` across a kill and a restart."""
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
from repro_torch.engine.spec_decode import PredictiveSampler
from repro_torch.launch import serve
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.admission import Request
from repro_torch.serving.engine import ServingEngine

sys.path.insert(0, os.path.dirname(__file__))
from torch_recovery_driver import (ENGINE_KW, EPS_SEED,  # noqa: E402
                                   make_requests)

DRIVER = os.path.join(os.path.dirname(__file__), "torch_recovery_driver.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# (kill point, firing index), the reference's: each lands mid-run, after
# the first admission and before the queue drains
MATRIX = [("post_admit", 2), ("mid_spill", 1),
          ("pre_fsync", 5), ("post_sync", 3)]


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


def _driver(phase: str, ddir: str = "", kill: str = "") -> list:
    out = _child([DRIVER, phase] + ([ddir] if ddir else []), kill)
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


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
def test_kill_point_recovery_bitwise(tmp_path, reference, point, index):
    ddir = str(tmp_path / "durable")
    served = _driver("serve", ddir, kill=f"{point}:{index}")
    resumed = _driver("resume", ddir)
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
