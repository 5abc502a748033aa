"""Tensor parallelism on the model axis (``repro_torch/sharding/
{collectives,tensor_parallel}.py``, the engine on a ``(data, model)``
mesh) on the CPU: gloo, world 2, reduced qwen3-1.7b in float32 with JAX's
weights.

The ranks run in one spawn (``tests/torch_tp_driver.py tp``, which imports
only the port): each rank's slices equal the whole leaves', bitwise, and
some leaves are split; the paged verify window's logits at model 2 are
bitwise the same on both ranks, within 1e-5 of model 1's and within 1e-4
(``test_torch_serving.py``'s tolerance) of JAX's; the op census of one
verify pass counts the collectives the design implies; the reference's
tensor-parallel traffic (``tests/serving/test_mesh_engine.py``'s
TP_SCRIPT: batch 4, W 4, ``max_len`` 32, block 4, 4 requests) at data 2 x
model 2 gives tokens bitwise across the ranks and bitwise those of data 1 x
model 2 at batch 2 (the same rows a call), and under the margin rule those
of the port's and JAX's single-device engines at batch 4 (the reference's
own test of this, which claims bitwise tokens, is one of the red ones).
And ``launch/serve.py --mesh 2,2`` serves, and ``--mesh 1,2
--durable-dir`` restores after a kill."""
import json
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
from repro.models.transformer import PagedView as JaxPagedView
from repro.models.transformer import TransformerLM as JaxLM
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.checkpoint.io import params_from_numpy, save_pytree
from repro_torch.configs import get_config
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import make_eps_fn
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.admission import Request
from repro_torch.serving.engine import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
DRIVER = ROOT / "tests" / "torch_tp_driver.py"
EPS_SEED = 9
KW = dict(window_max=4, max_len=32, eps_key=EPS_SEED, block_size=4,
          adaptive=False)
B, W, BS, NB = 2, 8, 4, 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def traffic(vocab, cls=Request):
    """The reference's TP_SCRIPT traffic."""
    rng = np.random.default_rng(3)
    return [cls(uid=i, prompt=rng.integers(0, vocab,
                                           size=int(rng.integers(2, 7))),
                new_tokens=int(rng.integers(3, 6))) for i in range(4)]


def port_pools(cfg, jpaged):
    """The reference's paged cache tree's pools in the port's layer order
    (``TransformerLM.pool_leaves``)."""
    layers = list(jpaged.get("prefix", []))
    for i in range(cfg.n_blocks):
        layers += [jax.tree.map(lambda a: a[i], b) for b in jpaged["blocks"]]
    layers += list(jpaged.get("suffix", []))
    return [np.asarray(l["mixer"][k]) for l in layers for k in ("k", "v")]


def run_driver(scenario, directory):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(DRIVER), scenario,
                          str(directory)], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    cfg = get_config("qwen3-1.7b", reduced=True)
    jcfg = jax_get_config("qwen3-1.7b", reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    d = tmp_path_factory.mktemp("tp")
    save_pytree(tree, str(d), 0)
    # random pools at cache lengths 13 and 22, through permuted tables
    rng = np.random.default_rng(7)
    P = 1 + B * NB
    jpaged = JaxLM.init_paged_cache(jcfg, B, P, BS)
    leaves, treedef = jax.tree.flatten(jpaged)
    jpaged = jax.tree.unflatten(treedef, [
        jnp.asarray(0.1 * rng.standard_normal(l.shape), l.dtype)
        for l in leaves])
    inputs = {"tokens": rng.integers(0, cfg.vocab, (B, W)),
              "tables": (1 + rng.permutation(B * NB)).reshape(
                  B, NB).astype(np.int32),
              "cache_len": np.array([13, 22], np.int32)}
    np.savez(d / "inputs.npz", **inputs, **{
        f"pool{i}": a for i, a in enumerate(port_pools(cfg, jpaged))})
    ranks = run_driver("tp", d)
    jlogits, _, _ = JaxLM.decode_window_paged(
        jparams, jcfg, jnp.asarray(inputs["tokens"]), jpaged,
        JaxPagedView(jnp.asarray(inputs["tables"]), jnp.arange(B)),
        jnp.asarray(inputs["cache_len"]))
    params = params_from_numpy(tree, cfg, device="cpu")
    return dict(cfg=cfg, jcfg=jcfg, jparams=jparams, params=params,
                ranks=ranks, jlogits=np.asarray(jlogits))


def test_rank_slices_equal_the_whole_leaves(tp):
    for r in tp["ranks"]:
        assert r["slices_equal"], r
        # wq, wk, wv, wo, up, gate, down of both layers and the table
        assert r["n_split"] == 7 * 2 + 1, r
    assert tp["ranks"][0]["logits"] == tp["ranks"][1]["logits"]


def test_window_logits_model2_against_model1_and_jax(tp):
    got = np.asarray(tp["ranks"][0]["logits"], np.float32)
    assert got.shape == (B, W, tp["cfg"].vocab)
    for r in tp["ranks"]:
        assert r["logits_err_vs_model1"] < 1e-5, r["logits_err_vs_model1"]
    assert np.abs(got - tp["jlogits"]).max() < 1e-4


def test_census_counts_the_collectives_of_a_pass(tp):
    """Per verify pass: 4 all-reduces a layer in attention (the q, k, v
    and output products, row-parallel), 1 in the MLP (up and gate
    column-parallel, down row-parallel), 1 for the embedding, and the
    logits gathered once: 2 x 5 + 1 = 11 all-reduces and 1 all-gather on
    reduced qwen's 2 layers, all on the model axis."""
    cfg = tp["cfg"]
    D, V = cfg.d_model, cfg.vocab
    for r in tp["ranks"]:
        model = r["census"]["model"]
        assert model["all-reduce"]["count"] == cfg.n_layers * 5 + 1
        assert model["all-gather"]["count"] == 1
        assert set(r["census"]) == {"model"}
        assert r["c10d_axes"] == ["model"]
        # the gathered logits: B x W rows of the whole vocabulary, f32
        assert model["all-gather"]["bytes"] == B * W * V * 4
        # the embedding's and the output products' (B, W, D) sums, f32
        assert model["all-reduce"]["bytes"] >= (cfg.n_layers * 2 + 1) * \
            B * W * D * 4


def test_tp_tokens_bitwise_across_ranks_and_equal_rows(tp):
    r0, r1 = tp["ranks"]
    assert r0["tokens_d2"] == r1["tokens_d2"]
    assert r0["tokens_d2"] == r0["tokens_d1"]
    assert r0["tokens_d1"] == r1["tokens_d1"]
    for r in tp["ranks"]:
        # every checked round and prefill passed its contract, with the
        # model axis's collectives allowed and counted
        assert r["contracts_ok"] and r["collectives_checked"] > 0, r
        assert "ROUND_CONTRACT" in r["contracts"]


def test_tp_tokens_against_the_single_device_engines(tp):
    """Against the port's single-device engine at batch 4 and JAX's (the
    noise of ``make_eps_fn(9)`` on both), under the margin rule with
    tolerance 1e-4: row-parallel sums round otherwise than one product."""
    cfg, jcfg, jparams, params = (tp["cfg"], tp["jcfg"], tp["jparams"],
                                  tp["params"])
    got = {int(u): np.asarray(t) for u, t in tp["ranks"][0]["tokens_d2"]
           .items()}
    eng = ServingEngine(cfg, params, batch=4, device="cpu", **KW)
    for r in traffic(cfg.vocab):
        assert eng.submit(r)
    mine = {r.uid: r.result for r in eng.run()}
    eps = make_eps_fn(EPS_SEED, cfg.vocab)
    for u, ref in mine.items():
        def margin_at(p, toks=ref, sid=u):
            logits, _, _ = TransformerLM.decode_window(
                params, cfg, torch.as_tensor(toks[None, :p]),
                TransformerLM.init_cache(cfg, 1, p),
                torch.zeros(1, dtype=torch.int64))
            e = eps(torch.tensor([sid]), torch.tensor([[p]]))
            return top2_margin((logits[0, -1] + e[0, 0]).numpy())
        check_token_agreement(ref, got[u], margin_at, tol=1e-4)
    key = jax.random.PRNGKey(EPS_SEED)
    jeng = JaxEngine(jcfg, jparams, batch=4, eps_key=key,
                     **{k: v for k, v in KW.items() if k != "eps_key"})
    for r in traffic(cfg.vocab, JaxRequest):
        jeng.submit(r)
    jeps = jax_make_eps_fn(key, jcfg.vocab)
    for jr in jeng.run():
        def margin_at(p, toks=jr.result, sid=jr.uid):
            logits, _, _ = JaxLM.apply(jparams, jcfg,
                                       jnp.asarray(toks[None, :p], jnp.int32))
            e = jeps(jnp.asarray([sid], jnp.int32),
                     jnp.asarray([[p]], jnp.int32))
            return top2_margin(np.asarray(logits[0, -1] + e[0, 0]))
        check_token_agreement(jr.result, got[jr.uid], margin_at, tol=1e-4,
                              start=len(jr.prompt))


def test_serve_cli_spawns_the_model_ranks():
    """``--mesh 2,2 --device cpu --reduced``: two model ranks over gloo,
    two data shards each; rank 0 prints."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-1.7b", "--reduced", "--device", "cpu", "--mesh", "2,2",
         "--mesh-devices", "cpu,cpu", "--batch", "4", "--requests", "4",
         "--new-tokens", "6"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 4 requests / 24 tokens" in out.stdout
    assert "2 model ranks (gloo)" in out.stdout
    assert out.stdout.count("served ") == 1          # rank 0 prints


def test_durable_dir_on_a_model_axis_restores_after_a_kill(tmp_path):
    """``--mesh 1,2 --durable-dir``, once refused as ROADMAP item 20c, now
    serves: a run killed at its first host sync (both ranks carry the kill
    point) leaves rank 0's journal and checkpoint and each rank's disk
    tier; the next run over the directory restores on both ranks, rank 0
    reports what it recovered and serves its own requests after them."""
    ddir = str(tmp_path / "durable")
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "qwen3-1.7b", "--reduced", "--device", "cpu", "--mesh", "1,2",
            "--mesh-devices", "cpu", "--requests", "3", "--new-tokens", "8",
            "--durable-dir", ddir]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    killed = subprocess.run(args, capture_output=True, text=True, cwd=ROOT,
                            env=dict(env, REPRO_KILL_POINT="post_sync:0"),
                            timeout=300)
    assert killed.returncode != 0 and "a rank died" in killed.stderr, \
        killed.stderr[-3000:]
    assert "served" not in killed.stdout
    assert {"journal.wal", "checkpoint.json", "disk", "rank1"} <= set(
        os.listdir(ddir))
    out = subprocess.run(args, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count(f"recovered 3 journaled requests from {ddir}") \
        == 1                                          # rank 0 prints
    assert "served 6 requests / 48 tokens" in out.stdout
    assert "2 model ranks (gloo)" in out.stdout
