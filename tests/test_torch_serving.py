"""The port's serving layer on the CPU: its engine against its own solo
sampler (bitwise), against the JAX engine on the same traffic (block
tables bitwise, tokens under the margin rule), the host-side copies against
the reference's, and the CLI."""
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
from repro.serving.adaptive import AdaptiveWindowController as JaxCtrl
from repro.serving.admission import prefill_chunks as jax_prefill_chunks
from repro.serving.blocks import BlockManager as JaxBlocks
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler
from repro_torch.launch import serve
from repro_torch.serving.adaptive import AdaptiveWindowController
from repro_torch.serving.admission import Request, prefill_chunks
from repro_torch.serving.blocks import BlockManager
from repro_torch.serving.engine import ServingEngine

EPS_SEED = 9
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen3-1.7b", reduced=True)
    jcfg = jax_get_config("qwen3-1.7b", reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, jparams, params_from_numpy(tree, cfg)


def _traffic(seed, n, vocab, lo=2, hi=14, new_lo=4, new_hi=12, shared=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, size=int(rng.integers(lo, hi)))
        if shared is not None:
            p = np.concatenate([shared, p])
        out.append((i, p, int(rng.integers(new_lo, new_hi))))
    return out


def _solo(cfg, params, uid, prompt, new, window, max_len):
    s = PredictiveSampler(cfg, params, window=window, max_len=max_len,
                          eps_key=EPS_SEED, device=CPU)
    t, _ = s.generate(torch.as_tensor(prompt)[None], new,
                      seq_ids=torch.tensor([uid]))
    return t[0, :len(prompt) + new].numpy()


@pytest.mark.parametrize("adaptive,prefix", [(False, True), (True, False)])
def test_engine_matches_port_solo_bitwise(qwen, adaptive, prefix):
    """Ragged prompts, slot reuse, mid-flight admission, prefix hits and an
    adaptive window: every request equals its solo run bit for bit. The
    solo run attends over a dense max_len + W cache, the engine over a
    gathered nb * bs view of its blocks."""
    cfg, _, _, params = qwen
    eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=64,
                        eps_key=EPS_SEED, block_size=4, adaptive=adaptive,
                        prefix_cache=prefix, device=CPU)
    shared = np.random.default_rng(5).integers(0, cfg.vocab, size=9)
    traffic = _traffic(1, 3, cfg.vocab) + [
        (10 + i, p, n) for i, p, n in _traffic(2, 2, cfg.vocab,
                                                 shared=shared)]
    for uid, p, n in traffic[:3]:
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    eng.step()
    for uid, p, n in traffic[3:]:
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    done = eng.run()
    assert sorted(r.uid for r in done) == sorted(u for u, _, _ in traffic)
    for r in done:
        assert r.ok
        ref = _solo(cfg, params, r.uid, r.prompt, r.new_tokens, 8, 64)
        np.testing.assert_array_equal(r.result, ref,
                                      err_msg=f"request {r.uid}")
    assert eng.pool.blocks_in_use() == 0


def _jax_margin_fn(jcfg, jparams, eps_key, uid, tokens):
    jeps = jax_make_eps_fn(eps_key, jcfg.vocab)

    def margin_at(p):
        logits, _, _ = JaxLM.apply(jparams, jcfg,
                                   jnp.asarray(tokens[None, :p], jnp.int32))
        e = jeps(jnp.asarray([uid], jnp.int32), jnp.asarray([[p]], jnp.int32))
        return top2_margin(np.asarray(logits[0, -1] + e[0, 0]))
    return margin_at


def test_engine_matches_jax_engine(qwen):
    """Same traffic through both engines in lockstep, with JAX's noise
    injected into the port: block tables and per-step host state equal
    bitwise, tokens equal under the margin rule (tolerance 1e-4: float32
    logits of the two frameworks differ by ~1e-6 here)."""
    cfg, jcfg, jparams, params = qwen
    key = jax.random.PRNGKey(EPS_SEED)
    jeps = jax.jit(jax_make_eps_fn(key, cfg.vocab))

    def eps_fn(seq_ids, positions):
        e = jeps(jnp.asarray(seq_ids.numpy(), jnp.int32),
                 jnp.asarray(positions.numpy(), jnp.int32))
        return torch.from_numpy(np.array(e))

    kw = dict(batch=2, window_max=8, max_len=64, block_size=4,
              adaptive=True)
    eng = ServingEngine(cfg, params, eps_fn=eps_fn, device=CPU, **kw)
    jeng = JaxEngine(jcfg, jparams, eps_key=key, host_cache_mb=0, **kw)
    shared = np.random.default_rng(7).integers(0, cfg.vocab, size=10)
    traffic = _traffic(3, 4, cfg.vocab, shared=shared)
    for uid, p, n in traffic:
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
        jeng.submit(JaxRequest(uid=uid, prompt=p, new_tokens=n))
    while True:
        more, jmore = eng.step(), jeng.step()
        assert more == jmore
        np.testing.assert_array_equal(eng.tables, jeng.tables)
        assert [len(o) for o in eng.owned] == [len(o) for o in jeng.owned]
        np.testing.assert_array_equal(eng.n_host, jeng.n_host)
        assert eng.controller.window == jeng.controller.window
        if not more:
            break
    got = {r.uid: r for r in eng.done}
    assert sorted(got) == sorted(r.uid for r in jeng.done)
    for jr in jeng.done:
        r = got[jr.uid]
        assert (r.calls_used, r.prefill_calls, r.prefix_hit_blocks) == (
            jr.calls_used, jr.prefill_calls, jr.prefix_hit_blocks)
        check_token_agreement(
            jr.result, r.result,
            _jax_margin_fn(jcfg, jparams, key, jr.uid, jr.result), tol=1e-4,
            start=len(jr.prompt))
    mine, ref = eng.export_metrics(), jeng.export_metrics()
    for k in ("rounds", "prefill_calls", "tokens_generated", "prefix_hits",
              "prefix_misses", "blocks_allocated", "evictions",
              "arm_calls_vs_ancestral"):
        assert mine[k] == ref[k], k


def test_block_manager_matches_reference():
    """Same alloc/lookup/register/release script: same ids, same cache."""
    rng = np.random.default_rng(0)
    a, b = BlockManager(16, 4), JaxBlocks(16, 4)
    prompts = [rng.integers(0, 50, size=int(rng.integers(5, 18)))
               for _ in range(6)]
    prompts[3] = np.concatenate([prompts[0][:8], prompts[3]])
    held = []
    for p in prompts:
        nb_full = (len(p) - 1) // 4
        ha, ka = a.lookup_prefix(p, nb_full)
        hb, kb = b.lookup_prefix(p, nb_full)
        assert ha == hb and ka == kb
        own_a = ha + a.alloc(nb_full - len(ha) + 1)
        own_b = hb + b.alloc(nb_full - len(hb) + 1)
        assert own_a == own_b
        for j in range(len(ha), nb_full):
            a.register(own_a[j], ka[j])
            b.register(own_b[j], kb[j])
        held.append(own_a)
        if len(held) > 2:
            blocks = held.pop(0)
            a.release_all(blocks)
            b.release_all(blocks)
        assert a.free == b.free and list(a.cached_free) == list(b.cached_free)
    assert a.stats.export().items() <= b.stats.export().items()


def test_controller_and_chunks_match_reference():
    mine, ref = AdaptiveWindowController(w_max=8), JaxCtrl(w_max=8)
    rng = np.random.default_rng(1)
    for _ in range(40):
        acc, rows = int(rng.integers(0, 30)), int(rng.integers(0, 8))
        assert mine.observe_aggregate(acc, rows) == \
            ref.observe_aggregate(acc, rows)
    for n in range(0, 150):
        for c in (1, 48, 64):
            assert prefill_chunks(n, c) == jax_prefill_chunks(n, c)


def test_cli_runs_on_cpu(capsys):
    serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                "--requests", "3", "--new-tokens", "6", "--max-len", "48",
                "--block-size", "8"])
    out = capsys.readouterr().out
    assert "served 3 requests / 18 tokens" in out


def test_entry_points_refuse_cpu_unless_asked(qwen):
    cfg, _, _, params = qwen
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params, batch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PredictiveSampler(cfg, params)
