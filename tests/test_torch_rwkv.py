"""The port's RWKV-6 path on the CPU: its time mix, channel mix, decoder,
window decode with recurrent states and solo sampler against the JAX
reference on the reduced rwkv6-7b (2 layers, d_model 256, head width 32,
vocab 512) in float32, with the reference's weights loaded through
``params_from_numpy`` and inputs made with numpy from a seed; and the
port's serving engine against its own solo sampler.

Tolerances: the time mix at T = 16, the channel mix and one window with its
per-position states 1e-5 (float32 matmuls and transcendental functions of
two libraries round differently); the time mix at T = 256 (the chunked
scan) 1e-4 (the same, carried through 256 steps of the state); decoder
logits and selected states 1e-4 (through two layers); integer outputs
(tokens, ``row_stats``) bitwise under the same injected noise; token
streams of whole generations under the margin rule with tolerance 1e-4.
Inside the port everything is bitwise, in bfloat16 too. The bf16 model
scan against the reference's bf16 scan: 2^-7 relative plus 1e-3 (one bf16
ulp of the value).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_pytree as jax_save_pytree
from repro.configs import get_config as jax_get_config
from repro.engine.spec_decode import PredictiveSampler as JaxSampler
from repro.engine.spec_decode import make_eps_fn as jax_make_eps_fn
from repro.engine.spec_decode import verify_round as jax_verify_round
from repro.models.ssm import RWKV6ChannelMix as JaxCMix
from repro.models.ssm import RWKV6TimeMix as JaxTMix
from repro.models.transformer import TransformerLM as JaxLM
from repro.nn.core import LayerNorm as JaxLayerNorm
from repro_torch.checkpoint.io import (load_pytree, params_from_numpy,
                                       params_to_numpy, reference_tree,
                                       save_pytree)
from repro_torch.configs import get_config
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler, verify_round
from repro_torch.kernels.rwkv_wkv.ops import rwkv_wkv
from repro_torch.launch import serve
from repro_torch.models.ssm import RWKV6ChannelMix, RWKV6TimeMix
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.core import LayerNorm
from repro_torch.serving.admission import Request
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
EPS_KEY = jax.random.PRNGKey(9)
EPS_SEED = 9


@pytest.fixture(scope="module")
def rwkv():
    cfg = get_config("rwkv6-7b", reduced=True)
    jcfg = jax_get_config("rwkv6-7b", reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, jparams, params_from_numpy(tree, cfg)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _layer0(params, jparams, key):
    return (params["layers"][0][key],
            jax.tree.map(lambda a: a[0], jparams["blocks"][0][key]))


def _jax_eps_for_port(vocab):
    jeps = jax.jit(jax_make_eps_fn(EPS_KEY, vocab))

    def eps_fn(seq_ids, positions):
        return _t(jeps(jnp.asarray(seq_ids.numpy(), jnp.int32),
                       jnp.asarray(positions.numpy(), jnp.int32)))
    return eps_fn


def _tree_close(got, want, tol):
    assert jax.tree.structure(jax.tree.map(np.asarray, got)) == \
        jax.tree.structure(jax.tree.map(np.asarray, want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(a, b, tol)


def test_checkpoint_round_trip_of_the_rwkv_tree(rwkv, tmp_path):
    """The reference's tree (nested ``mu`` and ``lora`` dicts, the channel
    mix under ``ffn``, the stacked ``blocks`` axis) converts both ways and
    through either package's checkpoint files, bitwise."""
    cfg, _, jparams, params = rwkv
    assert set(params["layers"][0]["mixer"]["lora"]) == set("rkvwg")
    assert set(params["layers"][1]["ffn"]) == {"mu_k", "mu_r", "wk", "wv",
                                               "wr"}
    want = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    jax_save_pytree(jparams, str(tmp_path / "ref"), step=1)
    save_pytree(reference_tree(params, cfg), str(tmp_path / "port"), step=1)
    for d in ("ref", "port"):
        loaded = params_from_numpy(load_pytree(str(tmp_path / d), 1), cfg)
        for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
            assert torch.equal(a, b)


def test_layernorm_matches():
    rng = np.random.default_rng(0)
    x = 3.0 + rng.standard_normal((2, 5, 256)).astype(np.float32)
    p = {"scale": rng.standard_normal(256).astype(np.float32),
         "bias": rng.standard_normal(256).astype(np.float32)}
    _close(LayerNorm.apply({k: _t(v) for k, v in p.items()}, _t(x)),
           JaxLayerNorm.apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("T,tol", [(16, 1e-5), (256, 1e-4)])
def test_time_mix_full_matches(rwkv, T, tol):
    """T = 256 takes the chunked scan on both sides."""
    cfg, jcfg, jparams, params = rwkv
    p, jp = _layer0(params, jparams, "mixer")
    x = np.random.default_rng(T).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    _close(RWKV6TimeMix.full(p, _t(x), cfg),
           JaxTMix.full(jp, jnp.asarray(x), jcfg), tol)


def _state(rng, cfg, B):
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return {"x_last": rng.standard_normal((B, cfg.d_model)).astype(
                np.float32),
            "S": 0.3 * rng.standard_normal((B, H, hd, hd)).astype(
                np.float32)}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_time_mix_window_matches_from_a_state(rwkv, use_kernel):
    """One window from a non-zero state: the output and the state after
    every position. ``use_kernel`` takes the WKV op (its float32 plain
    version on the CPU) instead of the model scan."""
    cfg, jcfg, jparams, params = rwkv
    p, jp = _layer0(params, jparams, "mixer")
    rng = np.random.default_rng(1)
    B, W = 2, 8
    x = rng.standard_normal((B, W, cfg.d_model)).astype(np.float32)
    st = _state(rng, cfg, B)
    y, s = RWKV6TimeMix.window(p, _t(x), cfg, {k: _t(v) for k, v in
                                               st.items()},
                               use_kernel=use_kernel)
    jy, js = JaxTMix.window(jp, jnp.asarray(x), jcfg,
                            {k: jnp.asarray(v) for k, v in st.items()})
    _close(y, jy, 1e-5)
    assert s["S"].shape == (B, W) + st["S"].shape[1:]
    _close(s["S"], js["S"], 1e-5)
    _close(s["x_last"], js["x_last"], 0)
    # the last-state form is the last slice of the per-position one
    y2, s2 = RWKV6TimeMix.window(p, _t(x), cfg, {k: _t(v) for k, v in
                                                 st.items()},
                                 use_kernel=use_kernel, last_state_only=True)
    assert torch.equal(y2, y)
    assert torch.equal(s2["S"], s["S"][:, -1])
    assert torch.equal(s2["x_last"], s["x_last"][:, -1])


def test_channel_mix_matches(rwkv):
    cfg, jcfg, jparams, params = rwkv
    p, jp = _layer0(params, jparams, "ffn")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    x_last = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    _close(RWKV6ChannelMix.full(p, _t(x), cfg),
           JaxCMix.full(jp, jnp.asarray(x), jcfg), 1e-5)
    y, s = RWKV6ChannelMix.window(p, _t(x), cfg, {"x_last": _t(x_last)})
    jy, js = JaxCMix.window(jp, jnp.asarray(x), jcfg,
                            {"x_last": jnp.asarray(x_last)})
    _close(y, jy, 1e-5)
    _close(s["x_last"], js["x_last"], 0)


def test_apply_matches(rwkv):
    cfg, jcfg, jparams, params = rwkv
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 24))
    logits, h, _ = TransformerLM.apply(params, cfg, _t(toks))
    jlogits, jh, _ = JaxLM.apply(jparams, jcfg, jnp.asarray(toks))
    _close(logits, jlogits, 1e-4)
    _close(h, jh, 1e-4)


def test_full_refuses_a_gradient_on_the_kernel_route_only_on_cuda(rwkv):
    """On the CPU the kernel route is the plain one, so a gradient flows;
    on a CUDA tensor (tests/test_torch_gpu.py) it raises."""
    cfg, _, _, params = rwkv
    p = {k: v for k, v in params["layers"][0]["mixer"].items()}
    x = torch.randn((1, 6, cfg.d_model), requires_grad=True)
    RWKV6TimeMix.full(p, x, cfg).sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def _jax_state_tree(jcache):
    """The reference's cache tree ({"blocks": [per-spec entries with a
    leading layer axis]}) as the port's per-layer list."""
    out = []
    n = jax.tree.leaves(jcache["blocks"][0])[0].shape[0]
    for i in range(n):
        for entry in jcache["blocks"]:
            out.append(jax.tree.map(lambda a: np.asarray(a)[i], entry))
    return {"layers": out}


def test_decode_window_and_select_states_match(rwkv):
    """A prompt prefill then a window from the selected states: logits of
    both calls and the states selected at per-row accept points."""
    cfg, jcfg, jparams, params = rwkv
    rng = np.random.default_rng(4)
    B, L, W = 2, 9, 8
    toks = rng.integers(0, cfg.vocab, size=(B, L + W))
    zero = np.zeros(B, np.int32)
    cache = TransformerLM.init_cache(cfg, B, 32, device=CPU)
    jcache = JaxLM.init_cache(jcfg, B, 32)
    lg1, _, nc = TransformerLM.decode_window(params, cfg, _t(toks[:, :L]),
                                             cache, _t(zero))
    jlg1, _, jnc = JaxLM.decode_window(jparams, jcfg,
                                       jnp.asarray(toks[:, :L]), jcache,
                                       jnp.asarray(zero))
    _close(lg1, jlg1, 1e-4)
    full = np.full(B, L, np.int32)
    cache = TransformerLM.select_states(cfg, nc, _t(full))
    jcache = JaxLM.select_states(jcfg, jnc, jnp.asarray(full))
    _tree_close(cache, _jax_state_tree(jcache), 1e-4)
    cl = np.full(B, L, np.int32)
    lg2, h, nc = TransformerLM.decode_window(params, cfg, _t(toks[:, L:]),
                                             cache, _t(cl))
    jlg2, jh, jnc = JaxLM.decode_window(jparams, jcfg,
                                        jnp.asarray(toks[:, L:]), jcache,
                                        jnp.asarray(cl))
    _close(lg2, jlg2, 1e-4)
    _close(h, jh, 1e-4)
    acc = np.array([3, 8], np.int32)
    _tree_close(TransformerLM.select_states(cfg, nc, _t(acc)),
                _jax_state_tree(JaxLM.select_states(jcfg, jnc,
                                                    jnp.asarray(acc))),
                1e-4)


def _port_states(cfg, cache):
    return [leaf for layer in cache["layers"] for e in layer.values()
            for leaf in e.values()]


def test_verify_rounds_row_stats_and_tokens_bitwise(rwkv):
    """Three rounds from the same prompts under the same (JAX's) noise:
    ``row_stats``, accepted tokens and next windows equal bitwise, and the
    recurrent states within 1e-4 — row 2 is done from the start, so it
    adopts with ``a = 0`` the state after ``cand[0]``, one token past its
    snapshot, as the reference does."""
    cfg, jcfg, jparams, params = rwkv
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab, size=(3, 6))
    s = PredictiveSampler(cfg, params, window=8, max_len=40,
                          eps_fn=_jax_eps_for_port(cfg.vocab), device=CPU)
    js = JaxSampler(jcfg, jparams, window=8, max_len=40, eps_key=EPS_KEY)
    st = s.init_state(prompts, 3)
    jst = js.init_state(jnp.asarray(prompts, jnp.int32), 3)
    _tree_close(st.cache, _jax_state_tree(jst.cache), 1e-4)
    target = np.array([10, 30, 6], np.int64)
    snap = [leaf[2].clone() for leaf in _port_states(cfg, st.cache)]
    for i in range(3):
        st, stats = verify_round(params, cfg, s.eps_fn, st, _t(target))
        jst, jstats = jax_verify_round(jparams, jcfg, js.eps_fn, jst,
                                       jnp.asarray(target, jnp.int32))
        np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))
        np.testing.assert_array_equal(st.tokens.numpy(),
                                      np.asarray(jst.tokens))
        np.testing.assert_array_equal(st.cand.numpy(), np.asarray(jst.cand))
        _tree_close(st.cache, _jax_state_tree(jst.cache), 1e-4)
        assert int(stats[2, 0]) == 0            # the done row accepted 0
        if i == 0:
            # its window re-ran from the snapshot: the adopted state is
            # the one after cand[0], not the snapshot
            after = _port_states(cfg, st.cache)
            assert not all(torch.equal(a[2], b) for a, b in zip(after, snap))


def test_generate_matches_jax(rwkv):
    """Whole generations: tokens under the margin rule, and the same
    per-row call counts where the streams are equal."""
    cfg, jcfg, jparams, params = rwkv
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab, size=(2, 7))
    s = PredictiveSampler(cfg, params, window=4, max_len=48,
                          eps_fn=_jax_eps_for_port(cfg.vocab), device=CPU)
    js = JaxSampler(jcfg, jparams, window=4, max_len=48, eps_key=EPS_KEY)
    toks, stats = s.generate(prompts, 20)
    jtoks, jstats = js.generate(jnp.asarray(prompts, jnp.int32), 20)
    jeps = jax_make_eps_fn(EPS_KEY, cfg.vocab)
    for b in range(2):
        ref = np.asarray(jtoks[b, :27])

        def margin_at(p, ref=ref, b=b):
            logits, _, _ = JaxLM.apply(jparams, jcfg,
                                       jnp.asarray(ref[None, :p], jnp.int32))
            e = jeps(jnp.asarray([b], jnp.int32),
                     jnp.asarray([[p]], jnp.int32))
            return top2_margin(np.asarray(logits[0, -1] + e[0, 0]))
        res = check_token_agreement(ref, toks[b, :27].numpy(), margin_at,
                                    tol=1e-4, start=7)
        if res is None:
            assert stats["per_seq_calls"][b] == jstats["per_seq_calls"][b]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_window_8_equals_window_1_bitwise(rwkv, use_kernel):
    """The reference's ``test_window_exactness_vs_ancestral`` for RWKV: a
    W = 8 predictive run gives the tokens of the W = 1 (ancestral) run, on
    the plain scan and on the WKV op's route."""
    cfg, _, _, params = rwkv
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, size=(2, 5))
    out = {}
    for W in (8, 1):
        s = PredictiveSampler(cfg, params, window=W, max_len=40,
                              eps_key=EPS_SEED, device=CPU,
                              use_attention_kernel=use_kernel)
        out[W], stats = s.generate(prompts, 24)
        if W == 1:
            assert stats["rounds"] == 24
    assert torch.equal(out[8], out[1])


def _solo(cfg, params, uid, prompt, new):
    s = PredictiveSampler(cfg, params, window=8, max_len=64,
                          eps_key=EPS_SEED, device=CPU)
    t, _ = s.generate(torch.as_tensor(prompt)[None], new,
                      seq_ids=torch.tensor([uid]))
    return t[0, :len(prompt) + new].numpy()


def _traffic(seed, n, vocab, shared=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, size=int(rng.integers(2, 14)))
        if shared is not None:
            p = np.concatenate([shared, p])
        out.append((i, p, int(rng.integers(4, 12))))
    return out


def test_engine_matches_port_solo_bitwise(rwkv):
    """Ragged prompts sharing a 9-token prefix, chunked prefill, slot
    reuse, mid-flight admission and an adaptive window: every request
    equals its solo run bit for bit. The prefix cache was asked for and,
    without a host tier to hold its state snapshots, is off for the
    recurrent stack (a hit would skip the state's prefill)."""
    cfg, _, _, params = rwkv
    eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=64,
                        eps_key=EPS_SEED, block_size=4, prefix_cache=True,
                        prefill_chunk=4, host_cache_mb=0, device=CPU)
    assert not eng.kv_prefix
    shared = np.random.default_rng(8).integers(0, cfg.vocab, size=9)
    traffic = _traffic(9, 5, cfg.vocab, shared=shared)
    for uid, p, n in traffic[:3]:
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    eng.step()
    for uid, p, n in traffic[3:]:
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    done = eng.run()
    assert sorted(r.uid for r in done) == [u for u, _, _ in traffic]
    for r in done:
        assert r.ok and r.prefix_hit_blocks == 0
        np.testing.assert_array_equal(
            r.result, _solo(cfg, params, r.uid, r.prompt, r.new_tokens),
            err_msg=f"request {r.uid}")
    m = eng.export_metrics()
    assert m["prefix_hits"] == 0
    assert m["verify_passes"] >= m["rounds"]


def test_cleared_and_readmitted_slot_starts_from_zero(rwkv):
    """A freed slot's rows are zero; a slot whose rows hold garbage when a
    request is admitted serves that request as from the zero state."""
    cfg, _, _, params = rwkv
    eng = ServingEngine(cfg, params, batch=1, window_max=4, max_len=48,
                        eps_key=EPS_SEED, block_size=4, device=CPU)
    traffic = _traffic(10, 2, cfg.vocab)
    uid, p, n = traffic[0]
    eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    eng.run()
    leaves = _port_states(cfg, eng.paged)
    assert len(leaves) == 3 * cfg.n_layers      # S, x_last; x_last (cmix)
    assert all(bool((leaf == 0).all()) for leaf in leaves)
    for leaf in leaves:
        leaf.normal_()
    uid, p, n = traffic[1]
    eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    (r,) = [r for r in eng.run() if r.uid == uid]
    np.testing.assert_array_equal(r.result, _solo(cfg, params, uid, p, n))


def test_paged_cache_keeps_recurrent_rows_per_slot(rwkv):
    """Recurrent states are one row per batch slot, not per block."""
    cfg, _, _, _ = rwkv
    paged = TransformerLM.init_paged_cache(cfg, batch=3, num_blocks=11,
                                           block_size=4, device=CPU)
    hd = cfg.rwkv_head_dim
    for layer in paged["layers"]:
        assert layer["mixer"]["S"].shape == (3, cfg.d_model // hd, hd, hd)
        assert layer["mixer"]["x_last"].shape == (3, cfg.d_model)
        assert layer["ffn"]["x_last"].shape == (3, cfg.d_model)


def test_cli_serves_rwkv_on_cpu(capsys):
    serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                "--requests", "3", "--new-tokens", "6", "--max-len", "48",
                "--block-size", "8"])
    assert "served 3 requests / 18 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("use_kernel", [False, True])
def test_bf16_engine_matches_solo_bitwise_on_both_routes(use_kernel):
    """In bfloat16 the plain scan rounds the state every step and the WKV
    op never does (it keeps the stored float32 state as it is), so on both
    routes the tokens do not depend on where the engine's prefill chunks
    and adaptive windows split the sequence: the engine equals the solo
    sampler (one prefill window, W = 8) bit for bit. With the state stored
    in bfloat16 the WKV op's route would round it at every split and part
    from the solo run."""
    cfg = dataclasses.replace(get_config("rwkv6-7b", reduced=True),
                              dtype="bfloat16")
    params = TransformerLM.init(cfg, seed=0, device=CPU)
    eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=96,
                        eps_key=3, block_size=4, prefill_chunk=8,
                        use_attention_kernel=use_kernel, device=CPU)
    rng = np.random.default_rng(0)
    traffic = [(i, rng.integers(0, cfg.vocab, size=int(rng.integers(10, 30))),
                40) for i in range(4)]
    for uid, p, n in traffic:
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    for r in eng.run():
        s = PredictiveSampler(cfg, params, window=8, max_len=96, eps_key=3,
                              device=CPU, use_attention_kernel=use_kernel)
        t, _ = s.generate(torch.as_tensor(r.prompt)[None], r.new_tokens,
                          seq_ids=torch.tensor([r.uid]))
        np.testing.assert_array_equal(
            r.result, t[0, :len(r.prompt) + r.new_tokens].numpy(),
            err_msg=f"request {r.uid}")


def test_bf16_model_scan_matches_jax_and_parts_from_float32():
    """The plain route in bfloat16 is the reference's bf16 model scan (one
    bf16 ulp apart at most); both part from the float32 recurrence (the
    kernels' plain version) by several percent of |y| over 256 steps with
    the model's decays, the rounding the WKV kernel avoids."""
    rng = np.random.default_rng(12)
    B, T, H, hd = 1, 256, 4, 64
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(-6 + 0.5 * rng.standard_normal((B, T, H, hd))))
    u = 0.5 * np.ones((H, hd), np.float32)
    ins = (r, k, v, w.astype(np.float32), u, np.zeros((B, H, hd, hd)))
    jy, _ = JaxTMix._wkv_scan(*(jnp.asarray(a, jnp.bfloat16) for a in ins))
    jy = np.asarray(jy.astype(jnp.float32))
    bf = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
          for a in ins]
    y, _ = RWKV6TimeMix._wkv_scan(*bf)
    y = y.float().numpy()
    np.testing.assert_allclose(y, jy, rtol=2.0 ** -7, atol=1e-3)
    y32 = rwkv_wkv(*bf[:5]).float().numpy()
    assert np.abs(jy - y32).mean() > 0.02 * np.abs(y32).mean()
