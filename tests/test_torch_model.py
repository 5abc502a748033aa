"""The port's layers, decoder and solo sampler against the JAX reference on
the reduced qwen3-1.7b in float32, with the reference's weights loaded
through ``params_from_numpy`` and inputs made with numpy from a seed.

Tolerances: single layers 1e-5 (float32 matmuls and transcendental
functions of two libraries round differently); decoder logits 1e-4 (the
same, through two layers); integer outputs (argmax, accept counts,
``row_stats``) bitwise under the same injected noise; token streams under
the margin rule with tolerance 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_pytree
from repro.configs import get_config as jax_get_config
from repro.engine.spec_decode import PredictiveSampler as JaxSampler
from repro.engine.spec_decode import make_eps_fn as jax_make_eps_fn
from repro.engine.spec_decode import verify_round as jax_verify_round
from repro.models.attention import GQAttention as JaxGQA
from repro.models.transformer import TransformerLM as JaxLM
from repro.nn.core import RMSNorm as JaxRMSNorm
from repro.nn.rope import apply_rope as jax_rope
from repro_torch.checkpoint.io import (load_pytree, params_from_numpy,
                                       params_to_numpy)
from repro_torch.configs import get_config
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler, verify_round
from repro_torch.models.attention import GQAttention
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.core import RMSNorm
from repro_torch.nn.rope import apply_rope

CPU = torch.device("cpu")
EPS_KEY = jax.random.PRNGKey(9)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen3-1.7b", reduced=True)
    jcfg = jax_get_config("qwen3-1.7b", reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, jparams, params_from_numpy(tree, cfg)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _jax_eps_for_port(vocab):
    jeps = jax.jit(jax_make_eps_fn(EPS_KEY, vocab))

    def eps_fn(seq_ids, positions):
        return _t(jeps(jnp.asarray(seq_ids.numpy(), jnp.int32),
                       jnp.asarray(positions.numpy(), jnp.int32)))
    return eps_fn


def test_checkpoint_reader_and_param_bridge_round_trip(qwen, tmp_path):
    cfg, _, jparams, params = qwen
    save_pytree(jparams, str(tmp_path), step=3)
    tree = load_pytree(str(tmp_path), 3)
    loaded = params_from_numpy(tree, cfg)
    assert len(loaded["layers"]) == cfg.n_layers
    back = params_to_numpy(loaded, cfg)
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
        assert torch.equal(a, b)


def test_rmsnorm_and_rope_match(qwen):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5))
    _close(RMSNorm.apply({"scale": _t(scale)}, _t(x)),
           JaxRMSNorm.apply({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           1e-5)
    _close(apply_rope(_t(x), _t(pos), 1e6),
           jax_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)


def _layer0(params, jparams):
    return (params["layers"][0]["mixer"],
            jax.tree.map(lambda a: a[0], jparams["blocks"][0]["mixer"]))


@pytest.mark.parametrize("window", [0, 5])
def test_gqa_window_matches(qwen, window):
    cfg, jcfg, jparams, params = qwen
    p, jp = _layer0(params, jparams)
    rng = np.random.default_rng(1)
    B, W, S = 2, 8, 32
    x = rng.standard_normal((B, W, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, S, cfg.n_kv_heads, cfg.head_dim)).astype(
        np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    cl = np.array([3, 20], np.int32)
    y, c = GQAttention.window(p, _t(x), cfg, {"k": _t(kc), "v": _t(vc)},
                              _t(cl), window=window)
    jy, jc = JaxGQA.window(jp, jnp.asarray(x), jcfg,
                           {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                           jnp.asarray(cl), window=window)
    _close(y, jy, 1e-5)
    _close(c["k"], jc["k"], 1e-5)
    _close(c["v"], jc["v"], 1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gqa_window_paged_matches(qwen, use_kernel):
    cfg, jcfg, jparams, params = qwen
    p, jp = _layer0(params, jparams)
    rng = np.random.default_rng(2)
    B, W, bs, nb = 2, 8, 4, 6
    P = 1 + B * nb
    x = rng.standard_normal((B, W, cfg.d_model)).astype(np.float32)
    shape = (P, bs, cfg.n_kv_heads, cfg.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    tables = (1 + np.arange(B * nb)).reshape(B, nb).astype(np.int32)
    cl = np.array([2, 13], np.int32)
    y, c = GQAttention.window_paged(
        p, _t(x), cfg, {"k": _t(kp), "v": _t(vp)}, _t(tables), _t(cl),
        use_kernel=use_kernel)
    jy, jc = JaxGQA.window_paged(
        jp, jnp.asarray(x), jcfg, {"k": jnp.asarray(kp),
                                   "v": jnp.asarray(vp)},
        jnp.asarray(tables), jnp.asarray(cl), use_kernel=use_kernel,
        interpret=True)
    _close(y, jy, 1e-5)
    _close(c["k"][1:], np.asarray(jc["k"])[1:], 1e-5)
    _close(c["v"][1:], np.asarray(jc["v"])[1:], 1e-5)


def test_decode_window_logits_match(qwen):
    cfg, jcfg, jparams, params = qwen
    rng = np.random.default_rng(3)
    B, L, W = 2, 9, 8
    toks = rng.integers(0, cfg.vocab, size=(B, L + W))
    cache = TransformerLM.init_cache(cfg, B, 32, device=CPU)
    jcache = JaxLM.init_cache(jcfg, B, 32)
    zero = np.zeros(B, np.int32)
    _, _, cache = TransformerLM.decode_window(params, cfg, _t(toks[:, :L]),
                                              cache, _t(zero))
    _, _, jcache = JaxLM.decode_window(jparams, jcfg,
                                       jnp.asarray(toks[:, :L]), jcache,
                                       jnp.asarray(zero))
    cl = np.full(B, L, np.int32)
    logits, h, _ = TransformerLM.decode_window(params, cfg, _t(toks[:, L:]),
                                               cache, _t(cl))
    jlogits, jh, _ = JaxLM.decode_window(jparams, jcfg,
                                         jnp.asarray(toks[:, L:]), jcache,
                                         jnp.asarray(cl))
    assert logits.shape == (B, W, cfg.vocab)
    _close(logits, jlogits, 1e-4)
    _close(h, jh, 1e-4)


@pytest.mark.parametrize("use_verify_kernel", [False, True])
def test_verify_round_row_stats_bitwise(qwen, use_verify_kernel):
    """One round from the same state under the same (JAX's) noise: the
    packed row stats, accepted tokens and next windows are equal."""
    cfg, jcfg, jparams, params = qwen
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab, size=(3, 6))
    s = PredictiveSampler(cfg, params, window=8, max_len=40,
                          eps_fn=_jax_eps_for_port(cfg.vocab), device=CPU)
    js = JaxSampler(jcfg, jparams, window=8, max_len=40, eps_key=EPS_KEY)
    st = s.init_state(prompts, 3)
    jst = js.init_state(jnp.asarray(prompts, jnp.int32), 3)
    target = np.array([10, 30, 6], np.int64)   # row 2 already done
    for _ in range(3):
        st, stats = verify_round(params, cfg, s.eps_fn, st, _t(target),
                                 use_verify_kernel=use_verify_kernel)
        jst, jstats = jax_verify_round(jparams, jcfg, js.eps_fn, jst,
                                       jnp.asarray(target, jnp.int32),
                                       use_verify_kernel=use_verify_kernel)
        np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))
        np.testing.assert_array_equal(st.tokens.numpy(),
                                      np.asarray(jst.tokens))
        np.testing.assert_array_equal(st.cand.numpy(), np.asarray(jst.cand))
        assert int(st.rounds) == int(jst.rounds)


def test_generate_matches_jax_under_margin_rule(qwen):
    cfg, jcfg, jparams, params = qwen
    rng = np.random.default_rng(5)
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
        if res is None:     # identical streams: identical call counts
            assert stats["per_seq_calls"][b] == jstats["per_seq_calls"][b]


def test_bf16_leaves_convert_exactly(tmp_path):
    """bf16 checkpoints (full-width configs): ml_dtypes arrays, and the raw
    2-byte records ``np.load`` returns for them, become the same bf16
    tensors."""
    import ml_dtypes

    from repro_torch.checkpoint.io import _to_tensor
    vals = np.random.default_rng(6).standard_normal((3, 5)).astype(
        np.float32)
    bf = vals.astype(ml_dtypes.bfloat16)
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert torch.equal(_to_tensor(bf, torch.bfloat16, None), want)
    np.savez(tmp_path / "a.npz", a0=bf)
    raw = np.load(tmp_path / "a.npz")["a0"]
    assert torch.equal(_to_tensor(raw, torch.bfloat16, None), want)
