"""The port's jamba-1.5-large-398b on the CPU: the hybrid stack (Mamba-1,
GQA attention, dense and MoE FFNs) against the JAX reference on the
reduced config cut to its first four layers ((mamba, dense), (mamba, moe),
(mamba, dense), (attn, moe); d_model 256, d_inner 512, 8 states, 4
experts, vocab 512) in float32, with the reference's weights saved by its
``save_pytree`` and loaded through the port's reader and
``params_from_numpy``; and the port's serving engine against its own solo
sampler.

Tolerances: decoder logits, hidden states and recurrent states 1e-4
(through four layers of float32 arithmetic of two libraries); the loss
1e-4 and its gradients 1e-4 of each leaf's largest plus 1e-4 relative;
integer results (tokens, accept counts, block tables) bitwise under the
same injected noise; token streams of whole generations under the margin
rule at 1e-4. Inside the port bitwise: the two-pass verify step against
the one-pass step, the engine against the solo sampler, in bfloat16 too.
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
from repro.launch.serve import make_serve_step as jax_make_serve_step
from repro.models.losses import lm_loss as jax_lm_loss
from repro.models.transformer import TransformerLM as JaxLM
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.checkpoint.io import (load_pytree, params_from_numpy,
                                       params_to_numpy, reference_tree,
                                       save_pytree, tree_from_numpy)
from repro_torch.configs import get_config
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler
from repro_torch.launch import serve
from repro_torch.models.losses import lm_loss
from repro_torch.models.transformer import (STATE_MODES, PagedView,
                                            TransformerLM, has_recurrent)
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten
from repro_torch.serving.admission import Request
from repro_torch.serving.engine import ServingEngine

ARCH = "jamba-1.5-large-398b"
CPU = torch.device("cpu")
EPS_SEED = 9
EPS_KEY = jax.random.PRNGKey(EPS_SEED)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's torch work on one thread, put back after it: its many
    small ops lose most of their time to the thread pool when the suite's
    workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cut(cfg):
    return dataclasses.replace(cfg, n_layers=4,
                               layer_block=cfg.layer_block[:4])


@pytest.fixture(scope="module")
def jamba(tmp_path_factory):
    """The reduced cut in both packages, the reference's weights through
    its own checkpoint files, and its jitted decode."""
    cfg = _cut(get_config(ARCH, reduced=True))
    jcfg = _cut(jax_get_config(ARCH, reduced=True))
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    d = tmp_path_factory.mktemp("jamba")
    jax_save_pytree(jparams, str(d), step=1)
    params = params_from_numpy(load_pytree(str(d), 1), cfg)
    jdecode = jax.jit(JaxLM.decode_window, static_argnums=(1, 5))
    return cfg, jcfg, jparams, params, jdecode


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _port_layers(cfg, tree):
    """A reference-layout cache tree (stacked blocks) as the port's one
    dict per layer."""
    layers = list(tree.get("prefix", []))
    for i in range(cfg.n_blocks):
        layers += [jax.tree.map(lambda a: a[i], b) for b in tree["blocks"]]
    layers += list(tree.get("suffix", []))
    return {"layers": tree_from_numpy(jax.tree.map(np.asarray, layers))}


def _rec_leaves(cfg, cache):
    """The recurrent leaves of a port cache tree, in layer order."""
    return [leaf for spec, c in zip(cfg.layer_specs(), cache["layers"])
            if spec[0] == "mamba" for leaf in (c["mixer"]["conv"],
                                               c["mixer"]["h"])]


def _jax_eps_for_port(vocab):
    jeps = jax.jit(jax_make_eps_fn(EPS_KEY, vocab))

    def eps_fn(seq_ids, positions):
        return _t(jeps(jnp.asarray(seq_ids.numpy(), jnp.int32),
                       jnp.asarray(positions.numpy(), jnp.int32)))
    return eps_fn


def _margin_fn(jcfg, jparams, uid, tokens):
    jeps = jax_make_eps_fn(EPS_KEY, jcfg.vocab)

    def margin_at(p):
        logits, _, _ = JaxLM.apply(jparams, jcfg,
                                   jnp.asarray(tokens[None, :p], jnp.int32))
        e = jeps(jnp.asarray([uid], jnp.int32), jnp.asarray([[p]], jnp.int32))
        return top2_margin(np.asarray(logits[0, -1] + e[0, 0]))
    return margin_at


# ---------------------------------------------------------------------------
# the config and the weight tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_the_reference(reduced):
    """Field for field, the 8-layer block included; the cut keeps whole
    blocks by cutting the block itself."""
    cfg, jcfg = get_config(ARCH, reduced), jax_get_config(ARCH, reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert len(cfg.layer_block) == 8 and has_recurrent(cfg)
    cut = _cut(cfg)
    assert cut.n_blocks == 1 and cut.layer_specs() == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("attn", "moe")]


def test_tree_round_trips_bitwise(jamba, tmp_path):
    """The reference's tree (Mamba's ``dt_proj`` bias and ``A_log``, the
    stacked ``blocks`` axis, the untied head) converts both ways and
    through either package's checkpoint files bitwise; the port's own init
    builds the same tree and shapes."""
    cfg, _, jparams, params, _ = jamba
    m = params["layers"][0]["mixer"]
    assert set(m["dt_proj"]) == {"w", "b"} and "b" not in m["in_proj"]
    want = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    save_pytree(reference_tree(params, cfg), str(tmp_path), step=1)
    loaded = params_from_numpy(load_pytree(str(tmp_path), 1), cfg)
    for a, b in zip(tree_leaves(loaded), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    mine = reference_tree(TransformerLM.init(cfg, seed=0, device=CPU), cfg)
    assert jax.tree.structure(jax.tree.map(lambda t: t.numpy(), mine)) == \
        jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_apply_matches(jamba):
    cfg, jcfg, jparams, params, _ = jamba
    tok = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 24))
    logits, h, aux = TransformerLM.apply(params, cfg, _t(tok))
    jl, jh, jaux = jax.jit(lambda p, t: JaxLM.apply(p, jcfg, t))(
        jparams, jnp.asarray(tok))
    _close(logits, jl, 1e-4)
    _close(h, jh, 1e-4)
    _close(aux, jaux, 1e-6)


def test_lm_loss_metrics_and_gradients_match(jamba):
    """Through every parameter, Mamba's included (T = 24: the per-step
    scan; ``test_torch_mamba.py`` holds the chunked one's gradient)."""
    cfg, jcfg, jparams, params, _ = jamba
    tok = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 24))
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = lm_loss(tree_unflatten(params, leaves), cfg, _t(tok))
    grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jax_lm_loss, has_aux=True), static_argnums=1)(
        jparams, jcfg, jnp.asarray(tok))
    _close(loss.detach(), jloss, 1e-4)
    assert sorted(metrics) == sorted(jm)
    for k in jm:
        _close(metrics[k].detach(), jm[k], 1e-4)
    got, want = (jax.tree.leaves(params_to_numpy(grads, cfg)),
                 jax.tree.leaves(jgrads))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-4 * max(float(np.abs(w).max()), 1e-12))
    m = grads["layers"][0]["mixer"]
    assert float(m["A_log"].abs().max()) > 0
    assert float(m["dt_proj"]["b"].abs().max()) > 0


def _prefilled(jamba, B=3, L=9):
    """Dense caches of both packages after a prompt prefill of L tokens."""
    cfg, jcfg, jparams, params, jdecode = jamba
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, size=(B, L))
    zero = np.zeros(B, np.int32)
    _, _, nc = TransformerLM.decode_window(
        params, cfg, _t(toks), TransformerLM.init_cache(cfg, B, 32,
                                                        device=CPU),
        _t(zero))
    _, _, jnc = jdecode(jparams, jcfg, jnp.asarray(toks),
                        JaxLM.init_cache(jcfg, B, 32), jnp.asarray(zero),
                        "per_position")
    full = np.full(B, L, np.int32)
    cache = TransformerLM.select_states(cfg, nc, _t(full))
    jcache = JaxLM.select_states(jcfg, jnc, jnp.asarray(full))
    return cache, jcache, rng


def test_decode_window_state_modes_match(jamba):
    """A window from prefilled caches in each state mode: the logits of
    every mode equal the per-position pass's bitwise and JAX's within
    1e-4; "per_position" states and, selected at per-row accept counts,
    JAX's; "none" hands back the cache's own states; "advance" gives JAX's
    advanced states and the port's own selected ones bitwise."""
    cfg, jcfg, jparams, params, jdecode = jamba
    cache, jcache, rng = _prefilled(jamba)
    assert STATE_MODES == ("per_position", "none", "advance")
    _close_tree = lambda a, b: [_close(x, y, 1e-4)  # noqa: E731
                                for x, y in zip(tree_leaves(a),
                                                tree_leaves(b))]
    _close_tree(cache, _port_layers(cfg, jcache))
    W = 8
    toks = rng.integers(0, cfg.vocab, size=(3, W))
    cl = np.full(3, 9, np.int32)
    acc = np.array([1, 5, 8], np.int64)
    out = {}
    for mode in STATE_MODES:
        a = _t(acc) if mode == "advance" else None
        out[mode] = TransformerLM.decode_window(params, cfg, _t(toks), cache,
                                                _t(cl), state_mode=mode,
                                                accept=a)
        jl, jh, jnc = jdecode(jparams, jcfg, jnp.asarray(toks), jcache,
                              jnp.asarray(cl), mode,
                              jnp.asarray(acc, jnp.int32)
                              if mode == "advance" else None)
        _close(out[mode][0], jl, 1e-4)
        _close(out[mode][1], jh, 1e-4)
        assert torch.equal(out[mode][0], out["per_position"][0]), mode
        if mode == "per_position":
            jsel = JaxLM.select_states(jcfg, jnc, jnp.asarray(acc, jnp.int32))
            sel = TransformerLM.select_states(cfg, out[mode][2], _t(acc))
            h = out[mode][2]["layers"][0]["mixer"]["h"]
            assert h.shape == (3, W, 2 * cfg.d_model, cfg.ssm_state)
            _close_tree(sel, _port_layers(cfg, jsel))
        elif mode == "none":
            for a, b in zip(_rec_leaves(cfg, out[mode][2]),
                            _rec_leaves(cfg, cache)):
                assert a is b
        else:
            got = _rec_leaves(cfg, out[mode][2])
            assert got[1].shape == (3, 2 * cfg.d_model, cfg.ssm_state)
            for a, b in zip(got, _rec_leaves(cfg, _port_layers(cfg, jnc))):
                _close(a, b, 1e-4)
            for a, b in zip(got, _rec_leaves(cfg, sel)):
                assert torch.equal(a, b)
    with pytest.raises(ValueError, match="accept"):
        TransformerLM.decode_window(params, cfg, _t(toks), cache, _t(cl),
                                    state_mode="advance")


@pytest.mark.parametrize("low_memory", [False, True])
def test_make_serve_step_matches_the_reference(jamba, low_memory):
    """Four fixed-point rounds of the verify step on the same prefilled
    caches, each window made of the last round's outputs (so the accept
    counts grow): out tokens and accept counts bitwise JAX's, the taken
    states within 1e-4; the port's two-pass step equals its one-pass step
    bitwise, tokens, accept counts and states."""
    cfg, jcfg, jparams, params, _ = jamba
    cache, jcache, rng = _prefilled(jamba)
    W = 8
    eps = rng.gumbel(size=(3, W, cfg.vocab)).astype(np.float32)
    cl = np.full(3, 9, np.int32)
    cand = rng.integers(0, cfg.vocab, size=(3, W))
    step = serve.make_serve_step(cfg, W, low_memory=low_memory)
    other = serve.make_serve_step(cfg, W, low_memory=not low_memory)
    jstep = jax.jit(jax_make_serve_step(jcfg, W, low_memory=low_memory))
    accepts = []
    for _ in range(4):
        out, acc, new = step(params, _t(cand), cache, _t(cl), _t(eps))
        jout, jacc, jnew = jstep(jparams, jnp.asarray(cand), jcache,
                                 jnp.asarray(cl), jnp.asarray(eps))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        for a, b in zip(_rec_leaves(cfg, new),
                        _rec_leaves(cfg, _port_layers(cfg, jnew))):
            _close(a, b, 1e-4)
        out2, acc2, new2 = other(params, _t(cand), cache, _t(cl), _t(eps))
        assert torch.equal(out2, out) and torch.equal(acc2, acc)
        for a, b in zip(_rec_leaves(cfg, new), _rec_leaves(cfg, new2)):
            assert torch.equal(a, b)
        accepts.append(acc.tolist())
        cand = np.concatenate([cand[:, :1], out.numpy()[:, :-1]], axis=1)
    assert max(accepts[-1]) > 1 and accepts[-1] != accepts[0]


def test_paged_cache_holds_pools_and_recurrent_rows():
    """One tree: the attention layer's block pools, and per-slot Mamba rows
    (float32 ``h``) that ``reset_rows`` zeroes and ``adopt_states_paged``
    writes in place."""
    cfg = _cut(get_config(ARCH, reduced=True))
    paged = TransformerLM.init_paged_cache(cfg, batch=3, num_blocks=11,
                                           block_size=4, device=CPU)
    DI = 2 * cfg.d_model
    for spec, c in zip(cfg.layer_specs(), paged["layers"]):
        if spec[0] == "attn":
            assert c["mixer"]["k"].shape == (11, 4, cfg.n_kv_heads,
                                             cfg.head_dim)
        else:
            assert c["mixer"]["conv"].shape == (3, 3, DI)
            assert c["mixer"]["h"].shape == (3, DI, cfg.ssm_state)
            assert c["mixer"]["h"].dtype == torch.float32
        assert "ffn" not in c
    leaves = _rec_leaves(cfg, paged)
    assert len(leaves) == 6
    for leaf in leaves:
        leaf.normal_()
    sel = {"layers": [{"mixer": {k: torch.full_like(v[:1], 2.0)
                                 for k, v in c["mixer"].items()}}
                      if s[0] == "mamba" else {}
                      for s, c in zip(cfg.layer_specs(), paged["layers"])]}
    TransformerLM.adopt_states_paged(cfg, paged, sel, torch.tensor([2]))
    TransformerLM.reset_rows(cfg, paged, 0)
    for leaf in leaves:
        assert bool((leaf[0] == 0).all()) and bool((leaf[2] == 2).all())
        assert not bool((leaf[1] == 0).all())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_generate_matches_jax(jamba):
    """Whole solo generations: tokens under the margin rule, and the same
    per-row call counts where the streams are equal."""
    cfg, jcfg, jparams, params, _ = jamba
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 7))
    s = PredictiveSampler(cfg, params, window=4, max_len=40,
                          eps_fn=_jax_eps_for_port(cfg.vocab), device=CPU)
    js = JaxSampler(jcfg, jparams, window=4, max_len=40, eps_key=EPS_KEY)
    toks, stats = s.generate(prompts, 16)
    jtoks, jstats = js.generate(jnp.asarray(prompts, jnp.int32), 16)
    for b in range(2):
        ref = np.asarray(jtoks[b, :23])
        res = check_token_agreement(ref, toks[b, :23].numpy(),
                                    _margin_fn(jcfg, jparams, b, ref),
                                    tol=1e-4, start=7)
        if res is None:
            assert stats["per_seq_calls"][b] == jstats["per_seq_calls"][b]


def _solo(cfg, params, uid, prompt, new, max_len=64):
    s = PredictiveSampler(cfg, params, window=8, max_len=max_len,
                          eps_key=EPS_SEED, device=CPU)
    t, _ = s.generate(torch.as_tensor(prompt)[None], new,
                      seq_ids=torch.tensor([uid]))
    return t[0, :len(prompt) + new].numpy()


def test_engine_matches_port_solo_bitwise(jamba):
    """Five ragged requests through two slots (chunked prefill, slot
    reuse, mid-flight admission, an adaptive window): every request equals
    its solo run bit for bit. The prefix cache was asked for and is off for
    the hybrid stack (a hit would skip the Mamba states' prefill)."""
    cfg, _, _, params, _ = jamba
    eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=64,
                        eps_key=EPS_SEED, block_size=4, prefix_cache=True,
                        prefill_chunk=8, device=CPU)
    assert not eng.kv_prefix
    rng = np.random.default_rng(8)
    shared = rng.integers(0, cfg.vocab, size=9)
    traffic = [(i, np.concatenate([shared, rng.integers(
        0, cfg.vocab, size=int(rng.integers(2, 14)))]) if i % 2 else
        rng.integers(0, cfg.vocab, size=int(rng.integers(2, 20))),
        int(rng.integers(6, 13))) for i in range(5)]
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
    assert eng.export_metrics()["prefix_hits"] == 0


def test_engine_matches_jax_engine(jamba):
    """The reference's jamba serving case in one batch of two requests:
    both engines in lockstep with JAX's noise injected into the port (its
    prefix cache and host tier off, as the port's), block tables and host
    state bitwise at every step, tokens under the margin rule at 1e-4."""
    cfg, jcfg, jparams, params, _ = jamba
    kw = dict(batch=2, window_max=4, max_len=48, block_size=4,
              adaptive=False)
    eng = ServingEngine(cfg, params, eps_fn=_jax_eps_for_port(cfg.vocab),
                        device=CPU, **kw)
    jeng = JaxEngine(jcfg, jparams, eps_key=EPS_KEY, host_cache_mb=0, **kw)
    rng = np.random.default_rng(13)
    for i in range(2):
        p = rng.integers(0, cfg.vocab, size=int(rng.integers(2, 7)))
        n = int(rng.integers(8, 12))
        eng.submit(Request(uid=i, prompt=p, new_tokens=n))
        jeng.submit(JaxRequest(uid=i, prompt=p, new_tokens=n))
    while True:
        more, jmore = eng.step(), jeng.step()
        assert more == jmore
        np.testing.assert_array_equal(eng.tables, jeng.tables)
        np.testing.assert_array_equal(eng.n_host, jeng.n_host)
        if not more:
            break
    got = {r.uid: r for r in eng.done}
    assert sorted(got) == sorted(r.uid for r in jeng.done) == [0, 1]
    for jr in jeng.done:
        r = got[jr.uid]
        assert (r.calls_used, r.prefill_calls) == (jr.calls_used,
                                                   jr.prefill_calls)
        check_token_agreement(jr.result, r.result,
                              _margin_fn(jcfg, jparams, jr.uid, jr.result),
                              tol=1e-4, start=len(jr.prompt))


def test_bf16_engine_matches_solo_bitwise():
    """In bfloat16, on a 2-layer (mamba, dense) + (attn, dense) cut: the
    engine's prefill chunks and adaptive windows split each sequence
    elsewhere than the solo sampler's one prefill window and W = 8 rounds,
    and its tokens still equal the solo run's bit for bit, because the
    Mamba state is stored in float32 between windows
    (``test_torch_mamba.py::test_bf16_state_storage_is_what_keeps_splits_
    exact``)."""
    cfg = dataclasses.replace(
        get_config(ARCH, reduced=True), n_layers=2, dtype="bfloat16",
        layer_block=(("mamba", "dense"), ("attn", "dense")))
    params = TransformerLM.init(cfg, seed=0, device=CPU)
    eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=64,
                        eps_key=3, block_size=4, prefill_chunk=8, device=CPU)
    rng = np.random.default_rng(0)
    traffic = [(i, rng.integers(0, cfg.vocab, size=int(rng.integers(14, 30))),
                16) for i in range(2)]
    for uid, p, n in traffic:
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    done = eng.run()
    assert len(done) == 2 and eng.export_metrics()["prefill_calls"] > 2
    for r in done:
        s = PredictiveSampler(cfg, params, window=8, max_len=64, eps_key=3,
                              device=CPU)
        t, _ = s.generate(torch.as_tensor(r.prompt)[None], r.new_tokens,
                          seq_ids=torch.tensor([r.uid]))
        np.testing.assert_array_equal(
            r.result, t[0, :len(r.prompt) + r.new_tokens].numpy(),
            err_msg=f"request {r.uid}")


def test_decode_window_paged_matches_dense(jamba):
    """The paged decode over random pools and recurrent rows, in each state
    mode, against the dense decode over the gathered view: logits and the
    recurrent entries bitwise."""
    cfg, _, _, params, _ = jamba
    B, W, bs, nb = 2, 8, 4, 6
    rng = np.random.default_rng(7)
    paged = TransformerLM.init_paged_cache(cfg, B + 1, 1 + B * nb, bs,
                                           device=CPU)
    for leaf in tree_leaves(paged):
        leaf.copy_(0.1 * torch.from_numpy(rng.standard_normal(
            tuple(leaf.shape)).astype(np.float32)))
    tables = _t((1 + rng.permutation(B * nb)).reshape(B, nb).astype(
        np.int32))
    rows = torch.tensor([2, 0])
    cl = _t(np.array([3, 13], np.int32))
    toks = _t(rng.integers(0, cfg.vocab, size=(B, W)))
    acc = torch.tensor([3, 6])
    for mode in STATE_MODES:
        a = acc if mode == "advance" else None
        pool = tree_unflatten(paged, [t.clone() for t in tree_leaves(paged)])
        dense = {"layers": [
            {"mixer": ({k: v[rows] for k, v in c["mixer"].items()}
                       if s[0] == "mamba" else
                       {k: v[tables].flatten(1, 2)
                        for k, v in c["mixer"].items()})}
            for s, c in zip(cfg.layer_specs(), paged["layers"])]}
        lg, _, new = TransformerLM.decode_window_paged(
            params, cfg, toks, pool, PagedView(tables, rows), cl,
            state_mode=mode, accept=a)
        dlg, _, dnew = TransformerLM.decode_window(
            params, cfg, toks, dense, cl.long(), state_mode=mode, accept=a)
        assert torch.equal(lg, dlg), mode
        for x, y in zip(_rec_leaves(cfg, new), _rec_leaves(cfg, dnew)):
            assert torch.equal(x, y), mode


def test_cli_serves_jamba_on_cpu(capsys):
    """The whole reduced config (8 layers, one jamba block)."""
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "2", "--new-tokens", "5", "--max-len", "32",
                "--block-size", "8"])
    assert "served 2 requests / 10 tokens" in capsys.readouterr().out
