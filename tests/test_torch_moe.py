"""The port's mixture-of-experts layer against the JAX reference, on the CPU:
routing, the load-balancing loss, the capacity dispatch, the whole decoder,
its loss and gradients, the verify-window decode (dense and paged), and
serving, on reduced deepseek-v3-671b (layers (mla, dense) + (mla, moe),
E = 4, top-2, sigmoid scores, 1 shared expert) and reduced dbrx-132b
((attn, moe) x 2, E = 4, top-2, softmax), float32, and dbrx in bfloat16.
The reference's weights go through ``save_pytree``, the port's numpy reader
and ``params_from_numpy``; inputs are made with numpy from a seed.

Tolerances: integer results bitwise (expert ids, planted ties included,
and the capacity keep masks); router weights, probabilities and the aux
loss 1e-6 (float32 exp and division in two libraries); the MoE output
1e-5 in float32; in bfloat16 4 bf16 ulps of the value plus 1e-3 (every
bf16 product is rounded once on each side from float32 sums taken in
another order, and the reference's own jitted and eager forms part by one
ulp); decoder logits 1e-4 (through two layers); the loss and its
gradients as ``test_torch_train.py`` holds them (1e-4; gradients 1e-4 of
the leaf's largest plus 1e-4 relative); served tokens bitwise against the
port's solo sampler, and against JAX's solo sampler under the margin rule
at 1e-4. A token's no-drop MoE output is bitwise the same whatever the
other tokens of its batch and window are.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_pytree
from repro.configs import get_config as jax_get_config
from repro.engine.spec_decode import PredictiveSampler as JaxSampler
from repro.models.losses import lm_loss as jax_lm_loss
from repro.models.moe import MoE as JaxMoE
from repro.models.moe import _mlp_apply as jax_mlp_apply
from repro.models.moe import _mlp_init as jax_mlp_init
from repro.models.transformer import PagedView as JaxPagedView
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.checkpoint.io import (load_pytree, params_from_numpy,
                                       params_to_numpy, reference_tree,
                                       tree_from_numpy)
from repro_torch.configs import get_config
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler, make_eps_fn
from repro_torch.launch import serve as serve_cli
from repro_torch.models.losses import lm_loss
from repro_torch.models.moe import MoE, _mlp_apply, top_k
from repro_torch.models.transformer import PagedView, TransformerLM
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten
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
EPS_SEED = 9
ARCHS = ("deepseek-v3-671b", "dbrx-132b")


def _models(tmp_path_factory, arch, dtype="float32"):
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype=dtype)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    d = tmp_path_factory.mktemp(arch + dtype)
    save_pytree(jparams, str(d), step=1)
    return cfg, jcfg, jparams, params_from_numpy(load_pytree(str(d), 1), cfg)


@pytest.fixture(scope="module")
def deepseek(tmp_path_factory):
    return _models(tmp_path_factory, "deepseek-v3-671b")


@pytest.fixture(scope="module")
def dbrx(tmp_path_factory):
    return _models(tmp_path_factory, "dbrx-132b")


@pytest.fixture(scope="module")
def dbrx_bf16(tmp_path_factory):
    return _models(tmp_path_factory, "dbrx-132b", "bfloat16")


@pytest.fixture(params=["deepseek", "dbrx"])
def model(request):
    return request.getfixturevalue(request.param)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _moe_layer(params, jparams, cfg):
    """The first MoE layer's parameters in both trees."""
    i = next(i for i, s in enumerate(cfg.layer_specs()) if s[1] == "moe")
    if i < len(cfg.layer_prefix):
        return params["layers"][i]["ffn"], jparams["prefix"][i]["ffn"]
    j = (i - len(cfg.layer_prefix)) % len(cfg.layer_block)
    blk = (i - len(cfg.layer_prefix)) // len(cfg.layer_block)
    return (params["layers"][i]["ffn"],
            jax.tree.map(lambda a: a[blk], jparams["blocks"][j]["ffn"]))


def _x(cfg, shape, seed):
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return (torch.from_numpy(x).to(cfg.param_dtype),
            jnp.asarray(x).astype(cfg.dtype))


def _jax_keep(ids, C):
    """The reference's keep mask, by the lines of its ``MoE.apply``."""
    ids_flat = ids.reshape(-1)
    ids_s = ids_flat[jnp.argsort(ids_flat)]
    first = jnp.searchsorted(ids_s, ids_s, side="left")
    return jnp.arange(ids_flat.shape[0]) - first < C


# ---------------------------------------------------------------------------
# routing and the layer
# ---------------------------------------------------------------------------

def test_top_k_ties_go_to_the_lower_index():
    """Scores on a coarse grid (many exact ties, at the k boundary too):
    the same values and indices as ``jax.lax.top_k``."""
    rng = np.random.default_rng(0)
    for E, k in ((256, 8), (16, 4), (4, 2)):
        s = rng.integers(0, 5, size=(64, E)).astype(np.float32) / 4
        s[0] = 0.5                                 # one row all tied
        w, ids = top_k(_t(s), k)
        jw, jids = jax.lax.top_k(jnp.asarray(s), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        assert ids[0].tolist() == list(range(k))


@pytest.mark.parametrize("tie", [False, True])
def test_route_matches(model, tie):
    """``tie``: the router's columns 1 and 2 made equal in both trees, so
    those two experts score equal on every token."""
    cfg, jcfg, jparams, params = model
    p, jp = _moe_layer(params, jparams, cfg)
    if tie:
        w = jp["router"]["w"].at[:, 2].set(jp["router"]["w"][:, 1])
        jp = dict(jp, router={"w": w})
        p = dict(p, router={"w": _t(w)})
    x, jx = _x(cfg, (40,), 1)
    ids, wts, probs = MoE.route(p, x, cfg)
    jids, jw, jprobs = JaxMoE.route(jp, jx, jcfg)
    if tie:
        assert bool((probs[:, 1] == probs[:, 2]).all())
        has1, has2 = (ids == 1).any(-1), (ids == 2).any(-1)
        assert bool((has1 & ~has2).any())       # the tie decided a slot,
        assert not bool((has2 & ~has1).any())   # always for the lower index
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(wts, jw, 1e-6)
    _close(probs, jprobs, 1e-6)
    aux = MoE.load_balance_loss(probs, ids, cfg)
    _close(aux, JaxMoE.load_balance_loss(jprobs, jids, jcfg), 1e-6)
    # on the same inputs, the loss itself
    _close(MoE.load_balance_loss(_t(jprobs), _t(jids), cfg),
           JaxMoE.load_balance_loss(jprobs, jids, jcfg), 1e-6)


@pytest.mark.parametrize("cf", [None, 1.25, 0.5])
def test_apply_matches(model, cf):
    cfg, jcfg, jparams, params = model
    p, jp = _moe_layer(params, jparams, cfg)
    x, jx = _x(cfg, (2, 24), 2)
    y, aux = MoE.apply(p, x, cfg, capacity_factor=cf)
    jy, jaux = JaxMoE.apply(jp, jx, jcfg, capacity_factor=cf)
    _close(y, jy, 1e-5)
    _close(aux, jaux, 1e-6)
    ids, _, _ = MoE.route(p, x.reshape(-1, cfg.d_model), cfg)
    jids, _, _ = JaxMoE.route(jp, jx.reshape(-1, cfg.d_model), jcfg)
    N = x.shape[0] * x.shape[1]
    C = MoE.capacity(N, cfg, cf)
    _, _, _, keep = MoE.plan(ids, C)
    jkeep = _jax_keep(jids, C)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if cf is None:
        assert bool(keep.all())                     # no-drop
    if cf == 0.5:
        assert not bool(keep.all())                 # drops


def test_apply_matches_in_bf16(dbrx_bf16):
    cfg, jcfg, jparams, params = dbrx_bf16
    p, jp = _moe_layer(params, jparams, cfg)
    x, jx = _x(cfg, (2, 24), 3)
    for cf in (None, 0.5):
        y, aux = MoE.apply(p, x, cfg, capacity_factor=cf)
        jy, jaux = JaxMoE.apply(jp, jx, jcfg, capacity_factor=cf)
        assert y.dtype == torch.bfloat16
        want = _np(jy)
        err = np.abs(_np(y) - want)
        assert (err <= 4 * 2.0 ** -8 * np.abs(want) + 1e-3).all(), err.max()
        _close(aux, jaux, 1e-6)
        ids, _, _ = MoE.route(p, x.reshape(-1, cfg.d_model), cfg)
        jids, _, _ = JaxMoE.route(jp, jx.reshape(-1, cfg.d_model), jcfg)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        C = MoE.capacity(48, cfg, cf)
        np.testing.assert_array_equal(MoE.plan(ids, C)[3].numpy(),
                                      np.asarray(_jax_keep(jids, C)))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply_matches(kind):
    jp = jax_mlp_init(jax.random.PRNGKey(3), 64, 96, kind, jnp.float32)
    p = tree_from_numpy(jax.tree.map(np.asarray, jp))
    assert sorted(p) == sorted(jp)
    x = np.random.default_rng(4).standard_normal((5, 64)).astype(np.float32)
    _close(_mlp_apply(p, _t(x), kind), jax_mlp_apply(jp, jnp.asarray(x),
                                                     kind), 1e-5)


@pytest.mark.parametrize("name", ["deepseek", "dbrx", "dbrx_bf16"])
def test_no_drop_output_depends_on_its_own_token_only(request, name):
    """At capacity None, change every other token of the batch and the
    window: each kept token's output is bitwise the same."""
    cfg, _, jparams, params = request.getfixturevalue(name)
    p, _ = _moe_layer(params, jparams, cfg)
    x, _ = _x(cfg, (2, 8), 5)
    y, _ = MoE.apply(p, x, cfg, capacity_factor=None)
    for seed, (b, w) in ((6, (0, 0)), (7, (1, 5)), (8, (0, 7))):
        other, _ = _x(cfg, (2, 8), seed)
        other[b, w] = x[b, w]
        y2, _ = MoE.apply(p, other, cfg, capacity_factor=None)
        assert torch.equal(y2[b, w], y[b, w])
        assert not torch.equal(y2, y)


# ---------------------------------------------------------------------------
# the decoder, the loss and the checkpoint tree
# ---------------------------------------------------------------------------

def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def test_apply_logits_match(model):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 24)
    for cap in (None, 1.25):
        logits, h, aux = TransformerLM.apply(params, cfg, _t(tok),
                                             moe_capacity=cap)
        jl, jh, jaux = jax.jit(lambda p, t, cap=cap: JaxLM.apply(
            p, jcfg, t, moe_capacity=cap))(jparams, jnp.asarray(tok))
        _close(logits, jl, 1e-4)
        _close(h, jh, 1e-4)
        _close(aux, jaux, 1e-6)
        assert float(aux) > 0
    logits_r, _, aux_r = TransformerLM.apply(params, cfg, _t(tok),
                                             moe_capacity=1.25, remat=True)
    assert torch.equal(logits_r, TransformerLM.apply(
        params, cfg, _t(tok), moe_capacity=1.25)[0])
    assert torch.equal(aux_r, aux)


def test_lm_loss_metrics_and_gradients_match(model):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 24, seed=5)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = lm_loss(tree_unflatten(params, leaves), cfg, _t(tok))
    grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jax_lm_loss, has_aux=True), static_argnums=1)(
        jparams, jcfg, jnp.asarray(tok))
    assert sorted(metrics) == sorted(jm)
    for k in jm:
        _close(metrics[k].detach(), jm[k], 1e-4)
    assert float(metrics["moe_aux"].detach()) > 0
    got, want = (jax.tree.leaves(params_to_numpy(grads, cfg)),
                 jax.tree.leaves(jgrads))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-4 * max(float(np.abs(w).max()), 1e-12))
    # the expert stacks and the router get gradients
    router = _moe_layer(grads, jgrads, cfg)[0]
    assert float(router["router"]["w"].abs().max()) > 0
    assert float(router["experts"]["down"].abs().max()) > 0


def test_moe_tree_round_trips_bitwise(model):
    """``reference_tree`` of the port's parameters is the reference's tree
    (the (n_blocks, E, D, F) expert stacks included), and
    ``params_from_numpy`` of it gives the same tensors back."""
    cfg, _, jparams, params = model
    ref = reference_tree(params, cfg)
    assert jax.tree.structure(jax.tree.map(np.asarray, jparams)) == \
        jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    e = ref["blocks"][-1]["ffn"]["experts"]
    assert e["up"].shape == (cfg.n_blocks, cfg.n_experts, cfg.d_model,
                             cfg.moe_d_ff)
    back = params_from_numpy(jax.tree.map(lambda t: t.numpy(), ref), cfg)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the port's own init builds the same tree and shapes
    mine = reference_tree(TransformerLM.init(cfg, seed=0, device=CPU), cfg)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        assert a.shape == b.shape


# ---------------------------------------------------------------------------
# the verify window, dense and paged
# ---------------------------------------------------------------------------

def test_decode_window_logits_match(model):
    cfg, jcfg, jparams, params = model
    rng = np.random.default_rng(3)
    B, L, W = 2, 9, 8
    toks = rng.integers(0, cfg.vocab, size=(B, L + W))
    cache = TransformerLM.init_cache(cfg, B, 32, device=CPU)
    jcache = JaxLM.init_cache(jcfg, B, 32)
    zero = np.zeros(B, np.int32)
    jdecode = jax.jit(JaxLM.decode_window, static_argnums=1)
    _, _, cache = TransformerLM.decode_window(params, cfg, _t(toks[:, :L]),
                                              cache, _t(zero))
    _, _, jcache = jdecode(jparams, jcfg, jnp.asarray(toks[:, :L]), jcache,
                           jnp.asarray(zero))
    cl = np.full(B, L, np.int32)
    logits, h, _ = TransformerLM.decode_window(params, cfg, _t(toks[:, L:]),
                                               cache, _t(cl))
    jlogits, jh, _ = jdecode(jparams, jcfg, jnp.asarray(toks[:, L:]), jcache,
                             jnp.asarray(cl))
    _close(logits, jlogits, 1e-4)
    _close(h, jh, 1e-4)


def _port_layers(cfg, tree):
    """A reference-layout cache tree (prefix, stacked blocks, suffix) as
    the port's one dict per layer."""
    layers = list(tree.get("prefix", []))
    for i in range(cfg.n_blocks):
        layers += [jax.tree.map(lambda a: a[i], b) for b in tree["blocks"]]
    layers += list(tree.get("suffix", []))
    return {"layers": tree_from_numpy(jax.tree.map(np.asarray, layers))}


def test_decode_window_paged_matches(model):
    """Over random pools through block tables (the gather fallback; the
    kernels' plain versions behind ``use_kernel`` are held by
    ``test_torch_kernels.py``)."""
    cfg, jcfg, jparams, params = model
    B, W, bs, nb = 2, 8, 4, 6
    P = 1 + B * nb
    jpaged = JaxLM.init_paged_cache(jcfg, B, P, bs)
    leaves, treedef = jax.tree.flatten(jpaged)
    rng = np.random.default_rng(7)
    jpaged = jax.tree.unflatten(treedef, [
        jnp.asarray(0.1 * rng.standard_normal(l.shape), l.dtype)
        for l in leaves])
    paged = _port_layers(cfg, jpaged)
    tables = (1 + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
    cl = np.array([3, 13], np.int32)
    toks = rng.integers(0, cfg.vocab, size=(B, W))
    logits, _, new = TransformerLM.decode_window_paged(
        params, cfg, _t(toks), paged, PagedView(_t(tables), torch.arange(B)),
        _t(cl))
    jlogits, _, jnew = jax.jit(
        lambda p, t, c, tab, n: JaxLM.decode_window_paged(
            p, jcfg, t, c, JaxPagedView(tab, jnp.arange(B)), n))(
        jparams, jnp.asarray(toks), jpaged, jnp.asarray(tables),
        jnp.asarray(cl))
    _close(logits, jlogits, 1e-4)
    for a, b in zip(tree_leaves(new), tree_leaves(_port_layers(cfg, jnew))):
        _close(a[1:], b[1:], 1e-5)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _traffic(cfg):
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab, size=9)
    return [(0, rng.integers(0, cfg.vocab, size=3), 9),
            (1, np.concatenate([shared, rng.integers(0, cfg.vocab, 4)]), 7),
            (2, np.concatenate([shared, rng.integers(0, cfg.vocab, 2)]), 10)]


@pytest.mark.parametrize("name,heads", [("deepseek", False),
                                        ("deepseek", True), ("dbrx", False)])
def test_engine_matches_port_solo_bitwise_and_jax_under_margin(
        request, name, heads):
    """Ragged prompts, slot reuse, prefix hits and chunked prefill: every
    request equals the port's solo run bit for bit, and JAX's solo run
    wherever JAX's top-2 margin exceeds 1e-4."""
    cfg, jcfg, jparams, params = request.getfixturevalue(name)
    eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=64,
                        eps_key=EPS_SEED, block_size=4,
                        use_forecast_heads=heads, device=CPU)
    for uid, p, n in _traffic(cfg):
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    done = eng.run()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    jeps = JaxSampler(jcfg, jparams, eps_key=jax.random.PRNGKey(EPS_SEED))
    for r in done:
        assert r.ok
        end = len(r.prompt) + r.new_tokens
        s = PredictiveSampler(cfg, params, window=8, max_len=64,
                              eps_key=EPS_SEED, use_forecast_heads=heads,
                              device=CPU)
        t, _ = s.generate(torch.as_tensor(r.prompt)[None], r.new_tokens,
                          seq_ids=torch.tensor([r.uid]))
        np.testing.assert_array_equal(r.result, t[0, :end].numpy(),
                                      err_msg=f"request {r.uid}")
        if heads or r.uid != 1:
            continue               # one JAX solo run per config: its cost
        js = JaxSampler(jcfg, jparams, window=8, max_len=64,
                        eps_key=jax.random.PRNGKey(EPS_SEED))
        jt, _ = js.generate(jnp.asarray(r.prompt, jnp.int32)[None],
                            r.new_tokens,
                            seq_ids=jnp.asarray([r.uid], jnp.int32))
        ref = np.asarray(jt[0, :end])

        def margin_at(p, ref=ref, uid=r.uid):
            logits, _, _ = JaxLM.apply(jparams, jcfg,
                                       jnp.asarray(ref[None, :p], jnp.int32))
            e = jeps.eps_fn(jnp.asarray([uid], jnp.int32),
                            jnp.asarray([[p]], jnp.int32))
            return top2_margin(np.asarray(logits[0, -1] + e[0, 0]))
        check_token_agreement(ref, r.result, margin_at, tol=1e-4,
                              start=len(r.prompt))
    assert eng.export_metrics()["prefix_hits"] >= 1
    assert eng.pool.blocks_in_use() == 0


def test_bf16_engine_matches_port_solo_bitwise(dbrx_bf16):
    cfg, _, _, params = dbrx_bf16
    eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=64,
                        eps_key=EPS_SEED, block_size=4, device=CPU)
    for uid, p, n in _traffic(cfg)[:2]:
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    for r in eng.run():
        s = PredictiveSampler(cfg, params, window=8, max_len=64,
                              eps_key=EPS_SEED, device=CPU)
        t, _ = s.generate(torch.as_tensor(r.prompt)[None], r.new_tokens,
                          seq_ids=torch.tensor([r.uid]))
        np.testing.assert_array_equal(
            r.result, t[0, :len(r.prompt) + r.new_tokens].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--requests", "1", "--new-tokens", "4", "--max-len",
                    "32"])
    out = capsys.readouterr().out
    assert "served 1 requests / 4 tokens" in out


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_route_log_keeps_the_routing_that_chose_each_token(model):
    """``chip_smoke.py``'s record of a served run's MoE routing by
    (sequence, position): it covers every position whose logits chose a
    token, equals the routing of one window recomputing the stream (in
    float32 no router tie here lies within a rounding), and a record one
    position off is told apart. ``routing_check`` then finds no routing
    difference and the served last token; with one expert set planted
    at position p - 1 it finds that position alone, and the logits that
    choose token p move."""
    cs = _chip_smoke()
    cfg, _, _, params = model
    eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=64,
                        eps_key=1, block_size=4, device=CPU)
    rng = np.random.default_rng(11)
    for uid, L, n in ((0, 6, 9), (1, 11, 7), (2, 3, 10)):
        eng.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab, L),
                           new_tokens=n))
    with cs.RouteLog() as log:
        done = eng.run()
    eps_fn = make_eps_fn(1, cfg.vocab)
    for r in done:
        p = len(r.result) - 1
        got = log.routes(r.seq_id, r.result)
        assert set(range(p)) <= set(got)
        chk = cs.routing_check(cfg, params, CPU, eps_fn, r.result, r.seq_id,
                               got)
        assert chk["routing_differs_at"] == []
        assert chk["pinned_token"] == int(r.result[p])
        shifted = {q: got[q + 1] for q in range(p - 1)}
        assert cs.routing_check(cfg, params, CPU, eps_fn, r.result[:p],
                                r.seq_id, shifted)["routing_differs_at"]
        planted = dict(got)
        planted[p - 1] = got[p - 1].clone()
        planted[p - 1][0] = (planted[p - 1][0] + 1) % cfg.n_experts
        moved = cs.routing_check(cfg, params, CPU, eps_fn, r.result,
                                 r.seq_id, planted)
        assert moved["routing_differs_at"] == [p - 1]
        assert moved["pinned_margin"] != chk["pinned_margin"]
