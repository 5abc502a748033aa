"""The remaining dense configs of the port against the JAX reference, on the
CPU: gemma3-1b (5 ``local`` sliding-window layers to 1 global, geglu,
``embed_scale``, qk-norm, tied embeddings), gemma-2b (MQA, geglu,
``embed_scale``) and mistral-large-123b (GQA, swiglu, untied head), at
their reduced widths in float32, plus a gemma3 layout with the full
config's 6-layer block and its 2-layer ``local`` suffix at reduced widths
(8 layers). The reference's weights go through ``save_pytree``, the port's
numpy reader and ``params_from_numpy``; inputs are made with numpy from a
seed. Sequences run past the reduced sliding window of 16, so the window
hides keys on the ``local`` layers.

Tolerances: the configs, the shapes and the weight trees equal the
reference's exactly; decoder logits 1e-4 (float32 through up to 8 layers,
sums in another order); the loss and its gradients as
``test_torch_train.py`` holds them (1e-4; gradients 1e-4 of the leaf's
largest plus 1e-4 relative); the dense and paged decode windows 1e-4, the
pools written by them 1e-5; served tokens bitwise against the port's solo
sampler, and against JAX's solo sampler under the margin rule at 1e-4.
The bf16 ``embed_scale`` normaliser at gemma3-1b's d_model of 1152 and the
embeddings it scales are bitwise the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_pytree
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs import shape_applicable as jax_shape_applicable
from repro.engine.spec_decode import PredictiveSampler as JaxSampler
from repro.models.losses import lm_loss as jax_lm_loss
from repro.models.transformer import PagedView as JaxPagedView
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.checkpoint.io import (load_pytree, params_from_numpy,
                                       params_to_numpy, reference_tree,
                                       tree_from_numpy)
from repro_torch.configs import (SHAPES, get_config, list_archs,
                                 shape_applicable)
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.losses import lm_loss
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
ARCHS = ("gemma3-1b", "gemma-2b", "mistral-large-123b")
# the reduced configs, and gemma3's full layout (block + suffix) at their
# widths
MODELS = ARCHS + ("gemma3-1b-suffix",)


def _cfg(get, name):
    arch = name.removesuffix("-suffix")
    cfg = get(arch, reduced=True)
    if name.endswith("-suffix"):
        full = get(arch)
        cfg = dataclasses.replace(cfg, n_layers=8,
                                  layer_block=full.layer_block,
                                  layer_suffix=full.layer_suffix)
    return cfg


@pytest.fixture(scope="module", params=MODELS)
def model(request, tmp_path_factory):
    cfg, jcfg = _cfg(get_config, request.param), _cfg(jax_get_config,
                                                      request.param)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    d = tmp_path_factory.mktemp(request.param)
    save_pytree(jparams, str(d), step=1)
    return cfg, jcfg, jparams, params_from_numpy(load_pytree(str(d), 1), cfg)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, reduced):
    cfg, jcfg = get_config(arch, reduced), jax_get_config(arch, reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.layer_specs() == jcfg.layer_specs()
    assert cfg.n_blocks == jcfg.n_blocks


def test_gemma3_layout_has_its_window_and_suffix():
    cfg = get_config("gemma3-1b")
    specs = [m for m, _ in cfg.layer_specs()]
    assert len(specs) == 26 and specs.count("attn") == 4
    assert specs[-2:] == ["local", "local"] and cfg.sliding_window == 512
    assert cfg.n_blocks == 4 and cfg.head_dim == 256


def test_shapes_and_arch_list_equal_reference():
    assert list_archs() == jax_list_archs()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for arch in list_archs():
        for shape in SHAPES:
            assert shape_applicable(arch, shape) == jax_shape_applicable(
                arch, shape)


# ---------------------------------------------------------------------------
# the weight bridge and the whole-sequence forward
# ---------------------------------------------------------------------------

def test_tree_round_trips_bitwise(model):
    """``reference_tree`` of the port's parameters is the reference's tree
    (the stacked blocks, and the suffix where the layout has one), and
    ``params_from_numpy`` of it gives the same tensors back."""
    cfg, _, jparams, params = model
    ref = reference_tree(params, cfg)
    assert jax.tree.structure(jax.tree.map(np.asarray, jparams)) == \
        jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len(ref.get("suffix", [])) == len(cfg.layer_suffix)
    back = params_from_numpy(jax.tree.map(lambda t: t.numpy(), ref), cfg)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    mine = reference_tree(TransformerLM.init(cfg, seed=0, device=CPU), cfg)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        assert a.shape == b.shape


def test_apply_logits_match(model):
    """40 positions: the last 24 of each sequence lose keys to the reduced
    window of 16 on the ``local`` layers."""
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 40)
    logits, h, _ = TransformerLM.apply(params, cfg, _t(tok))
    jl, jh, _ = jax.jit(lambda p, t: JaxLM.apply(p, jcfg, t))(
        jparams, jnp.asarray(tok))
    _close(logits, jl, 1e-4)
    _close(h, jh, 1e-4)
    if cfg.sliding_window:
        # the window is in effect: without it the logits move
        wide = dataclasses.replace(cfg, sliding_window=0)
        assert not torch.allclose(
            TransformerLM.apply(params, wide, _t(tok))[0], logits,
            atol=1e-3)


def test_lm_loss_metrics_and_gradients_match(model):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 32, seed=5)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = lm_loss(tree_unflatten(params, leaves), cfg, _t(tok))
    grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jax_lm_loss, has_aux=True), static_argnums=1)(
        jparams, jcfg, jnp.asarray(tok))
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


def test_embed_scale_normaliser_is_the_reference_bf16():
    """gemma3-1b's d_model of 1152 in bf16: sqrt(1152) rounds to the same
    bf16 number on both sides, and the scaled embeddings are bitwise
    equal."""
    cfg = dataclasses.replace(get_config("gemma3-1b", reduced=True),
                              d_model=1152, dtype="bfloat16")
    jcfg = dataclasses.replace(jax_get_config("gemma3-1b", reduced=True),
                               d_model=1152, dtype="bfloat16")
    rng = np.random.default_rng(11)
    table = rng.standard_normal((cfg.vocab, 1152)).astype(np.float32)
    tok = _tokens(cfg, 2, 9, seed=11)
    got = TransformerLM._embed({"embed": {"table": _t(table).bfloat16()}},
                               cfg, _t(tok).long())
    want = JaxLM._embed({"embed": {"table": jnp.asarray(table,
                                                        jnp.bfloat16)}},
                        jcfg, jnp.asarray(tok), None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert float(torch.tensor(1152 ** 0.5, dtype=torch.bfloat16)) == float(
        jnp.asarray(np.sqrt(1152), jnp.bfloat16))


# ---------------------------------------------------------------------------
# the verify window, dense and paged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["sdpa", "decode_op"])
def test_decode_window_logits_match(model, use_kernel):
    """A 21-token prefill, then an 8-token window at positions 21-28: the
    window's queries see past the reduced window of 16. ``use_kernel`` runs
    the dense flash-decode op (its plain version on the CPU)."""
    cfg, jcfg, jparams, params = model
    rng = np.random.default_rng(3)
    B, L, W = 2, 21, 8
    toks = rng.integers(0, cfg.vocab, size=(B, L + W))
    cache = TransformerLM.init_cache(cfg, B, 40, device=CPU)
    jcache = JaxLM.init_cache(jcfg, B, 40)
    zero = np.zeros(B, np.int32)
    jdecode = jax.jit(JaxLM.decode_window, static_argnums=1)
    _, _, cache = TransformerLM.decode_window(
        params, cfg, _t(toks[:, :L]), cache, _t(zero), use_kernel=use_kernel)
    _, _, jcache = jdecode(jparams, jcfg, jnp.asarray(toks[:, :L]), jcache,
                           jnp.asarray(zero))
    cl = np.array([L, L - 4], np.int32)
    logits, h, _ = TransformerLM.decode_window(
        params, cfg, _t(toks[:, L:]), cache, _t(cl), use_kernel=use_kernel)
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


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "paged_decode_op"])
def test_decode_window_paged_matches(model, use_kernel):
    """Over random pools through block tables at lengths 21 and 30, past
    the reduced window: the gather fallback, and the fused paged decode
    op's plain version."""
    cfg, jcfg, jparams, params = model
    B, W, bs, nb = 2, 8, 4, 10
    P = 1 + B * nb
    jpaged = JaxLM.init_paged_cache(jcfg, B, P, bs)
    leaves, treedef = jax.tree.flatten(jpaged)
    rng = np.random.default_rng(7)
    jpaged = jax.tree.unflatten(treedef, [
        jnp.asarray(0.1 * rng.standard_normal(l.shape), l.dtype)
        for l in leaves])
    paged = _port_layers(cfg, jpaged)
    tables = (1 + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
    cl = np.array([21, 30], np.int32)
    toks = rng.integers(0, cfg.vocab, size=(B, W))
    logits, _, new = TransformerLM.decode_window_paged(
        params, cfg, _t(toks), paged,
        PagedView(_t(tables), torch.arange(B), use_kernel), _t(cl))
    jlogits, _, jnew = jax.jit(
        lambda p, t, c, tab, n: JaxLM.decode_window_paged(
            p, jcfg, t, c, JaxPagedView(tab, jnp.arange(B)), n))(
        jparams, jnp.asarray(toks), jpaged, jnp.asarray(tables),
        jnp.asarray(cl))
    _close(logits, jlogits, 1e-4)
    for a, b in zip(tree_leaves(new), tree_leaves(_port_layers(cfg, jnew))):
        _close(a[1:], b[1:], 1e-5)


# ---------------------------------------------------------------------------
# serving and the CLIs
# ---------------------------------------------------------------------------

def _traffic(cfg):
    """Prompts of 3, 24 and 27 tokens (the last two share 20, a prefix
    hit) with 9, 7 and 10 new tokens: the longer ones pass the reduced
    window of 16 during prefill and every verify round."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab, size=20)
    return [(0, rng.integers(0, cfg.vocab, size=3), 9),
            (1, np.concatenate([shared, rng.integers(0, cfg.vocab, 4)]), 7),
            (2, np.concatenate([shared, rng.integers(0, cfg.vocab, 7)]), 10)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_port_solo_bitwise_and_jax_under_margin(
        request, arch, tmp_path_factory):
    """Ragged prompts, slot reuse, a prefix hit and chunked prefill: every
    request equals the port's solo run bit for bit, and JAX's solo run
    wherever JAX's top-2 margin exceeds 1e-4."""
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(
        arch, reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    d = tmp_path_factory.mktemp("serve-" + arch)
    save_pytree(jparams, str(d), step=1)
    params = params_from_numpy(load_pytree(str(d), 1), cfg)
    eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=64,
                        eps_key=EPS_SEED, block_size=4, device=CPU)
    for uid, p, n in _traffic(cfg):
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    done = eng.run()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    jeps = JaxSampler(jcfg, jparams, eps_key=jax.random.PRNGKey(EPS_SEED))
    for r in done:
        assert r.ok
        end = len(r.prompt) + r.new_tokens
        s = PredictiveSampler(cfg, params, window=8, max_len=64,
                              eps_key=EPS_SEED, device=CPU)
        t, _ = s.generate(torch.as_tensor(r.prompt)[None], r.new_tokens,
                          seq_ids=torch.tensor([r.uid]))
        np.testing.assert_array_equal(r.result, t[0, :end].numpy(),
                                      err_msg=f"request {r.uid}")
        if r.uid != 2:
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--requests", "1", "--new-tokens", "4", "--max-len",
                    "32"])
    out = capsys.readouterr().out
    assert "served 1 requests / 4 tokens" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch, capsys):
    """Two steps at 24 positions, past gemma3's reduced window."""
    train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "24",
                    "--log-every", "1"])
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2 and lines[-1] == "done"
    assert all(np.isfinite(float(ln.split()[3])) for ln in steps)
