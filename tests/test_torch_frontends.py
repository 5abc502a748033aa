"""The multimodal backbones of the port against the JAX reference, on the
CPU: musicgen-large (MHA over 4 kv heads of 64 at reduced width, GELU, an
untied head) and internvl2-1b (GQA, swiglu, rope_theta 1e6, tied
embeddings), each with its stub frontend's prefix of ``n_prefix_tokens``
embeddings before the tokens, at their reduced widths in float32. The
reference's weights go through ``save_pytree``, the port's numpy reader
and ``params_from_numpy``; inputs and prefixes are made with numpy from a
seed and handed to both packages, except where the prefix's own noise is
the point (``random_prefix``, ``normal``).

Tolerances: the configs and the weight trees equal the reference's
exactly; the random bits at widths 8, 16 and 32, and the bfloat16
``normal`` draws, bitwise; the float32 ``normal`` within 4 ulps (XLA's
erfinv polynomial, whose ``log1p`` rounds otherwise; 95% of values
bitwise) and ``random_prefix`` (0.02 times it, one more rounding) within
5; logits 1e-4 (float32 through two layers, sums in another order);
the loss and its gradients as ``test_torch_train.py`` holds them (1e-4;
gradients 1e-4 of the leaf's largest plus 1e-4 relative); the parameters
after one SGD step at 0.1 2e-5 (0.1 times the gradients' 1e-4); served
tokens bitwise against the port's solo sampler, and against JAX's under
the margin rule at 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.checkpoint.io import save_pytree
from repro.configs import get_config as jax_get_config
from repro.engine.spec_decode import PredictiveSampler as JaxSampler
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models import frontends as jax_frontends
from repro.models.losses import lm_loss as jax_lm_loss
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch import optim
from repro_torch.checkpoint.io import (load_pytree, params_from_numpy,
                                       params_to_numpy, reference_tree)
from repro_torch.configs import ARCHS, PORTED, get_config
from repro_torch.core import random as jr
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import make_train_step
from repro_torch.models import frontends
from repro_torch.models.losses import lm_loss
from repro_torch.models.transformer import TransformerLM
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
ARCHS_MM = ("musicgen-large", "internvl2-1b")


@pytest.fixture(scope="module", params=ARCHS_MM)
def model(request, tmp_path_factory):
    cfg = get_config(request.param, reduced=True)
    jcfg = jax_get_config(request.param, reduced=True)
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


def _prefix(cfg, B, seed=0):
    """A prefix of the frontend's shape, made with numpy at the scale
    ``random_prefix`` draws."""
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (B, cfg.n_prefix_tokens, cfg.d_model))).astype(np.float32)


def _ulps(a, b):
    """|a - b| in float32 units in the last place (finite values)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    # order the sign-magnitude integers as the floats are ordered
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


# ---------------------------------------------------------------------------
# the configs and the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS_MM)
def test_config_equals_reference(arch, reduced):
    cfg, jcfg = get_config(arch, reduced), jax_get_config(arch, reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.layer_specs() == jcfg.layer_specs()
    assert cfg.n_prefix_tokens == (8 if reduced else 256)


def test_every_arch_is_ported():
    assert sorted(PORTED) == sorted(ARCHS) and len(ARCHS) == 10
    for arch in ARCHS:
        assert get_config(arch).name == arch


def test_tree_round_trips_bitwise(model):
    """``reference_tree`` of the port's parameters is the reference's tree
    (musicgen's untied ``head`` included), and ``params_from_numpy`` of
    it gives the same tensors back."""
    cfg, _, jparams, params = model
    ref = reference_tree(params, cfg)
    assert jax.tree.structure(jax.tree.map(np.asarray, jparams)) == \
        jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ("head" in params) == (not cfg.tie_embeddings)
    back = params_from_numpy(jax.tree.map(lambda t: t.numpy(), ref), cfg)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the noise: random bits, normal, the random prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,dtype", [(8, jnp.uint8), (16, jnp.uint16),
                                         (32, jnp.uint32)])
def test_random_bits_bitwise(width, dtype):
    for seed in (0, 7):
        want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed),
                                          (4099,), dtype))
        got = jr.random_bits(jr.prng_key(seed), 4099, width)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normal_matches_jax(dtype):
    """The uniforms under it bitwise; the values bitwise in bfloat16 (every
    one of its 128 uniforms is drawn here) and within 4 ulps in float32."""
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    lo = float(np.nextafter(np.array(-1.0, jdt), np.array(0.0, jdt)))
    for seed in (0, 3):
        key, jkey = jr.prng_key(seed), jax.random.PRNGKey(seed)
        u = jr.uniform(key, 20000, lo, 1.0, tdt).float().numpy()
        ju = np.asarray(jax.random.uniform(jkey, (20000,), jdt, lo, 1.0)
                        .astype(jnp.float32))
        np.testing.assert_array_equal(u, ju)
        got = jr.normal(key, (4, 50, 100), tdt)
        want = np.asarray(jax.random.normal(jkey, (4, 50, 100), jdt)
                          .astype(jnp.float32))
        assert got.dtype == tdt and got.shape == (4, 50, 100)
        if dtype == "bfloat16":
            assert len(np.unique(u)) == 128
            np.testing.assert_array_equal(got.float().numpy(), want)
        else:
            d = _ulps(got.numpy(), want)
            assert d.max() <= 4 and (d == 0).mean() > 0.9, (
                d.max(), (d == 0).mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_random_prefix_matches_reference(model, dtype):
    """The train CLI's prefix of step ``it``: ``random_prefix(fold_in(key,
    it))`` on both sides; and ``prefix_spec`` the reference's shape on the
    meta device."""
    cfg, jcfg, _, _ = model
    cfg = dataclasses.replace(cfg, dtype=dtype)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    for it in (0, 5):
        got = frontends.random_prefix(jr.fold_in(jr.prng_key(0), it), cfg, 2)
        want = jax_frontends.random_prefix(
            jax.random.fold_in(jax.random.PRNGKey(0), it), jcfg, 2)
        assert got.dtype == cfg.param_dtype
        assert tuple(got.shape) == want.shape == (2, 8, cfg.d_model)
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got.float().numpy(), want)
        else:
            assert _ulps(got.numpy(), want).max() <= 5
    spec = frontends.prefix_spec(cfg, 3)
    jspec = jax_frontends.prefix_spec(jcfg, 3)
    assert spec.device.type == "meta" and tuple(spec.shape) == jspec.shape
    assert spec.dtype == cfg.param_dtype
    plain = dataclasses.replace(cfg, n_prefix_tokens=0)
    assert frontends.prefix_spec(plain, 3) is None
    assert frontends.random_prefix(jr.prng_key(0), plain, 3) is None


# ---------------------------------------------------------------------------
# the whole-sequence forward, the loss and the train step with a prefix
# ---------------------------------------------------------------------------

def test_apply_with_prefix_matches(model):
    """One prefix array in both packages: logits and ``h`` over the prefix
    and the tokens (B, n_pre + S, ...), RoPE from position 0 on the
    prefix."""
    cfg, jcfg, jparams, params = model
    tok, pre = _tokens(cfg, 2, 24), _prefix(cfg, 2)
    logits, h, _ = TransformerLM.apply(params, cfg, _t(tok), _t(pre))
    jl, jh, _ = jax.jit(lambda p, t, e: JaxLM.apply(p, jcfg, t, e))(
        jparams, jnp.asarray(tok), jnp.asarray(pre))
    assert tuple(logits.shape) == (2, cfg.n_prefix_tokens + 24, cfg.vocab)
    _close(logits, jl, 1e-4)
    _close(h, jh, 1e-4)
    # the prefix is in effect: without it the token positions move
    alone, _, _ = TransformerLM.apply(params, cfg, _t(tok))
    assert not torch.allclose(alone, logits[:, cfg.n_prefix_tokens:],
                              atol=1e-3)


def test_lm_loss_and_gradients_with_prefix_match(model):
    cfg, jcfg, jparams, params = model
    tok, pre = _tokens(cfg, 2, 20, seed=5), _prefix(cfg, 2, seed=5)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = lm_loss(tree_unflatten(params, leaves), cfg, _t(tok),
                            _t(pre))
    grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jax_lm_loss, has_aux=True), static_argnums=1)(
        jparams, jcfg, jnp.asarray(tok), jnp.asarray(pre))
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


def test_train_step_with_prefix_and_accumulation_matches(model):
    """One step with the prefix, its batch split into 2 microbatches (the
    prefix with it): the metrics and every parameter after it. SGD at 0.1,
    whose update is linear in the gradient, so the parameters inherit the
    gradients' tolerance (an AdamW step divides by |g| + eps and magnifies
    it where |g| is near eps: ``test_torch_train.py`` holds that step)."""
    cfg, jcfg, jparams, params = model
    params = jax.tree.map(lambda t: t.clone(), params)
    jopt, opt = jax_optim.sgd(0.1), optim.sgd(0.1)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, remat=False,
                                        accum_steps=2))
    step = make_train_step(cfg, opt, remat=False, accum_steps=2)
    tok, pre = _tokens(cfg, 2, 16, seed=2), _prefix(cfg, 2, seed=2)
    jparams, _, jm = jstep(jparams, jopt.init(jparams), jnp.asarray(tok),
                           jnp.asarray(pre))
    params, _, m = step(params, opt.init(params), _t(tok), _t(pre))
    for k in ("loss", "xent", "grad_norm"):
        _close(m[k], jm[k], 1e-4)
    for a, b in zip(jax.tree.leaves(params_to_numpy(params, cfg)),
                    jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# serving (no prefix: the reference serves tokens alone) and the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS_MM)
def test_engine_matches_port_solo_bitwise_and_jax_under_margin(
        arch, tmp_path_factory):
    """Prompts of 3, 14 and 17 tokens (the last two share 12, a prefix
    hit), 9, 7 and 10 new: every request equals the port's solo run bit
    for bit, and one equals JAX's solo run wherever JAX's top-2 margin
    exceeds 1e-4."""
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(
        arch, reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    d = tmp_path_factory.mktemp("serve-" + arch)
    save_pytree(jparams, str(d), step=1)
    params = params_from_numpy(load_pytree(str(d), 1), cfg)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab, size=12)
    traffic = [(0, rng.integers(0, cfg.vocab, size=3), 9),
               (1, np.concatenate([shared, rng.integers(0, cfg.vocab, 2)]),
                7),
               (2, np.concatenate([shared, rng.integers(0, cfg.vocab, 5)]),
                10)]
    eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=48,
                        eps_key=EPS_SEED, block_size=4, device=CPU)
    for uid, p, n in traffic:
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    done = eng.run()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    for r in done:
        assert r.ok
        end = len(r.prompt) + r.new_tokens
        s = PredictiveSampler(cfg, params, window=8, max_len=48,
                              eps_key=EPS_SEED, device=CPU)
        t, _ = s.generate(torch.as_tensor(r.prompt)[None], r.new_tokens,
                          seq_ids=torch.tensor([r.uid]))
        np.testing.assert_array_equal(r.result, t[0, :end].numpy(),
                                      err_msg=f"request {r.uid}")
    r = next(r for r in done if r.uid == 2)   # one JAX solo run: its cost
    end = len(r.prompt) + r.new_tokens
    js = JaxSampler(jcfg, jparams, window=8, max_len=48,
                    eps_key=jax.random.PRNGKey(EPS_SEED))
    jt, _ = js.generate(jnp.asarray(r.prompt, jnp.int32)[None], r.new_tokens,
                        seq_ids=jnp.asarray([r.uid], jnp.int32))
    ref = np.asarray(jt[0, :end])

    def margin_at(p):
        logits, _, _ = JaxLM.apply(jparams, jcfg,
                                   jnp.asarray(ref[None, :p], jnp.int32))
        e = js.eps_fn(jnp.asarray([r.uid], jnp.int32),
                      jnp.asarray([[p]], jnp.int32))
        return top2_margin(np.asarray(logits[0, -1] + e[0, 0]))
    check_token_agreement(ref, r.result, margin_at, tol=1e-4,
                          start=len(r.prompt))
    assert eng.export_metrics()["prefix_hits"] >= 1
    assert eng.pool.blocks_in_use() == 0


@pytest.mark.parametrize("arch", ARCHS_MM)
def test_serve_cli_on_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--requests", "1", "--new-tokens", "4", "--max-len",
                    "32"])
    assert "served 1 requests / 4 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS_MM)
def test_train_cli_on_cpu(arch, capsys):
    """Two steps, each with its random prefix of 8 embeddings."""
    train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--log-every", "1"])
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2 and lines[-1] == "done"
    assert all(np.isfinite(float(ln.split()[3])) for ln in steps)
