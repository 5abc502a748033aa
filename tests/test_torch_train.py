"""The port's training path against the JAX reference, on the CPU in
float32: the whole-sequence forward (``TransformerLM.apply``, on the plain
route and on the chunked route), ``lm_loss`` with its metrics and every
gradient leaf, the optimizers and schedules, the synthetic data, the train
step, the checkpoints and the train CLI.

Models: reduced qwen3-1.7b, and reduced deepseek-v3-671b cut to two
``("mla", "dense")`` layers (no MoE) with its two forecast heads. Both
packages load the same ``save_pytree`` checkpoint of the reference's
weights; inputs are made with numpy from a seed.

Tolerances: logits and losses 1e-4 (float32 matmuls and transcendental
functions of two libraries round differently, through two layers);
gradients 1e-4 of the largest gradient of their leaf plus 1e-4 relative
(the same rounding, through the backward); optimizer updates and states
1e-6 relative plus 1e-7 (elementwise float32 arithmetic, where ``pow``,
``sqrt`` and ``rsqrt`` may differ by an ulp); schedules 1e-6 relative;
parameters after three train steps 2e-5 (an AdamW step moves a weight by
about lr·g/(|g| + eps), and where |g| is near eps the gradients' own 1e-4
carries into a part of lr = 3e-4); data and checkpoints bitwise.
"""
import dataclasses
import io
import math
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jax_attention
from repro import optim as jax_optim
from repro.checkpoint.io import restore_pytree as jax_restore_pytree
from repro.checkpoint.io import save_pytree as jax_save_pytree
from repro.configs import get_config as jax_get_config
from repro.data.synthetic import synthetic_tokens as jax_synthetic_tokens
from repro.data.synthetic import token_batches as jax_token_batches
from repro.launch.train import make_optimizer as jax_make_optimizer
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models.attention import GQAttention as JaxGQA
from repro.models.losses import lm_loss as jax_lm_loss
from repro.models.transformer import TransformerLM as JaxLM
import repro_torch.models.attention as attention
from repro_torch import optim
from repro_torch.checkpoint.io import (latest_step, load_pytree,
                                       params_from_numpy, params_to_numpy,
                                       reference_tree, restore_pytree,
                                       save_pytree)
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.synthetic import synthetic_tokens, token_batches
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import make_optimizer, make_train_step
from repro_torch.models.attention import GQAttention
from repro_torch.models.losses import lm_loss
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten


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
_MLA_CUT = dict(n_layers=2, layer_prefix=(("mla", "dense"),) * 2)


def _models(tmp_path_factory, arch, cut):
    cfg = dataclasses.replace(get_config(arch, reduced=True), **cut)
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), **cut)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    d = tmp_path_factory.mktemp(arch)
    jax_save_pytree(jparams, str(d), step=1)
    return cfg, jcfg, jparams, params_from_numpy(load_pytree(str(d), 1), cfg)


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    return _models(tmp_path_factory, "qwen3-1.7b", {})


@pytest.fixture(scope="module")
def deepseek(tmp_path_factory):
    return _models(tmp_path_factory, "deepseek-v3-671b", _MLA_CUT)


@pytest.fixture(params=["qwen", "deepseek"])
def model(request):
    return request.getfixturevalue(request.param)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _grads_close(got_tree, want_tree):
    got, want = jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)
    assert jax.tree.structure(got_tree) == jax.tree.structure(want_tree)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-4 * max(float(np.abs(w).max()), 1e-12))


def _port_grads(params, cfg, tokens, **kw):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = lm_loss(tree_unflatten(params, leaves), cfg,
                            torch.from_numpy(tokens), **kw)
    grads = torch.autograd.grad(loss, leaves)
    return ({k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def test_gqa_full_matches(qwen):
    cfg, jcfg, jparams, params = qwen
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    p = params["layers"][0]["mixer"]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["mixer"])
    got = GQAttention.full(p, torch.from_numpy(x), cfg)
    want = JaxGQA.full(jp, jnp.asarray(x), jcfg)
    _close(got.detach(), want, 1e-5)
    got_w = GQAttention.full(p, torch.from_numpy(x), cfg, window=5)
    want_w = JaxGQA.full(jp, jnp.asarray(x), jcfg, window=5)
    _close(got_w.detach(), want_w, 1e-5)


def test_apply_logits_match(model):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 24)
    logits, h, aux = TransformerLM.apply(params, cfg, torch.from_numpy(tok))
    jl, jh, jaux = JaxLM.apply(jparams, jcfg, jnp.asarray(tok))
    _close(logits.detach(), jl, 1e-4)
    _close(h.detach(), jh, 1e-4)
    assert float(aux) == float(jaux) == 0.0
    # remat recomputes each layer in the backward: the same forward
    logits_r, _, _ = TransformerLM.apply(params, cfg, torch.from_numpy(tok),
                                         remat=True)
    assert torch.equal(logits_r, logits)


def test_chunked_route_matches(model, monkeypatch):
    """Above ``CHUNKED_THRESHOLD`` both packages attend in checkpointed
    query chunks of 512 rows; the threshold is lowered in both for this
    test so a 1024-token sequence takes that route (two chunks)."""
    cfg, jcfg, jparams, params = model
    monkeypatch.setattr(attention, "CHUNKED_THRESHOLD", 512)
    monkeypatch.setattr(jax_attention, "CHUNKED_THRESHOLD", 512)
    tok = _tokens(cfg, 1, 1024, seed=3)
    metrics, grads = _port_grads(params, cfg, tok)
    (jloss, jm), jgrads = jax.value_and_grad(jax_lm_loss, has_aux=True)(
        jparams, jcfg, jnp.asarray(tok))
    _close(metrics["loss"], jloss, 1e-4)
    _grads_close(params_to_numpy(grads, cfg), jgrads)
    # and the chunked route is the same function as the unchunked one
    monkeypatch.setattr(attention, "CHUNKED_THRESHOLD", 2048)
    plain, _ = lm_loss(params, cfg, torch.from_numpy(tok))
    _close(plain.detach(), metrics["loss"], 1e-5)


def test_lm_loss_metrics_and_gradients_match(model):
    cfg, jcfg, jparams, params = model
    tok = _tokens(cfg, 2, 24, seed=5)
    metrics, grads = _port_grads(params, cfg, tok)
    (jloss, jm), jgrads = jax.value_and_grad(jax_lm_loss, has_aux=True)(
        jparams, jcfg, jnp.asarray(tok))
    assert sorted(metrics) == sorted(jm)
    for k in jm:
        _close(metrics[k], jm[k], 1e-4)
    if cfg.forecast_horizon:
        assert "forecast_kl" in metrics and float(metrics["forecast_kl"]) > 0
    assert math.log(cfg.vocab) - 1 < float(metrics["xent"]) \
        < math.log(cfg.vocab) + 1
    _grads_close(params_to_numpy(grads, cfg), jgrads)


def test_capacity_factor_leaves_a_dense_stack_unchanged(qwen):
    """A capacity factor runs (MoE is ported); without MoE layers aux is 0
    and the logits are those of no-drop."""
    cfg, _, _, params = qwen
    tok = torch.zeros((1, 4), dtype=torch.int32)
    logits, _, aux = TransformerLM.apply(params, cfg, tok, moe_capacity=1.25)
    assert float(aux) == 0.0
    assert torch.equal(logits, TransformerLM.apply(params, cfg, tok)[0])


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"a": {"w": rng.standard_normal((4, 8)).astype(np.float32)},
            "b": [rng.standard_normal((6,)).astype(np.float32),
                  rng.standard_normal((2, 3, 5)).astype(np.float32)],
            "_mask": np.ones((3,), np.float32)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


_OPTS = {
    "adamw": (lambda m: m.adamw(m.linear_warmup_cosine(1e-2, 1, 3),
                                weight_decay=0.1)),
    "adafactor": (lambda m: m.adafactor(m.cosine_schedule(0.1, 3),
                                        weight_decay=0.01)),
    "sgd": lambda m: m.sgd(0.05),
    "sgd_schedule": lambda m: m.sgd(m.linear_warmup_cosine(0.05, 1, 3)),
}


@pytest.mark.parametrize("name", sorted(_OPTS))
def test_optimizer_updates_and_states_match(name):
    rng = np.random.default_rng(11)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jopt, opt = _OPTS[name](jax_optim), _OPTS[name](optim)
    jp, p = jax.tree.map(jnp.asarray, params), _to_torch(params)
    p_in_place = _to_torch(params)
    js, s = jopt.init(jp), opt.init(p)
    s_in_place = opt.init(p_in_place)
    for g in grads:
        jg, gt = jax.tree.map(jnp.asarray, g), _to_torch(g)
        jg, jgn = jax_optim.clip_by_global_norm(jax_optim.zero_frozen(jg),
                                                1.0)
        gz = optim.zero_frozen(gt)
        gc, gn = optim.clip_by_global_norm(gz, 1.0)
        _close(gn, jgn, 1e-6)
        _close(gc["a"]["w"], jg["a"]["w"], 1e-6)
        assert float(gc["_mask"].abs().sum()) == 0.0
        ju, js = jopt.update(jg, js, jp)
        u, s = opt.update(gc, s, p)
        for a, b in zip(jax.tree.leaves(_to_np(u)),
                        jax.tree.leaves(_to_np(ju))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        for a, b in zip(jax.tree.leaves(_to_np(s)),
                        jax.tree.leaves(_to_np(js))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        jp = jax_optim.apply_updates(jp, ju)
        p = optim.apply_updates(p, u)
        # the in-place, leaf-by-leaf step gives the same numbers bitwise
        opt.step(gz, s_in_place, p_in_place,
                 grad_scale=torch.clamp(1.0 / (gn + 1e-9), max=1.0))
        for a, b in zip(tree_leaves(p_in_place), tree_leaves(p)):
            assert torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(_to_np(p)), jax.tree.leaves(_to_np(jp))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_adafactor_state_is_factored():
    opt = optim.adafactor(0.1)
    state = opt.init({"big": torch.zeros((128, 256)),
                      "vec": torch.zeros((64,))})
    assert state["v"]["big"]["vr"].shape == (128,)
    assert state["v"]["big"]["vc"].shape == (256,)
    assert state["v"]["vec"]["v"].shape == (64,)


def test_adafactor_on_stacked_expert_leaves_matches_reference():
    """A 3-D (E, D, F) leaf, as the MoE layers' expert stacks: its second
    moments factor over the last two axes, (E, D) and (E, F), and three
    updates and states equal the reference's within the optimizer
    tolerance."""
    rng = np.random.default_rng(12)
    params = {"experts": rng.standard_normal((4, 16, 24)).astype(np.float32),
              "router": rng.standard_normal((16, 4)).astype(np.float32)}
    jopt, opt = _OPTS["adafactor"](jax_optim), _OPTS["adafactor"](optim)
    jp, p = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, s = jopt.init(jp), opt.init(p)
    assert s["v"]["experts"]["vr"].shape == (4, 16)
    assert s["v"]["experts"]["vc"].shape == (4, 24)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        u, s = opt.update(_to_torch(g), s, p)
        for a, b in zip(jax.tree.leaves(_to_np(u)) +
                        jax.tree.leaves(_to_np(s)),
                        jax.tree.leaves(_to_np(ju)) +
                        jax.tree.leaves(_to_np(js))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        jp = jax_optim.apply_updates(jp, ju)
        p = optim.apply_updates(p, u)


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (0.3,)),
    ("cosine_schedule", (2.0, 7)),
    ("linear_warmup_cosine", (1.0, 3, 10)),
    ("linear_warmup_cosine", (3e-4, 1, 3)),       # train.py at steps=3
    ("exponential_decay", (0.01, 0.999995)),
])
def test_schedules_match(name, args):
    from repro.optim import schedules as jax_schedules
    fn = getattr(optim, name)(*args)
    jfn = getattr(jax_schedules, name)(*args)
    for step in range(12):
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got),
                                   float(jfn(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_tokens_and_batches_bitwise():
    np.testing.assert_array_equal(synthetic_tokens(5, 33, 512, seed=4),
                                  jax_synthetic_tokens(5, 33, 512, seed=4))
    mine = token_batches(16, 4, 12, 151936, seed=2)
    ref = jax_token_batches(16, 4, 12, 151936, seed=2)
    pipe = TokenPipeline(token_batches(16, 4, 12, 151936, seed=2), CPU)
    for _ in range(6):                   # past one epoch of 4 batches
        a, b, c = next(mine), next(ref), next(pipe)
        np.testing.assert_array_equal(a, b)
        assert c.dtype == torch.int32 and np.array_equal(c.numpy(), b)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _clone(params):
    return jax.tree.map(lambda t: t.clone(), params)


def test_three_train_steps_match_reference(model):
    cfg, jcfg, jparams, params = model
    params = _clone(params)
    jopt, opt = jax_make_optimizer(jcfg, 3), make_optimizer(cfg, 3)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, remat=False))
    step = make_train_step(cfg, opt, remat=False)
    js, s = jopt.init(jparams), opt.init(params)
    batches = token_batches(16, 2, 16, cfg.vocab, seed=1)
    for _ in range(3):
        batch = next(batches)
        jparams, js, jm = jstep(jparams, js, jnp.asarray(batch))
        params, s, m = step(params, s, torch.from_numpy(batch))
        for k in ("loss", "xent", "grad_norm"):
            _close(m[k], jm[k], 1e-4)
    for a, b in zip(jax.tree.leaves(params_to_numpy(params, cfg)),
                    jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5, atol=2e-5)


def test_remat_step_equals_plain_step(qwen):
    cfg, _, _, params = qwen
    batch = torch.from_numpy(_tokens(cfg, 2, 16, seed=8))
    out = []
    for remat in (False, True):
        opt = optim.adamw(1e-3)
        p = _clone(params)
        p, _, m = make_train_step(cfg, opt, remat=remat)(p, opt.init(p),
                                                         batch)
        out.append((p, m))
    assert torch.equal(out[0][1]["loss"], out[1][1]["loss"])
    for a, b in zip(tree_leaves(out[0][0]), tree_leaves(out[1][0])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_gradient_accumulation_matches_full_batch(qwen):
    """accum_steps=2 gives (numerically) the update of the full batch, with
    the reference's own tolerance (tests/test_optim.py)."""
    cfg, _, _, params = qwen
    batch = torch.from_numpy(_tokens(cfg, 4, 16, seed=1))
    out = []
    for accum in (1, 2):
        opt = optim.sgd(0.1)
        p = _clone(params)
        p, _, _ = make_train_step(cfg, opt, remat=False,
                                  accum_steps=accum)(p, opt.init(p), batch)
        out.append(p)
    for a, b in zip(tree_leaves(out[0]), tree_leaves(out[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_bitwise(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((5, 7), generator=g).to(dtype),
            "list": [torch.randn((3,), generator=g).to(dtype), []],
            "nan": torch.tensor([float("nan"), -0.0, 1e-40]).to(dtype)}
    save_pytree(tree, str(tmp_path), 12)
    assert latest_step(str(tmp_path)) == 12
    back = restore_pytree(str(tmp_path), 12)
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert b.dtype == dtype
        assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    assert back["list"][1] == []
    raw = load_pytree(str(tmp_path), 12)
    assert raw["w"].dtype.kind == ("V" if dtype == torch.bfloat16 else "f")


def test_port_checkpoint_reads_in_reference_bitwise(qwen, tmp_path):
    cfg, _, jparams, params = qwen
    save_pytree(reference_tree(params, cfg), str(tmp_path), 3)
    back = jax_restore_pytree(str(tmp_path), 3)
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # and the port's loader rebuilds its own tree from it
    again = params_from_numpy(load_pytree(str(tmp_path), 3), cfg)
    for a, b in zip(tree_leaves(again), tree_leaves(params)):
        assert torch.equal(a, b)


def test_bf16_params_survive_save_and_load(tmp_path):
    cfg = dataclasses.replace(get_config("qwen3-1.7b", reduced=True),
                              dtype="bfloat16")
    params = TransformerLM.init(cfg, seed=3, device=CPU)
    save_pytree(reference_tree(params, cfg), str(tmp_path), 1)
    again = params_from_numpy(load_pytree(str(tmp_path), 1), cfg)
    for a, b in zip(tree_leaves(again), tree_leaves(params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_train_cli_two_steps_on_cpu(tmp_path):
    out = io.StringIO()
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
            "--steps", "2", "--batch", "2", "--seq", "16", "--log-every",
            "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with redirect_stdout(out):
        train_cli.main(argv)
    lines = out.getvalue().splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2 and lines[-1] == "done"
    for ln in steps:
        f = ln.split()
        assert f[2] == "loss" and f[4] == "xent" and f[-1] == "ms/step"
        assert math.isfinite(float(f[3]))
    assert latest_step(str(tmp_path)) == 2
    out = io.StringIO()
    with redirect_stdout(out):
        train_cli.main(argv[:6] + ["3"] + argv[7:])
    assert "restored step 2" in out.getvalue()


def test_train_cli_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"])
