"""The port's Mamba-1 mixer and the recurrent mixers' two-pass
``advance_state`` on the CPU, against the JAX reference: on the first layer
of the reduced jamba-1.5-large-398b cut to its first four layers (d_model
256, d_inner 512, 8 states per channel) in float32, with the reference's
weights loaded through ``params_from_numpy`` and inputs made with numpy
from a seed; RWKV's on the reduced rwkv6-7b.

Tolerances: ``full`` at T = 16, one window with its per-position conv
inputs (``in_proj``'s outputs) and states, and the advanced states 1e-5
(float32 matmuls and transcendental functions of two libraries round
differently); RWKV's token-shift rows bitwise (they are the inputs); ``full`` at
T = 256 (the chunked, checkpointed scan) 1e-4 (the same, carried through
256 steps of the state), and its gradients 1e-4 of each leaf's largest
plus 1e-4 relative. Inside the port bitwise: the last-state form against
the last per-position state, a window continued from a carried state
against one window over both, ``advance_state`` against the per-position
state it stops at, on both RWKV routes, and the two-pass verify step
against the one-pass step on rwkv6-7b.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.ssm import Mamba as JaxMamba
from repro.models.ssm import RWKV6ChannelMix as JaxCMix
from repro.models.ssm import RWKV6TimeMix as JaxTMix
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch.serve import make_serve_step
from repro_torch.models.ssm import (Mamba, RWKV6ChannelMix, RWKV6TimeMix,
                                    _softplus)
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.optimizers import tree_leaves


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


def _models(arch, cut=None):
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                               reduced=True)
    if cut:
        cfg, jcfg = cut(cfg), cut(jcfg)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg)


@pytest.fixture(scope="module")
def jamba():
    return _models("jamba-1.5-large-398b", _cut)


@pytest.fixture(scope="module")
def rwkv():
    return _models("rwkv6-7b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _layer0(params, jparams, key):
    return (params["layers"][0][key],
            jax.tree.map(lambda a: a[0], jparams["blocks"][0][key]))


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _mamba_state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    DI = 2 * cfg.d_model
    return {"conv": rng.standard_normal((B, 3, DI)).astype(np.float32),
            "h": 0.3 * rng.standard_normal(
                (B, DI, cfg.ssm_state)).astype(np.float32)}


def test_mamba_init_matches_the_reference_tree(jamba):
    """The port's own init gives the reference's leaves and shapes, A_log
    = log(1..N) in the model's dtype, and the zero state's shapes."""
    cfg, _, jparams, params = jamba
    _, jp = _layer0(params, jparams, "mixer")
    mine = Mamba.init(torch.Generator().manual_seed(0), cfg)
    assert set(mine) == set(jp)
    for k, v in mine.items():
        if isinstance(v, dict):
            assert {n: t.shape for n, t in v.items()} == {
                n: tuple(a.shape) for n, a in jp[k].items()}, k
        else:
            assert tuple(v.shape) == jp[k].shape, k
    _close(mine["A_log"], jp["A_log"], 1e-7)
    bf = Mamba.init(torch.Generator().manual_seed(0), dataclasses.replace(
        cfg, dtype="bfloat16"), dtype=torch.bfloat16)
    assert bf["A_log"].dtype == torch.bfloat16
    st = Mamba.init_state(cfg, 3, dtype=torch.bfloat16)
    assert st["conv"].shape == (3, 3, 2 * cfg.d_model)
    assert st["conv"].dtype == torch.bfloat16
    assert st["h"].shape == (3, 2 * cfg.d_model, cfg.ssm_state)
    assert st["h"].dtype == torch.float32


@pytest.mark.parametrize("T,tol", [(16, 1e-5), (256, 1e-4)])
def test_mamba_full_matches(jamba, T, tol):
    """T = 256 takes the chunked, checkpointed scan on both sides."""
    cfg, jcfg, jparams, params = jamba
    p, jp = _layer0(params, jparams, "mixer")
    x = _x(cfg, (2, T), T)
    _close(Mamba.full(p, _t(x), cfg), JaxMamba.full(jp, jnp.asarray(x), jcfg),
           tol)


def test_mamba_softplus_is_logaddexp():
    """dt's softplus is JAX's ``logaddexp(x, 0)``: past torch's threshold
    of 20 too, where ``F.softplus`` returns x itself."""
    x = np.array([-30, -5, 0, 3, 19.5, 20.5, 40], np.float32)
    _close(_softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)), 1e-7)


def test_mamba_window_matches_from_a_state(jamba):
    """One window from a non-zero state: y, the conv inputs and the SSM
    state after every position; the last-state form is the last of them
    bitwise, with the same y."""
    cfg, jcfg, jparams, params = jamba
    p, jp = _layer0(params, jparams, "mixer")
    B, W = 2, 8
    x = _x(cfg, (B, W), 1)
    st = _mamba_state(cfg, B, 2)
    y, s = Mamba.window(p, _t(x), cfg, {k: _t(v) for k, v in st.items()})
    jy, js = JaxMamba.window(jp, jnp.asarray(x), jcfg,
                             {k: jnp.asarray(v) for k, v in st.items()})
    _close(y, jy, 1e-5)
    assert s["conv"].shape == (B, W, 3, 2 * cfg.d_model)
    assert s["h"].shape == (B, W, 2 * cfg.d_model, cfg.ssm_state)
    assert s["h"].dtype == torch.float32
    _close(s["conv"], js["conv"], 1e-5)
    _close(s["h"], js["h"], 1e-5)
    y2, s2 = Mamba.window(p, _t(x), cfg, {k: _t(v) for k, v in st.items()},
                          last_state_only=True)
    assert torch.equal(y2, y)
    assert torch.equal(s2["conv"], s["conv"][:, -1])
    assert torch.equal(s2["h"], s["h"][:, -1])


def test_mamba_window_continuation_equals_full(jamba):
    """Windows of 5, 2 and 9 positions, each from the state the one before
    left, give ``full``'s output bitwise (the state is carried in float32
    across the splits). A one-token window is left out: there the
    projections are matrix-vector products, which the CPU's BLAS rounds
    otherwise."""
    cfg, _, _, params = jamba
    p = params["layers"][0]["mixer"]
    x = _t(_x(cfg, (2, 16), 3))
    st = Mamba.init_state(cfg, 2)
    ys = []
    for a, b in ((0, 5), (5, 7), (7, 16)):
        y, st = Mamba.window(p, x[:, a:b], cfg, st, last_state_only=True)
        ys.append(y)
    assert torch.equal(torch.cat(ys, dim=1), Mamba.full(p, x, cfg))


def test_bf16_state_storage_is_what_keeps_splits_exact(jamba):
    """In bfloat16 the scan still carries its state in float32: stored so
    between windows (the port), a split sequence gives one window's output
    and final state bitwise; rounded to bfloat16 at the split (the
    reference's storage), the final state parts from the unsplit one. This
    is why the engine, whose prefill chunks and verify windows split
    sequences elsewhere than the solo sampler's, can equal the solo
    sampler in bfloat16 (``test_torch_jamba.py``)."""
    cfg, _, _, params = jamba
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    p = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()}
             if isinstance(v, dict) else v.to(torch.bfloat16))
         for k, v in params["layers"][0]["mixer"].items()}
    x = _t(_x(cfg, (1, 24), 4)).to(torch.bfloat16)
    st0 = Mamba.init_state(cfg, 1, dtype=torch.bfloat16)
    whole, end = Mamba.window(p, x, cfg, st0, last_state_only=True)
    y1, st = Mamba.window(p, x[:, :22], cfg, st0, last_state_only=True)
    y2, st2 = Mamba.window(p, x[:, 22:], cfg, st, last_state_only=True)
    assert torch.equal(torch.cat([y1, y2], dim=1), whole)
    assert torch.equal(st2["h"], end["h"])
    rounded = dict(st, h=st["h"].to(torch.bfloat16))
    _, st2r = Mamba.window(p, x[:, 22:], cfg, rounded, last_state_only=True)
    assert not torch.equal(st2r["h"], end["h"])


_ACCEPT = np.array([1, 5, 8], np.int64)


def test_mamba_advance_state_matches(jamba):
    """The state after ``accept`` tokens of a window, the reference's
    freeze-masked scan: within 1e-5 of JAX's and bitwise the port's own
    per-position state at ``accept - 1``."""
    cfg, jcfg, jparams, params = jamba
    p, jp = _layer0(params, jparams, "mixer")
    B, W = 3, 8
    x = _x(cfg, (B, W), 5)
    st = {k: _t(v) for k, v in _mamba_state(cfg, B, 6).items()}
    got = Mamba.advance_state(p, _t(x), cfg, st, _t(_ACCEPT))
    want = JaxMamba.advance_state(jp, jnp.asarray(x), jcfg,
                                  {k: jnp.asarray(v.numpy())
                                   for k, v in st.items()},
                                  jnp.asarray(_ACCEPT, jnp.int32))
    _close(got["conv"], want["conv"], 1e-5)
    _close(got["h"], want["h"], 1e-5)
    _, per = Mamba.window(p, _t(x), cfg, st)
    rows = torch.arange(B)
    for k in ("conv", "h"):
        assert torch.equal(got[k], per[k][rows, _t(_ACCEPT - 1)]), k
    # nothing accepted: the carried state itself
    zero = Mamba.advance_state(p, _t(x), cfg, st, torch.zeros(B,
                                                              dtype=int))
    assert torch.equal(zero["h"], st["h"])
    assert torch.equal(zero["conv"], st["conv"])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rwkv_advance_state_matches(rwkv, use_kernel):
    """The time mix's and channel mix's advanced states against JAX's
    (1e-5), and bitwise the per-position states ``window`` gives at
    ``accept - 1`` on the same route: the plain scan's, rounded on entry
    to the model's dtype, or the WKV op's float32 one."""
    cfg, jcfg, jparams, params = rwkv
    (p, jp), (pc, jpc) = (_layer0(params, jparams, "mixer"),
                          _layer0(params, jparams, "ffn"))
    rng = np.random.default_rng(7)
    B, W = 3, 8
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    x = _x(cfg, (B, W), 8)
    st = {"x_last": rng.standard_normal((B, cfg.d_model)).astype(np.float32),
          "S": 0.3 * rng.standard_normal((B, H, hd, hd)).astype(np.float32)}
    acc = _t(_ACCEPT)
    jacc = jnp.asarray(_ACCEPT, jnp.int32)
    tst = {k: _t(v) for k, v in st.items()}
    got = RWKV6TimeMix.advance_state(p, _t(x), cfg, tst, acc,
                                     use_kernel=use_kernel)
    want = JaxTMix.advance_state(jp, jnp.asarray(x), jcfg,
                                 {k: jnp.asarray(v) for k, v in st.items()},
                                 jacc)
    _close(got["S"], want["S"], 1e-5)
    _close(got["x_last"], want["x_last"], 0)
    _, per = RWKV6TimeMix.window(p, _t(x), cfg, tst, use_kernel=use_kernel)
    rows = torch.arange(B)
    assert got["S"].dtype == torch.float32
    for k in ("S", "x_last"):
        assert torch.equal(got[k], per[k][rows, acc - 1]), k
    cm = RWKV6ChannelMix.advance_state(pc, _t(x), cfg,
                                       {"x_last": tst["x_last"]}, acc)
    jcm = JaxCMix.advance_state(jpc, jnp.asarray(x), jcfg,
                                {"x_last": jnp.asarray(st["x_last"])}, jacc)
    _close(cm["x_last"], jcm["x_last"], 0)
    _, cper = RWKV6ChannelMix.window(pc, _t(x), cfg,
                                     {"x_last": tst["x_last"]})
    assert torch.equal(cm["x_last"], cper["x_last"][rows, acc - 1])


def test_mamba_full_gradient_matches_jax(jamba):
    """``full`` at T = 256 (the chunked scan, each chunk checkpointed):
    the gradients of a weighted sum of its output with respect to every
    parameter and the input, against ``jax.grad``."""
    cfg, jcfg, jparams, params = jamba
    p, jp = _layer0(params, jparams, "mixer")
    x = _x(cfg, (1, 256), 9)
    wgt = np.random.default_rng(10).standard_normal(
        (1, 256, cfg.d_model)).astype(np.float32)
    leaves = {k: ({n: t.clone().requires_grad_() for n, t in v.items()}
                  if isinstance(v, dict) else v.clone().requires_grad_())
              for k, v in p.items()}
    xt = _t(x).requires_grad_()
    (Mamba.full(leaves, xt, cfg) * _t(wgt)).sum().backward()
    jg, jgx = jax.jit(jax.grad(
        lambda q, xx: jnp.sum(JaxMamba.full(q, xx, jcfg) * wgt),
        argnums=(0, 1)))(jp, jnp.asarray(x))
    pairs = [(xt.grad, jgx)]
    for k, v in leaves.items():
        if isinstance(v, dict):
            pairs += [(t.grad, jg[k][n]) for n, t in v.items()]
        else:
            pairs.append((v.grad, jg[k]))
    for g, w in pairs:
        w = np.asarray(w)
        assert g is not None
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4,
            atol=1e-4 * max(float(np.abs(w).max()), 1e-12))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rwkv_two_pass_step_equals_one_pass(rwkv, use_kernel):
    """The reduced rwkv6-7b through ``make_serve_step`` in both forms from
    the same prefilled cache, on each route, over three fixed-point rounds
    (the accept counts grow): tokens, accept counts and every recurrent
    state (time mix and channel mix) bitwise equal."""
    cfg, _, _, params = rwkv
    rng = np.random.default_rng(11)
    B, L, W = 2, 7, 8
    prompts = _t(rng.integers(0, cfg.vocab, size=(B, L)))
    _, _, nc = TransformerLM.decode_window(
        params, cfg, prompts, TransformerLM.init_cache(cfg, B, 16),
        torch.zeros(B, dtype=torch.int64), use_kernel=use_kernel)
    cache = TransformerLM.select_states(cfg, nc, torch.full((B,), L))
    eps = _t(rng.gumbel(size=(B, W, cfg.vocab)).astype(np.float32))
    cand = _t(rng.integers(0, cfg.vocab, size=(B, W)))
    cl = torch.full((B,), L)
    one, two = (make_serve_step(cfg, W, low_memory=lm, use_kernel=use_kernel)
                for lm in (False, True))
    for _ in range(3):
        out1, acc1, sel = one(params, cand, cache, cl, eps)
        out2, acc2, adv = two(params, cand, cache, cl, eps)
        assert torch.equal(out1, out2) and torch.equal(acc1, acc2)
        for a, b in zip(tree_leaves(sel), tree_leaves(adv)):
            assert torch.equal(a, b)
        cand = torch.cat([cand[:, :1], out1[:, :-1]], dim=1)
    assert int(acc1.max()) > 1
