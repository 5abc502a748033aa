"""The port's image ARM against the JAX package's: the raster-scan masks,
``Conv2D`` (stride 1 and 2, transposed), ``MaskedConv2D``, ``PixelCNN``,
``PixelForecast``, the joint bits/dim + 0.01 KL loss and its gradient,
samples, and the weight bridge from a reference checkpoint. JAX runs on
the CPU; both sides get the reference's parameters.

Tolerances: masks, group ids and the Appendix-B-free integer paths
bitwise; convolutions 1e-5 absolute (float32 sums in another order);
PixelCNN logits and h, forecast logits 1e-4 absolute plus 1e-4 relative
(a few convolutions deep); bits/dim, the KL and the loss 1e-5 relative;
gradients 1e-4 of each leaf's largest gradient plus 1e-7. Strict
triangular dependence is held bitwise: logits at positions <= j do not
change, to the bit, when inputs at j or from j on do. Samples follow the
margin rule (``engine/agreement.py``) at a tolerance of 1e-3, which
exceeds the logits' gap.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_pytree as jax_save_pytree
from repro.configs import paper as jpaper
from repro.core import forecasting as jfc
from repro.core import predictive_sampling as jps
from repro.models.pixelcnn import PixelCNN as JPixelCNN
from repro.nn import core as jcore
from repro_torch import optim
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten
from repro_torch.checkpoint.io import (restore_pytree, tree_from_numpy,
                                       tree_to_numpy)
from repro_torch.configs import paper
from repro_torch.core import predictive_sampling as ps
from repro_torch.core.forecasting import PixelForecast, PixelForecastConfig
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.models.losses import pixelcnn_loss
from repro_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from repro_torch.nn import core


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's torch work on one thread, put back after it: its many
    small ops lose most of their time to the thread pool when the suite's
    workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CFG_BIN = PixelCNNConfig(height=6, width=6, channels=1, categories=2,
                         filters=8, n_res=2, first_kernel=5)
CFG_RGB = PixelCNNConfig(height=4, width=4, channels=3, categories=4,
                         filters=12, n_res=2, first_kernel=3)
CONFIGS = {"bin": CFG_BIN, "rgb": CFG_RGB,
           **{f"reduced_{k}": v for k, v in paper.PIXELCNN_REDUCED.items()}}


def _jcfg(cfg):
    from repro.models.pixelcnn import PixelCNNConfig as JConfig
    return JConfig(**vars(cfg))


def _jfcfg(fcfg):
    return jfc.PixelForecastConfig(**vars(fcfg))


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed):
    return JPixelCNN.init(jax.random.PRNGKey(seed), _jcfg(cfg))


def _params(cfg, seed=0):
    """The reference's PixelCNN parameters: (JAX tree, a fresh copy as the
    port's tree)."""
    jp = _jax_params(cfg, seed)
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _images(cfg, B, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.categories, size=(B, cfg.height, cfg.width, cfg.channels))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("kh,kw,n_in,n_out,groups,mask_type", [
    (7, 7, 6, 12, 3, "A"), (3, 3, 24, 12, 3, "B"), (1, 1, 24, 6, 3, "B"),
    (5, 5, 2, 8, 1, "A"), (3, 3, 16, 16, 1, "T"), (3, 5, 8, 4, 2, "B")])
def test_masks_equal_reference(kh, kw, n_in, n_out, groups, mask_type):
    gi, go = core.group_ids(n_in, groups), core.group_ids(n_out, groups)
    np.testing.assert_array_equal(gi, jcore.group_ids(n_in, groups))
    np.testing.assert_array_equal(
        core._pixelcnn_mask(kh, kw, gi, go, mask_type),
        jcore._pixelcnn_mask(kh, kw, gi, go, mask_type))


@pytest.mark.parametrize("name", ["bin", "rgb", "reduced_cifar10_8bit"])
def test_init_masks_and_shapes_equal_reference(name):
    cfg = CONFIGS[name]
    jp, _ = _params(cfg)
    mine = PixelCNN.init(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    # both flatten dicts in sorted key order
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = tree_leaves(mine)
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        path = jax.tree_util.keystr(path)
        assert g.shape == w.shape, path
        if "_mask" in path:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k,stride,transpose", [
    (3, 1, False), (4, 2, False), (7, 1, False), (1, 1, False),
    (4, 2, True), (3, 1, True)])
def test_conv2d_matches_reference(k, stride, transpose):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, 8, 10, 5)).astype(np.float32)
    p = {"w": rng.standard_normal((k, k, 5, 6)).astype(np.float32),
         "b": rng.standard_normal((6,)).astype(np.float32)}
    kw = dict(stride=(stride, stride), transpose=transpose)
    want = jcore.Conv2D.apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              **kw)
    got = core.Conv2D.apply(tree_from_numpy(p), torch.from_numpy(x), **kw)
    assert got.shape == want.shape
    _close(got, want, 1e-5)


@pytest.mark.parametrize("mask_type", ["A", "B", "T"])
def test_masked_conv2d_matches_reference(mask_type):
    p = jcore.MaskedConv2D.init(jax.random.PRNGKey(0), 12, 9, (5, 5),
                                mask_type=mask_type, groups_in=3,
                                groups_out=3)
    x = np.random.default_rng(0).standard_normal((2, 7, 7, 12)).astype(
        np.float32)
    want = jcore.MaskedConv2D.apply(p, jnp.asarray(x))
    got = core.MaskedConv2D.apply(tree_from_numpy(jax.tree.map(np.asarray,
                                                               p)),
                                  torch.from_numpy(x))
    _close(got, want, 1e-5)
    _close(core.concat_elu(torch.from_numpy(x)),
           jcore.concat_elu(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pixelcnn_logits_h_and_bpd_match_reference(name):
    cfg = CONFIGS[name]
    jp, tp = _params(cfg)
    x = _images(cfg, 3)
    jl, jh = JPixelCNN.forward_int(jp, jnp.asarray(x), _jcfg(cfg))
    tl, th = PixelCNN.forward_int(tp, torch.from_numpy(x), cfg)
    assert tl.shape == jl.shape and th.shape == jh.shape
    _close(tl, jl, 1e-4, 1e-4)
    _close(th, jh, 1e-4, 1e-4)
    _close(PixelCNN.bpd(tp, torch.from_numpy(x), cfg),
           JPixelCNN.bpd(jp, jnp.asarray(x), _jcfg(cfg)), 0, 1e-5)
    # the flat ARM interface and its h shape
    arm = PixelCNN.make_arm_fn(tp, cfg)
    lg, h = arm(torch.from_numpy(x.reshape(3, cfg.d)))
    assert lg.shape == (3, cfg.d, cfg.categories)
    assert tuple(h.shape) == arm.h_shape(3)
    assert cfg.flat_to_chw(cfg.d - 1) == (cfg.channels - 1, cfg.height - 1,
                                          cfg.width - 1)


@pytest.mark.parametrize("name", ["bin", "rgb", "reduced_binary_mnist",
                                  "reduced_cifar10_8bit"])
def test_strict_triangular_dependence_bitwise(name):
    """Changing x at flat position j, or every position from j on, leaves
    the logits at positions <= j unchanged to the bit; the change reaches
    some later position."""
    cfg = CONFIGS[name]
    _, tp = _params(cfg)
    arm = PixelCNN.make_arm_fn(tp, cfg)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, cfg.categories, size=(2, cfg.d)))
    base, _ = arm(x)
    for j in sorted({0, 1, cfg.channels, cfg.d // 2, cfg.d - 2, cfg.d - 1}):
        one = x.clone()
        one[:, j] = (one[:, j] + 1) % cfg.categories
        rest = x.clone()
        rest[:, j:] = torch.from_numpy(rng.integers(
            0, cfg.categories, size=(2, cfg.d - j)))
        for x2 in (one, rest):
            pert, _ = arm(x2)
            assert torch.equal(pert[:, :j + 1], base[:, :j + 1]), j
        if j < cfg.d - 1:
            assert not torch.equal(arm(one)[0][:, j + 1:],
                                   base[:, j + 1:]), j


def _forecast_setup(cfg, T, seed=0):
    fcfg = paper.forecast_cfg(cfg, T)
    jf = jfc.PixelForecast.init(jax.random.PRNGKey(seed + 1), _jfcfg(fcfg))
    return fcfg, jf, tree_from_numpy(jax.tree.map(np.asarray, jf))


@pytest.mark.parametrize("name,T", [("rgb", 2), ("bin", 5),
                                    ("reduced_cifar10_5bit", 1)])
def test_pixel_forecast_apply_and_kl_match_reference(name, T):
    cfg = CONFIGS[name]
    jp, tp = _params(cfg)
    fcfg, jf, tf = _forecast_setup(cfg, T)
    x = _images(cfg, 2)
    jl, jh = JPixelCNN.forward_int(jp, jnp.asarray(x), _jcfg(cfg))
    tl, th = PixelCNN.forward_int(tp, torch.from_numpy(x), cfg)
    jo = jfc.PixelForecast.apply(jf, jh, _jfcfg(fcfg))
    to = PixelForecast.apply(tf, th, fcfg)
    assert to.shape == (2, cfg.height * cfg.width,
                        T * cfg.channels, cfg.categories)
    _close(to, jo, 1e-4, 1e-4)
    P = cfg.height * cfg.width
    arm_j = jl.reshape(2, P, cfg.channels, cfg.categories)
    arm_t = tl.reshape(2, P, cfg.channels, cfg.categories)
    _close(PixelForecast.kl_loss(to, arm_t, fcfg),
           jfc.PixelForecast.kl_loss(jo, arm_j, _jfcfg(fcfg)), 0, 1e-5)


def _jax_joint_loss(cfg, fcfg, batch):
    """The reference's joint loss (``benchmarks/common.py``)."""
    def loss(p_all):
        p, fp = p_all
        logits, h = JPixelCNN.forward_int(p, batch, _jcfg(cfg))
        logp = jax.nn.log_softmax(logits, axis=-1)
        ll = jnp.take_along_axis(logp, batch[..., None], axis=-1)
        nll = -jnp.mean(jnp.sum(ll, axis=(1, 2, 3)))
        B = batch.shape[0]
        arm = logits.reshape(B, cfg.height * cfg.width, cfg.channels,
                             cfg.categories)
        out = jfc.PixelForecast.apply(fp, h, _jfcfg(fcfg))
        kl = jfc.PixelForecast.kl_loss(out, arm, _jfcfg(fcfg))
        return nll / (cfg.d * np.log(2.0)) + 0.01 * kl
    return loss


@pytest.mark.parametrize("name,T", [("rgb", 2), ("reduced_binary_mnist", 3)])
def test_joint_loss_gradient_matches_jax_grad(name, T):
    cfg = CONFIGS[name]
    jp, tp = _params(cfg)
    fcfg, jf, tf = _forecast_setup(cfg, T)
    x = _images(cfg, 4)
    jl, jg = jax.value_and_grad(_jax_joint_loss(cfg, fcfg, jnp.asarray(x)))(
        (jp, jf))
    tree = {"p": tp, "f": tf}
    leaves = [t.requires_grad_(True) for t in tree_leaves(tree)]
    t_all = tree_unflatten(tree, leaves)
    loss, metrics = pixelcnn_loss(t_all["p"], t_all["f"],
                                  torch.from_numpy(x), cfg, fcfg)
    _close(loss.detach(), jl, 0, 1e-5)
    grads = tree_unflatten(tree, torch.autograd.grad(loss, leaves))
    got = tree_leaves(tree_to_numpy({"p": grads["p"],
                                           "f": grads["f"]}))
    want = tree_leaves(tree_to_numpy({
        "p": tree_from_numpy(jax.tree.map(np.asarray, jg[0])),
        "f": tree_from_numpy(jax.tree.map(np.asarray, jg[1]))}))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, 1e-4 * np.abs(w).max() + 1e-7)


@pytest.mark.parametrize("name,B", [("rgb", 2), ("reduced_binary_mnist", 2),
                                    ("reduced_cifar10_5bit", 1)])
def test_samples_agree_with_reference_under_margin_rule(name, B):
    """The port's ancestral, fpi and learned-forecast samples against the
    reference's ancestral samples with the same eps: equal up to a first
    difference, where the reference's top-2 margin is below 1e-3. The
    port's samplers equal its own ancestral sample bitwise."""
    cfg = CONFIGS[name]
    jp, tp = _params(cfg)
    fcfg, _, tf = _forecast_setup(cfg, 2)
    eps = np.random.default_rng(9).gumbel(
        size=(B, cfg.d, cfg.categories)).astype(np.float32)
    jarm = JPixelCNN.make_arm_fn(jp, _jcfg(cfg))
    xj, _ = jps.ancestral_sample(jarm, jnp.asarray(eps))
    xj = np.asarray(xj)
    jlogits = np.asarray(jarm(jnp.asarray(xj))[0])
    arm = PixelCNN.make_arm_fn(tp, cfg)
    et = torch.from_numpy(eps)
    x_ref, _ = ps.ancestral_sample(arm, et)
    learned = ps.make_learned_forecast(PixelForecast.module_fn(tf, fcfg),
                                       window=2 * cfg.channels,
                                       group=cfg.channels)
    for x, _ in (ps.predictive_sample(arm, ps.fpi_forecast, et),
                 ps.predictive_sample(arm, learned, et),
                 ps.fixed_point_sample(arm, et)):
        assert torch.equal(x, x_ref)
    for b in range(B):
        check_token_agreement(
            xj[b], x_ref[b].numpy(),
            lambda p: top2_margin(jlogits[b, p] + eps[b, p]), 1e-3)


def test_bridge_from_reference_checkpoint(tmp_path):
    """A PixelCNN + PixelForecast tree that the reference's save_pytree
    wrote, read back with the port's restore_pytree, computes what JAX
    computes, masks bitwise; tree_to_numpy inverts tree_from_numpy."""
    cfg = CFG_RGB
    jp, _ = _params(cfg, seed=3)
    fcfg, jf, _ = _forecast_setup(cfg, 2, seed=3)
    jax_save_pytree({"arm": jp, "forecast": jf}, str(tmp_path), 7)
    tree = restore_pytree(str(tmp_path), 7, device="cpu")
    tp, tf = tree["arm"], tree["forecast"]
    assert isinstance(tp["res"], list) and len(tp["res"]) == cfg.n_res
    np.testing.assert_array_equal(tp["in_conv"]["_mask"].numpy(),
                                  np.asarray(jp["in_conv"]["_mask"]))
    x = _images(cfg, 2)
    jl, jh = JPixelCNN.forward_int(jp, jnp.asarray(x), _jcfg(cfg))
    tl, th = PixelCNN.forward_int(tp, torch.from_numpy(x), cfg)
    _close(tl, jl, 1e-4, 1e-4)
    _close(PixelForecast.apply(tf, th, fcfg),
           jfc.PixelForecast.apply(jf, jh, _jfcfg(fcfg)), 1e-4, 1e-4)
    back = tree_to_numpy(tp)
    for a, b in zip(tree_leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_training_reduces_bpd_and_keeps_masks():
    """The reference test's 30 AdamW steps on strokes, in the port."""
    from repro_torch.data.synthetic import binary_strokes
    cfg = PixelCNNConfig(height=8, width=8, channels=1, categories=2,
                         filters=8, n_res=1, first_kernel=5)
    params = PixelCNN.init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    masks = [params["in_conv"]["_mask"].clone()]
    data = torch.from_numpy(binary_strokes(64, 8, 8, seed=0))
    opt = optim.adamw(5e-3)
    state = opt.init(params)
    losses = []
    for _ in range(30):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss = PixelCNN.bpd(tree_unflatten(params, leaves), data, cfg)
        grads = optim.zero_frozen(tree_unflatten(
            params, torch.autograd.grad(loss, leaves)))
        params, state = opt.step(grads, state, params)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8, losses
    assert torch.equal(params["in_conv"]["_mask"], masks[0])


def test_paper_configs_equal_reference():
    for name in ("PIXELCNN_FULL", "PIXELCNN_REDUCED"):
        mine, ref = getattr(paper, name), getattr(jpaper, name)
        assert {k: vars(v) for k, v in mine.items()} == {
            k: vars(v) for k, v in ref.items()}
    for name in ("AE_FULL", "AE_REDUCED", "LATENT_ARM_FULL",
                 "LATENT_ARM_REDUCED"):
        assert vars(getattr(paper, name)) == vars(getattr(jpaper, name))
    full = paper.PIXELCNN_FULL["binary_mnist"]
    assert vars(paper.forecast_cfg(full, 20)) == vars(
        jpaper.forecast_cfg(jpaper.PIXELCNN_FULL["binary_mnist"], 20))
    assert isinstance(paper.forecast_cfg(full, 20), PixelForecastConfig)
