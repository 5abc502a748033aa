"""Expert parallelism (``repro_torch/sharding/moe_shard.py``) on the CPU:
gloo, world 4 (data 2 x model 2), reduced dbrx-132b (4 experts, top-2) in
float32 with JAX's weights, the ranks in one spawn
(``tests/torch_tp_driver.py moe``, which imports only the port).

``_moe_ep_only`` at model 2 (x whole on every rank, 2 experts a rank)
and ``moe_apply_sharded`` at data 2 x model 2 (x split over data, the
experts over model on E and over data on their dim 1, the weights
gathered over data) against the no-drop ``MoE.apply`` of the port and of
JAX, within the reference test's bounds (``tests/sharding/
test_moe_shard.py``: ``err < 2e-4``, ``aux_err < 0.1``, the training
layout's aux being a per-data-shard mean); ``MoE.apply`` on placed experts
takes the expert-parallel path. And reduced dbrx served at model 2 (its
attention tensor-parallel, its experts expert-parallel) gives tokens that
agree on every rank bitwise and with the port's single-device engine under
the margin rule."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.moe import MoE as JaxMoE
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.checkpoint.io import params_from_numpy, save_pytree
from repro_torch.configs import get_config
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import make_eps_fn
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.engine import ServingEngine

from test_torch_tensor_parallel import EPS_SEED, KW, run_driver, traffic


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    cfg = get_config("dbrx-132b", reduced=True)
    jcfg = jax_get_config("dbrx-132b", reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    d = tmp_path_factory.mktemp("moe")
    save_pytree(tree, str(d), 0)
    x = np.random.default_rng(1).standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32)
    np.savez(d / "inputs.npz", x=x)
    ranks = run_driver("moe", d)
    params = params_from_numpy(tree, cfg, device="cpu")
    i = next(i for i, (_, f) in enumerate(cfg.layer_specs()) if f == "moe")
    p = params["layers"][i]["ffn"]
    y, aux = MoE.apply(p, torch.from_numpy(x), cfg, capacity_factor=None)
    jp = JaxLM_layer(jcfg, jparams, i)["ffn"]
    jy, jaux = JaxMoE.apply(jp, jax.numpy.asarray(x), jcfg,
                            capacity_factor=None)
    return dict(cfg=cfg, params=params, ranks=ranks, x=x, y=y.numpy(),
                aux=float(aux), jy=np.asarray(jy), jaux=float(jaux))


def JaxLM_layer(jcfg, jparams, i):
    """Layer ``i`` of the reference's tree (the stacked blocks unstacked)."""
    pre, per = len(jcfg.layer_prefix), len(jcfg.layer_block)
    if i < pre:
        return jparams["prefix"][i]
    j, r = divmod(i - pre, per)
    return jax.tree.map(lambda a: a[j], jparams["blocks"][r])


def test_ep_only_matches_the_dense_layer(moe):
    for r in moe["ranks"]:
        y = np.asarray(r["y_ep"], np.float32)
        assert r["experts_local"] == moe["cfg"].n_experts // 2
        assert np.abs(y - moe["y"]).max() < 2e-4
        assert np.abs(y - moe["jy"]).max() < 2e-4
        assert abs(r["aux_ep"] - moe["aux"]) < 1e-6
        assert abs(r["aux_ep"] - moe["jaux"]) < 0.1
        # MoE.apply on placed experts is this path
        assert r["ep_apply_equal"]
    ys = [r["y_ep"] for r in moe["ranks"]]
    assert all(y == ys[0] for y in ys)           # one value on every rank


def test_training_layout_matches_the_dense_layer(moe):
    """Each data rank's half of the batch, gathered in data order."""
    by_data = {}
    for r in moe["ranks"]:
        by_data.setdefault(r["data_rank"], []).append(r)
    halves = []
    for d in sorted(by_data):
        pair = by_data[d]
        assert pair[0]["y_tr"] == pair[1]["y_tr"]
        halves.append(np.asarray(pair[0]["y_tr"], np.float32))
    y = np.concatenate(halves)
    assert np.abs(y - moe["y"]).max() < 2e-4
    assert np.abs(y - moe["jy"]).max() < 2e-4
    for r in moe["ranks"]:
        assert abs(r["aux_tr"] - moe["aux"]) < 0.1
        assert abs(r["aux_tr"] - moe["jaux"]) < 0.1


def test_served_ep_tokens_hold_under_the_margin_rule(moe):
    cfg, params = moe["cfg"], moe["params"]
    toks = [r["tokens"] for r in moe["ranks"]]
    assert all(t == toks[0] for t in toks)
    got = {int(u): np.asarray(t) for u, t in toks[0].items()}
    eng = ServingEngine(cfg, params, batch=2, device="cpu", **KW)
    for r in traffic(cfg.vocab):
        assert eng.submit(r)
    eps = make_eps_fn(EPS_SEED, cfg.vocab)
    for r in eng.run():
        def margin_at(p, toks=r.result, sid=r.uid):
            logits, _, _ = TransformerLM.decode_window(
                params, cfg, torch.as_tensor(toks[None, :p]),
                TransformerLM.init_cache(cfg, 1, p),
                torch.zeros(1, dtype=torch.int64))
            e = eps(torch.tensor([sid]), torch.tensor([[p]]))
            return top2_margin((logits[0, -1] + e[0, 0]).numpy())
        check_token_agreement(r.result, got[r.uid], margin_at, tol=1e-4,
                              start=len(r.prompt))
