"""The model axis for training (``launch/train.py:shard_train_step``,
``sharding/{collectives,tensor_parallel,moe_shard}.py``'s backward, the
optimizers on placed leaves) on the CPU: gloo, reduced qwen3-1.7b and
reduced dbrx-132b in float32 with JAX's weights, the ranks in two spawns of
``tests/torch_train_mesh_driver.py`` (which imports only the port): world 4
(data 2 x model 2, then ``no_tp``, then dbrx's MoE layer in both, then
dbrx whole at two microbatches a step) and world 2 (data 1 x model 2,
then the same ranks under ``no_tp``, then data 2 x model 1). The batch is
B = 4, S = 16 of ``token_batches``.

Tolerances, each a leaf's max |difference| over its max |value|:
``GRAD_TOL`` (1e-5) against the port's single-process step for the
gradients gathered whole, the global norm, the loss (absolute) and the
optimizers' gathered state and parameters (float32 sums in another
order), except AdamW's, held within ``ADAMW_TOL`` (1e-3): its first step
divides each gradient element by its own magnitude, so an element whose
gradient is at the rounding level steps by up to the learning rate either
way, and the two runs' parameters and moments then part by more than a
sum's rounding (3.4e-4 at most in my run); ``JAX_TOL`` (1e-4, ``test_torch_train.py``'s) against
JAX's ``jax.value_and_grad(lm_loss)``. Every planted fault
(``chip_smoke.TRAIN_FAULTS``) must move the gradients or the norm
past ``GRAD_TOL``. Replicated leaves are checked bitwise across the ranks
after every step (``tensor_parallel.agree_replicas`` raises otherwise).
The MoE layer: ``moe_apply_sharded``'s output and gradients within
``GRAD_TOL`` of ``MoE.apply`` at capacity None (no-drop: each token's
output is its own), and at capacity 1.25 of the per-data-rank emulation
(each data rank's tokens through ``MoE.apply`` at their local capacity,
the load-balancing loss averaged over data), and an Adafactor step on the
placed experts; and within ``JAX_TOL`` of JAX's own ``moe_apply_sharded``
under ``jax.grad`` at both capacities, run at data 2 x model 2 in a
subprocess of four forced host devices (``JAX_MOE``), once its gradients
at capacity None are shown within ``JAX_TOL`` of JAX's ``MoE.apply``. Two
microbatches a step (dbrx whole at data 2 x model 2): the gradients and
the metrics within ``GRAD_TOL`` of the per-microbatch emulation, whose
microbatch ``i`` is the global batch's, split over data."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree as jax_restore_pytree
from repro.configs import get_config as jax_get_config
from repro.models.losses import lm_loss as jax_lm_loss
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch import optim
from repro_torch.checkpoint.io import (load_pytree, params_from_numpy,
                                       reference_tree, save_pytree)
from repro_torch.configs import get_config
from repro_torch.data.synthetic import token_batches
from repro_torch.launch import train as train_cli
from repro_torch.models.moe import MoE
from repro_torch.optim.optimizers import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding.collectives import JOINT, Axis

from torch_train_mesh_driver import (LR, MOE_AUX, STEPS, TRAIN_FAULTS,
                                     flat, make_opt)

ROOT = Path(__file__).resolve().parents[1]
DRIVER = ROOT / "tests" / "torch_train_mesh_driver.py"
GRAD_TOL = 1e-5
ADAMW_TOL = 1e-3
JAX_TOL = 1e-4
B, S = 4, 16
LAYOUTS = ("2x2", "no_tp", "1x2", "1x2_no_tp", "2x1")
SIZES = {"2x2": (2, 2), "no_tp": (2, 2), "1x2": (1, 2), "1x2_no_tp": (1, 2),
         "2x1": (2, 1)}

# JAX's moe_apply_sharded at data 2 x model 2 on four forced host devices
# (its own process: the test's JAX has one device), on the port's layer and
# inputs: argv DIR MOE_AUX; writes DIR/moe_jax.npz
JAX_MOE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models.moe import MoE
    from repro.sharding.moe_shard import moe_apply_sharded

    d, moe_aux = sys.argv[1], float(sys.argv[2])
    cfg = get_config("dbrx-132b", reduced=True)
    p = {}
    for k, v in np.load(d + "/moe_layer.npz").items():
        a, b = k.split("/")
        p.setdefault(a, {})[b] = jnp.asarray(v)
    inp = np.load(d + "/moe_inputs.npz")
    x, r = jnp.asarray(inp["x"]), jnp.asarray(inp["r"])
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {}
    for cap, tag, w in ((None, "none", 0.0), (1.25, "1.25", moe_aux)):
        fns = [("sharded", lambda p, x: moe_apply_sharded(p, x, cfg, mesh,
                                                          cap))]
        if cap is None:     # tokens independent: the single device's too
            fns.append(("single", lambda p, x: MoE.apply(
                p, x, cfg, capacity_factor=None)))
        for name, fn in fns:
            def loss(p, x):
                y, aux = fn(p, x)
                return jnp.sum(y * r) / 2 + w * aux, (y, aux)
            with mesh:
                (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(p, x)
            out[f"{name}/{tag}/y"] = np.asarray(y)
            out[f"{name}/{tag}/aux"] = np.asarray(aux)
            out[f"{name}/{tag}/grad_x"] = np.asarray(gx)
            for a in gp:
                for b in gp[a]:
                    out[f"{name}/{tag}/grad/{a}/{b}"] = np.asarray(gp[a][b])
    np.savez(d + "/moe_jax.npz", **out)
''')


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_driver(scenario, directory):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(DRIVER), scenario,
                          str(directory)], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def references(cfg, params, b0, b1):
    """The port's single-process step: step 1's loss, norm and gradients,
    and two steps of each optimizer, flattened as the driver reads them."""
    ref = {}
    step = train_cli.make_train_step(cfg, make_opt("sgd"), remat=True)
    m, g = step.local_grads(params, torch.from_numpy(b0))
    ref.update({f"grad/{k}": v for k, v in flat(g).items()})
    meta = {"loss": float(m["loss"]),
            "gnorm": float(train_cli.global_norm(g))}
    for name in LR:
        opt = make_opt(name)
        p = tree_map(lambda t: t.clone(), params)
        state = opt.init(p)
        step = train_cli.make_train_step(cfg, opt, remat=True)
        losses = []
        for b in (b0, b1)[:STEPS[name]]:
            p, state, m = step(p, state, torch.from_numpy(b))
            losses.append(float(m["loss"]))
        meta[name] = losses
        ref.update({f"{name}/params/{k}": v for k, v in flat(p).items()})
        for slot, tree in state.items():
            if slot != "step":
                ref.update({f"{name}/{slot}/{k}": v
                            for k, v in flat(tree).items()})
    return ref, meta


def moe_references(cfg, layer, x, r):
    """The whole MoE layer: at capacity None, (sum(y * r)) / D through
    ``MoE.apply``; at 1.25, the per-data-rank emulation (each data rank's
    rows at their local capacity, the aux averaged over data) and an
    Adafactor step with its gradients."""
    D = 2
    out = {}
    for cap in (None, 1.25):
        tag = "none" if cap is None else "1.25"
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     layer)
        xt = torch.from_numpy(x).requires_grad_(True)
        rt = torch.from_numpy(r)
        if cap is None:
            y, aux = MoE.apply(p, xt, cfg, capacity_factor=None)
            loss = (y.float() * rt).sum() / D
        else:
            b = x.shape[0] // D
            ys, auxes = zip(*[MoE.apply(p, xt[d * b:(d + 1) * b], cfg,
                                        capacity_factor=cap)
                              for d in range(D)])
            y = torch.cat(ys)
            aux = sum(auxes) / D
            loss = (y.float() * rt).sum() / D + MOE_AUX * aux
        leaves = tree_leaves(p)
        gl = torch.autograd.grad(loss, [xt] + leaves)
        grads = tree_unflatten(p, list(gl[1:]))
        out.update({f"{tag}/grad/{k}": v for k, v in flat(grads).items()})
        out[f"{tag}/y"] = y.detach().numpy()
        out[f"{tag}/grad_x"] = gl[0].numpy()
        out[f"{tag}/aux"] = float(aux.detach())
        if cap is not None:
            opt = optim.adafactor(LR["adafactor"])
            p = tree_map(lambda t: t.detach().clone(), layer)
            state = opt.init(p)
            opt.step(grads, state, p)
            out.update({f"adafactor/{k}": v
                        for k, v in flat(state["v"]).items()})
            out.update({f"adafactor/params/{k}": v
                        for k, v in flat(p).items()})
    return out


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh")
    cfg = get_config("qwen3-1.7b", reduced=True)
    jcfg = jax_get_config("qwen3-1.7b", reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    save_pytree(tree, str(d), 0)
    it = token_batches(64, B, S, cfg.vocab)
    b0, b1 = next(it).astype(np.int64), next(it).astype(np.int64)
    np.savez(d / "inputs.npz", b0=b0, b1=b1)
    params = params_from_numpy(tree, cfg, device="cpu")
    ref, meta = references(cfg, params, b0, b1)
    np.savez(d / "ref.npz", **ref)
    # JAX: one value_and_grad of the reference's loss
    (jloss, _), jgrads = jax.value_and_grad(jax_lm_loss, has_aux=True)(
        jparams, jcfg, jnp.asarray(b0, jnp.int32))
    jflat = flat(params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg,
                                   device="cpu"))

    dcfg = get_config("dbrx-132b", reduced=True)
    djcfg = jax_get_config("dbrx-132b", reduced=True)
    dtree = jax.tree.map(np.asarray, JaxLM.init(jax.random.PRNGKey(0), djcfg))
    save_pytree(dtree, str(d / "dbrx"), 0)
    dparams = params_from_numpy(dtree, dcfg, device="cpu")
    moe_i = next(i for i, (_, f) in enumerate(dcfg.layer_specs())
                 if f == "moe")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 8, dcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((4, 8, dcfg.d_model)).astype(np.float32)
    np.savez(d / "moe_inputs.npz", x=x, r=r)
    moe_ref = moe_references(dcfg, dparams["layers"][moe_i]["ffn"], x, r)
    np.savez(d / "moe_layer.npz", **flat(dparams["layers"][moe_i]["ffn"]))
    jax_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
    jax_out = subprocess.run([sys.executable, "-c", JAX_MOE, str(d),
                              str(MOE_AUX)], capture_output=True, text=True,
                             env=jax_env, cwd=ROOT, timeout=300)
    assert jax_out.returncode == 0, jax_out.stderr[-4000:]
    np.savez(d / "dbrx_batch.npz", b=next(token_batches(
        64, B, S, dcfg.vocab)).astype(np.int64))

    ranks = {"w4": run_driver("w4", d), "w2": run_driver("w2", d)}
    by_layout = {t: [r[t] for r in ranks["w4"]] for t in ("2x2", "no_tp")}
    by_layout.update({t: [r[t] for r in ranks["w2"]]
                      for t in ("1x2", "1x2_no_tp", "2x1")})
    return dict(dir=d, cfg=cfg, ref=ref, meta=meta, jloss=float(jloss),
                jflat=jflat, layouts=by_layout,
                moe={t: [r[k] for r in ranks["w4"]]
                     for t, k in (("2x2", "moe"), ("no_tp", "moe_no_tp"))},
                moe_ref=moe_ref, moe_jax=dict(np.load(d / "moe_jax.npz")),
                dbrx_tree=dtree,
                accum_metrics=[r["dbrx_accum"] for r in ranks["w4"]],
                moe_got={t: dict(np.load(d / f"moe_{t}.npz"))
                         for t in ("2x2", "no_tp")}, tree=tree)


def rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_step_gradients_match_single_process_and_jax(mesh, layout):
    meta = mesh["meta"]
    for r in mesh["layouts"][layout]:
        s = r["sound"]
        assert abs(s["loss"] - meta["loss"]) < GRAD_TOL, (layout, s["loss"])
        assert abs(s["loss"] - mesh["jloss"]) < JAX_TOL
        assert abs(s["gnorm"] - meta["gnorm"]) < GRAD_TOL * meta["gnorm"]
        assert s["grad_rel"] < GRAD_TOL, (layout, s["by_leaf"])
    got = dict(np.load(mesh["dir"] / f"grads_{layout}.npz"))
    assert set(got) == set(mesh["jflat"])
    for k, want in mesh["jflat"].items():
        assert rel(got[k], want) < JAX_TOL, (layout, k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_planted_faults_exceed_the_tolerance(mesh, layout):
    """Each fault the layout can show (the copy_to backward needs a model
    axis, the data mean and the FSDP sum a data axis) moves the gradients
    or the global norm past ``GRAD_TOL``."""
    d, m = SIZES[layout]
    no_tp = layout.endswith("no_tp")
    want = {k for k, shows in TRAIN_FAULTS.items()
            if (shows(d * m, 1) if no_tp else shows(d, m))}
    gnorm = mesh["meta"]["gnorm"]
    for r in mesh["layouts"][layout]:
        assert set(r["faults"]) == want
        for name, f in r["faults"].items():
            moved = max(f["grad_rel"], abs(f["gnorm"] - gnorm) / gnorm)
            assert moved > GRAD_TOL, (layout, name, f, r["sound"])
            assert moved > 10 * r["sound"]["grad_rel"], (layout, name)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("opt", tuple(LR))
def test_optimizer_steps_on_placed_leaves_match_single_process(mesh, layout,
                                                                opt):
    """Two steps of SGD and AdamW and one of Adafactor (``STEPS``) from
    JAX's weights: the losses, the parameters and the optimizer's state
    (AdamW's mu and nu, Adafactor's vr and vc) gathered whole, against the
    single-process step's; SGD's update is linear in the gradients.
    Replicated leaves agreed bitwise across the ranks after each step (the
    driver raises otherwise)."""
    tol = ADAMW_TOL if opt == "adamw" else GRAD_TOL
    for r in mesh["layouts"][layout]:
        got = r[opt]
        assert np.abs(np.asarray(got["losses"])
                      - np.asarray(mesh["meta"][opt])).max() < GRAD_TOL
        assert got["rel"] < tol, (layout, opt, got["by_leaf"])
    keys = {k.split("/")[1] for k in mesh["ref"] if k.startswith(opt + "/")}
    assert keys == {"sgd": {"params"}, "adamw": {"params", "mu", "nu"},
                    "adafactor": {"params", "v"}}[opt]


def test_layouts_split_the_leaves_as_the_rules_say(mesh):
    """At data 2 x model 2 the large leaves are split over both axes; under
    ``no_tp`` over the joint axis, at data 1 x model 2 too (the batch is
    split over it there); at data 1 x model 2 over the model only; at data
    2 x model 1 over the data only."""
    n = {t: mesh["layouts"][t][0]["n_split"] for t in LAYOUTS}
    # wq, wk, wv, wo, up, gate, down of both layers and the table
    assert n["2x2"] == {"data": 15, "model": 15, JOINT: 0}
    assert n["no_tp"] == {"data": 0, "model": 0, JOINT: 15}
    assert n["1x2"] == {"data": 0, "model": 15, JOINT: 0}
    assert n["1x2_no_tp"] == {"data": 0, "model": 0, JOINT: 15}
    assert n["2x1"] == {"data": 15, "model": 0, JOINT: 0}


@pytest.mark.parametrize("layout", ("2x2", "no_tp"))
def test_moe_layer_no_drop_matches_moe_apply(mesh, layout):
    """Capacity None: ``moe_apply_sharded`` at data 2 x model 2 (each data
    rank's rows, 2 experts a rank), and under ``no_tp`` (each rank's row,
    its data rank's rows gathered, the experts whole), against
    ``MoE.apply`` on the whole batch: the output, the input's gradient and
    every leaf's."""
    got, want = mesh["moe_got"][layout], mesh["moe_ref"]
    for k in ("none/y", "none/grad_x"):
        assert rel(got[k], want[k]) < GRAD_TOL, k
    keys = [k for k in want if k.startswith("none/grad/")]
    assert {"none/grad/router/w", "none/grad/experts/up",
            "none/grad/experts/down"} <= set(keys)
    for k in keys:
        assert rel(got[k], want[k]) < GRAD_TOL, k
    E = get_config("dbrx-132b", reduced=True).n_experts
    for r in mesh["moe"][layout]:
        assert r["experts_local"] == (E if layout == "no_tp" else E // 2)
        assert r["split"] == ([JOINT] if layout == "no_tp"
                              else ["data", "model"])


@pytest.mark.parametrize("layout", ("2x2", "no_tp"))
def test_moe_layer_local_capacity_matches_the_emulation(mesh, layout):
    """Capacity 1.25 at data 2: each data rank routes its own tokens at
    their local capacity and the aux is averaged over data, as the
    reference's shard_map computes; against the per-data-rank emulation,
    the aux's gradient reaching each data rank's own aux once. Then one
    Adafactor step on the placed experts (E over model and dim 1 over
    data, or under ``no_tp`` a dim over both): vr, vc and the parameters
    gathered whole."""
    got, want = mesh["moe_got"][layout], mesh["moe_ref"]
    for k in [k for k in want if k.startswith(("1.25/", "adafactor/"))
              and k != "1.25/aux"]:
        assert rel(got[k], want[k]) < GRAD_TOL, k
    for r in mesh["moe"][layout]:
        assert abs(r["aux_1.25"] - want["1.25/aux"]) < GRAD_TOL
    # the local capacity drops entries the global one keeps: not MoE.apply
    assert rel(got["1.25/y"], want["none/y"]) > GRAD_TOL


def test_jax_moe_apply_sharded_is_an_oracle_at_no_drop(mesh):
    """JAX's ``moe_apply_sharded`` at data 2 x model 2 under ``jax.grad``
    agrees with JAX's ``MoE.apply`` at capacity None (tokens independent):
    the output, the input's gradient and every leaf's within ``JAX_TOL``,
    so it serves as the oracle below."""
    j = mesh["moe_jax"]
    keys = [k[len("sharded/none/"):] for k in j
            if k.startswith("sharded/none/") and not k.endswith("/aux")]
    assert {"y", "grad_x", "grad/router/w", "grad/experts/up"} <= set(keys)
    for k in keys:
        assert rel(j[f"sharded/none/{k}"], j[f"single/none/{k}"]) < JAX_TOL, k


@pytest.mark.parametrize("cap", ("none", "1.25"))
@pytest.mark.parametrize("layout", ("2x2", "no_tp"))
def test_moe_layer_matches_jax_moe_apply_sharded(mesh, layout, cap):
    """The port's placed MoE layer against JAX's ``moe_apply_sharded`` on
    the same layer and inputs: the output, the load-balancing loss (the
    mean over data at 1.25), the input's gradient and every leaf's within
    ``JAX_TOL``; at 1.25 the aux weighs 1 in the loss, so the router's
    gradient holds the aux's, each data rank's reaching the router once."""
    got, j = mesh["moe_got"][layout], mesh["moe_jax"]
    keys = [k[len(f"sharded/{cap}/"):] for k in j
            if k.startswith(f"sharded/{cap}/") and not k.endswith("/aux")]
    for k in keys:
        assert rel(got[f"{cap}/{k}"], j[f"sharded/{cap}/{k}"]) < JAX_TOL, k
    if cap == "1.25":
        for r in mesh["moe"][layout]:
            assert abs(r["aux_1.25"] - float(j["sharded/1.25/aux"])) < JAX_TOL


def test_accumulated_microbatches_hold_the_reference_rows(mesh, monkeypatch):
    """Reduced dbrx-132b at data 2 x model 2 with two microbatches a step
    (capacity 1.25): the gradients summed over the ranks and the metrics
    averaged over data within ``GRAD_TOL`` of the per-microbatch
    emulation (the port's single-process step with each microbatch's MoE
    tokens routed per data rank, the aux averaged over data), whose
    microbatch ``i`` is the global rows ``[2i, 2i + 2)`` split over data,
    as the reference cuts them. Cutting each rank's contiguous rows into
    microbatches instead logs other rows' metrics."""
    cfg = get_config("dbrx-132b", reduced=True)
    params = params_from_numpy(mesh["dbrx_tree"], cfg, device="cpu")
    batch = np.load(mesh["dir"] / "dbrx_batch.npz")["b"]
    D, A = 2, 2
    apply = MoE.apply

    def per_data_rank(p, x, cfg, capacity_factor=1.25):
        b = x.shape[0] // D
        ys, auxes = zip(*[apply(p, x[d * b:(d + 1) * b], cfg,
                                capacity_factor) for d in range(D)])
        return torch.cat(ys), sum(auxes) / D
    monkeypatch.setattr(MoE, "apply", staticmethod(per_data_rank))
    step = train_cli.make_train_step(cfg, make_opt("sgd"), remat=True,
                                     accum_steps=A)
    m, g = step.local_grads(params, torch.from_numpy(batch))
    # each rank's contiguous rows cut into microbatches: microbatch i is
    # rows i and 2 + i
    contiguous = np.arange(B).reshape(D, A, -1).transpose(1, 0, 2).ravel()
    m_other, _ = step.local_grads(params, torch.from_numpy(batch[contiguous]))
    got = dict(np.load(mesh["dir"] / "grads_dbrx_accum.npz"))
    want = flat(g)
    assert set(got) == set(want)
    for k in want:
        assert rel(got[k], want[k]) < GRAD_TOL, k
    for r in mesh["accum_metrics"]:
        for k in ("loss", "xent", "moe_aux"):
            assert abs(r[k] - float(m[k])) < GRAD_TOL * abs(float(m[k])), k
        assert abs(r["loss"] - float(m_other["loss"])) > GRAD_TOL


def test_checkpoint_written_on_a_mesh_restores_bitwise(mesh):
    """AdamW's parameters after two steps at data 2 x model 2, written by
    rank 0 from the leaves gathered whole: the port's loader gives them
    bitwise, and the reference's ``restore_pytree`` reads the same
    arrays."""
    cfg = mesh["cfg"]
    d = str(mesh["dir"] / "ckpt_2x2")
    params = params_from_numpy(load_pytree(d, 2), cfg, device="cpu")
    want = dict(np.load(mesh["dir"] / "params_2x2.npz"))
    got = flat(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    jtree = jax_restore_pytree(d, 2)
    mine = flat(reference_tree(params, cfg))
    jflat = {k: np.asarray(v, np.float32) for k, v in flat_numpy(jtree)}
    assert set(jflat) == set(mine)
    for k in mine:
        np.testing.assert_array_equal(jflat[k], mine[k])


def flat_numpy(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_numpy(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat_numpy(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def test_train_cli_on_a_mesh_logs_the_single_process_losses(tmp_path):
    """``launch.train --mesh 1,2 --device cpu``: two model ranks over gloo
    log, on rank 0 alone, the losses the single process logs, and
    ``--ckpt-dir`` writes the leaves gathered whole once, within
    ``ADAMW_TOL`` of the single process's parameters."""
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
            "--steps", "2", "--batch", "4", "--seq", "16", "--log-every",
            "1"]
    params, logged = train_cli.main(argv)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *argv, "--mesh", "1,2", "--ckpt-dir",
                          str(tmp_path), "--ckpt-every", "2"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "(data 1, model 2) mesh, 2 ranks (gloo)" in out.stdout
    lines = [l for l in out.stdout.splitlines() if l.startswith("step ")]
    assert len(lines) == 2
    for (step, loss), line in zip(logged, lines):
        assert line.startswith(f"step {step} loss {loss:.4f}")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000002.json", "ckpt_00000002.npz"]
    got = flat(params_from_numpy(load_pytree(str(tmp_path), 2),
                                 get_config("qwen3-1.7b", reduced=True),
                                 device="cpu"))
    for k, want in flat(params).items():
        assert rel(got[k], want) < ADAMW_TOL, k


@pytest.mark.parametrize("arch", ("deepseek-v3-671b", "rwkv6-7b",
                                  "jamba-1.5-large-398b"))
def test_mla_and_recurrent_mixers_on_a_training_mesh_name_item_20c(arch):
    cfg = get_config(arch, reduced=True)
    axes = {"data": Axis("data", 0, 1), "model": Axis("model", 0, 2),
            JOINT: Axis(JOINT, 0, 2)}
    with pytest.raises(NotImplementedError, match="20c"):
        train_cli.shard_train_step(cfg, make_opt("sgd"), axes)
