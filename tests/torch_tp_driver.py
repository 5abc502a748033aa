"""Child process of the port's model-axis tests (not a test file:
``test_torch_tensor_parallel.py`` and ``test_torch_moe_shard.py`` run it as
a subprocess). It imports only the port, spawns the ranks of one scenario
over gloo on the CPU (``sharding.collectives.spawn``, one torch thread a
rank) and prints their results as one JSON list, rank by rank, on its last
line.

* ``tp DIR`` — world 2, model 2, reduced qwen3-1.7b in float32 from the
  checkpoint ``DIR/ckpt_00000000`` with the paged inputs of
  ``DIR/inputs.npz``: each rank's slices against the whole leaves; the
  paged verify window's logits at model 2 and at model 1 under the op
  census (collectives by axis); the reference's tensor-parallel traffic at
  data 2 x model 2 (batch 4) and data 1 x model 2 (batch 2).
* ``moe DIR`` — world 4, data 2 x model 2, reduced dbrx-132b in float32
  from ``DIR``'s checkpoint and its input ``x``: ``_moe_ep_only`` at model
  2 (each data pair on the whole ``x``), ``moe_apply_sharded`` (``x`` split
  over data, the experts over model and data) and a served run at model 2
  on each data pair.
* ``gpu BACKEND`` — world 2 on the card (``tests/test_torch_gpu.py``):
  reduced qwen3-1.7b in float32 (the port's weights, seed 0) at model 2,
  both ranks on ``cuda:0`` over gloo, or a card each over NCCL; the
  reference's TP traffic on the kernel path, its tokens, launches and
  contract reports (``REPRO_CHECK_CONTRACTS=1`` in the environment: under
  NCCL every dispatch also runs under sync-debug "error"), and the
  window logits against model 1's.

Usage: ``python torch_tp_driver.py {tp,moe} DIR`` or ``python
torch_tp_driver.py gpu {gloo,nccl}``
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis import Census  # noqa: E402
from repro_torch.checkpoint.io import load_pytree, params_from_numpy  # noqa: E402,E501
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402
from repro_torch.models.transformer import PagedView, TransformerLM  # noqa: E402,E501
from repro_torch.serving.admission import Request  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.topology import ServingTopology  # noqa: E402
from repro_torch.sharding import collectives  # noqa: E402
from repro_torch.sharding.moe_shard import _moe_ep_only, moe_apply_sharded  # noqa: E402,E501
from repro_torch.sharding.rules import param_specs  # noqa: E402
from repro_torch.sharding.tensor_parallel import place, placements_of  # noqa: E402,E501

CPU = torch.device("cpu")
EPS_SEED = 9
TP_KW = dict(window_max=4, max_len=32, eps_key=EPS_SEED, block_size=4,
             adaptive=False)


def tp_traffic(vocab):
    """The reference's TP_SCRIPT traffic: 4 requests, prompts of 2-6
    tokens, 3-5 new."""
    rng = np.random.default_rng(3)
    return [Request(uid=i, prompt=rng.integers(0, vocab,
                                               size=int(rng.integers(2, 7))),
                    new_tokens=int(rng.integers(3, 6))) for i in range(4)]


def serve(cfg, params, reqs, **kw):
    eng = ServingEngine(cfg, params, **kw)
    for r in reqs:
        assert eng.submit(r), r.error
    done = {r.uid: r for r in eng.run()}
    assert all(r.ok for r in done.values()), [r.error for r in done.values()]
    return eng, {u: r.result.tolist() for u, r in done.items()}


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def slices_of(params, placed) -> dict:
    """How many leaves are split, and whether each is the whole leaf's
    slice, bitwise."""
    n, equal = 0, True
    for (_, whole), (_, mine) in zip(leaves(params), leaves(placed)):
        want = whole
        for pl in placements_of(mine).values():
            want = want.narrow(pl.dim, pl.lo, pl.size)
        n += bool(placements_of(mine))
        equal &= want.shape == mine.shape and torch.equal(want, mine)
    return {"n_split": n, "n_leaves": len(list(leaves(params))),
            "slices_equal": bool(equal)}


def tp_rank(rank, world, store_path, ckpt):
    torch.set_num_threads(1)
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = params_from_numpy(load_pytree(ckpt, 0), cfg, device=CPU)
    mesh = make_host_mesh(1, 2, devices=("cpu",), rank=rank,
                          store_path=store_path)
    topo = ServingTopology(mesh)
    placed = topo.place_params(cfg, params)
    out = slices_of(params, placed)

    inp = np.load(Path(ckpt) / "inputs.npz")
    pools = [torch.from_numpy(inp[f"pool{i}"])
             for i in range(2 * cfg.n_layers)]

    def window(p):
        paged = TransformerLM.init_paged_cache(cfg, 2, pools[0].shape[0], 4)
        for leaf, src in zip(TransformerLM.pool_leaves(cfg, paged), pools):
            leaf.copy_(src)
        logits, _, _ = TransformerLM.decode_window_paged(
            p, cfg, torch.from_numpy(inp["tokens"]), paged,
            PagedView(torch.from_numpy(inp["tables"]), torch.arange(2)),
            torch.from_numpy(inp["cache_len"]))
        return logits
    ref = window(params)
    with Census() as c:
        got = window(placed)
    out.update(logits_err_vs_model1=float((got - ref).abs().max()),
               logits=got.tolist(), census=c.collectives_by_axis,
               c10d_axes=sorted({str(r.axis) for r in c.ops
                                 if r.op.startswith("c10d")}))

    # the reference's TP traffic: data 2 x model 2 at batch 4, and data 1 x
    # model 2 at batch 2 (the same rows a call)
    d2 = ServingTopology(make_host_mesh(2, 2, devices=("cpu", "cpu")))
    eng, out["tokens_d2"] = serve(cfg, placed, tp_traffic(cfg.vocab),
                                  topology=d2, batch=4, **TP_KW)
    reps = eng.contract_reports
    out["contracts"] = sorted({r.contract for r in reps})
    out["contracts_ok"] = bool(reps) and all(r.ok for r in reps)
    out["collectives_checked"] = sum(
        v["count"] for r in reps
        for v in r.metrics["collectives_by_axis"].get("model", {}).values())
    _, out["tokens_d1"] = serve(cfg, placed, tp_traffic(cfg.vocab),
                                topology=topo, batch=2, **TP_KW)
    m = eng.export_metrics()
    out["host_syncs"] = m["host_syncs"]
    return out


def moe_rank(rank, world, store_path, ckpt):
    torch.set_num_threads(1)
    cfg = get_config("dbrx-132b", reduced=True)
    params = params_from_numpy(load_pytree(ckpt, 0), cfg, device=CPU)
    axes = collectives.init_axes(rank, world, 2, store_path=store_path,
                                 backend="gloo")
    model, data = axes["model"], axes["data"]
    x = torch.from_numpy(np.load(Path(ckpt) / "inputs.npz")["x"])
    moe_i = next(i for i, (_, f) in enumerate(cfg.layer_specs())
                 if f == "moe")
    # the serving layout: the experts over model only, x whole
    mesh = make_host_mesh(1, 2, devices=("cpu",))
    tp_params = ServingTopology(mesh).place_params(cfg, params)
    p_ep = tp_params["layers"][moe_i]["ffn"]
    y_ep, aux_ep = _moe_ep_only(p_ep, x, cfg, None, model)
    y_apply, _ = MoE.apply(p_ep, x, cfg, capacity_factor=None)
    # the training layout: experts over model (E) and data (dim 1), x
    # split over data
    specs = param_specs(cfg, params, mesh_2x2())
    p_tr = place(params, specs, axes)["layers"][moe_i]["ffn"]
    b = x.shape[0] // data.size
    y_tr, aux_tr = moe_apply_sharded(p_tr, x[data.rank * b:(data.rank + 1)
                                             * b], cfg, None, model, data)
    # served at model 2 on this data pair's two ranks
    _, tokens = serve(cfg, tp_params, tp_traffic(cfg.vocab),
                      topology=ServingTopology(mesh), batch=2, **TP_KW)
    return {"y_ep": y_ep.tolist(), "aux_ep": float(aux_ep),
            "ep_apply_equal": bool(torch.equal(y_ep, y_apply)),
            "y_tr": y_tr.tolist(), "aux_tr": float(aux_tr),
            "data_rank": data.rank, "model_rank": model.rank,
            "experts_local": int(p_ep["experts"]["up"].shape[0]),
            "tokens": tokens}


def gpu_rank(rank, world, store_path, backend):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sharding.collectives import stages_through_host
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = TransformerLM.init(cfg, seed=0, device=dev)
    devices = ("cuda:0", "cuda:1") if backend == "nccl" else ("cuda:0",)
    topo = ServingTopology(make_host_mesh(1, 2, devices=devices,
                                          backend=backend, rank=rank,
                                          store_path=store_path))
    placed = topo.place_params(cfg, params)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 4)), device=dev)

    def window(p):
        paged = TransformerLM.init_paged_cache(cfg, 2, 3, 4, device=dev)
        tables = torch.arange(1, 3, device=dev).view(2, 1).int()
        logits, _, _ = TransformerLM.decode_window_paged(
            p, cfg, toks, paged, PagedView(tables, torch.arange(
                2, device=dev), True), torch.zeros(2, dtype=torch.int64,
                                                   device=dev))
        return logits
    err = float((window(placed) - window(params)).abs().max())
    reset_launches()
    eng, tokens = serve(cfg, placed, tp_traffic(cfg.vocab), topology=topo,
                        batch=2, use_verify_kernel=True, host_cache_mb=0,
                        **TP_KW)
    reps = eng.contract_reports
    return {"tokens": tokens, "launches": dict(LAUNCHES),
            "logits_err_vs_model1": err, "backend": topo.mesh.backend,
            "sync_check": not stages_through_host(),
            "contracts_ok": all(r.ok for r in reps), "checked": len(reps)}


def mesh_2x2():
    from repro_torch.launch.mesh import Mesh
    return Mesh(axis_names=("data", "model"), shape={"data": 2, "model": 2},
                devices=())


if __name__ == "__main__":
    scenario, arg = sys.argv[1:3]
    fn, world = {"tp": (tp_rank, 2), "moe": (moe_rank, 4),
                 "gpu": (gpu_rank, 2)}[scenario]
    print(json.dumps(collectives.spawn(fn, world, arg, timeout=300)))
