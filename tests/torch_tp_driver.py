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
  NCCL every dispatch also runs under sync-debug "error"), the window
  logits against model 1's, and ``durable``'s clock runs on the card.

* ``durable DIR`` — crash safety and the clock, reduced qwen3-1.7b in
  float32 (the port's weights, seed 0) on ``torch_recovery_driver.py``'s
  workload and engine settings. Every run is a process of its own,
  forked from this one (``run_forked``), so that a kill point's SIGKILL
  takes only that run: the kill matrix at model 1 (one process each
  ``serve`` and ``resume``) and at data 1 x model 2 (two ranks each),
  an uninterrupted model-2 run durable and volatile (with the files each
  rank opened for writing), the clock runs (``clock_traffic``: a deadline
  and ``max_request_seconds`` on a stepped clock, rank 1's skewed) at
  model 1 and model 2, and the planted fault, each rank deciding by its
  own clock. Each run's JSON events go to a file of its own in DIR; the
  result line holds them all.

Usage: ``python torch_tp_driver.py {tp,moe,durable} DIR`` or ``python
torch_tp_driver.py gpu {gloo,nccl}``
"""
import builtins
import json
import os
import shutil
import signal
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

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
    out = {"tokens": tokens, "launches": dict(LAUNCHES),
           "logits_err_vs_model1": err, "backend": topo.mesh.backend,
           "sync_check": not stages_through_host(),
           "contracts_ok": all(r.ok for r in reps), "checked": len(reps)}
    # the engine's clock on the card: rank 1's skewed, then each rank's own
    skew = CLOCK_SKEW if rank == 1 else None
    out["clock"] = clock_run(cfg, placed, topo, skew)
    try:
        clock_run(cfg, placed, topo, skew, own_clock=True)
        out["own_clock"] = "no divergence"
    except collectives.RankDivergence as e:
        out["own_clock"] = f"RankDivergence: {e}"
    return out


def mesh_2x2():
    from repro_torch.launch.mesh import Mesh
    return Mesh(axis_names=("data", "model"), shape={"data": 2, "model": 2},
                devices=())


# ---- durable: crash safety and the clock on the model axis ----------------

# the kill matrix of ``test_torch_recovery.py`` (point, firing index)
MATRIX = [("post_admit", 2), ("mid_spill", 1),
          ("pre_fsync", 5), ("post_sync", 3)]
# the clock runs: batch 2, W 4, fixed; ``max_request_seconds`` and the
# deadline in seconds of the stepped clock, which moves one second before
# a step and ``CLOCK_MOVES`` elsewhere
CLOCK_KW = dict(batch=2, window_max=4, max_len=64, block_size=4,
                adaptive=False, eps_key=EPS_SEED, max_request_seconds=5.0)
CLOCK_SKEW = (1000.0, 7.0)        # rank 1's clock: 1000 + 7 t
# seconds idle before the first submits, before the late ones, and within
# a step (between its top and its host sync)
CLOCK_MOVES = dict(idle=10.0, late=0.25, within=0.25)
PLANTED_BLOCK = "kv_0_00000000deadbeef.blk"


def run_forked(fn, world, *args, kill="", timeout=120.0) -> list:
    """``fn(rank, world, store_path, *args)`` in ``world`` processes forked
    from this one (the imports and the weights are shared, nothing is
    loaded again), ``REPRO_KILL_POINT=kill`` in their environment. Where a
    kill point fires, the ranks it spared (stuck in, or failed by, a
    collective with the dead one) are killed too. Returns the exit codes;
    raises where a rank raised (with its traceback) or ran past
    ``timeout``. The store's directory is removed before this returns."""
    import multiprocessing as mp
    ctx = mp.get_context("fork")
    tmp = tempfile.mkdtemp(prefix="repro_torch_forked_")
    store = os.path.join(tmp, "store")
    sys.stdout.flush()
    procs = [ctx.Process(target=_forked_rank,
                         args=(fn, r, world, store, args, kill))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        died_at = None
        timed_out = False
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if died_at is None and any(p.exitcode == -signal.SIGKILL
                                       for p in procs):
                died_at = now
            timed_out |= died_at is None and now > deadline
            if timed_out or (died_at is not None and now > died_at + 2.0):
                for p in procs:
                    if p.is_alive():
                        p.kill()
            time.sleep(0.01)
        for p in procs:
            p.join()
        codes = [p.exitcode for p in procs]
        if timed_out:
            raise RuntimeError(f"ranks still running after {timeout} s")
        if any(c not in (0, -signal.SIGKILL) for c in codes) and not died_at:
            errs = [store + f".err{r}" for r in range(world)]
            raise RuntimeError(f"exit codes {codes}: " + "".join(
                open(e).read() for e in errs if os.path.exists(e)))
        return codes
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _forked_rank(fn, rank, world, store, args, kill):
    os.environ.pop("REPRO_KILL_POINT", None)
    if kill:
        os.environ["REPRO_KILL_POINT"] = kill
    code = 0
    try:
        fn(rank, world, store, *args)
    except BaseException:
        with open(store + f".err{rank}", "w") as f:
            f.write(traceback.format_exc())
        code = 1
    finally:
        collectives.shutdown()
        sys.stdout.flush()
    os._exit(code)


def _events_to(path):
    """This process's stdout into ``path``, line-buffered: the JSON events
    ``recovery_child`` prints, each on disk before the next step."""
    sys.stdout = open(path, "w", buffering=1)


def _read_events(path) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.startswith("{")]


def _axis_topology(rank, world, store_path):
    if world == 1:
        return None
    return ServingTopology(make_host_mesh(1, world, devices=("cpu",),
                                          rank=rank, store_path=store_path))


def _engine_params(cfg, params, topo):
    return params if topo is None else topo.place_params(cfg, params)


def recovery_rank(rank, world, store_path, cfg, params, mode, ddir, out):
    """One rank (or the one process, at world 1) of a kill-matrix run:
    ``chip_smoke.recovery_child``'s loop on ``torch_recovery_driver.py``'s
    engine, its events to ``out``.<rank>."""
    from chip_smoke import recovery_child
    from torch_recovery_driver import ENGINE_KW, METRIC_KEYS, make_requests
    torch.set_num_threads(1)
    topo = _axis_topology(rank, world, store_path)
    placed = _engine_params(cfg, params, topo)
    reqs = make_requests(cfg)
    _events_to(f"{out}.{rank}")
    recovery_child(
        lambda: ServingEngine(cfg, placed, eps_key=EPS_SEED, device=None
                              if topo else "cpu", topology=topo,
                              durable_dir=ddir, journal_fsync_every=1,
                              **ENGINE_KW),
        mode, reqs[:1], reqs[1:], METRIC_KEYS)


class _Writes:
    """The files this process opens for writing (``open`` with a mode of
    w, a or x) or renames into place, by path, while it is held."""

    def __enter__(self):
        self.paths, self._open, self._rename = set(), builtins.open, os.rename

        def opened(file, mode="r", *a, **kw):
            if isinstance(file, (str, os.PathLike)) and set(mode) & set("wax"):
                self.paths.add(os.path.abspath(file))
            return self._open(file, mode, *a, **kw)

        def renamed(src, dst, *a, **kw):
            self.paths.add(os.path.abspath(dst))
            return self._rename(src, dst, *a, **kw)
        builtins.open, os.rename = opened, renamed
        return self

    def __exit__(self, *exc):
        builtins.open, os.rename = self._open, self._rename


def clock_traffic(cfg, fault=False):
    """The requests submitted first and those submitted after the first
    step. First: a long request cut by ``max_request_seconds`` (5 s of
    the stepped clock, 20 new tokens at W 4, one round a step while
    requests queue) and a short one, then one without a deadline and one
    with a deadline of 1.5 s that ranks before both (and misses it while
    it runs); after the first step, one of priority 1 with a deadline of
    2.5 s that misses it in the queue.
    ``fault``: the long and the short one first, then one more after the
    first step. Under the planted fault rank 1 (its clock 7x) cuts every
    live request at the first sync and rank 0 only the long one, later;
    the short one has finished on both by then, so the late one is
    admitted on both (into another slot on rank 1), the ranks run the
    same collectives, and the digest of the next host sync reads the
    difference."""
    rng = np.random.default_rng(11)
    long_, short = (Request(uid=0, prompt=rng.integers(0, cfg.vocab, size=6),
                            new_tokens=20),
                    Request(uid=1, prompt=rng.integers(0, cfg.vocab, size=4),
                            new_tokens=4))
    other = Request(uid=2, prompt=rng.integers(0, cfg.vocab, size=5),
                    new_tokens=5)
    if fault:
        return [long_, short], [other]
    return [long_, short, other,
            Request(uid=3, prompt=rng.integers(0, cfg.vocab, size=3),
                    new_tokens=5, deadline=1.5)], [
            Request(uid=4, prompt=rng.integers(0, cfg.vocab, size=4),
                    new_tokens=3, priority=1, deadline=2.5)]


def clock_run(cfg, params, topo=None, skew=None, own_clock=False):
    """``clock_traffic`` on a stepped clock: ``time.monotonic`` is ``t`` in
    this process (``skew`` (a, b): a + b t); ``t`` moves one second
    before each step and by ``CLOCK_MOVES`` before the first submits,
    before the late ones and within each step (as its round is
    dispatched). So a submit,
    the step's top and the sync each read another time, as a clock that
    moves on its own would give them. ``own_clock`` plants the fault: the
    engine decides by this process's clock, not rank 0's. Returns each
    request's outcome and clocks (latency, queue wait), the deadline
    counters, the queue order at the second step, the submits, the steps
    and the host broadcasts the engine issued (on a model axis one as it
    was built, one a submit, one at a step's top and one after its host
    sync; none without one)."""
    before = {k: tuple(v) for k, v in collectives.STATS.items()}
    steps = 0
    clock = [0.0]
    a, b = skew or (0.0, 1.0)
    real = time.monotonic
    time.monotonic = lambda: a + b * clock[0]
    try:
        eng = ServingEngine(cfg, params, topology=topo, device=None
                            if topo else "cpu", **CLOCK_KW)
        if own_clock:
            eng._now = time.monotonic
        dispatch = eng._round_program

        def moving(*args, **kw):
            clock[0] += CLOCK_MOVES["within"]
            return dispatch(*args, **kw)
        eng._round_program = moving
        first, late = clock_traffic(cfg, fault=own_clock)
        clock[0] += CLOCK_MOVES["idle"]
        for r in first:
            assert eng.submit(r), r.error
        order = None
        while eng._pending():
            clock[0] += 1.0
            eng.step()
            steps += 1
            if order is None:
                order = [r.uid for r in eng.queue.lookahead(8)]
                clock[0] += CLOCK_MOVES["late"]
                for r in late:
                    assert eng.submit(r), r.error
    finally:
        time.monotonic = real
    m = eng.export_metrics()
    return {"outcomes": {int(r.uid): {
                "error": r.error.code if r.error else None,
                "result": None if r.result is None else r.result.tolist(),
                "missed_deadline": bool(r.missed_deadline),
                "queue_deadline_missed": bool(r.queue_deadline_missed),
                "latency": r.latency, "queue_wait": r.queue_wait}
                for r in eng.done},
            "order_after_step_1": order, "steps": steps,
            "submits": len(first) + len(late),
            "broadcasts": {axis: kinds.get("host-broadcast", {}).get("count")
                           for axis, kinds in collectives.stats_by_axis(
                               before).items()},
            "metrics": {k: m.get(k, 0) for k in (
                "requests_failed", "requests_finished",
                "deadline_missed_in_queue", "host_syncs", "rounds")}}


def durable_rank(rank, world, store_path, cfg, params, ddir, out):
    """The uninterrupted runs, at world 2 in one process group: volatile,
    then durable under ``_Writes``, then a restore over its directory with
    a disk entry planted on the last rank alone, then the clock run with
    rank 1's clock skewed, then the planted fault
    (``clock_traffic(fault=True)``). Writes its results to
    ``out``.<rank>."""
    from torch_recovery_driver import ENGINE_KW, make_requests
    torch.set_num_threads(1)
    topo = _axis_topology(rank, world, store_path)
    placed = _engine_params(cfg, params, topo)
    res = {}

    def run(**kw):
        eng = ServingEngine(cfg, placed, topology=topo, device=None
                            if topo else "cpu", eps_key=EPS_SEED,
                            **ENGINE_KW, **kw)
        reqs = make_requests(cfg)
        eng.submit(reqs[0])
        eng.step()
        for r in reqs[1:]:
            eng.submit(r)
        done = {int(r.uid): r.result.tolist() for r in eng.run()}
        eng.close()
        return done, eng.export_metrics()
    res["volatile"], res["volatile_metrics"] = run()
    with _Writes() as w:
        res["durable"], res["durable_metrics"] = run(durable_dir=ddir)
    res["wrote"] = sorted(os.path.relpath(p, ddir) for p in w.paths
                          if p.startswith(os.path.abspath(ddir)))
    # a disk entry only the last rank holds (as a rank killed after its
    # peers may have spilled one): a restore over the directory drops it
    if world > 1 and rank == world - 1:
        with open(os.path.join(ddir, f"rank{rank}", "disk",
                               PLANTED_BLOCK), "wb") as f:
            f.write(b"\0" * 64)
    eng = ServingEngine(cfg, placed, topology=topo, device=None
                        if topo else "cpu", eps_key=EPS_SEED,
                        durable_dir=ddir, **ENGINE_KW)
    res["restored"] = eng.restore()
    res["disk_after_restore"] = sorted(eng.disk.names())
    skew = CLOCK_SKEW if rank == 1 else None
    res["clock"] = clock_run(cfg, placed, topo, skew)
    try:
        clock_run(cfg, placed, topo, skew, own_clock=True)
        res["own_clock"] = "no divergence"
    except collectives.RankDivergence as e:
        res["own_clock"] = f"RankDivergence: {e}"
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)


def durable_scenario(directory) -> dict:
    """Everything of ``durable DIR``, in this order: the uninterrupted runs
    at model 1 and at model 2 (``durable_rank``), then the kill matrix at
    model 1 and at model 2."""
    from repro_torch.analysis import Census
    torch.set_num_threads(1)
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = TransformerLM.init(cfg, seed=0, device=CPU)
    with Census():                    # its imports, once, before the forks
        torch.zeros(1) + 1
    d = Path(directory)
    out = {}
    for world in (1, 2):
        run_forked(durable_rank, world, cfg, params,
                   str(d / f"uninterrupted_m{world}"), str(d / f"m{world}"))
        out[f"model{world}"] = [json.load(open(d / f"m{world}.{r}"))
                                for r in range(world)]
    for world in (1, 2):
        runs = out[f"model{world}_matrix"] = {}
        for point, index in MATRIX:
            ddir = d / f"kill_m{world}_{point}"
            ev = str(d / f"events_m{world}_{point}")
            codes = run_forked(recovery_rank, world, cfg, params, "serve",
                               str(ddir), ev + ".serve",
                               kill=f"{point}:{index}")
            run_forked(recovery_rank, world, cfg, params, "resume", str(ddir),
                       ev + ".resume")
            runs[point] = {
                "serve_codes": codes,
                "served": [_read_events(f"{ev}.serve.{r}")
                           for r in range(world)],
                "resumed": [_read_events(f"{ev}.resume.{r}")
                            for r in range(world)]}
    return out


if __name__ == "__main__":
    scenario, arg = sys.argv[1:3]
    if scenario == "durable":
        print(json.dumps(durable_scenario(arg)))
        sys.exit(0)
    fn, world = {"tp": (tp_rank, 2), "moe": (moe_rank, 4),
                 "gpu": (gpu_rank, 2)}[scenario]
    print(json.dumps(collectives.spawn(fn, world, arg, timeout=300)))
