"""The mesh engine's host-side pieces against the reference's, on the CPU:
``ServingTopology``'s partition math (over a ``FakeMesh``, as
``tests/serving/test_topology.py`` drives the reference's),
``ShardedBlockPool`` (routing, sub-pools, a migration's block accounting,
the merged counters) on the same scripts, and ``paged_partition_specs``
leaf by leaf for every arch's reduced config; ``make_host_mesh`` and the
host tier's per-shard rings. No engine runs here."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import TransformerLM as JaxLM
from repro.serving import ServingTopology as JaxTopology
from repro.serving import ShardedBlockPool as JaxPool
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.blocks import ShardedBlockPool, chain_hashes
from repro_torch.serving.hostcache import HostTier
from repro_torch.serving.topology import ServingTopology

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



class FakeMesh:
    """Only ``shape`` and ``axis_names`` are read by the partition math."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("shape", [None, {"data": 2, "model": 4},
                                   {"data": 4, "model": 1}])
def test_partition_math_matches_the_reference(shape):
    mine = ServingTopology(None if shape is None else FakeMesh(shape))
    ref = JaxTopology(None if shape is None else FakeMesh(shape))
    assert mine.data_size == ref.data_size
    assert mine.auto_axes == ref.auto_axes
    for batch in (4, 8, 16):
        per = mine.slots_per_shard(batch)
        assert per == ref.slots_per_shard(batch)
        for b in range(batch):
            assert mine.shard_of_slot(b, batch) == ref.shard_of_slot(b,
                                                                     batch)
        for s in range(mine.data_size):
            assert mine.slot_range(s, batch) == ref.slot_range(s, batch)
            for r in range(per):
                assert mine.global_slot(s, r, batch) == ref.global_slot(
                    s, r, batch)
            assert mine.block_offset(s, 33) == ref.block_offset(s, 33)
    if mine.data_size > 1:
        # both refuse a batch that does not divide over the shards
        with pytest.raises(ValueError):
            mine.slots_per_shard(5)
        with pytest.raises(AssertionError):
            ref.slots_per_shard(5)


def test_route_matches_the_reference():
    rng = np.random.default_rng(1)
    cases = [(3, {0: 5, 1: 9}), (3, {1: 9, 0: 5}), (3, {0: 9, 1: 9}),
             (6, {0: 5, 1: 4}), (5, {0: 5, 1: 4}), (1, {})]
    cases += [(int(rng.integers(0, 12)),
               {int(s): int(rng.integers(-3, 12))
                for s in rng.choice(4, size=int(rng.integers(0, 5)),
                                    replace=False)})
              for _ in range(200)]
    for need, head in cases:
        assert ShardedBlockPool.route(need, head) == JaxPool.route(need,
                                                                   head)
    assert ShardedBlockPool.route(3, {0: 9, 1: 9}) == 0      # tie: lowest
    assert ShardedBlockPool.route(5, {0: 5, 1: 4}) == 0      # exact fit


def _pool_state(pool):
    return [(m.free, list(m.cached_free), m.refcount.tolist(),
             dict(m.block_of), dict(m.hash_of), m.stats.export())
            for m in pool.shards]


def test_sharded_pool_script_matches_the_reference():
    """A random script of allocations, releases, registrations, prefix
    lookups and migrations on two sub-pools: the same ids, free and
    cached-free lists, refcounts, prefix maps and counters as the
    reference's after every step, and the same merged export."""
    rng = np.random.default_rng(7)
    mine, ref = ShardedBlockPool(2, 12, 2), JaxPool(2, 12, 2)
    prompts = [rng.integers(0, 9, 9) for _ in range(4)]
    held = {0: [], 1: []}
    for step in range(300):
        s = int(rng.integers(0, 2))
        op = rng.choice(["alloc", "release", "register", "lookup",
                         "migrate"])
        n = int(rng.integers(1, 3))
        prompt = prompts[step % 4]
        got = []
        for pool in (mine, ref):
            m = pool.manager(s)
            try:
                if op == "alloc":
                    out = m.alloc(n)
                elif op == "release" and held[s]:
                    out = m.release(held[s][-1])
                elif op == "register" and held[s]:
                    keys = chain_hashes(prompt, 2)
                    out = m.register(held[s][-1], keys[len(held[s]) % 4])
                elif op == "lookup":
                    out = m.lookup_prefix(prompt, 4)
                elif op == "migrate" and held[s]:
                    out = pool.begin_migration(s, 1 - s, 1)
                    pool.finish_migration(s, [held[s][-1]])
                else:
                    out = None
            except MemoryError as e:
                out = f"MemoryError: {e}"
            got.append(out)
        assert got[0] == got[1], (step, op, got)
        out = got[0]
        if op == "alloc" and isinstance(out, list):
            held[s] += out
        elif op == "release" and held[s]:
            held[s].pop()
        elif op == "lookup":
            held[s] += out[0]
        elif op == "migrate" and isinstance(out, list):
            held[s].pop()
            held[1 - s] += out
        assert _pool_state(mine) == _pool_state(ref), (step, op)
        assert mine.available() == ref.available()
        assert mine.blocks_in_use() == ref.blocks_in_use()
    assert mine.stats_export() == ref.stats_export()
    assert mine.stats_export()["blocks_migrated_in"] > 0


def test_prefix_caches_do_not_cross_shards():
    """The same prompt hits on shard 0 and misses on shard 1, and the
    merged hit rate is recomputed over both."""
    pool = ShardedBlockPool(2, 8, 2)
    prompt = np.asarray([5, 6, 7, 8, 9])
    m0 = pool.manager(0)
    blocks = m0.alloc(2)
    for b, k in zip(blocks, chain_hashes(prompt, 2)):
        m0.register(b, k)
    assert m0.lookup_prefix(prompt, 2)[0] == blocks
    assert pool.manager(1).lookup_prefix(prompt, 2)[0] == []
    merged = pool.stats_export()
    assert (merged["prefix_hits"], merged["prefix_misses"],
            merged["prefix_hit_rate"]) == (2, 2, 0.5)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_partition_specs_match_the_reference(arch):
    """Leaf by leaf, each of the port's per-layer leaves splits on the
    dimension the reference's array holding it splits on (past a stacked
    array's layer axis), and the leaves' shapes agree."""
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                               reduced=True)
    batch, blocks, bs = 4, 6, 4
    paged = TransformerLM.init_paged_cache(cfg, batch, blocks, bs,
                                           device="meta")
    specs = TransformerLM.paged_partition_specs(cfg, paged)
    jpaged = JaxLM.init_paged_cache(jcfg, batch, blocks, bs)
    jspecs = JaxLM.paged_partition_specs(jcfg, jpaged)
    pre, blk = len(cfg.layer_prefix), len(cfg.layer_block)
    suf0 = pre + blk * cfg.n_blocks
    walk = ([("prefix", i, [i], False) for i in range(pre)]
            + [("suffix", j, [suf0 + j], False)
               for j in range(len(cfg.layer_suffix))]
            + [("blocks", j, [pre + r * blk + j for r in range(cfg.n_blocks)],
                True) for j in range(blk if cfg.n_blocks else 0)])
    seen = 0
    for seg, i, layers, stacked in walk:
        jentry, jleaves = jspecs[seg][i], jpaged[seg][i]
        for layer in layers:
            assert set(specs["layers"][layer]) == set(jentry)
            for part, keys in jentry.items():
                assert set(specs["layers"][layer][part]) == set(keys)
                for key, jspec in keys.items():
                    spec = specs["layers"][layer][part][key]
                    leaf = paged["layers"][layer][part][key]
                    jleaf = jleaves[part][key]
                    want = tuple(jspec)[1:] if stacked else tuple(jspec)
                    assert spec[:len(want)] == want
                    assert all(d is None for d in spec[len(want):])
                    assert len(spec) == leaf.ndim
                    jshape = jleaf.shape[1:] if stacked else jleaf.shape
                    assert tuple(leaf.shape) == tuple(jshape)
                    seen += 1
    assert seen == len(TransformerLM.pool_leaves(cfg, paged)) + len(
        TransformerLM.state_leaves(cfg, paged))
    assert jax.tree.leaves(jspecs)     # the reference's tree is not empty


def test_make_host_mesh():
    mesh = make_host_mesh(2, devices=("cpu", "cpu"))
    assert mesh.shape == {"data": 2, "model": 1}
    assert mesh.devices == (torch.device("cpu"),) * 2
    topo = ServingTopology(mesh)
    assert topo.data_size == 2 and topo.auto_axes == frozenset()
    assert topo.device(1) == torch.device("cpu")
    assert ServingTopology().device(0, "cpu") == torch.device("cpu")
    # a model axis is one process a rank: without its rank and the group's
    # store, and with no group made, this process cannot be one
    with pytest.raises(ValueError, match="rank"):
        make_host_mesh(2, 2, devices=("cpu", "cpu"))
    with pytest.raises(ValueError):
        make_host_mesh(2, devices=("cpu",))
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_host_mesh(2)


def test_host_tier_keys_carry_the_shard_and_one_ring_a_device():
    """One arena, one budget, a key space per shard; two shards on one
    device share its staging ring."""
    tier = ServingTopology(make_host_mesh(
        2, devices=("cpu", "cpu"))).host_tier(1 << 20)
    assert tier.num_shards == 2
    assert tier.staging_for(0) is tier.staging_for(1) is tier.staging
    rows = [torch.arange(6, dtype=torch.float32)]
    assert tier.put_kv(0, 11, rows)
    assert tier.has_kv(0, 11) and not tier.has_kv(1, 11)
    assert tier.kv_run(1, [11]) == 0 and tier.kv_run(0, [11]) == 1
    assert tier.stats_export()["h2d_staged"] == 0
    with pytest.raises(ValueError):
        HostTier(1 << 20, 2, device=["cpu"])


def test_migration_copy_contract_matches_the_reference():
    from repro.analysis import MIGRATION_COPY_CONTRACT as JaxMigration
    from repro_torch.analysis import MIGRATION_COPY_CONTRACT
    assert MIGRATION_COPY_CONTRACT.rule_names() == JaxMigration.rule_names()
