"""The port's disk tier (``serving/hostcache/disk.py``) and the host tier's
fall-through to it, against the reference's on the CPU.

The frame codec byte for byte (float32, int32 and uint8, numpy arrays and
tensors), every inconsistency rejected, ``durable_name``; the bfloat16 gap
of the reference's frames (its ``decode_entry`` returns two-byte voids)
and the port's layout, which gives bfloat16 back bitwise; ``DiskTier``
driven beside the reference's through one script with equal stats after
every step; the tier's arena -> disk -> miss fall-through beside the
reference's tier; and one reduced qwen3-1.7b block's ``.blk`` file byte for
byte the JAX engine's for the same contents and chain key."""
import os
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import TransformerLM as JaxLM
from repro.serving import HostTier as JaxTier
from repro.serving import ServingEngine as JaxEngine
from repro.serving.faults import CircuitBreaker as JaxBreaker
from repro.serving.faults import FaultPlan as JaxFaultPlan
from repro.serving.hostcache.disk import DiskTier as JaxDisk
from repro.serving.hostcache.disk import decode_entry as jax_decode
from repro.serving.hostcache.disk import durable_name as jax_durable_name
from repro.serving.hostcache.disk import encode_entry as jax_encode
from repro_torch.configs import get_config
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import CircuitBreaker, FaultPlan
from repro_torch.serving.hostcache import (DiskTier, HostTier, LeafLayout,
                                           decode_entry, durable_name,
                                           encode_entry)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "serving"))
from recovery_driver import ENGINE_KW as JAX_KW  # noqa: E402
from recovery_driver import EPS_KEY as JAX_EPS  # noqa: E402
from recovery_driver import make_requests as jax_requests  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = torch.device("cpu")


def _blk(fill, shape=(4, 8), dtype=np.float32):
    return np.full(shape, fill, dtype)


def _mixed():
    rng = np.random.default_rng(3)
    return [rng.standard_normal((4, 2, 8)).astype(np.float32),
            rng.integers(-2 ** 31, 2 ** 31 - 1, (3, 5)).astype(np.int32),
            rng.integers(0, 256, (7,)).astype(np.uint8),
            np.zeros((0,), np.float32), np.ones((2, 1, 3), np.int32)]


# ---------------------------------------------------------------------------
# the frame codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("as_tensor", [False, True])
def test_frames_byte_equal_the_reference(as_tensor):
    """float32, int32, uint8 and empty arrays framed to the reference's
    bytes, from numpy arrays and from tensors; each package decodes the
    other's frame to the same arrays."""
    arrays = _mixed()
    src = [torch.from_numpy(a) for a in arrays] if as_tensor else arrays
    frame = encode_entry(src)
    assert frame == jax_encode(arrays)
    for got in (decode_entry(jax_encode(arrays)), jax_decode(frame)):
        assert len(got) == len(arrays)
        for a, b in zip(arrays, got):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_decode_rejects_every_inconsistency():
    frame = encode_entry([_blk(1)])
    bad = [frame[:-1], frame[:len(frame) // 2], b"", frame + b"x"]
    for i in (-1, 0):              # bit rot in the payload, the magic
        b = bytearray(frame)
        b[i] ^= 0xFF
        bad.append(bytes(b))
    for buf in bad:
        assert decode_entry(buf) is None and jax_decode(buf) is None


@pytest.mark.parametrize("ns,shard,key", [
    ("kv", 0, 0x1234), ("rec", 3, -1), ("kv", 0, 2 ** 61 - 1),
    ("rec", 1, -(2 ** 61))])
def test_durable_name_equals_the_references(ns, shard, key):
    assert durable_name(ns, shard, key) == jax_durable_name(ns, shard, key)
    assert len(durable_name(ns, shard, key)) == len(f"{ns}_{shard}_") + 20


def test_bfloat16_gap_closed_by_the_layout(tmp_path):
    """The reference writes ``ml_dtypes.bfloat16`` as ``'<V2'`` and decodes
    it as a two-byte void array; the port frames a bfloat16 tensor to the
    same bytes, and its tier, through the layout, gives it back as
    bfloat16, bitwise."""
    x = torch.randn(2, 4, 3, dtype=torch.float32).to(torch.bfloat16)
    ref_arr = x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    frame = encode_entry([x])
    assert frame == jax_encode([ref_arr])
    (dec,) = jax_decode(frame)
    assert dec.dtype.str == "|V2" and dec.dtype != ref_arr.dtype
    (mine,) = decode_entry(frame)
    assert mine.dtype.str == "|V2"
    leaves = [torch.zeros((5, 4, 3), dtype=torch.bfloat16)
              for _ in range(2)]
    lay = LeafLayout.of(leaves, [([0, 1], True)])
    tier = HostTier(1 << 20, device=CPU, disk=DiskTier(str(tmp_path)))
    tier.set_layout("kv", lay)
    packed = [torch.cat([x[0].reshape(-1), x[1].reshape(-1)])]
    assert tier.put_kv(0, 7, packed) and tier.flush_to_disk(0, [7]) == 1
    with open(tmp_path / durable_name("kv", 0, 7), "rb") as f:
        assert f.read() == frame            # the two leaves stacked
    tier.arena.drop(("kv", 0, 7))
    got = tier.get_kv(0, 7)
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0].view(torch.int16), packed[0].view(torch.int16))
    assert tier.stats_export()["disk_promotes"] == 1


def test_layout_packs_mixed_dtypes_and_rejects_a_foreign_entry():
    """Leaves of two dtypes interleaved (the engine packs one flat tensor
    per dtype, in first-appearance order) go to the reference's arrays and
    back bitwise; arrays of another shape or dtype are no entry."""
    rng = np.random.default_rng(0)
    rows = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, 3), (4,), (2, 3))]
    rows[1] = rows[1].to(torch.bfloat16)
    leaves = [r[None].expand(5, *r.shape) for r in rows]
    lay = LeafLayout.of(leaves, [([0, 2], True), ([1], False)])
    packed = [torch.cat([rows[0].reshape(-1), rows[2].reshape(-1)]),
              rows[1].reshape(-1)]
    ref = lay.to_reference(packed)
    assert [tuple(a.shape) for a in ref] == [(2, 2, 3), (4,)]
    arrays = decode_entry(encode_entry(ref))
    back = lay.from_reference(arrays)
    assert torch.equal(back[0], packed[0])
    assert torch.equal(back[1].view(torch.int16), packed[1].view(torch.int16))
    assert lay.from_reference(arrays[:1]) is None
    assert lay.from_reference([arrays[0][:1], arrays[1]]) is None
    assert lay.from_reference([arrays[0].astype(np.float64),
                               arrays[1]]) is None


# ---------------------------------------------------------------------------
# DiskTier beside the reference's
# ---------------------------------------------------------------------------

FRAME = len(jax_encode([_blk(0)]))


def _script(faults):
    """(op, args) steps over both tiers; "restart" opens a new tier on the
    same directory, "orphan" leaves a crash's .tmp, "rmdir" takes the
    directory away (every later write an OSError)."""
    steps = [("put", i) for i in range(5)]
    steps += [("get", 0), ("get", 4), ("put", 99), ("put", 2), ("get", 2),
              ("contains", 3), ("drop", 3), ("drop", 3), ("get", 3),
              ("orphan", None), ("restart", None), ("get", 2), ("put", 5),
              ("get", 5), ("get", 6), ("put", 6), ("put", 7), ("get", 7)]
    if faults is None:
        steps += [("rmdir", None), ("put", 8), ("get", 5), ("get", 7)]
    else:
        for i in range(10, 22):
            steps += [("put", i), ("get", i), ("get", i - 2)]
        steps += [("drop", 13), ("contains", 14)]
    return steps


def _step(d, op, arg, as_tensor, root):
    name = durable_name("kv", 0, arg) if arg is not None else None
    if op == "put":
        a = _blk(arg, (64, 64) if arg == 99 else (4, 8))
        return d.put(name, [torch.from_numpy(a)] if as_tensor else [a])
    if op == "get":
        got = d.get(name)
        return None if got is None else [np.asarray(x).tolist() for x in got]
    if op == "orphan":
        with open(os.path.join(root, "kv_0_dead.blk.tmp"), "wb") as f:
            f.write(b"half a frame")
        return None
    if op == "rmdir":
        for n in os.listdir(root):
            os.unlink(os.path.join(root, n))
        os.rmdir(root)
        return None
    return getattr(d, op)(name)


@pytest.mark.parametrize("faults", [
    None, "disk_full=@2;3;4,disk_torn_write=@1;7,disk_slow=@0;3",
    "seed=5,disk_full=0.3,disk_torn_write=0.2,disk_slow=0.5"])
def test_disk_tier_matches_the_reference_on_one_script(tmp_path, faults):
    """Budget LRU, dedup, an entry too large, drops, an index rebuilt by a
    restart with an orphan swept; with faults a torn write caught at the
    read, ENOSPC tripping the breaker and its half-open probe, a slow
    read; without, a directory gone (OSError) degrading to misses. Every
    answer and ``stats_export`` equal the reference's at every step."""
    roots = [str(tmp_path / "port"), str(tmp_path / "ref")]

    def make(cls, root, br, plan):
        return cls(root, capacity_bytes=3 * FRAME, faults=plan(faults)
                   if faults else None, breaker=br(threshold=2, cooldown=3))

    mine = make(DiskTier, roots[0], CircuitBreaker, FaultPlan.parse)
    ref = make(JaxDisk, roots[1], JaxBreaker, JaxFaultPlan.parse)
    seen = {}                     # the largest value of each counter
    for op, arg in _script(faults):
        if op == "restart":
            mine = DiskTier(roots[0], capacity_bytes=3 * FRAME,
                            faults=mine.faults, breaker=mine.breaker)
            ref = JaxDisk(roots[1], capacity_bytes=3 * FRAME,
                          faults=ref.faults, breaker=ref.breaker)
            assert mine.stats.orphans_swept == ref.stats.orphans_swept == 1
        else:
            assert (_step(mine, op, arg, True, roots[0])
                    == _step(ref, op, arg, False, roots[1])), (op, arg)
        assert mine.stats_export() == ref.stats_export(), (op, arg)
        assert mine.bytes_resident <= mine.capacity_bytes
        for k, v in mine.stats_export().items():
            if isinstance(v, int):
                seen[k] = max(seen.get(k, 0), v)
    st = seen
    assert st["disk_evictions"] > 0 and st["disk_rejections"] > 0
    if faults is None:
        assert st["disk_hits"] > 0 and st["disk_misses"] > 0
    else:
        assert st["disk_checksum_failures"] >= 1 and st["disk_tripped"] >= 1
        assert mine.faults.fired == ref.faults.fired


def test_drop_is_never_gated(tmp_path):
    d = DiskTier(str(tmp_path))
    d.put(durable_name("kv", 0, 1), [_blk(1)])
    d.breaker.state, d.breaker._cooldown_left = "open", 100
    assert not d.contains(durable_name("kv", 0, 1))
    assert d.drop(durable_name("kv", 0, 1)) and len(d) == 0
    assert not d.drop(durable_name("kv", 0, 1))


# ---------------------------------------------------------------------------
# the host tier's fall-through, beside the reference's tier
# ---------------------------------------------------------------------------

def test_tier_falls_through_to_disk_like_the_reference(tmp_path):
    """Two-entry arenas over disk tiers: victims demote, ``has_kv`` and
    ``kv_run`` see disk-resident keys, a get promotes, a pin promotes
    pinned, ``flush_to_disk`` makes resident keys durable, a snapshot
    falls through, a key on neither is a miss, and the stats (arena, disk,
    promotes, spills) equal the reference's; a new tier over the same
    directory hits what the first one spilled."""
    blk = 8 * 4 * 4
    mine = HostTier(2 * blk, device=CPU,
                    disk=DiskTier(str(tmp_path / "port")))
    ref = JaxTier(2 * blk, disk=JaxDisk(str(tmp_path / "ref")))
    for t, conv in ((mine, lambda a: [torch.from_numpy(x) for x in a]),
                    (ref, list)):
        for k in range(4):
            assert t.put_kv(0, k, conv([_blk(k)]))
        assert t.put_rec(0, 50, conv([_blk(50)]))
        assert t.has_kv(0, 0) and t.kv_run(0, [0, 1, 2, 3, 9]) == 4
        got = t.get_kv(0, 1)
        np.testing.assert_array_equal(np.asarray(got[0]), _blk(1))
        assert t.pin_kv(0, 0)
        assert t.flush_to_disk(0, [0, 1, 50], ns="kv") == 2
        assert t.flush_to_disk(0, [50], ns="rec") == 1
        np.testing.assert_array_equal(np.asarray(t.get_rec(0, 50)[0]),
                                      _blk(50))
        assert t.get_kv(0, 77) is None and not t.has_kv(0, 77)
        assert not t.pin_kv(0, 77)
        t.unpin_kv(0, 0)
    assert mine.stats_export() == ref.stats_export()
    st = mine.stats_export()
    assert st["disk_spills"] >= 3 and st["disk_promotes"] >= 2
    again = HostTier(2 * blk, device=CPU,
                     disk=DiskTier(str(tmp_path / "port")))
    np.testing.assert_array_equal(again.get_kv(0, 3)[0].numpy(), _blk(3))
    assert again.stats_export()["disk_hits"] == 1


# ---------------------------------------------------------------------------
# a reduced qwen3-1.7b block on disk, beside the JAX engine's
# ---------------------------------------------------------------------------

def test_block_file_byte_equals_the_jax_engines(tmp_path):
    """The JAX engine's durable run parks a request, which flushes its
    prompt blocks to disk; the same contents in the port's pool (written
    leaf by leaf into block 1), spilled under the same chain key, give a
    byte-equal ``.blk`` file, and each package reads the other's file to
    the same rows."""
    jcfg = jax_get_config("qwen3-1.7b", reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    jdir = tmp_path / "jax"
    jeng = JaxEngine(jcfg, jparams, eps_key=JAX_EPS, durable_dir=str(jdir),
                     **JAX_KW)
    reqs = jax_requests(jcfg)
    jeng.submit(reqs[0])
    jeng.step()
    for r in reqs[1:]:
        jeng.submit(r)
    jeng.run()
    jeng.close()
    files = sorted(n for n in os.listdir(jdir / "disk") if n.startswith("kv"))
    assert files and jeng.export_metrics()["disk_spills"] >= 1
    name = files[0]
    key = int(name.split("_")[2].removesuffix(".blk"), 16)
    key = key - 2 ** 64 if key >= 2 ** 63 else key
    jbytes = (jdir / "disk" / name).read_bytes()
    k, v = jax_decode(jbytes)             # (layers, block, kv heads, width)

    cfg = get_config("qwen3-1.7b", reduced=True)
    eng = ServingEngine(cfg, TransformerLM.init(cfg, seed=0, device=CPU),
                        batch=1, window_max=4, max_len=64, block_size=4,
                        durable_dir=str(tmp_path / "port"), device=CPU)
    leaves = TransformerLM.pool_leaves(cfg, eng.paged)
    for layer in range(cfg.n_layers):
        leaves[2 * layer][1] = torch.from_numpy(k[layer].copy())
        leaves[2 * layer + 1][1] = torch.from_numpy(v[layer].copy())
    rows = eng._collect_block_payload([1])[0]
    assert eng.tier.put_kv(0, key, rows)
    assert eng.tier.flush_to_disk(0, [key]) == 1
    mine = (tmp_path / "port" / "disk" / name).read_bytes()
    assert mine == jbytes
    # each package reads the other's file
    other = JaxDisk(str(tmp_path / "port" / "disk")).get(name)
    np.testing.assert_array_equal(other[0], k)
    eng.tier.arena.drop(("kv", 0, key))
    for n in os.listdir(tmp_path / "port" / "disk"):
        os.unlink(tmp_path / "port" / "disk" / n)
    (tmp_path / "port" / "disk" / name).write_bytes(jbytes)
    back = ServingEngine(cfg, eng.params, batch=1, window_max=4, max_len=64,
                         block_size=4, durable_dir=str(tmp_path / "port"),
                         device=CPU)
    got = back.tier.get_kv(0, key)
    assert len(got) == 1 and torch.equal(got[0], rows[0])
