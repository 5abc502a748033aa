"""The dry run on the meta device (``repro_torch.launch.dryrun``) against
the reference's abstract shapes: at published widths every arch's
parameter bytes equal those of ``jax.eval_shape(TransformerLM.init)``, and
every decode pair's window cache the reference's ``_window_cache_shape``
(bytes; the port keeps RWKV-6's ``S`` and Mamba's ``h`` in float32,
ROADMAP §3, and those leaves count at 4 bytes); reduced qwen3-1.7b's
flops equal a hand count of its products; ``--all`` at the reduced
configs writes one record per pair with no error. Nothing is allocated:
every tensor lies on the meta device."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.launch import dryrun

# the recurrent states the port stores in float32 (ROADMAP §3, PRs 14, 21)
FLOAT32_STATES = ("S", "h")
DECODE_PAIRS = [(a, s) for a in ARCHS for s in SHAPES
                if SHAPES[s].kind == "decode" and shape_applicable(a, s)[0]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_bytes(tree, float32_keys=()):
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = getattr(path[-1], "key", None)
        size = 4 if key in float32_keys else jnp.dtype(leaf.dtype).itemsize
        total += int(np.prod(leaf.shape)) * size
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_equal_the_reference_abstract_params(arch):
    jcfg = jax_get_config(arch)
    want = _jax_bytes(jax.eval_shape(
        lambda: JaxLM.init(jax.random.PRNGKey(0), jcfg)))
    params = dryrun.abstract_params(get_config(arch))
    assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(
        params))
    assert dryrun.tree_bytes(params) == want


@pytest.mark.parametrize("arch,shape", DECODE_PAIRS)
def test_window_cache_bytes_equal_the_reference(arch, shape):
    """The reference's ``launch/dryrun.py:_window_cache_shape`` at the
    shape's batch and cache length, published widths."""
    jcfg = jax_get_config(arch)
    s = SHAPES[shape]
    B, W = s.global_batch, dryrun.DECODE_WINDOW
    S = -(-(s.seq_len + W) // 256) * 256
    pshape = jax.eval_shape(lambda: JaxLM.init(jax.random.PRNGKey(0), jcfg))
    cache = jax.eval_shape(lambda: JaxLM.init_cache(jcfg, B, S,
                                                    jcfg.param_dtype))
    new = jax.eval_shape(
        lambda p, c: JaxLM.decode_window(
            p, jcfg, jnp.zeros((B, W), jnp.int32), c,
            jnp.zeros((B,), jnp.int32))[2], pshape, cache)
    cfg = get_config(arch)
    got = dryrun.window_cache_bytes(cfg, s, dryrun.abstract_params(cfg))
    assert got == _jax_bytes(new, FLOAT32_STATES)


@pytest.fixture(scope="module")
def all_pairs(tmp_path_factory):
    """``--all --reduced``'s records by tag, written once for the file:
    the sweep's own test and the hand count read them."""
    out = tmp_path_factory.mktemp("dryrun")
    assert dryrun.main(["--all", "--reduced", "--out", str(out)]) == 0
    return out, {p.stem: json.loads(p.read_text())
                 for p in out.glob("*.json")}


def _record(recs, arch, shape):
    (rec,) = [r for r in recs.values()
              if r["arch"] == arch and r["shape"] == shape]
    return rec


def test_reduced_qwen_flops_equal_a_hand_count(all_pairs):
    """Per layer the q, k, v, o projections, the swiglu MLP's three
    products and attention's two over the full square (the plain
    versions'), then the tied head: 2 flops a multiply-add. The records
    are the reduced sweep's (``all_pairs``), as ``run_pair`` wrote them."""
    cfg = get_config("qwen3-1.7b", reduced=True)
    L, D, H, KV, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)
    F, V = cfg.d_ff, cfg.vocab

    def count(N, B, Tq, Tk):
        return L * (2 * N * D * (H + 2 * KV) * hd + 2 * N * H * hd * D
                    + 3 * 2 * N * D * F + 2 * 2 * B * H * Tq * Tk * hd
                    ) + 2 * N * D * V
    s = SHAPES["decode_32k"]
    W = dryrun.DECODE_WINDOW
    S = -(-(s.seq_len + W) // 256) * 256
    _, recs = all_pairs
    rec = _record(recs, "qwen3-1.7b", "decode_32k")
    assert rec["flops"] == count(s.global_batch * W, s.global_batch, W, S)
    assert rec["kernel_calls"] == {"decode_attention": L}
    s = SHAPES["prefill_32k"]
    rec = _record(recs, "qwen3-1.7b", "prefill_32k")
    N = s.global_batch * s.seq_len
    assert rec["flops"] == count(N, s.global_batch, s.seq_len, s.seq_len)


def test_all_pairs_at_reduced_configs_write_one_record_each(all_pairs):
    tmp_path, recs = all_pairs
    assert len(recs) == len(ARCHS) * len(SHAPES)
    for tag, rec in recs.items():
        ok, _ = shape_applicable(rec["arch"], rec["shape"])
        assert rec["status"] == ("ok" if ok else "skipped"), (tag, rec)
        assert rec["mesh"] is None
        if ok:
            assert rec["flops"] > 0 and rec["param_bytes"] > 0
            assert (rec["optimizer_bytes"] > 0) == (
                SHAPES[rec["shape"]].kind == "train")
            assert (rec["cache_bytes"] > 0) == (
                SHAPES[rec["shape"]].kind == "decode")
    # --skip-existing keeps every ok or skipped record
    assert dryrun.main(["--all", "--reduced", "--skip-existing", "--out",
                        str(tmp_path)]) == 0
