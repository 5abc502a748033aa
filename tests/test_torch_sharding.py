"""The port's sharding rules (``repro_torch/sharding/{api,rules}.py``)
against the reference's (``repro/sharding/{api,rules}.py``).

For all ten archs at published widths, on stand-in meshes (16, 16), (1, 2)
and (2, 4) (the rules read only ``shape`` and ``axis_names``), every leaf
of the port's parameter tree (built on the meta device) gets the spec the
reference's ``_leaf_spec``, ``_leaf_spec_no_tp`` and ``serving_param_
shardings`` give its counterpart in the reference's tree (built by
``jax.eval_shape``), bitwise; a stacked block leaf's counterpart is the
stacked array, whose leading axis the port's spec drops. The same for the
dense cache's leaves (``_cache_leaf_spec``) and the paged cache's
(``paged_partition_specs``). The activation rules, ``Rules.spec``'s dedup
and ``batch_sharding`` too, and the stacked-size rule pinned on reduced
qwen3-1.7b's ``wk`` and DBRX's norm scales, which a per-layer count would
replicate."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.models.transformer import TransformerLM as JaxLM
from repro.sharding import rules as jrules
from repro.sharding.api import Rules as JaxRules
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.transformer import TransformerLM
from repro_torch.sharding import rules
from repro_torch.sharding.api import Rules

MESHES = ((16, 16), (1, 2), (2, 4))
BATCH, MAX_LEN = 16, 64

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



class FakeMesh:
    """Only .shape and .axis_names are consulted by the rules."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def fake(data, model, pod=None):
    shape = {"pod": pod} if pod else {}
    shape.update(data=data, model=model)
    return FakeMesh(shape)


def full(spec, ndim):
    """A reference PartitionSpec (or a port spec) as a tuple of ``ndim``
    entries."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def ref_leaves(tree):
    """{path names: leaf} of a reference tree, its rules' path names."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", ""))) for k in p):
            leaf for p, leaf in flat}


def port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from port_leaves(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from port_leaves(v, path + (str(i),))
    else:
        yield path, tree


def counterparts(cfg, port_tree, port_specs, ref):
    """(port path, port shape, port spec, reference names, reference leaf,
    stacked) for every port leaf; each reference leaf is visited."""
    specs = dict(port_leaves(port_specs))
    out, seen = [], set()
    for path, leaf in port_leaves(port_tree):
        names, depth = list(path), 0
        if path[0] == "layers":
            prefix, depth = rules.reference_layer(cfg, int(path[1]))
            names = prefix + list(path[2:])
        rleaf = ref[tuple(names)]
        shape = tuple(leaf.shape)
        assert tuple(rleaf.shape) == (((depth,) if depth else ()) + shape), \
            (path, names, rleaf.shape, shape)
        seen.add(tuple(names))
        out.append((path, shape, specs[path], names, rleaf, bool(depth)))
    assert seen == set(ref), set(ref) ^ seen
    return out


def assert_same(rows, ref_fn):
    n_split = 0
    for path, shape, spec, names, rleaf, stacked in rows:
        want = full(ref_fn(names, rleaf), len(rleaf.shape))
        if stacked:
            assert want[0] is None, (names, want)
            want = want[1:]
        assert len(spec) == len(shape) and spec == want, (path, spec, want)
        n_split += any(a is not None for a in spec)
    return n_split


@pytest.fixture(scope="module")
def trees():
    out = {}

    def get(arch):
        if arch not in out:
            cfg, jcfg = get_config(arch), jax_get_config(arch)
            params = TransformerLM.init(cfg, device="meta")
            jparams = jax.eval_shape(
                lambda: JaxLM.init(jax.random.PRNGKey(0), jcfg))
            cache = TransformerLM.init_cache(cfg, BATCH, MAX_LEN,
                                             device="meta")
            jcache = jax.eval_shape(
                lambda: JaxLM.init_cache(jcfg, BATCH, MAX_LEN))
            out[arch] = cfg, params, ref_leaves(jparams), cache, \
                ref_leaves(jcache)
        return out[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_the_reference(arch, trees):
    cfg, params, jparams, cache, jcache = trees(arch)
    for data, model in MESHES:
        mesh = fake(data, model)
        drop = ("data",)
        n = assert_same(counterparts(cfg, params, rules.param_specs(
            cfg, params, mesh), jparams),
            lambda nm, lf: jrules._leaf_spec(nm, lf, mesh))
        assert n > 0
        assert_same(counterparts(cfg, params, rules.param_specs(
            cfg, params, mesh, no_tp=True), jparams),
            lambda nm, lf: jrules._leaf_spec_no_tp(nm, lf, mesh))
        assert_same(counterparts(cfg, params, rules.serving_param_specs(
            cfg, params, mesh), jparams),
            lambda nm, lf: jrules._strip_axes(
                jrules._leaf_spec(nm, lf, mesh), drop))
        assert_same(counterparts(cfg, cache, rules.cache_specs(
            cfg, cache, mesh, BATCH), jcache),
            lambda nm, lf: jrules._cache_leaf_spec(nm, lf, mesh, BATCH))
        shardings = rules.param_shardings(cfg, params, mesh)
        assert shardings["embed"]["table"].mesh is mesh


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_specs_equal_the_reference(arch):
    """The reduced config's paged cache: the port's split of each pool or
    state over "data" against the reference's ``paged_partition_specs``."""
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                               reduced=True)
    paged = TransformerLM.init_paged_cache(cfg, 4, 32, 4, device="meta")
    jpaged = jax.eval_shape(lambda: JaxLM.init_paged_cache(jcfg, 4, 32, 4))
    jspecs = JaxLM.paged_partition_specs(jcfg, jpaged)
    ref = {k: (leaf, spec) for (k, leaf), spec in zip(
        ref_leaves(jpaged).items(),
        jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, P)))}
    mesh = fake(2, 2)
    shard = rules.paged_cache_shardings(cfg, paged, mesh)
    specs = jax.tree.map(lambda s: s.spec, shard,
                         is_leaf=lambda x: isinstance(x, rules.NamedSharding))
    rows = counterparts(cfg, paged, specs, {k: v[0] for k, v in ref.items()})
    assert rows
    assert_same(rows, lambda nm, lf: ref[tuple(nm)][1])


def test_serving_shardings_strip_data_on_a_real_mesh(trees):
    """The reference's own ``serving_param_shardings`` on a one-device
    mesh, and ``batch_sharding`` / ``replicated``, against the port's."""
    cfg, params, jparams, _, _ = trees("qwen3-1.7b")
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jtree = jax.eval_shape(lambda: JaxLM.init(jax.random.PRNGKey(0),
                                              jax_get_config("qwen3-1.7b")))
    ref_specs = {k: s.spec for k, s in ref_leaves(
        jrules.serving_param_shardings(jtree, jmesh)).items()}
    mesh = fake(1, 1)
    rows = counterparts(cfg, params, rules.serving_param_specs(
        cfg, params, mesh), jparams)
    assert_same(rows, lambda nm, lf: ref_specs[tuple(nm)])
    for no_tp in (False, True):
        assert rules.batch_sharding(mesh, no_tp).spec == tuple(
            jrules.batch_sharding(jmesh, no_tp).spec)
    assert rules.replicated(mesh).spec == tuple(jrules.replicated(jmesh).spec)


@pytest.mark.parametrize("pod", [None, 2])
def test_activation_rules_equal_the_reference(pod):
    mesh = fake(16, 16, pod)
    names = [("batch", "seq", "embed"), ("batch", "seq", "vocab"),
             ("batch", None, "heads"), ("experts", "batch", "embed"),
             ("batch", "heads", "vocab")]
    for mine, ref in (
            (rules.default_activation_rules(mesh),
             jrules.default_activation_rules(mesh)),
            (rules.default_activation_rules(mesh, shard_embed=True),
             jrules.default_activation_rules(mesh, shard_embed=True)),
            (rules.default_activation_rules(mesh, no_tp=True),
             jrules.default_activation_rules(mesh, no_tp=True)),
            (rules.decode_activation_rules(mesh),
             jrules.decode_activation_rules(mesh))):
        assert dict(mine.mapping) == dict(ref.mapping)
        for n in names:
            assert mine.spec(n) == tuple(ref.spec(n)), n


def test_rules_spec_dedups_axes():
    mapping = {"batch": ("pod", "data"), "embed": "model", "heads": "model"}
    names = ("batch", "heads", "embed")
    assert Rules(mapping).spec(names) == (("pod", "data"), "model", None)
    assert Rules(mapping).spec(names) == tuple(JaxRules(mapping).spec(names))


def test_stacked_size_rule_shards_small_layers():
    """Reduced qwen3-1.7b's ``wk`` is 32,768 elements a layer but 65,536
    stacked, DBRX's norm scales 6,144 a layer but 245,760 stacked: counted
    as the reference's stacked leaves, both are split over "model" (a
    per-layer count would replicate them)."""
    mesh = fake(1, 2)
    cfg = get_config("qwen3-1.7b", reduced=True)
    p = TransformerLM.init(cfg, device="meta")
    specs = rules.serving_param_specs(cfg, p, mesh)
    wk = p["layers"][0]["mixer"]["wk"]["w"]
    assert wk.numel() < rules.REPLICATE_BELOW <= wk.numel() * cfg.n_blocks
    assert specs["layers"][0]["mixer"]["wk"]["w"] == ("model", None)
    for i in range(cfg.n_layers):
        assert specs["layers"][i]["mixer"]["wq"]["w"] == ("model", None)
        assert specs["layers"][i]["ffn"]["up"]["w"] == (None, "model")
        assert specs["layers"][i]["ffn"]["down"]["w"] == ("model", None)
    assert specs["embed"]["table"] == ("model", None)
    cfg = get_config("dbrx-132b")
    p = TransformerLM.init(cfg, device="meta")
    specs = rules.serving_param_specs(cfg, p, mesh)
    for i in (0, cfg.n_layers - 1):
        layer = specs["layers"][i]
        assert layer["norm1"]["scale"] == ("model",)
        assert layer["norm2"]["scale"] == ("model",)
        assert layer["ffn"]["router"]["w"] == (None, None)
        assert specs["layers"][i]["ffn"]["experts"]["up"] == (
            "model", None, None)
    assert specs["head"]["w"] == (None, "model")
    assert specs["final_norm"]["scale"] == (None,)
    assert p["layers"][0]["norm1"]["scale"].numel() < rules.REPLICATE_BELOW


def test_port_specs_place_on_the_meta_device():
    """``rules.param_specs`` runs on a meta tree without touching a
    device, and every split dim divides by its axes' sizes."""
    sizes = {"data": 2, "model": 4}
    for arch in ("qwen3-1.7b", "dbrx-132b"):
        cfg = get_config(arch, reduced=True)
        p = TransformerLM.init(cfg, device="meta")
        for (path, leaf), (_, spec) in zip(
                port_leaves(p), port_leaves(rules.param_specs(
                    cfg, p, fake(2, 4)))):
            for d, ax in enumerate(spec):
                if ax is None:
                    continue
                axes = (ax,) if isinstance(ax, str) else ax
                assert leaf.shape[d] % int(np.prod(
                    [sizes[a] for a in axes])) == 0, (path, spec)
            assert isinstance(leaf, torch.Tensor)
