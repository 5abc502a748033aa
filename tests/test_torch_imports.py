"""Import guard: the port and ``chip_smoke.py`` import neither ``jax`` nor
the JAX package ``repro`` — by an AST scan of every module, and by
importing them all in a fresh interpreter and checking ``sys.modules``.
The card's tests (``test_torch_gpu.py``) and the torch examples
(``examples/*_torch.py``) run where JAX is not installed, so the scan
covers them too."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    return (sorted(PORT.rglob("*.py"))
            + sorted((ROOT / "examples").glob("*_torch.py"))
            + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py"])


def _top(name):
    return name.split(".")[0]


def test_ast_scan_finds_no_forbidden_import():
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if _top(n) in FORBIDDEN]
    assert len(_sources()) > 20
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_scan_covers_the_mla_and_forecast_modules():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"configs/deepseek_v3_671b.py", "core/forecasting.py",
            "models/attention.py", "kernels/paged_attention/ops.py",
            "kernels/paged_attention/kernel.py"} <= names
    assert (PORT / "kernels" / "csrc" / "paged_latent.cu").exists()


def test_scan_covers_the_training_modules():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"models/losses.py", "optim/optimizers.py", "optim/schedules.py",
            "data/synthetic.py", "data/pipeline.py", "launch/train.py",
            "kernels/flash_attention/ops.py",
            "kernels/flash_attention/kernel.py",
            "kernels/flash_attention/ref.py"} <= names
    assert (PORT / "kernels" / "csrc" / "flash_attention.cu").exists()


def test_scan_covers_the_rwkv_and_dense_decode_modules():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"configs/rwkv6_7b.py", "models/ssm.py", "nn/core.py",
            "kernels/rwkv_wkv/ops.py", "kernels/rwkv_wkv/kernel.py",
            "kernels/rwkv_wkv/ref.py", "kernels/decode_attention/ops.py",
            "kernels/decode_attention/kernel.py",
            "kernels/decode_attention/ref.py"} <= names
    for cu in ("rwkv_wkv.cu", "decode_attention.cu"):
        assert (PORT / "kernels" / "csrc" / cu).exists()


def test_scan_covers_the_dense_config_modules():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"configs/gemma3_1b.py", "configs/gemma_2b.py",
            "configs/mistral_large_123b.py", "configs/shapes.py",
            "configs/__init__.py", "kernels/split.py"} <= names


def test_scan_covers_the_mamba_and_jamba_modules():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"configs/jamba_1_5_large_398b.py", "models/ssm.py",
            "models/transformer.py", "launch/serve.py"} <= names


def test_scan_covers_the_frontend_and_fault_modules():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"configs/musicgen_large.py", "configs/internvl2_1b.py",
            "models/frontends.py", "core/random.py", "serving/faults.py",
            "serving/engine.py", "serving/admission.py",
            "serving/blocks.py"} <= names


def test_scan_covers_the_preemption_and_staging_modules():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"engine/scheduler.py", "engine/spec_decode.py",
            "serving/engine.py", "serving/admission.py", "serving/blocks.py",
            "serving/adaptive.py", "serving/metrics.py", "serving/faults.py",
            "models/transformer.py", "launch/serve.py"} <= names


def test_scan_covers_the_host_tier_modules():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"serving/hostcache/__init__.py", "serving/hostcache/arena.py",
            "serving/hostcache/staging.py", "serving/hostcache/tier.py",
            "serving/engine.py", "serving/blocks.py",
            "serving/metrics.py"} <= names


def test_scan_covers_the_durability_modules():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"serving/journal.py", "serving/hostcache/disk.py",
            "serving/hostcache/tier.py", "serving/hostcache/arena.py",
            "serving/faults.py", "serving/engine.py",
            "launch/serve.py"} <= names


def test_scan_covers_the_analysis_launch_and_example_modules():
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert {"src/repro_torch/analysis/__init__.py",
            "src/repro_torch/analysis/census.py",
            "src/repro_torch/analysis/contracts.py",
            "src/repro_torch/analysis/hotpath.py",
            "src/repro_torch/analysis/lint.py",
            "src/repro_torch/analysis/rules.py",
            "src/repro_torch/launch/dryrun.py",
            "examples/quickstart_torch.py", "examples/serve_llm_torch.py",
            "examples/train_multiarch_torch.py",
            "examples/latent_autoencoder_torch.py"} <= names


def test_scan_covers_the_mesh_modules():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"launch/mesh.py", "serving/topology.py", "serving/blocks.py",
            "serving/engine.py", "serving/hostcache/tier.py",
            "analysis/contracts.py", "launch/serve.py"} <= names


def test_scan_covers_the_training_mesh_modules():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"sharding/collectives.py", "sharding/tensor_parallel.py",
            "sharding/moe_shard.py", "sharding/rules.py",
            "optim/optimizers.py", "data/pipeline.py", "launch/train.py",
            "launch/mesh.py", "checkpoint/io.py", "nn/core.py",
            "models/moe.py"} <= names


def test_the_rank_drivers_import_no_jax():
    """The spawned-rank drivers (``tests/torch_*_driver.py``) run on the
    card for ``test_torch_gpu.py``: the port and ``chip_smoke`` only."""
    drivers = sorted((ROOT / "tests").glob("torch_*_driver.py"))
    assert {p.name for p in drivers} >= {"torch_tp_driver.py",
                                         "torch_train_mesh_driver.py"}
    for path in drivers:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names if _top(n) in FORBIDDEN], path
