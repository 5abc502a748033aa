"""The port's AST host-sync / determinism linter
(``repro_torch.analysis.lint``) against the reference's on the same
fixtures: the reference's lint fixtures give the same (line, rule)
findings from both linters; the torch forms of a host sync (``.tolist()``,
``.cpu()``, ``.numpy()``, ``int()``, ``nonzero``) and the ``self.<method>``
closure are the port's alone; the port lints clean through its CLI."""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint as jax_lint
from repro_torch.analysis.lint import Finding, lint_file, lint_paths, main

ROOT = Path(__file__).resolve().parents[1]

# the reference's fixtures (tests/analysis/test_lint.py), by name:
# (relative path, source, lint relative to the fixture root)
FIXTURES = {
    "hot_decorated": ("mod.py", """
        import numpy as np
        from repro.analysis import hot_path

        @hot_path
        def round_fn(x):
            return float(np.asarray(x).sum())

        def cold_fn(x):
            return float(np.asarray(x).sum())   # NOT hot: no finding
    """, False),
    "round_loop_builder": ("eng.py", """
        def _round_loop_fn(self, W, k):
            def loop(args):
                n = args[0].item()
                return n
            return loop
    """, False),
    "same_module_calls": ("mod.py", """
        import numpy as np
        from repro.analysis import hot_path

        def helper(x):
            return bool(x)            # reached FROM a hot fn

        @hot_path
        def round_fn(x):
            return helper(x)
    """, False),
    "suppressions": ("mod.py", """
        import numpy as np
        from repro.analysis import hot_path

        @hot_path
        def a(x):
            return x.item()           # repro: allow(host-sync)

        @hot_path
        def b(x):                     # repro: allow(host-sync)
            return x.item()
    """, False),
    "nondet_module": ("serving/journal.py", """
        import random
        import time

        def stamp():
            return time.time(), random.random()

        def seeded(key):
            import jax
            return jax.random.uniform(key)    # seeded stream: fine
    """, True),
    "nondet_elsewhere": ("launch/bench.py", """
        import time

        def wall():
            return time.time()        # NOT a deterministic module: fine
    """, True),
    "bare_except": ("anywhere.py", """
        def f():
            try:
                g()
            except:
                pass

        def g():
            try:
                f()
            except ValueError:
                pass                  # typed: fine
    """, False),
}


def _write(tmp_path, name, src):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return p


def _found(findings):
    return sorted((f.line, f.rule) for f in findings)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_equal_the_reference_linters(tmp_path, name):
    rel, src, rooted = FIXTURES[name]
    p = _write(tmp_path, rel, src)
    root = tmp_path if rooted else None
    got = lint_file(p, root=root)
    want = jax_lint.lint_file(p, root=root)
    assert _found(got) == _found(want)
    assert [f.path for f in got] == [f.path for f in want]


def test_fixture_messages_name_the_form_and_the_function(tmp_path):
    rel, src, _ = FIXTURES["hot_decorated"]
    msgs = [f.message for f in lint_file(_write(tmp_path, rel, src))]
    assert any("np.asarray" in m for m in msgs)
    assert any("float()" in m for m in msgs)
    rel, src, _ = FIXTURES["same_module_calls"]
    (f,) = lint_file(_write(tmp_path, "b/" + rel, src))
    assert "helper" in f.message
    rel, src, _ = FIXTURES["bare_except"]
    (f,) = lint_file(_write(tmp_path, "c/" + rel, src))
    assert "RequestError" in f.message


def test_torch_forms_of_a_host_sync(tmp_path):
    p = _write(tmp_path, "mod.py", """
        import torch
        from repro_torch.analysis import hot_path

        @hot_path
        def round_fn(x, n):
            a = x.tolist()
            b = x.cpu()
            c = x.numpy()
            d = int(n)
            e = torch.nonzero(x)
            f = x.nonzero()
            g = float("nan")          # a literal: no device value
            h = x.float()             # a dtype cast, not a read
            return a, b, c, d, e, f, g, h
    """)
    got = _found(lint_file(p))
    assert got == [(line, "host-sync") for line in range(7, 13)]
    # the reference's linter knows none of these forms, and flags the
    # literal the port spares
    assert _found(jax_lint.lint_file(p)) == [(13, "host-sync")]


def test_self_method_calls_close_over_the_class(tmp_path):
    p = _write(tmp_path, "eng.py", """
        from repro_torch.analysis import hot_path

        class Engine:
            @hot_path
            def _round_loop(self, x):
                return self._verify(x)

            def _verify(self, x):
                return x.item()

            def step(self, x):
                return self._round_loop(x).cpu()   # the sync, outside
    """)
    (f,) = lint_file(p)
    assert (f.line, f.rule) == (10, "host-sync")
    assert "_verify" in f.message


def test_finding_str_is_clickable():
    f = Finding("src/repro_torch/x.py", 12, "host-sync", "msg")
    assert str(f) == "src/repro_torch/x.py:12: [host-sync] msg"


def test_cli_exit_codes(tmp_path, capsys):
    clean = _write(tmp_path, "clean/ok.py", "x = 1\n")
    assert main([str(clean.parent)]) == 0
    dirty = _write(tmp_path, "dirty/bad.py", """
        try:
            pass
        except:
            pass
    """)
    assert main([str(dirty.parent)]) == 1
    out = capsys.readouterr().out
    assert "bare-except" in out and "1 finding(s)" in out


def test_lint_paths_recurses_directories(tmp_path):
    _write(tmp_path, "pkg/a.py", "x = 1\n")
    _write(tmp_path, "pkg/sub/b.py", """
        try:
            pass
        except:
            pass
    """)
    findings = lint_paths([str(tmp_path / "pkg")])
    assert len(findings) == 1 and findings[0].rule == "bare-except"
    assert findings[0].path.endswith("b.py")


def test_the_port_lints_clean_through_its_cli():
    """``python -m repro_torch.analysis.lint`` over src/repro_torch exits 0;
    the roots it starts from are the four hot functions."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=120,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout
    from repro_torch.analysis import is_hot_path
    from repro_torch.core.reparam import reparam_argmax
    from repro_torch.engine.spec_decode import verify_round
    from repro_torch.serving.engine import ServingEngine
    assert all(is_hot_path(f) for f in (
        verify_round, reparam_argmax, ServingEngine._round_loop,
        ServingEngine._staged_loop))
