"""AST host-sync / determinism linter over ``src/repro_torch``.

The port of the reference's ``analysis/lint.py``: the same three rules,
all static (the linted code is never imported):

* ``host-sync`` — device-to-host synchronizations inside *hot* functions:
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int()`` /
  ``float()`` / ``bool()`` on a value (not on a literal), ``torch.nonzero``
  and ``.nonzero()``, and ``np.asarray`` / ``np.array``. Hot = decorated
  ``@hot_path``, nested under a round-loop builder (``_round_loop_fn`` /
  ``_build_staged_round``, the reference's names), or reachable from
  either through same-module calls by name or, inside a class, through
  ``self.<method>`` calls (the port's roots are the engine's methods).
  Each sync drains the device stream: the stall the device-resident round
  loop exists to avoid, and what a CUDA graph of the loop cannot hold.
* ``nondet`` — Python ``random.*`` or ``time.time()`` in the modules that
  are deterministic by contract (journal, faults, adaptive policy, noise
  and verify code): wall clocks and the global RNG break replay.
* ``bare-except`` — ``except:`` with no exception type anywhere: it
  swallows ``RequestError`` (and KeyboardInterrupt), defeating the
  per-request quarantine path.

Suppress a finding with ``# repro: allow(<rule>)`` on the flagged line or
on the enclosing ``def`` line, with the reason after it. CLI::

    python -m repro_torch.analysis.lint [paths...]   # default: src/repro_torch

exits nonzero on any finding.
"""
from __future__ import annotations

import ast
import re
import sys
from dataclasses import dataclass
from pathlib import Path

# Modules whose behaviour is deterministic by contract (replay journal,
# fault plans, adaptive policy, seeded noise / verify round).
DETERMINISTIC_MODULES = (
    "serving/journal.py",
    "serving/faults.py",
    "serving/adaptive.py",
    "core/reparam.py",
    "engine/spec_decode.py",
)

# Builders whose nested functions run in the round loop (the reference's).
HOT_BUILDERS = ("_round_loop_fn", "_build_staged_round")

_ARRAY_CALLS = ("np.asarray", "numpy.asarray", "onp.asarray", "np.array",
                "numpy.array")
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "nonzero")
_SYNC_BUILTINS = ("float", "int", "bool")

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\(([\w*-]+)\)")


@dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _allows(source_lines, lineno: int) -> set:
    """Rules suppressed on source line ``lineno`` (1-based)."""
    if 1 <= lineno <= len(source_lines):
        return set(_ALLOW_RE.findall(source_lines[lineno - 1]))
    return set()


def _dotted(node) -> str:
    """Best-effort dotted name of a call target ('np.asarray', 'x.item')."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_hot_decorated(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = _dotted(target)
        if name == "hot_path" or name.endswith(".hot_path"):
            return True
    return False


def _sync_form(node: ast.Call):
    """The host-sync spelling ``node`` is, or None."""
    name = _dotted(node.func)
    if name in _ARRAY_CALLS:
        return f"`{name}`"
    if name == "torch.nonzero":
        return "`torch.nonzero`"
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in _SYNC_METHODS and not node.args:
        return f"`.{node.func.attr}()`"
    if isinstance(node.func, ast.Name) and node.func.id in _SYNC_BUILTINS \
            and node.args and not all(isinstance(a, ast.Constant)
                                      for a in node.args):
        return f"`{node.func.id}()` on a value"
    return None


class _ModuleLint:
    def __init__(self, path: Path, rel: str, tree: ast.Module, lines):
        self.path = path
        self.rel = rel
        self.tree = tree
        self.lines = lines
        self.findings: list[Finding] = []

    def _emit(self, rule, node, message, def_line: int = 0):
        allowed = _allows(self.lines, node.lineno)
        if def_line:
            allowed |= _allows(self.lines, def_line)
        if rule in allowed or "*" in allowed:
            return
        self.findings.append(Finding(self.rel, node.lineno, rule, message))

    # -- hot-function discovery ---------------------------------------
    def _hot_functions(self) -> list[ast.AST]:
        """@hot_path defs, defs nested under HOT_BUILDERS, plus the
        transitive closure of both over same-module calls by name and
        ``self.<method>`` calls."""
        fndefs = (ast.FunctionDef, ast.AsyncFunctionDef)
        by_name: dict[str, list] = {}
        methods: dict[str, list] = {}
        hot: list[ast.AST] = []
        seen: set[int] = set()

        def add(fn):
            if id(fn) not in seen:
                seen.add(id(fn))
                hot.append(fn)

        def walk(node, inside_builder):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, fndefs):
                    by_name.setdefault(child.name, []).append(child)
                    if isinstance(node, ast.ClassDef):
                        methods.setdefault(child.name, []).append(child)
                    if _is_hot_decorated(child) or inside_builder:
                        add(child)
                    walk(child, inside_builder
                         or child.name in HOT_BUILDERS)
                else:
                    walk(child, inside_builder)

        walk(self.tree, False)

        frontier = list(hot)
        while frontier:
            fn = frontier.pop()
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Name):
                    callees = by_name.get(f.id, [])
                elif isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and f.value.id == "self":
                    callees = methods.get(f.attr, [])
                else:
                    continue
                for callee in callees:
                    if id(callee) not in seen:
                        add(callee)
                        frontier.append(callee)
        return hot

    # -- rules ---------------------------------------------------------
    def check_host_sync(self):
        for fn in self._hot_functions():
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                form = _sync_form(node)
                if form is not None:
                    self._emit("host-sync", node,
                               f"{form} in hot function `{fn.name}` syncs "
                               "the device stream", fn.lineno)

    def check_nondet(self):
        if not self.rel.replace("\\", "/").endswith(DETERMINISTIC_MODULES):
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if name == "time.time":
                self._emit("nondet", node,
                           "`time.time()` in a deterministic module "
                           "breaks replay equivalence")
            elif name.startswith("random.") and name.count(".") == 1:
                self._emit("nondet", node,
                           f"global-RNG `{name}` in a deterministic "
                           "module breaks replay equivalence")

    def check_bare_except(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                self._emit("bare-except", node,
                           "bare `except:` can swallow RequestError "
                           "(and KeyboardInterrupt); name the exception")

    def run(self) -> list[Finding]:
        self.check_host_sync()
        self.check_nondet()
        self.check_bare_except()
        return self.findings


def lint_file(path, root=None) -> list[Finding]:
    path = Path(path)
    rel = str(path.relative_to(root)) if root else str(path)
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    return _ModuleLint(path, rel, tree, source.splitlines()).run()


def lint_paths(paths) -> list[Finding]:
    findings: list[Finding] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                findings.extend(lint_file(f, root=p.parent))
        else:
            findings.extend(lint_file(p))
    return findings


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        here = Path(__file__).resolve()
        argv = [str(here.parents[1])]          # src/repro_torch
    findings = lint_paths(argv)
    for f in findings:
        print(f)
    print(f"repro_torch-lint: {len(findings)} finding(s) in "
          f"{', '.join(argv)}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
