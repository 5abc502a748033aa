"""Named contracts and the check entry points.

The port of the reference's ``analysis/contracts.py``. A
:class:`Contract` is an ordered bundle of rules with a name; the shipped
contracts cover the engine's device programs:

* ``ROUND_CONTRACT`` — the round loop, ``ServingEngine._round_loop``.
* ``STAGED_ROUND_CONTRACT`` — the round loop with in-loop adoption,
  ``_staged_loop``; the same invariants under its own name, so violations
  and the recompile registry attribute to the right program.
* ``PREFILL_CONTRACT`` — a row-local prefill chunk, ``_prefill``.
  Pool-shaped writes are its job and collectives are allowed, but host
  reads and f64 are not, and the pool must still be updated in place.
* ``MIGRATION_COPY_CONTRACT`` — the device half of a sequence migration,
  ``ServingEngine._migration_copy``: the copy is a pool write by design,
  but it reads nothing on the host, makes no f64, writes the destination
  pool in place with no pool-sized transient, and keeps one argument
  signature (its ids padded to the table width).

On a mesh every shard's round dispatch is checked under its own label.
``select_contract(tensor_parallel=True)`` (an engine on a model axis)
allows the model axis's collectives, which are the tensor-parallel
contractions; a data-axis collective still fails. Unlike the reference,
whose compiled GSPMD program loses the pool's donation aliasing, the port
keeps DonationAliasCovers there: its pools are still written in place.

``check_program(fn, args, contract)`` runs one call through one contract
and returns a :class:`Report` (the call's return value in ``value``).
``maybe_check(kind, fn, args)`` is the engine seam: it makes the call,
plainly unless ``REPRO_CHECK_CONTRACTS=1`` (which the test suite's
``conftest.py`` sets), under which the first call of each (label, kind,
variant) runs under the census and is checked, raising
:class:`ContractViolationError` with the structured report on failure,
and on the card every call runs under ``set_sync_debug_mode("error")``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

from repro_torch.analysis.census import sync_debug_error
from repro_torch.analysis.rules import (DonationAliasCovers, NoCollectives,
                                        NoF64Leaks, NoHostCallbacks,
                                        NoPoolRankedScatters, Program,
                                        RecompileHazard, Rule, census,
                                        signature)


@dataclass
class Report:
    """Outcome of checking one program against one contract."""
    contract: str
    label: str
    violations: list = field(default_factory=list)
    metrics: dict = field(default_factory=dict)
    value: object = field(default=None, repr=False)

    @property
    def ok(self) -> bool:
        return not self.violations

    def __str__(self):
        head = (f"contract {self.contract} on `{self.label}`: "
                f"{'OK' if self.ok else f'{len(self.violations)} violation(s)'}")
        lines = [head] + [f"  - {v}" for v in self.violations]
        if self.metrics:
            lines.append("  metrics: " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.metrics.items())))
        return "\n".join(lines)


class ContractViolationError(AssertionError):
    """Raised by ``maybe_check`` / ``require`` on a failed contract.

    Subclasses AssertionError so assert-style harnesses (pytest,
    ``chip_smoke.py``) treat it as the same class of failure."""

    def __init__(self, report: Report):
        self.report = report
        super().__init__(str(report))


class Contract:
    """A named, ordered rule bundle."""

    def __init__(self, name: str, rules: list[Rule]):
        self.name = name
        self.rules = list(rules)

    def extend(self, *extra: Rule) -> "Contract":
        """A derived contract with ``extra`` rules appended (e.g. a
        workload-specific ``MaxLiveBytes`` budget)."""
        return Contract(self.name, self.rules + list(extra))

    def rule_names(self) -> list[str]:
        return [r.name for r in self.rules]


def _hot_rules():
    return [
        NoCollectives(),
        NoPoolRankedScatters(min_rank=3),
        NoHostCallbacks(),
        NoF64Leaks(),
        DonationAliasCovers(),
        RecompileHazard(max_shapes=8),
    ]


ROUND_CONTRACT = Contract("ROUND_CONTRACT", _hot_rules())
STAGED_ROUND_CONTRACT = Contract("STAGED_ROUND_CONTRACT", _hot_rules())
PREFILL_CONTRACT = Contract("PREFILL_CONTRACT", [
    NoHostCallbacks(),
    NoF64Leaks(),
    DonationAliasCovers(),
    RecompileHazard(max_shapes=16),    # one variant per pow2 chunk size
])

MIGRATION_COPY_CONTRACT = Contract("MIGRATION_COPY_CONTRACT", [
    NoHostCallbacks(),
    NoF64Leaks(),
    DonationAliasCovers(),
    RecompileHazard(max_shapes=8),
])

CONTRACTS = {c.name: c for c in (ROUND_CONTRACT, STAGED_ROUND_CONTRACT,
                                 PREFILL_CONTRACT, MIGRATION_COPY_CONTRACT)}

_KIND_TO_CONTRACT = {
    "round": "ROUND_CONTRACT",
    "staged_round": "STAGED_ROUND_CONTRACT",
    "prefill": "PREFILL_CONTRACT",
    "migration_copy": "MIGRATION_COPY_CONTRACT",
}


def select_contract(kind: str, *, donate: bool = True,
                    tensor_parallel: bool = False,
                    pool_scatter_shapes=None) -> Contract:
    """The contract enforced for an engine program of ``kind`` ("round" /
    "staged_round" / "prefill" / "migration_copy"). ``donate=False`` (an engine that copies
    its pool out of place each dispatch, ``--no-donate``) drops
    DonationAliasCovers. ``tensor_parallel`` allows the model axis's
    collectives in NoCollectives. ``pool_scatter_shapes`` (the engine's exact pool
    leaf shapes) narrows NoPoolRankedScatters from the rank proxy to real
    pool writes, so MoE dispatch buffers and recurrent state rows pass
    while a pool-shaped result made out of place is still caught."""
    contract = CONTRACTS[_KIND_TO_CONTRACT[kind]]
    rules = [r for r in contract.rules
             if donate or r.name != "DonationAliasCovers"]
    if tensor_parallel:
        rules = [NoCollectives(allow_axes=("model",))
                 if r.name == "NoCollectives" else r for r in rules]
    if pool_scatter_shapes is not None:
        rules = [NoPoolRankedScatters(min_rank=r.min_rank,
                                      pool_shapes=pool_scatter_shapes)
                 if r.name == "NoPoolRankedScatters" else r for r in rules]
    return Contract(contract.name, rules)


def check_program(fn, args, contract: Contract, label: str = None, *,
                  pool=(), state=(), program: Program = None) -> Report:
    """Run ``fn(*args)`` once under the census and check it against
    ``contract``; returns a :class:`Report` with structured violations,
    the census metrics (pool_scatters, host_callbacks, kernel_launches,
    collectives, aten_ops, peak_bytes) and the call's return value.
    ``pool`` (block pools) and ``state`` (other tensors, as recurrent
    rows) are what the call must update in place. A prebuilt ``program``
    (a fixture's census) replaces ``fn`` and ``args``."""
    if program is None:
        program = Program(fn, args, pool=pool, state=state,
                          label=label or "")
    report = Report(contract=contract.name, label=program.label)
    for rule in contract.rules:
        report.violations.extend(rule.check(program))
    report.metrics.update(census(program))
    report.value = program.output
    return report


def require(report: Report) -> Report:
    """Raise :class:`ContractViolationError` unless ``report.ok``."""
    if not report.ok:
        raise ContractViolationError(report)
    return report


def contracts_enabled() -> bool:
    return os.environ.get("REPRO_CHECK_CONTRACTS", "0") == "1"


# (label, kind, signature, variant) already checked this process: a
# contract is a property of the program variant, so one check is enough
_CHECKED: set = set()


def maybe_check(kind: str, fn, args, *, label: str = None, variant=None,
                donate: bool = True, pool=(), state=(),
                pool_scatter_shapes=None, tensor_parallel: bool = False,
                device=None, reports=None):
    """Engine seam: return ``fn(*args)``. Under ``REPRO_CHECK_CONTRACTS=1``
    the first call of each (label, kind, argument signature, ``variant``)
    runs under the census against :func:`select_contract`'s contract and
    raises :class:`ContractViolationError` on a violation, so a broken
    program fails loudly at its first dispatch, not as a perf mystery
    later; on a CUDA ``device`` every call then runs under
    ``set_sync_debug_mode("error")``. Unset, the call is made plainly.
    ``reports`` (a list) collects each check's Report, its metrics joined
    by ``variant``, ``signature`` (this call's) and ``signatures`` (the
    label's distinct argument signatures so far)."""
    if not contracts_enabled():
        return fn(*args)
    key = (label or kind, kind, signature(args), variant)
    if key in _CHECKED:
        with sync_debug_error(device):
            return fn(*args)
    _CHECKED.add(key)
    contract = select_contract(kind, donate=donate,
                               tensor_parallel=tensor_parallel,
                               pool_scatter_shapes=pool_scatter_shapes)
    report = check_program(fn, args, contract, label=label or kind,
                           pool=pool, state=state)
    report.metrics["variant"] = variant
    report.metrics["signature"] = key[2]
    report.metrics["signatures"] = len(
        RecompileHazard._registry.get(report.label, ()))
    if reports is not None:
        reports.append(report)
    return require(report).value


def check_engine_round(eng) -> Report:
    """Contract-check the round program an engine's next ``step()`` would
    dispatch on every data shard and return one Report, the one gate tests
    and benches share: each shard's loop runs once under the census at the
    engine's current window and ``rounds_per_sync``; the violations of all
    shards are kept, their counts summed (``peak_bytes``: the largest).
    The engine must hold no live row (a fresh or a drained engine), whose
    progress the dropped stats would lose; its rows are then the no-op
    lane and the loop changes no token. Duck-typed on the engine, so the
    analysis layer never imports serving."""
    if any(s is not None for s in eng.slots):
        raise ValueError("check_engine_round runs the round loop; the "
                         "engine has live rows whose stats it would drop")
    exemptions = eng._contract_exemptions()
    report = None
    for s in range(len(eng.shards)):
        kind, fn, args = eng._round_program(eng.controller.window,
                                            eng.rounds_per_sync, s)
        contract = select_contract(kind, donate=eng.donate, **exemptions)
        rep = check_program(fn, args, contract,
                            label=f"{kind}@{hex(id(eng))}:{s}",
                            **eng._paged_leaves((s,)))
        rep.metrics["n_args"] = len(args)
        report = rep if report is None else _merged(report, rep)
    return report


def _merged(a: Report, b: Report) -> Report:
    """Two shards' Reports of one program as one: violations of both,
    counts summed (per key where a dict), the peak the larger."""
    out = Report(contract=a.contract, label=a.label,
                 violations=a.violations + b.violations, value=a.value)
    for k, v in a.metrics.items():
        w = b.metrics[k]
        if k in ("peak_bytes", "n_args"):
            out.metrics[k] = max(v, w)
        elif isinstance(v, dict):
            out.metrics[k] = {x: v.get(x, 0) + w.get(x, 0)
                              for x in {**v, **w}}
        else:
            out.metrics[k] = v + w
    return out
