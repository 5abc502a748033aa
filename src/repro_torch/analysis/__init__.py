"""Hot-path checks: an op census, declarative contracts over it, and a
host-sync linter — the port of the reference's ``analysis`` package.

Public surface::

    from repro_torch import analysis
    report = analysis.check_program(fn, args, analysis.ROUND_CONTRACT,
                                    pool=leaves)
    assert report.ok, report
    report.metrics["pool_scatters"]     # the numbers gates assert on

    analysis.maybe_check("round", fn, args)   # engine seam, env-gated

    @analysis.hot_path                   # mark for the AST linter
    def verify_round(...): ...

The reference's jaxpr and HLO walkers (``EqnSite``,
``count_jaxpr_primitives``, ``find_jaxpr_primitives``,
``find_dtype_leaks``, ``find_collectives``, ``parse_collective_bytes``,
``parse_shape_bytes``) have no counterpart: an eager program has no
trace, and :class:`Census` records its ops as they run instead (c10d ops
for the collectives, each filed under the mesh axis that issued it: the
model axis's all-reduces and all-gathers under tensor parallelism).
"""
from repro_torch.analysis.census import Census, OpRecord
from repro_torch.analysis.contracts import (CONTRACTS,
                                            MIGRATION_COPY_CONTRACT,
                                            PREFILL_CONTRACT, ROUND_CONTRACT,
                                            STAGED_ROUND_CONTRACT, Contract,
                                            ContractViolationError, Report,
                                            check_engine_round,
                                            check_program, contracts_enabled,
                                            maybe_check, require,
                                            select_contract)
from repro_torch.analysis.hotpath import hot_path, is_hot_path
from repro_torch.analysis.rules import (DonationAliasCovers, MaxLiveBytes,
                                        NoCollectives, NoF64Leaks,
                                        NoHostCallbacks,
                                        NoPoolRankedScatters, Program,
                                        RecompileHazard, Rule, Violation,
                                        census)

__all__ = [
    "CONTRACTS", "Contract", "ContractViolationError", "Report",
    "ROUND_CONTRACT", "STAGED_ROUND_CONTRACT", "PREFILL_CONTRACT",
    "MIGRATION_COPY_CONTRACT",
    "check_engine_round", "check_program", "contracts_enabled",
    "maybe_check", "require", "select_contract",
    "Census", "OpRecord",
    "hot_path", "is_hot_path",
    "DonationAliasCovers", "MaxLiveBytes", "NoCollectives", "NoF64Leaks",
    "NoHostCallbacks", "NoPoolRankedScatters", "Program", "RecompileHazard",
    "Rule", "Violation", "census",
]
