"""Fault injection and self-healing channel guards for the PPN runtime.

The paper's static verdicts license cheap channel lowerings; this package
checks the licensed properties *live* and keeps a faulted network
producing correct answers — or failing loudly with a named culprit:

* `faults` — declarative, seeded `FaultPlan` (token drop / duplicate /
  reorder / corruption, actor stall / crash, capacity loss) triggered at
  chosen fire-counts, plus trace-level injection (`faulted_trace`);
* `guards` — sequence-tag disciplines per lowering, the multiset audit,
  `guarded_replay`, and the `ProgressWatchdog` that bounds recovery;
* `harness` — `ResilienceHooks` (an `EngineHooks` implementation) and
  `run_guarded`, wiring injection + detection + bounded recovery +
  FIFO→reorder-buffer degradation into the self-timed engine;
* `report` — the `ResilienceReport` artifact (schema-v4 ``"resilience"``
  field of `AnalysisReport`);
* `validate` — the per-kernel fault matrix behind
  ``Analysis.validate(mode="faults")``.
"""
from .faults import (ALL_KINDS, CAPACITY, CHANNEL_KINDS, CORRUPT, CRASH,
                     DROP, DUPLICATE, PROCESS_KINDS, REORDER, STALL,
                     TOKEN_KINDS, Fault, FaultPlan, FaultSpecError,
                     expected_pop_counts, faulted_trace, parse_fault)
from .guards import (GUARD_MODES, GuardViolation, ProgressWatchdog,
                     audit_trace, guarded_replay, mode_for_lowering)
from .harness import GuardedRun, ResilienceHooks, run_guarded
from .report import STATUSES, ResilienceReport
from .validate import (ResilienceValidation, WireFault, channel_lowerings,
                       faults_validate, wire_faults)

__all__ = [
    "ALL_KINDS", "CAPACITY", "CHANNEL_KINDS", "CORRUPT", "CRASH", "DROP",
    "DUPLICATE", "PROCESS_KINDS", "REORDER", "STALL", "TOKEN_KINDS",
    "Fault", "FaultPlan", "FaultSpecError", "expected_pop_counts",
    "faulted_trace", "parse_fault",
    "GUARD_MODES", "GuardViolation", "ProgressWatchdog", "audit_trace",
    "guarded_replay", "mode_for_lowering",
    "GuardedRun", "ResilienceHooks", "run_guarded",
    "STATUSES", "ResilienceReport",
    "ResilienceValidation", "WireFault", "channel_lowerings",
    "faults_validate", "wire_faults",
]
