"""Self-timed dataflow execution subsystem.

    engine   — event-driven executor: bounded channels, back-pressure,
               sequential/concurrent policies, structural deadlock
               detection, and the `EngineHooks` seam the resilience
               harness (`runtime.resilience`) plugs fault injection and
               runtime guards into
    observe  — SelfTimedReport / DeadlockInfo artifacts + rendering
    validate — `Analysis.validate(mode="selftimed")` checks
    backend  — the ``"selftimed"`` registry backend (scalar event machines
               per lowering + the whole-PPN `SelfTimedMachine` compile hook)

Importing this package registers the backend (it is the lazy module behind
``backend("selftimed")``).
"""
from .engine import (DeadlockError, EngineHooks, SelfTimedEngine,
                     SelfTimedError, cycle_channels, execute_ppn,
                     process_cycles)
from .observe import (ChannelStats, DeadlockInfo, ProcessStats,
                      SelfTimedReport)
from .validate import (SelfTimedValidation, executable_capacities,
                       planned_capacities,
                       selftimed_validate)
from .backend import SELFTIMED, SelfTimedMachine   # registers the backend

__all__ = [
    "ChannelStats", "DeadlockError", "DeadlockInfo", "EngineHooks",
    "ProcessStats",
    "SELFTIMED", "SelfTimedEngine", "SelfTimedError", "SelfTimedMachine",
    "SelfTimedReport", "SelfTimedValidation", "cycle_channels",
    "executable_capacities", "execute_ppn", "planned_capacities",
    "process_cycles",
    "selftimed_validate",
]
