"""The kind of configuration whose work is a job of T sweeps of a PolyBench
stencil, run through the port's main path.

Set-up takes the user's path on the kernel's registry case:
``analyze(get(k)).classify().fifoize().size().plan()``, then
``compile(backend="cuda")`` (with the mix's forced mode, if any) and
``validate(backend="cuda")``, after the kernels the mix names are built or
loaded from ``build/kernels/``; then one warm-up job.  A job makes a fresh
input on the device from the run's seed and the job's index and runs the
`CompiledStencil` that ``compile`` returned over it: chained calls of the
mix's ``steps_per_call`` sweeps at steps = block (the ring's time tile is
its block; the addressable mode takes no block), or, where that is null,
one call of all the job's sweeps.  The check holds a sample of the window's
outputs (and the traced window's last) to the program's reference in
float64, and, on the card, the launches a job made to what the mix says the
path launches.
"""
from __future__ import annotations

import time
from pathlib import Path

import torch

from portbench.lib.compare import Check, max_rel_err, sweeps
from portbench.lib.jobs import Reservoir, closed_loop, job_seed
from portbench.lib.plugins import load_module
from portbench.lib.trace import profile_jobs

#: the warm-up job's index (the window's jobs are 0, 1, …)
WARMUP = -1
#: the element type: the port's stencil kernels take float32 only
DTYPE = torch.float32
#: the window's jobs held to the reference, a uniform sample from the seed
CHECKED_JOBS = 3
#: the traced window: whole jobs, at least this many and this long
TRACE_JOBS = 2
TRACE_SECONDS = 1.0
#: the port's launch counters (`repro_torch.kernels.cuda_lib`) a run reads
COUNTERS = ("RING_STENCIL", "ADDRESSABLE_STEP", "REPLAY")


class NotTheTraffic(RuntimeError):
    """The program did not take the path the cell measures."""


class StencilJob:
    def __init__(self, folder: Path, ctx, log) -> None:
        config, mix = ctx.config, ctx.mix
        self.config, self.mix, self.log = config, mix, log
        self.program = config["program"]
        self.shape = tuple(int(n) for n in config["shape"])
        self.sweeps = int(config["sweeps"])
        if config["DATA_TYPE"] != "float":
            raise ValueError(f"DATA_TYPE {config['DATA_TYPE']!r}: the "
                             f"port's stencil kernels take float only")
        self.steps = mix["steps_per_call"] or self.sweeps
        if self.sweeps % self.steps:
            raise ValueError(f"{self.sweeps} sweeps are no whole number of "
                             f"calls of {self.steps}")
        self.reference = load_module(folder / "reference", self.program)
        self.device = torch.device(ctx.device)
        self.cuda = self.device.type == "cuda"
        self.seed = ctx.seed
        self.compiled = None
        self.samples = []
        ctx.sweeps = self.sweeps
        ctx.work = lambda n: self.reference.work(
            self.shape, n, torch.empty((), dtype=DTYPE).element_size())

    # ------------------------------------------------------------ set-up --
    def setup(self, ctx) -> None:
        import repro_torch.core.polybench  # noqa: F401  (the registry)
        from repro_torch.core import analyze
        from repro_torch.core.registry import get
        from repro_torch.kernels import cuda_lib

        self.cuda_lib = cuda_lib
        if self.cuda:
            t = time.perf_counter()
            built = cuda_lib.build_all([getattr(cuda_lib, k)
                                        for k in self.mix["kernels"]])
            ctx.spans["load"] = time.perf_counter() - t
            print(f"kernels built (s, 0 where loaded): {built}",
                  file=self.log)
        where = None if self.cuda else str(self.device)
        t = time.perf_counter()
        analysis = analyze(get(self.program)).classify().fifoize().size() \
            .plan()
        mode = self.mix["compile_mode"]
        self.compiled = analysis.compile(
            backend="cuda", device=where, **({"mode": mode} if mode else {}))
        ctx.spans["analysis"] = time.perf_counter() - t
        if self.compiled.mode != self.mix["expect_mode"]:
            raise NotTheTraffic(
                f"{ctx.cell}: compile() gave mode {self.compiled.mode!r}, the "
                f"cell measures {self.mix['expect_mode']!r}: "
                f"{self.compiled.describe()}")
        t = time.perf_counter()
        validation = analysis.validate(backend="cuda", device=where) \
            .validation
        ctx.spans["validate"] = time.perf_counter() - t
        print(f"validate: {validation.summary()}", file=self.log)
        self.gen = torch.Generator(device=self.device)
        t = time.perf_counter()
        self.job(WARMUP)
        ctx.spans["warmup"] = time.perf_counter() - t

    def counters(self) -> dict:
        return {k: getattr(self.cuda_lib, k).launches for k in COUNTERS}

    # -------------------------------------------------------------- jobs --
    def input(self, seed: int, index: int) -> torch.Tensor:
        """Job ``index``'s input: uniform on [0, 1), made on the device."""
        self.gen.manual_seed(job_seed(seed, index))
        return torch.rand(self.shape, generator=self.gen, dtype=DTYPE,
                          device=self.device)

    def job(self, index: int, seed=None) -> torch.Tensor:
        x = self.input(self.seed if seed is None else seed, index)
        y = x
        for _ in range(self.sweeps // self.steps):
            y = self.compiled(y, self.steps, self.steps)
        if self.cuda:
            torch.cuda.synchronize(self.device)
        return y

    def window(self, seconds: float, ctx) -> None:
        kept = Reservoir(CHECKED_JOBS, self.seed)
        before = self.counters()
        ctx.jobs, ctx.window_s = closed_loop(self.job, seconds, kept)
        ctx.launches = {k: n - before[k] for k, n in self.counters().items()}
        ctx.extra["attempted"] = ctx.jobs
        self.samples = [(self.seed, i, y) for i, y in kept.kept]

    def traced(self, ctx) -> None:
        first = ctx.jobs
        out, ctx.trace = profile_jobs(
            lambda j: self.job(first + j), TRACE_SECONDS, TRACE_JOBS,
            self.cuda)
        ctx.extra["attempted"] += ctx.trace.jobs
        self.samples.append((self.seed, first + ctx.trace.jobs - 1, out))

    # ------------------------------------------------------------- check --
    def reference_job(self, seed: int, index: int) -> torch.Tensor:
        """Job ``index``'s output by the reference, in float64."""
        return sweeps(self.reference.sweep,
                      self.input(seed, index).to(torch.float64), self.sweeps)

    def launches_per_job(self) -> dict:
        """The launches a job makes, by counter, on the mix's path."""
        per = {"call": self.sweeps // self.steps, "step": self.sweeps,
               "none": 0}
        return {k: per[v] for k, v in self.mix["launches"].items()}

    def check(self, ctx) -> list:
        limit = float(self.config["limits"]["max_rel_err"])
        errs = []
        while self.samples:
            seed, index, y = self.samples.pop(0)
            errs.append(max_rel_err(y, self.reference_job(seed, index)))
            del y
        worst = (float("nan") if any(e != e for e in errs) else max(errs))
        ctx.extra["failed"] = sum(not e <= limit for e in errs)
        checks = [Check("max_rel_err", worst, limit)]
        if self.cuda:       # the plain versions on a CPU launch nothing
            for k, want in self.launches_per_job().items():
                checks.append(Check(f"{k.lower()}_launches_per_job",
                                    ctx.launches[k] / ctx.jobs, want, "=="))
        return checks


def make(folder: Path, ctx, log) -> StencilJob:
    return StencilJob(folder, ctx, log)
