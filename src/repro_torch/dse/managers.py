"""Pluggable execution managers: where a `GroupTask` actually runs.

One protocol, three executions:

* `InlineManager`     — this process, task by task (debugging, tests, and
  the budgeted CI smoke);
* `PoolManager`       — a process pool; workers are seeded with the
  parent's polyhedron verdict cache and their caches are merged back as
  they finish (the `core.sweep.sweep_parallel` discipline), so a parallel
  sweep leaves the parent exactly as warm as a serial one.  Its workers are
  spawned, never forked: a child forked from a process that has touched
  CUDA cannot use the card;
* `SubprocessManager` — one OS process per task behind a slurm-style
  batch interface (`BatchManager`: submit → job id, poll → state,
  collect → results), each running ``python -m repro_torch.dse worker``.
  `SlurmManager` is the cluster stub on the same interface: it renders
  the sbatch script it would submit and refuses politely when no
  scheduler is installed (this container has none).

The contract every manager honors: ``submit()`` never blocks on analysis
work, ``drain()`` yields ``(task_id, results)`` pairs as groups complete
(order unspecified), and a task that dies in transit — worker crash,
unparseable output, pool failure — comes back as named per-point error
docs, never as an exception out of ``drain()`` (the sweep engine's
fleet-survival rule).
"""
from __future__ import annotations

import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Tuple)

from ..core.polyhedron import export_polyhedron_cache, merge_polyhedron_cache
from .experiment import GroupTask


def _error_results(payload: Mapping[str, Any], exc: BaseException
                   ) -> List[Dict[str, Any]]:
    """Per-point error docs for a task that failed in transit."""
    err = {"type": type(exc).__name__, "message": str(exc)}
    try:
        return [dict(p.as_dict(), error=dict(err))
                for p in GroupTask.from_dict(payload).points()]
    except Exception:                     # payload itself is malformed
        return [{"task": dict(payload), "error": err}]


class ExecutionManager:
    """The protocol (also a usable no-op base).  Implementations override
    `submit`, `drain`, and optionally `close`."""

    def submit(self, task_id: str, payload: Mapping[str, Any]) -> None:
        raise NotImplementedError

    def drain(self) -> Iterator[Tuple[str, List[Dict[str, Any]]]]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "ExecutionManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------ inline --

class InlineManager(ExecutionManager):
    """Run tasks in this process, in submission order, lazily at drain time
    (so the service can stop between groups on a point budget)."""

    def __init__(self) -> None:
        self._queue: List[Tuple[str, Mapping[str, Any]]] = []

    def submit(self, task_id: str, payload: Mapping[str, Any]) -> None:
        self._queue.append((task_id, dict(payload)))

    def drain(self) -> Iterator[Tuple[str, List[Dict[str, Any]]]]:
        from .worker import run_group
        while self._queue:
            task_id, payload = self._queue.pop(0)
            try:
                yield task_id, run_group(payload)
            except Exception as e:
                yield task_id, _error_results(payload, e)


# -------------------------------------------------------------------- pool --

def _pool_run(task_id: str, payload: Mapping[str, Any]
              ) -> Tuple[str, List[Dict[str, Any]], Dict]:
    from .worker import run_group
    return task_id, run_group(payload), export_polyhedron_cache()


class PoolManager(ExecutionManager):
    """Process-pool execution with polyhedron-cache sharing both ways."""

    def __init__(self, max_workers: Optional[int] = None,
                 share_cache: bool = True) -> None:
        init, initargs = (None, ())
        if share_cache:
            init, initargs = (merge_polyhedron_cache,
                              (export_polyhedron_cache(),))
        self.share_cache = share_cache
        self._pool = ProcessPoolExecutor(
            max_workers=max_workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=init, initargs=initargs)
        self._futures: Dict[Any, Tuple[str, Mapping[str, Any]]] = {}

    def submit(self, task_id: str, payload: Mapping[str, Any]) -> None:
        payload = dict(payload)
        fut = self._pool.submit(_pool_run, task_id, payload)
        self._futures[fut] = (task_id, payload)

    def drain(self) -> Iterator[Tuple[str, List[Dict[str, Any]]]]:
        while self._futures:
            done, _ = wait(list(self._futures), return_when=FIRST_COMPLETED)
            for fut in done:
                task_id, payload = self._futures.pop(fut)
                try:
                    _, results, worker_cache = fut.result()
                    if self.share_cache and worker_cache:
                        merge_polyhedron_cache(worker_cache)
                    yield task_id, results
                except Exception as e:       # broken pool / pickling error
                    yield task_id, _error_results(payload, e)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


# ------------------------------------------------------------------- batch --

class BatchManager(ExecutionManager):
    """Slurm-shaped half of the protocol: subclasses implement
    ``_submit(job) -> None`` (start it), ``_poll(job) -> state`` with state
    in {PENDING, RUNNING, COMPLETED, FAILED}, and ``_collect(job) ->
    results``; `drain` is the generic pump with a concurrency cap."""

    #: seconds between poll rounds while jobs are in flight
    poll_interval = 0.05

    def __init__(self, max_jobs: Optional[int] = None) -> None:
        self.max_jobs = max_jobs or (os.cpu_count() or 2)
        self._jobs: List[Dict[str, Any]] = []
        self._counter = 0

    # -- interface ----------------------------------------------------------
    def _submit(self, job: Dict[str, Any]) -> None:
        raise NotImplementedError

    def _poll(self, job: Dict[str, Any]) -> str:
        raise NotImplementedError

    def _collect(self, job: Dict[str, Any]) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def _cancel(self, job: Dict[str, Any]) -> None:
        pass

    # -- generic pump -------------------------------------------------------
    def submit(self, task_id: str, payload: Mapping[str, Any]) -> None:
        self._counter += 1
        self._jobs.append({"job_id": f"job{self._counter}", "state": "PENDING",
                           "task_id": task_id, "payload": dict(payload)})

    def poll(self) -> Dict[str, str]:
        """job id → state, refreshing running jobs (the squeue view)."""
        for job in self._jobs:
            if job["state"] == "RUNNING":
                job["state"] = self._poll(job)
        return {j["job_id"]: j["state"] for j in self._jobs}

    def drain(self) -> Iterator[Tuple[str, List[Dict[str, Any]]]]:
        while any(j["state"] in ("PENDING", "RUNNING") for j in self._jobs):
            running = sum(j["state"] == "RUNNING" for j in self._jobs)
            for job in self._jobs:
                if running >= self.max_jobs:
                    break
                if job["state"] == "PENDING":
                    try:
                        self._submit(job)
                        job["state"] = "RUNNING"
                        running += 1
                    except Exception as e:
                        job["state"] = "FAILED"
                        job["error"] = e
            self.poll()
            for job in self._jobs:
                if job["state"] in ("COMPLETED", "FAILED") \
                        and not job.get("yielded"):
                    job["yielded"] = True
                    if job["state"] == "COMPLETED":
                        try:
                            yield job["task_id"], self._collect(job)
                            continue
                        except Exception as e:
                            job["error"] = e
                    yield job["task_id"], _error_results(
                        job["payload"],
                        job.get("error") or RuntimeError("worker failed"))
            if any(j["state"] in ("PENDING", "RUNNING") for j in self._jobs):
                time.sleep(self.poll_interval)
        self._jobs = [j for j in self._jobs if not j.get("yielded")]

    def close(self) -> None:
        for job in self._jobs:
            if job["state"] == "RUNNING":
                self._cancel(job)


class SubprocessManager(BatchManager):
    """One ``python -m repro_torch.dse worker`` process per task, task/result
    hand-off via JSON files in a scratch directory.  Workers inherit
    ``REPRO_POLY_CACHE`` so they start from the persisted verdict layer;
    their in-memory gains die with them (the store's poly layer is the
    cross-process channel, saved by the service after the run)."""

    def __init__(self, max_jobs: Optional[int] = None,
                 python: str = sys.executable,
                 workdir: Optional[str] = None,
                 env: Optional[Mapping[str, str]] = None) -> None:
        super().__init__(max_jobs)
        self.python = python
        self._own_dir = workdir is None
        self.workdir = workdir or tempfile.mkdtemp(prefix="repro-dse-")
        base = dict(os.environ if env is None else env)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        base["PYTHONPATH"] = src + os.pathsep * bool(base.get("PYTHONPATH")) \
            + base.get("PYTHONPATH", "")
        self.env = base

    def _submit(self, job: Dict[str, Any]) -> None:
        task_file = os.path.join(self.workdir, f"{job['job_id']}.task.json")
        out_file = os.path.join(self.workdir, f"{job['job_id']}.out.json")
        with open(task_file, "w") as fh:
            json.dump(job["payload"], fh)
        job["out_file"] = out_file
        job["proc"] = subprocess.Popen(
            [self.python, "-m", "repro_torch.dse", "worker",
             "--task", task_file, "--out", out_file],
            env=self.env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE)

    def _poll(self, job: Dict[str, Any]) -> str:
        rc = job["proc"].poll()
        if rc is None:
            return "RUNNING"
        if rc == 0 and os.path.exists(job["out_file"]):
            return "COMPLETED"
        stderr = job["proc"].stderr.read().decode(errors="replace")[-2000:]
        job["error"] = RuntimeError(
            f"worker exited rc={rc}: {stderr.strip() or 'no output'}")
        return "FAILED"

    def _collect(self, job: Dict[str, Any]) -> List[Dict[str, Any]]:
        with open(job["out_file"]) as fh:
            return json.load(fh)

    def _cancel(self, job: Dict[str, Any]) -> None:
        proc = job.get("proc")
        if proc is not None and proc.poll() is None:
            proc.kill()

    def close(self) -> None:
        super().close()
        if self._own_dir:
            shutil.rmtree(self.workdir, ignore_errors=True)


class SlurmManager(BatchManager):
    """Interface stub for a real cluster: renders the sbatch script each
    task would submit, and submits only where ``sbatch`` exists (nowhere in
    this container — `poll`/`collect` mirror ``squeue``/output-file
    semantics so a deployment only fills in the three commands)."""

    SBATCH_TEMPLATE = ("#!/bin/sh\n#SBATCH --job-name=dse-{task_id}\n"
                       "#SBATCH --cpus-per-task=1\n"
                       "{python} -m repro_torch.dse worker --task {task} --out "
                       "{out}\n")

    def render_script(self, job: Dict[str, Any]) -> str:
        return self.SBATCH_TEMPLATE.format(
            task_id=job["task_id"], python=sys.executable,
            task=f"{job['job_id']}.task.json", out=f"{job['job_id']}.out.json")

    def _submit(self, job: Dict[str, Any]) -> None:
        if shutil.which("sbatch") is None:
            raise RuntimeError(
                "slurm manager: no sbatch on PATH (interface stub — use "
                "manager='subprocess' locally); would have submitted:\n"
                + self.render_script(job))
        raise NotImplementedError("slurm submission not wired up")

    def _poll(self, job: Dict[str, Any]) -> str:
        return "FAILED"

    def _collect(self, job: Dict[str, Any]) -> List[Dict[str, Any]]:
        raise NotImplementedError


MANAGERS = {"inline": InlineManager, "pool": PoolManager,
            "subprocess": SubprocessManager, "slurm": SlurmManager}


def make_manager(name: str, **kwargs: Any) -> ExecutionManager:
    """Instantiate a manager by registry name (the CLI ``--manager`` axis)."""
    try:
        cls = MANAGERS[name]
    except KeyError:
        raise ValueError(f"unknown execution manager {name!r} "
                         f"(have: {', '.join(sorted(MANAGERS))})") from None
    return cls(**kwargs)
