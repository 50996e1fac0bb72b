"""Design-space-exploration CLI.

    PYTHONPATH=src python -m repro_torch.dse run      [--spec F | --default]
        [--store DIR] [--manager inline|pool|subprocess] [--workers N]
        [--max-points N] [--kernels a,b,...] [--tile-sizes 1,2,4]
        [--size-count K]
    PYTHONPATH=src python -m repro_torch.dse resume   ... (same flags; alias —
        `run` is already store-first and recomputes nothing that is stored)
    PYTHONPATH=src python -m repro_torch.dse status   [--spec F | --default] [--store DIR]
    PYTHONPATH=src python -m repro_torch.dse frontier [--spec F | --default] [--store DIR]
    PYTHONPATH=src python -m repro_torch.dse worker   --task F --out F

The store root defaults to ``$REPRO_DSE_STORE`` or ``.cache/dse``.
``worker`` is the `SubprocessManager`'s entry point: one `GroupTask` JSON
in, one result-doc list JSON out.
"""
from __future__ import annotations

import argparse
import json
import sys

from .experiment import Experiment, default_experiment
from .service import DSEService
from .store import ArtifactStore


def _experiment(args: argparse.Namespace) -> Experiment:
    if args.spec:
        with open(args.spec) as fh:
            return Experiment.from_dict(json.load(fh))
    kw = {}
    if args.kernels:
        kw["kernels"] = args.kernels.split(",")
    if args.tile_sizes:
        kw["tile_sizes"] = [int(b) for b in args.tile_sizes.split(",")]
    if args.size_count:
        kw["size_count"] = args.size_count
    return default_experiment(**kw)


def _spec_flags(sub: argparse.ArgumentParser) -> None:
    sub.add_argument("--spec", help="experiment spec JSON file")
    sub.add_argument("--default", action="store_true",
                     help="use the built-in 15-kernel acceptance grid")
    sub.add_argument("--kernels", help="comma list (with --default)")
    sub.add_argument("--tile-sizes", help="comma list (with --default)")
    sub.add_argument("--size-count", type=int, help="sizes per tiling "
                     "(with --default)")
    sub.add_argument("--store", help="store root (default: "
                     "$REPRO_DSE_STORE or .cache/dse)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.dse")
    subs = ap.add_subparsers(dest="cmd", required=True)
    for name in ("run", "resume"):
        sub = subs.add_parser(name)
        _spec_flags(sub)
        sub.add_argument("--manager", default="inline",
                         choices=("inline", "pool", "subprocess", "slurm"))
        sub.add_argument("--workers", type=int, default=None)
        sub.add_argument("--max-points", type=int, default=None)
        sub.add_argument("--no-frontier", action="store_true")
    for name in ("status", "frontier"):
        _spec_flags(subs.add_parser(name))
    wk = subs.add_parser("worker")
    wk.add_argument("--task", required=True)
    wk.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    if args.cmd == "worker":
        from .worker import run_group
        with open(args.task) as fh:
            task_doc = json.load(fh)
        results = run_group(task_doc)
        with open(args.out, "w") as fh:
            json.dump(results, fh)
        return 0

    if not args.spec and not args.default:
        ap.error(f"{args.cmd} needs --spec FILE or --default")
    exp = _experiment(args)
    store = ArtifactStore(args.store)

    if args.cmd in ("run", "resume"):
        kwargs = {}
        if args.manager in ("pool",) and args.workers:
            kwargs["max_workers"] = args.workers
        if args.manager in ("subprocess", "slurm") and args.workers:
            kwargs["max_jobs"] = args.workers
        svc = DSEService(exp, store, manager=args.manager,
                         manager_kwargs=kwargs)
        summary = svc.run(max_points=args.max_points)
        print(json.dumps(summary, indent=1))
        if not args.no_frontier and not summary["stopped_early"] \
                and summary["pending"] <= 0:
            for line in svc.frontier_lines():
                print(line)
        return 1 if summary["errors"] else 0

    svc = DSEService(exp, store)
    if args.cmd == "status":
        print(json.dumps(svc.status(), indent=1))
        return 0
    doc = svc.frontier()                       # cmd == "frontier"
    for line in svc.frontier_lines(doc):
        print(line)
    print(f"frontier written to "
          f"{store.experiment_dir(doc['experiment_id']) / 'frontier.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
