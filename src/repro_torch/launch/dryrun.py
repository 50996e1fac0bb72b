"""Dry run: trace every (arch × shape cell × mesh) step once on the ``meta``
device (no allocation) and record its per-device memory, cost and roofline
into an incremental JSON cache.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID …]
        [--cell C …] [--mesh single|multi|both] [--out results/dryrun_torch]
        [--force]

The counterpart of `repro.launch.dryrun`, which lowers and compiles each
step for 256 or 512 TPU chips and reads XLA's per-device program (the
post-SPMD HLO) and memory.  The port runs a sharded step as DTensors on a
DeviceMesh (`Rules` given a DeviceMesh), and PyTorch has no SPMD
partitioner that would emit a per-device program.  So here the step is
run, eagerly, as device 0 of the mesh runs it: on ``meta`` tensors (no
allocation) at the cell's shapes, as DTensors laid out by the `Rules`
specs on a DeviceMesh of the mesh's axes over an in-process fake process
group of the mesh's size (`repro_torch.launch.mesh.fake_device_mesh`:
rank 0, collectives that move nothing), under the op-level walker
(`repro_torch.launch.hlo_stats`), which counts device 0's local ops and
the collectives DTensor and the model issue.  A host tool that allocates
nothing, as the reference's dry run is.  Rank 0 stands for every device:
every rank runs the same ops on its blocks, and the blocks are equal (the
specs shard only what divides) or, where DTensor splits a dimension that
does not divide, rank 0's is the largest, ceil(n / g), the block the
reference pads every device's to.  On one card (`make_host_mesh(1, 1)`)
the step runs on plain tensors, with no group.  A record holds, per
device:

* each device's argument, output and donated (alias) bytes, from the
  `Rules` specs of the parameters, the optimizer state, the batch and the
  cache; ``sharding_fallbacks``, the fallbacks those specs take (the
  reference's list also carries those of the activation constraints its
  trace meets); ``model_flops_*`` and ``skip_reason``'s verdict, the
  reference's;
* device 0's FLOPs and bytes, ``temp_bytes`` (its peak of live
  intermediates), and its collectives: their wire bytes at the reference's
  ring factors, by kind, and their counts;
* the roofline: the FLOPs at `PEAK_FLOPS_BF16`, the bytes at `HBM_BW` and
  the collective bytes at `LINK_BW` (NVLink, one rate on every axis, as
  the reference prices each of its axes at one ICI rate), and the
  dominant term among the three;
* null where the port has no counterpart: ``compile_s`` (nothing is
  compiled; ``lower_s`` is the trace's seconds) and ``xla_cost_analysis``.

On ``meta`` a model takes its CPU route: train and prefill attention are
`chunked_attention`, not kernel 5, so the walker counts the chunked form's
operations and no kernel of the repository launches.  DTensor's own host
work (sharding propagation, index arithmetic on CPU tensors) is not
counted.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback
from typing import Dict, Mapping, Optional, Tuple

import torch

from .. import configs
from ..configs.base import SHAPE_CELLS, ShapeCell
from ..models import Model, Rules, build
from ..train.step import make_abstract_train_state, make_train_step
from ..tree import tree_leaves, tree_map
from . import hlo_stats
from .mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16, fake_device_mesh,
                   make_production_mesh)

#: bytes of one pointer in XLA's tuple of a step's output buffers
_TUPLE = 8


def skip_reason(arch: str, cell: ShapeCell) -> Optional[str]:
    cfg = configs.get(arch).model
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention arch: one decode step against a 512k dense KV "
                "cache is quadratic-history; sub-quadratic families only "
                "(DESIGN.md §Arch-applicability)")
    return None


def model_flops(arch: str, cell: ShapeCell) -> float:
    cfg = configs.get(arch).model
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    return 2.0 * n_active * cell.global_batch          # decode: 1 token/seq


def batch_abstract(cfg, cell: ShapeCell, mode: str):
    """The step's batch as ``meta`` tensors, the reference's shapes and
    dtypes."""
    B, S = cell.global_batch, cell.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if mode == "train" or mode == "prefill":
        out = {"tokens": meta((B, S), torch.int32)}
        if cfg.family == "encdec":
            out["frames"] = meta((B, S, cfg.d_model), torch.bfloat16)
    else:
        out = {"tokens": meta((B, 1), torch.int32),
               "pos": meta((), torch.int32)}
        if cfg.family == "encdec":
            out["frames"] = meta((B, 1, cfg.d_model), torch.bfloat16)
    return out


def mesh_tag(mesh: Mapping[str, int]) -> str:
    return "x".join(str(int(n)) for n in mesh.values())


def _per_device(rules: Rules, tree, specs) -> int:
    """Bytes one device holds of ``tree`` laid out by ``specs``."""
    total = 0

    def one(t, spec):
        nonlocal total
        axes = [a for part in spec if part is not None
                for a in (part if isinstance(part, tuple) else (part,))]
        n = math.prod(int(rules.mesh[a]) for a in axes)
        total += t.numel() * t.element_size() // n

    tree_map(one, tree, specs)
    return total


def _setup(arch: str, cell: ShapeCell, mesh: Mapping[str, int],
           multi_pod: bool) -> Tuple[Model, Rules]:
    bundle = configs.get(arch)
    par = bundle.parallel_for(cell.name, multi_pod)
    return build(bundle.model, par), Rules.make(mesh, par)


def _logits_abstract(model: Model, cell: ShapeCell) -> torch.Tensor:
    dtype = model.plan["embed"]["embedding"].dtype
    return torch.empty((cell.global_batch, 1, model.cfg.padded_vocab()),
                       dtype=dtype, device="meta")


def _serve_batch_spec(rules: Rules, batch) -> Dict:
    """A serving step's batch laid out as the server lays it out."""
    names = {"tokens": ("batch", "seq"), "frames": ("batch", "seq", None),
             "pos": ()}
    return {k: rules.spec(v.shape, names[k][:len(v.shape)])
            for k, v in batch.items()}


def step_memory(arch: str, cell: ShapeCell, mesh: Mapping[str, int],
                multi_pod: bool = False) -> Tuple[Dict[str, int], Rules]:
    """Each device's argument, output and alias bytes of the cell's step on
    ``mesh``, from the specs alone (no trace), and the rules, whose
    ``dropped`` lists the specs' fallbacks in the reference's order:
    parameters, optimizer state (or cache), batch, logits.  The train step donates its state, a serving step its cache.
    The output bytes count XLA's tuple of output buffers too, a pointer of
    `_TUPLE` bytes a leaf, as the reference's ``output_size_in_bytes``
    does."""
    model, rules = _setup(arch, cell, mesh, multi_pod)
    cfg = model.cfg
    if cell.kind == "train":
        bundle = make_train_step(model, rules)
        state = {"params": model.abstract_params(),
                 "opt": make_abstract_train_state(model)["opt"]}
        batch = batch_abstract(cfg, cell, "train")
        bspec = bundle.batch_spec(batch)
        state_b = _per_device(rules, state, bundle.state_specs)
        metrics = 3 * 4                     # loss, grad_norm (f32), step
        leaves = len(tree_leaves(state)) + 3
        mem = {"argument_bytes": state_b + _per_device(rules, batch, bspec),
               "output_bytes": state_b + metrics + _TUPLE * leaves,
               "alias_bytes": state_b}
    else:
        B, S = cell.global_batch, cell.seq_len
        pspecs = model.param_specs(rules)
        cspecs = model.cache_specs(B, S, rules)
        batch = batch_abstract(cfg, cell, cell.kind)
        bspec = _serve_batch_spec(rules, batch)
        logits = _logits_abstract(model, cell)
        lspec = rules.spec(logits.shape, ("batch", None, "vocab_act"))
        cache = model.abstract_cache(B, S)
        cache_b = _per_device(rules, cache, cspecs)
        leaves = 1 + len(tree_leaves(cache))
        mem = {"argument_bytes": (_per_device(rules, model.abstract_params(),
                                              pspecs)
                                  + _per_device(rules, batch, bspec)
                                  + cache_b),
               "output_bytes": (_per_device(rules, logits, lspec) + cache_b
                                + _TUPLE * leaves),
               "alias_bytes": cache_b}
    return mem, rules


def _loops(model: Model, cell: ShapeCell):
    """The layer loops' trip counts (each stack's leading dimension), after
    the microbatch loop's where the step trains."""
    loops = []
    if cell.kind == "train":
        loops.append(("microbatches", model.par.num_microbatches))
    for key in ("encoder", "layers", "decoder"):
        if key in model.plan and not (key == "encoder"
                                      and cell.kind == "decode"):
            loops.append((key, tree_leaves(model.plan[key])[0].shape[0]))
    return loops


def _walk(model: Model, cell: ShapeCell, rules: Rules, lay_out):
    """The cell's step under the walker, its arguments made on ``meta`` and
    passed through ``lay_out(tree, specs)``."""
    cfg = model.cfg
    if cell.kind == "train":
        bundle = make_train_step(model, rules)
        state = lay_out({"params": model.abstract_params(),
                         "opt": make_abstract_train_state(model)["opt"]},
                        bundle.state_specs)
        batch = batch_abstract(cfg, cell, "train")
        return hlo_stats.analyze(bundle.step_fn, state,
                                 lay_out(batch, bundle.batch_spec(batch)))
    B, S = cell.global_batch, cell.seq_len
    params = lay_out(model.abstract_params(), model.param_specs(rules))
    cache = lay_out(model.abstract_cache(B, S),
                    model.cache_specs(B, S, rules))
    batch = batch_abstract(cfg, cell, cell.kind)
    # the server passes the position as it is (a host scalar), the rest
    # laid out
    batch = dict(lay_out(batch, _serve_batch_spec(rules, batch)),
                 **{k: v for k, v in batch.items() if k == "pos"})

    @torch.no_grad()
    def serve_step(params, batch, cache):
        with rules.context():
            if cell.kind == "prefill":
                return model.prefill_fn(params, batch, rules, cache)
            return model.decode_fn(params, batch, cache, rules)

    return hlo_stats.analyze(serve_step, params, batch, cache)


def lower_cell(arch: str, cell: ShapeCell, mesh: Mapping[str, int],
               multi_pod: bool):
    """Trace the cell's step on ``meta`` under the walker: the train step
    from `make_train_step`, or the prefill or decode forward.  On one card
    the step runs on plain tensors; on more, as DTensors over a fake mesh
    of ``mesh``'s axes (`fake_device_mesh`), so the walker counts device
    0's program: its local ops and the collectives DTensor and the model
    issue.  Returns that program's `HloStats` (per device) and the rules
    of the trace."""
    model, rules = _setup(arch, cell, mesh, multi_pod)
    if math.prod(int(n) for n in mesh.values()) == 1:
        stats = _walk(model, cell, rules, lambda tree, specs: tree)
    else:
        with fake_device_mesh(mesh) as dmesh:
            rules = Rules.make(dmesh, model.par)
            stats = _walk(model, cell, rules, lambda tree, specs: tree_map(
                rules.distribute_spec, tree, specs))
    stats.loops = _loops(model, cell)
    return stats, rules


def cell_record(arch: str, cell: ShapeCell, mesh: Mapping[str, int],
                multi_pod: bool = False) -> Dict:
    """The record of one step of ``arch`` at ``cell``'s shape on ``mesh``
    (any mesh of axis sizes: `make_host_mesh(1, 1)` is the one card),
    without the skip check or the cache: what `run_cell` records."""
    chips = math.prod(int(n) for n in mesh.values())
    mem, rules = step_memory(arch, cell, mesh, multi_pod)
    t0 = time.time()
    st, _ = lower_cell(arch, cell, mesh, multi_pod)
    t_lower = time.time() - t0
    temp = st.peak_live_bytes
    mf = model_flops(arch, cell)
    terms = {"compute": st.flops / PEAK_FLOPS_BF16,
             "memory": st.bytes / HBM_BW,
             "collective": st.collective_bytes / LINK_BW}
    return {
        "status": "ok",
        "chips": chips,
        "lower_s": round(t_lower, 2),
        "compile_s": None,
        "memory": dict(mem, temp_bytes=temp, peak_bytes_per_device=(
            mem["argument_bytes"] + temp + mem["output_bytes"]
            - mem["alias_bytes"])),
        "xla_cost_analysis": None,
        "hlo": st.as_dict(),
        "model_flops_global": mf,
        "model_flops_per_device": mf / chips,
        "roofline": {
            "compute_s": terms["compute"],
            "memory_s": terms["memory"],
            "collective_s": terms["collective"],
            "dominant": max(terms.items(), key=lambda kv: kv[1])[0],
            "useful_flops_ratio": ((mf / chips) / st.flops if st.flops
                                   else None),
        },
        "sharding_fallbacks": rules.dropped,
    }


def run_cell(arch: str, cell_name: str, multi_pod: bool, out_dir: pathlib.Path,
             force: bool = False) -> Dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    tag = mesh_tag(mesh)
    out_path = out_dir / f"{arch}__{cell_name}__{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cell = SHAPE_CELLS[cell_name]
    rec: Dict = {"arch": arch, "cell": cell_name, "mesh": tag,
                 "timestamp": time.time()}
    reason = skip_reason(arch, cell)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        out_path.write_text(json.dumps(rec, indent=2))
        return rec
    try:
        rec.update(cell_record(arch, cell, mesh, multi_pod))
    except Exception as e:  # record failures — they are dry-run bugs to fix
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--cell", nargs="*", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = args.arch or configs.arch_names()
    cells = args.cell or list(SHAPE_CELLS)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    for arch in archs:
        for cell in cells:
            for mp in meshes:
                tag = mesh_tag(make_production_mesh(multi_pod=mp))
                t0 = time.time()
                rec = run_cell(arch, cell, mp, out_dir, args.force)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    coll = ("n/a" if r["collective_s"] is None
                            else f"{r['collective_s']:.3e}s")
                    extra = (f"dom={r['dominant']} comp={r['compute_s']:.3e}s "
                             f"mem={r['memory_s']:.3e}s coll={coll} "
                             f"hbm={rec['memory']['peak_bytes_per_device']/2**30:.2f}GiB")
                elif status == "error":
                    extra = rec.get("error", "")[:160]
                print(f"[{arch} × {cell} × {tag}] {status} "
                      f"({time.time()-t0:.0f}s) {extra}", flush=True)


if __name__ == "__main__":
    main()
