"""The port's launch modules (`repro_torch.launch.{mesh,dryrun,hlo_stats,
roofline}`) against the JAX package's, on the CPU.

Importing `repro.launch.dryrun` sets ``XLA_FLAGS`` to 512 host devices, so
the reference's side of the dry run runs once, in one subprocess (the
``reference`` fixture): its meshes, `skip_reason`, `model_flops` and
`batch_abstract` for every arch × cell, each device's argument, output and
alias bytes and the fallbacks its own `Rules` specs give on the 16×16 and
2×16×16 production meshes (no compile), and three compiled anchors:
qwen2-7b's decode, prefill and train step at B = 4, S = 256 on a 2×2 mesh
of its host devices, cells where no spec falls back.  The reference's
`lower_cell` runs there on a mesh whose axes are ``Auto``: JAX 0.9.0's
`jax.make_mesh` makes ``Explicit`` axes, which the reference's
``with_sharding_constraint`` refuses.

1. The port's meshes are the reference's axis sizes.
2. `skip_reason`, `model_flops` and `batch_abstract`'s shapes and dtypes
   equal the reference's for all 10 archs × 4 cells.
3. Each device's argument, output and alias bytes and the fallbacks (as a
   multiset: JAX visits a dict's keys sorted) equal the reference's specs'
   on both production meshes for every arch × cell.
4. The anchors: the port's argument and output bytes equal the compiled
   reference's ``memory_analysis()`` exactly.  The record on a mesh of
   more than one card is device 0's DTensor program over a fake process
   group, so its FLOPs are held to the reference's per-device HLO count:
   within `ANCHOR_FLOPS_REL` for the train step and the prefill (the rest
   is the +1-per-element count of element-wise instructions, which XLA's
   CPU program and eager PyTorch spend differently).  In the decode step
   XLA's CPU program converts every bf16 operand of a dot to f32 (1.43e10
   of its 3.65e10 FLOPs are converts: the test prints its count with each
   convert taken as a bitcast) and counts its all-gathers' outputs, which
   the card does not do: there the port's FLOPs are held to the model
   FLOPs per device (`ANCHOR_DECODE_FLOPS`) and their ratio to the
   reference's is printed.  The collectives: every floating collective of the
   reference's CPU program is f32 (its weights are converted before they
   are gathered), the port's move the parameters' bf16, so the port's
   total and all-gather bytes, at f32's width, are held within
   `ANCHOR_COLL_FACTOR` of the reference's (printed at both widths, with
   the counts by kind).
5. The op-level walker against `tests/test_hlo_stats.py`: one matmul is
   exactly 2·M·N·K; L stacked ``tanh(c @ w)`` (a Python loop) give FLOPs
   within the reference's bounds for L = 4 and 16, and within those bounds
   of the reference's own count of the same ``jax.lax.scan``, and bytes
   equal to the eager ops' operands and results (0.60 of the reference's
   at L = 4, whose count also charges the scan's carry and dynamic
   slices); remat's recompute and the backward are seen; collective bytes
   carry the ring factors for groups of 2 and 4 under the in-process
   ``"fake"`` backend, for the c10d ops and the functional ones DTensor
   issues; the peak of live intermediates.  On fake meshes: a
   column-parallel product then a row-parallel one on 1×4 is one
   all-reduce and a quarter of each product; a ``Shard(0)`` to
   ``Shard(1)`` redistribute is one all-to-all; a DTensor op under the
   walker returns a DTensor; a record takes its group down and refuses
   one that is up; a 16×16 record has its collectives.
6. `run_cell` end to end on ``meta`` (smollm-135m ``decode_32k``): ``ok``,
   then read back from the cache without ``--force``.
7. `render` gives the reference's bytes on the same records (ok, skipped
   and error records, both meshes, markdown on and off); a null term is an
   empty cell; `main`'s header names the card.

About 50 s on this CPU in one process, the subprocess included.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.launch import hlo_stats as jhlo  # noqa: E402
from repro.launch.roofline import render as jrender  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPE_CELLS, ShapeCell  # noqa: E402
from repro_torch.launch import dryrun, hlo_stats, roofline  # noqa: E402
from repro_torch.launch.mesh import (LINK_BW,  # noqa: E402
                                     fake_device_mesh, make_host_mesh,
                                     make_production_mesh)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = configs.arch_names()
CELLS = list(SHAPE_CELLS)
MESHES = {"16x16": False, "2x16x16": True}
#: the compiled anchors: qwen2-7b at B = 4, S = 256 on a 2×2 mesh
ANCHORS = {"decode": "decode_32k", "prefill": "prefill_32k",
           "train": "train_4k"}
ANCHOR_B, ANCHOR_S = 4, 256
#: device 0's FLOPs against the reference's HLO count, relative (train and
#: prefill; see the module docstring)
ANCHOR_FLOPS_REL = 0.05
#: the decode anchor: device 0's FLOPs over the model FLOPs per device
ANCHOR_DECODE_FLOPS = (0.8, 1.25)
#: device 0's collective and all-gather bytes at the reference's width
#: against the reference's, as a factor either way
ANCHOR_COLL_FACTOR = 2.0

_REFERENCE = textwrap.dedent("""
    import json, math, re, sys
    import repro.launch.dryrun as d      # 512 host devices, before jax
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P
    jax.config.update("jax_enable_compilation_cache", False)
    from repro import configs
    from repro.configs.base import SHAPE_CELLS, ShapeCell
    from repro.launch import hlo_stats
    from repro.launch.mesh import make_host_mesh, make_production_mesh
    from repro.models import build
    from repro.models.sharding import Rules
    from repro.train.step import make_abstract_train_state, make_train_step

    def per_device(shape, tree, specs):
        leaves = jax.tree.leaves(tree)
        parts = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
        total = 0
        for t, sp in zip(leaves, parts, strict=True):
            axes = [a for p in sp if p is not None
                    for a in (p if isinstance(p, tuple) else (p,))]
            total += (math.prod(t.shape) * t.dtype.itemsize
                      // math.prod(shape[a] for a in axes))
        return total, len(leaves)

    def memory(arch, cell, multi_pod):
        shape = dict(make_production_mesh(multi_pod=multi_pod).shape)
        bundle = configs.get(arch)
        cfg = bundle.model
        par = bundle.parallel_for(cell.name, multi_pod)
        rules = Rules.make(type("M", (), {"shape": shape})(), par)
        model = build(cfg, par)
        if cell.kind == "train":
            bt = make_train_step(model, rules)
            state = {"params": model.abstract_params(),
                     "opt": make_abstract_train_state(model)["opt"]}
            batch = d.batch_abstract(cfg, cell, "train")
            bspec = bt.batch_spec(batch)
            sb, n = per_device(shape, state, bt.state_specs)
            # metrics: loss, grad_norm (float32) and step (int32), P()
            out = {"argument_bytes": sb + per_device(shape, batch, bspec)[0],
                   "output_bytes": sb + 12 + 8 * (n + 3),
                   "alias_bytes": sb}
        else:
            B, S = cell.global_batch, cell.seq_len
            pspecs = model.param_specs(rules)
            cache = model.abstract_cache(B, S)
            cspecs = model.cache_specs(B, S, rules)
            batch = d.batch_abstract(cfg, cell, cell.kind)
            names = {"tokens": ("batch", "seq"),
                     "frames": ("batch", "seq", None), "pos": ()}
            bspec = {k: rules.spec(v.shape, names[k][:len(v.shape)])
                     for k, v in batch.items()}
            logits = jax.ShapeDtypeStruct((B, 1, cfg.padded_vocab()),
                                          jnp.dtype(cfg.dtype))
            lspec = rules.spec(logits.shape, ("batch", None, "vocab_act"))
            cb, n = per_device(shape, cache, cspecs)
            out = {"argument_bytes": (
                       per_device(shape, model.abstract_params(), pspecs)[0]
                       + per_device(shape, batch, bspec)[0] + cb),
                   "output_bytes": (per_device(shape, logits, lspec)[0] + cb
                                    + 8 * (n + 1)),
                   "alias_bytes": cb}
        out["dropped"] = [list(x) for x in rules.dropped]
        return out

    res = {"meshes": {
               "host11": dict(make_host_mesh(1, 1).shape),
               "host22": dict(make_host_mesh(2, 2).shape),
               "16x16": dict(make_production_mesh().shape),
               "2x16x16": dict(make_production_mesh(multi_pod=True).shape)},
           "cells": {}, "anchors": {}}
    for arch in configs.arch_names():
        cfg = configs.get(arch).model
        for name, cell in SHAPE_CELLS.items():
            batch = d.batch_abstract(cfg, cell, cell.kind)
            res["cells"][f"{arch}/{name}"] = {
                "skip": d.skip_reason(arch, cell),
                "model_flops": d.model_flops(arch, cell),
                "batch": {k: [list(v.shape), str(v.dtype)]
                          for k, v in batch.items()},
                "memory": {"16x16": memory(arch, cell, False),
                           "2x16x16": memory(arch, cell, True)}}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    for kind, name in json.loads(sys.argv[2]).items():
        cell = ShapeCell(name, int(sys.argv[4]), int(sys.argv[3]), kind)
        lowered, rules = d.lower_cell("qwen2-7b", cell, mesh, False)
        compiled = lowered.compile()
        mem = compiled.memory_analysis()
        text = compiled.as_text()
        st = hlo_stats.analyze(text)
        # the element types each kind of collective moves in the program
        widths = {}
        for line in text.splitlines():
            m = re.search(r"= (.*?) (all-gather|all-reduce|reduce-scatter|"
                          r"all-to-all|collective-permute)(-start)?\\(", line)
            if m:
                widths.setdefault(m.group(2), set()).update(
                    re.findall(r"([a-z]+[0-9]*)\\[", m.group(1)))
        res["anchors"][kind] = {
            "argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "alias_bytes": mem.alias_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "flops": st.flops, "bytes": st.bytes, "dropped": rules.dropped,
            # the count with each convert taken as a bitcast (no FLOPs)
            "flops_without_converts": hlo_stats.analyze(
                text.replace(" convert(", " bitcast(")).flops,
            "collective_bytes": st.collective_bytes,
            "per_collective": st.per_collective,
            "collective_count": st.collective_count,
            "collective_types": {k: sorted(v) for k, v in widths.items()}}
    with open(sys.argv[1], "w") as f:
        json.dump(res, f)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference") / "reference.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", _REFERENCE, str(out),
                    json.dumps(ANCHORS), str(ANCHOR_B), str(ANCHOR_S)],
                   env=env, check=True, timeout=300)
    return json.loads(out.read_text())


# ------------------------------------------------------------- meshes ---

def test_meshes_are_the_reference_axis_sizes(reference):
    got = {"host11": make_host_mesh(1, 1), "host22": make_host_mesh(2, 2),
           "16x16": make_production_mesh(),
           "2x16x16": make_production_mesh(multi_pod=True)}
    assert got == reference["meshes"]
    assert dryrun.mesh_tag(got["2x16x16"]) == "2x16x16"


# ------------------------------------------------- skip, flops, batch ---

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cell", CELLS)
def test_skip_flops_and_batch_equal_the_reference(reference, arch, cell):
    want = reference["cells"][f"{arch}/{cell}"]
    c = SHAPE_CELLS[cell]
    assert dryrun.skip_reason(arch, c) == want["skip"]
    assert dryrun.model_flops(arch, c) == want["model_flops"]
    batch = dryrun.batch_abstract(configs.get(arch).model, c, c.kind)
    assert {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
            for k, v in batch.items()} == want["batch"]
    assert all(v.device.type == "meta" for v in batch.values())


# -------------------------------------------- per-device bytes, specs ---

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cell", CELLS)
def test_step_bytes_and_fallbacks_equal_the_reference(reference, arch, cell,
                                                      mesh):
    want = dict(reference["cells"][f"{arch}/{cell}"]["memory"][mesh])
    multi = MESHES[mesh]
    got, rules = dryrun.step_memory(arch, SHAPE_CELLS[cell],
                                       make_production_mesh(multi_pod=multi),
                                       multi)
    # the same fallbacks; JAX visits a dict's keys sorted, the port in the
    # plan's order
    assert sorted(list(x) for x in rules.dropped) == sorted(want.pop(
        "dropped"))
    assert got == want


# ------------------------------------------------ the compiled anchors ---

@pytest.mark.parametrize("kind", list(ANCHORS))
def test_anchor_bytes_equal_the_compiled_reference(reference, kind):
    want = reference["anchors"][kind]
    assert want["dropped"] == []
    cell = ShapeCell(ANCHORS[kind], ANCHOR_S, ANCHOR_B, kind)
    rec = dryrun.cell_record("qwen2-7b", cell, make_host_mesh(2, 2))
    mem, hlo = rec["memory"], rec["hlo"]
    assert rec["status"] == "ok" and rec["chips"] == 4
    assert rec["sharding_fallbacks"] == []
    assert mem["argument_bytes"] == want["argument_bytes"]
    assert mem["output_bytes"] == want["output_bytes"]
    assert mem["alias_bytes"] == want["alias_bytes"]
    # device 0's program: its FLOPs against the reference's HLO count
    ratio = hlo["flops"] / want["flops"]
    useful = rec["roofline"]["useful_flops_ratio"]
    if kind != "decode":
        assert abs(ratio - 1) <= ANCHOR_FLOPS_REL, ratio
    else:
        # the reference's count is 2.4x its model FLOPs here: XLA's CPU
        # program converts each bf16 operand of a dot to f32 (module
        # docstring, 4); the port's is held to the model FLOPs
        assert ANCHOR_DECODE_FLOPS[0] <= 1 / useful \
            <= ANCHOR_DECODE_FLOPS[1], useful
    # the collectives: each one's wire bytes at the reference's ring
    # factors; the reference's floating collectives are f32, the port's
    # the parameters' bf16, so its bytes are compared at f32's width too
    floats = {t for ts in want["collective_types"].values() for t in ts
              if t[0] in "bf"}
    assert floats == {"f32"}, want["collective_types"]
    width = 4 / getattr(torch, configs.get("qwen2-7b").model.dtype).itemsize
    gathered = hlo["per_collective"]["all-gather"]
    ratios = {"total": hlo["collective_bytes"] / want["collective_bytes"],
              "all-gather": gathered / want["per_collective"]["all-gather"]}
    for name, r in ratios.items():
        assert 1 / ANCHOR_COLL_FACTOR <= r * width <= ANCHOR_COLL_FACTOR, \
            (name, r)
    assert rec["roofline"]["collective_s"] == (hlo["collective_bytes"]
                                               / LINK_BW)
    assert rec["roofline"]["collective_s"] > 0
    print(f"{kind}: device 0's program / the reference's HLO: FLOPs "
          f"{ratio:.4f} ({hlo['flops'] / want['flops_without_converts']:.4f}"
          f" of its count without its converts, "
          f"{want['flops'] - want['flops_without_converts']:.4g} FLOPs; "
          f"model FLOPs / the port's {useful:.4f}), bytes "
          f"{hlo['bytes'] / want['bytes']:.4f}, collective bytes "
          f"{ratios['total']:.4f} ({ratios['total'] * width:.4f} at f32), "
          f"all-gather bytes {ratios['all-gather']:.4f} "
          f"({ratios['all-gather'] * width:.4f} at f32), temp "
          f"{mem['temp_bytes'] / want['temp_bytes']:.4f}; counts "
          f"{hlo['collective_count']} against {want['collective_count']}")
    assert rec["compile_s"] is None and rec["xla_cost_analysis"] is None


def test_one_card_record_has_its_collectives_exact():
    cell = ShapeCell("decode_32k", ANCHOR_S, ANCHOR_B, "decode")
    rec = dryrun.cell_record("qwen2-7b", cell, make_host_mesh(1, 1))
    assert rec["chips"] == 1 and "collectives" not in rec
    assert rec["hlo"]["collective_bytes"] == 0.0
    assert rec["roofline"]["collective_s"] == 0.0
    assert rec["hlo"]["loops"] == [("layers", 28)]
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] == (
        mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
        - mem["alias_bytes"])


# ------------------------------------------------ the op-level walker ---

def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_one_matmul_is_exactly_2mnk():
    st = hlo_stats.analyze(torch.matmul, _meta(8, 16), _meta(16, 32))
    assert st.flops == 2 * 8 * 16 * 32
    assert st.bytes == 4 * (8 * 16 + 16 * 32 + 8 * 32)


def _compile_scan(L):
    import jax.numpy as jnp

    def f(x, w):
        def body(c, wi):
            return jnp.tanh(c @ wi), None
        y, _ = jax.lax.scan(body, x, w)
        return y.sum()
    x = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    w = jax.ShapeDtypeStruct((L, 64, 64), jnp.float32)
    return jax.jit(f).lower(x, w).compile()


def _stacked(c, w):
    for i in range(w.shape[0]):
        c = torch.tanh(c @ w[i])
    return c.sum()


@pytest.mark.parametrize("L", [4, 16])
def test_unrolled_layers_count_as_the_reference_scan(L):
    st = hlo_stats.analyze(_stacked, _meta(64, 64), _meta(L, 64, 64))
    ref = jhlo.analyze(_compile_scan(L).as_text())
    dots = 2 * 64 ** 3
    assert L * dots <= st.flops <= L * dots * 1.2
    assert L * dots <= ref.flops <= L * dots * 1.2
    assert ref.flops / 1.2 <= st.flops <= ref.flops * 1.2
    # bytes: each layer's product reads c and w[i] and writes its result,
    # tanh reads and writes one (64, 64) array; the sum reads the last.
    # The reference's count also charges the loop's carry and its
    # dynamic slices, which eager indexing does not read (printed)
    layer = 4 * 64 * 64 * (3 + 2)
    assert st.bytes == L * layer + 4 * (64 * 64 + 1)
    print(f"L = {L}: bytes {st.bytes:.0f}, the reference's {ref.bytes:.0f}")


def test_backward_and_recompute_are_walked():
    from torch.utils.checkpoint import checkpoint
    L, dots = 4, 2 * 64 ** 3
    w = _meta(L, 64, 64).requires_grad_()

    def step(c, w):
        for i in range(L):
            c = checkpoint(lambda c, i: torch.tanh(c @ w[i]), c, i,
                           use_reentrant=False)
        return torch.autograd.grad(c.sum(), w)

    st = hlo_stats.analyze(step, _meta(64, 64), w)
    # forward L, recompute L, backward 2L - 1 products (no grad of c)
    assert (4 * L - 1) * dots <= st.flops <= (4 * L - 1) * dots * 1.2


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_kept_meta_results_change_no_count(kind, monkeypatch):
    """The walker runs a pure op once for each signature of its arguments
    and keeps its results' shapes (`hlo_stats._key`): the same counts as
    running every op, on a reduced MoE model's step."""
    import dataclasses
    from repro_torch.configs.base import reduced

    bundle = configs.get("qwen3-moe-30b-a3b")
    small = dataclasses.replace(bundle, model=reduced(bundle.model))
    monkeypatch.setattr(dryrun.configs, "get", lambda arch: small)
    cell = ShapeCell(ANCHORS[kind], 64, 8, kind)

    def counts():
        st, _ = dryrun.lower_cell("qwen3-moe-30b-a3b", cell,
                                  make_host_mesh(2, 2), False)
        return st.flops, st.bytes, st.peak_live_bytes

    kept = counts()
    assert counts() == kept                  # from the kept results
    monkeypatch.setattr(hlo_stats, "_key", lambda *a: None)
    assert counts() == kept                  # every op run


def test_peak_of_live_intermediates():
    st = hlo_stats.analyze(lambda x: ((x + 1) * 2).sum(), _meta(1024))
    assert st.peak_live_bytes == 2 * 4 * 1024        # x + 1 and its double


@pytest.mark.parametrize("g", [2, 4])
def test_collective_bytes_carry_the_ring_factors(g):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 1024
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=g)
    try:
        def collectives():
            x = torch.ones(n)
            dist.all_reduce(x)
            dist.all_gather_into_tensor(torch.empty(n * g), x)
            dist.reduce_scatter_tensor(torch.empty(n // g), x)
            dist.all_to_all_single(torch.empty(n), x)
            dist.send(x, 1)

        st = hlo_stats.analyze(collectives)
    finally:
        dist.destroy_process_group()
    full = 4 * n
    want = {"all-reduce": 2 * (g - 1) / g * full,
            "all-gather": (g - 1) * full,
            "reduce-scatter": (g - 1) / g * full,
            "all-to-all": (g - 1) / g * full,
            "collective-permute": full}
    assert st.per_collective == want
    assert st.collective_count == dict.fromkeys(want, 1)
    assert st.collective_bytes == sum(want.values())
    assert st.flops == n                     # the ones() fill, no more
    assert list(st.as_dict()) == list(jhlo.HloStats().as_dict())


@pytest.mark.parametrize("g", [2, 4])
def test_functional_collectives_carry_the_ring_factors(g):
    """The collectives DTensor issues (``_c10d_functional``), their group
    named by a string: the reference's factors; ``wait_tensor`` moves
    nothing."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 1024
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=g)
    try:
        group = dist.group.WORLD

        def collectives(x):
            return [funcol.wait_tensor(y) for y in (
                funcol.all_reduce(x, "sum", group),
                funcol.all_gather_tensor(x, 0, group),
                funcol.reduce_scatter_tensor(x, "sum", 0, group),
                funcol.all_to_all_single(x, None, None, group))]

        st = hlo_stats.analyze(collectives, _meta(n))
    finally:
        dist.destroy_process_group()
    full = 4 * n
    want = {"all-reduce": 2 * (g - 1) / g * full,
            "all-gather": (g - 1) * full,
            "reduce-scatter": (g - 1) / g * full,
            "all-to-all": (g - 1) / g * full}
    assert st.per_collective == want
    assert st.collective_count == dict.fromkeys(want, 1)
    assert st.flops == 0
    # each reads its operand and writes its result
    assert st.bytes == full * (1 + 1) + full * (1 + g) + full * (1 + 1 / g) \
        + full * (1 + 1)


def _dtensor(mesh, placements, shape):
    """A DTensor on ``meta`` of global ``shape``, device 0's block."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    local = compute_local_shape_and_global_offset(shape, mesh, placements)[0]
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def test_column_then_row_parallel_is_one_all_reduce():
    """A column-parallel product then a row-parallel one on a 1×4 mesh, the
    result made whole: device 0 runs each product on its quarter and one
    all-reduce of the output."""
    from torch.distributed.tensor import Replicate, Shard
    M, K, N, g = 8, 32, 64, 4
    R = Replicate()
    with fake_device_mesh({"data": 1, "model": g}) as mesh:
        x = _dtensor(mesh, (R, R), (M, K))
        w1 = _dtensor(mesh, (R, Shard(1)), (K, N))
        w2 = _dtensor(mesh, (R, Shard(0)), (N, K))
        st = hlo_stats.analyze(
            lambda x, a, b: ((x @ a) @ b).redistribute(mesh, (R, R)),
            x, w1, w2)
    assert st.per_collective == {"all-reduce": 4 * M * K * 2 * (g - 1) / g}
    assert st.collective_count == {"all-reduce": 1}
    assert st.flops == 2 * (2 * M * N * K / g)


def test_shard_to_shard_is_one_all_to_all():
    """``Shard(0)`` to ``Shard(1)``: one all-to-all of (g−1)/g of device 0's
    block, as the card does it (a CPU mesh would gather and chunk)."""
    from torch.distributed.tensor import Replicate, Shard
    g = 4
    with fake_device_mesh({"data": 1, "model": g}) as mesh:
        w = _dtensor(mesh, (Replicate(), Shard(0)), (64, 32))
        st = hlo_stats.analyze(
            lambda a: a.redistribute(mesh, (Replicate(), Shard(1))), w)
    block = 4 * 64 * 32 // g
    assert st.per_collective == {"all-to-all": block * (g - 1) / g}
    assert st.collective_count == {"all-to-all": 1}
    assert st.flops == 0


def test_a_dtensor_op_under_the_walker_returns_a_dtensor():
    """The walker hands a DTensor's op back to DTensor and counts the local
    ops at device 0's shapes; the kept results of pure ops (`_SEEN`) never
    stand in for a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = (Replicate(), Shard(0))
    with fake_device_mesh({"data": 1, "model": 4}) as mesh:
        x = _dtensor(mesh, pl, (32, 16))
        for _ in range(2):                   # the second from kept results
            out = []
            st = hlo_stats.analyze(lambda x: out.append(torch.tanh(x + 1)),
                                   x)
            y = out[0]
            assert type(y) is DTensor and tuple(y.placements) == pl
            assert y.shape == (32, 16) and y.to_local().shape == (8, 16)
            assert st.flops == 2 * 8 * 16 and not st.collective_count


def test_a_record_takes_its_fake_group_down():
    """A record on a mesh of more than one card starts its own fake group
    and takes it down, on an exception too; a group already up is never
    reused: the record raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cell = ShapeCell("decode_32k", 16, 4, "decode")
    rec = dryrun.cell_record("smollm-135m", cell, make_host_mesh(2, 2))
    assert rec["status"] == "ok" and rec["hlo"]["collective_bytes"] > 0
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="inside"):
        with fake_device_mesh({"data": 2, "model": 2}):
            raise ValueError("inside")
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with pytest.raises(RuntimeError, match="already up"):
            dryrun.cell_record("smollm-135m", cell, make_host_mesh(2, 2))
    finally:
        dist.destroy_process_group()


def test_a_production_mesh_record_has_its_collectives():
    cell = ShapeCell("decode_32k", ANCHOR_S, ANCHOR_B, "decode")
    rec = dryrun.cell_record("qwen2-7b", cell, make_production_mesh())
    hlo, rf = rec["hlo"], rec["roofline"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert "collectives" not in rec
    assert hlo["collective_bytes"] > 0 and hlo["collective_count"]
    assert rf["collective_s"] == hlo["collective_bytes"] / LINK_BW > 0
    assert rf["dominant"] == max(("compute", "memory", "collective"),
                                 key=lambda k: rf[k + "_s"])


# ---------------------------------------------------------- run_cell ---

def test_run_cell_on_meta_then_from_the_cache(tmp_path, monkeypatch):
    rec = dryrun.run_cell("smollm-135m", "decode_32k", False, tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["hlo"]["loops"] == [("layers", 30)]
    assert rec["roofline"]["dominant"] in ("compute", "memory")
    assert rec["sharding_fallbacks"]             # 9 heads on 16 devices
    saved = tmp_path / "smollm-135m__decode_32k__16x16.json"
    assert json.loads(saved.read_text()) == json.loads(json.dumps(rec))

    def traced(*a, **k):
        raise AssertionError("re-traced a cached cell")

    monkeypatch.setattr(dryrun, "cell_record", traced)
    again = dryrun.run_cell("smollm-135m", "decode_32k", False, tmp_path)
    assert again == json.loads(saved.read_text())
    skipped = dryrun.run_cell("smollm-135m", "long_500k", False, tmp_path)
    assert skipped["status"] == "skipped"


# ------------------------------------------------------------ render ---

def _records():
    recs = []
    for mesh in MESHES:
        recs.append({"arch": "qwen2-7b", "cell": "train_4k", "mesh": mesh,
                     "status": "ok", "compile_s": 12.5,
                     "memory": {"peak_bytes_per_device": 3.5 * 2 ** 30},
                     "roofline": {"dominant": "compute",
                                  "compute_s": 0.1893, "memory_s": 0.0123,
                                  "collective_s": 0.0456,
                                  "useful_flops_ratio": 0.8125}})
        recs.append({"arch": "smollm-135m", "cell": "decode_32k",
                     "mesh": mesh, "status": "ok", "compile_s": 3.0,
                     "memory": {"peak_bytes_per_device": 6.03 * 2 ** 30},
                     "roofline": {"dominant": "memory", "compute_s": 1.7e-6,
                                  "memory_s": 1.3e-3, "collective_s": 0.0,
                                  "useful_flops_ratio": None}})
        recs.append({"arch": "llama3-405b", "cell": "long_500k",
                     "mesh": mesh, "status": "skipped", "reason": "full"})
        recs.append({"arch": "jamba-1.5-large-398b", "cell": "train_4k",
                     "mesh": mesh, "status": "error",
                     "error": "RuntimeError: " + "x" * 80})
    return recs


@pytest.mark.parametrize("markdown", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_render_equals_the_reference(mesh, markdown):
    recs = _records()
    assert roofline.render(recs, mesh, markdown) == jrender(recs, mesh,
                                                            markdown)


def test_render_leaves_a_null_term_empty(tmp_path, capsys, monkeypatch):
    rec = {"arch": "qwen2-7b", "cell": "decode_32k", "mesh": "16x16",
           "status": "ok", "compile_s": None,
           "memory": {"peak_bytes_per_device": 2 ** 31},
           "roofline": {"dominant": "memory", "compute_s": 1e-5,
                        "memory_s": 3e-3, "collective_s": None,
                        "useful_flops_ratio": 0.5}}
    row = roofline.render([rec], "16x16", True).splitlines()[-1]
    assert row == ("| qwen2-7b | decode_32k | memory | 1.000e-05 | "
                   "3.000e-03 |  | 2.00 | 0.500 |  |")
    (tmp_path / "r.json").write_text(json.dumps(rec))
    monkeypatch.setattr(sys, "argv", ["roofline", "--cache", str(tmp_path),
                                      "--markdown"])
    roofline.main()
    out = capsys.readouterr().out
    assert "### mesh 16x16 (cards=256, H100 SXM: 989 TF/s bf16, 3350 GB/s" \
        in out and row in out
