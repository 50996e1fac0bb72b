"""Rank functions the port's tests spawn (`repro_torch.comm.run_ranks`) over
a gloo `DistGroup`.  Importable by name, and free of jax and `repro`, so a
spawned rank starts with torch alone.  Each reads the test's numpy inputs
from an ``.npz`` and writes what its stage computed to ``rank<r>.npz``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm import (DistGroup, PipelineSpec, analyze_pipeline,
                              fifo_shift, pipeline_loss_fn, stage_params)
from repro_torch.optim.compression import compressed_psum_mean

#: the pipeline selections both packages run, by name (the port's names;
#: "cuda:ppermute" is the counterpart of the reference's "pallas:ppermute")
SELECTIONS = ("plans", "reorder-buffer", "cuda:ppermute")


def stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def loss_head(h, tgt):
    return torch.mean((h - tgt) ** 2)


def selection_kwargs(name: str, stages: int, microbatches: int) -> dict:
    if name == "plans":
        _, plans = analyze_pipeline(PipelineSpec(stages=stages,
                                                 microbatches=microbatches))
        return {"plans": plans}
    return {"lowering": name}


def pipeline_grads(group, params_np, xs, tg, **kwargs):
    """The pipeline's loss and its gradients on ``group``'s local block."""
    params = stage_params(params_np, group)
    for p in params.values():
        p.requires_grad_()
    f = pipeline_loss_fn(stage_fn, loss_head, group, **kwargs)
    loss = f(params, xs.to(group.device), tg.to(group.device))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


class AllReduceInBackward(DistGroup):
    """A group whose sum all-reduce also all-reduces in backward
    (``torch.distributed.nn.functional.all_reduce``): the pitfall the
    port's `DistGroup` avoids, kept to show that it multiplies every
    gradient by the number of ranks."""

    def all_reduce(self, x, op="sum"):
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(x, group=self.pg or dist.group.WORLD)


def pipeline_rank(rank: int, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    data = np.load(inputs)
    params_np = {"w": data["w"], "b": data["b"]}
    xs, tg = torch.from_numpy(data["xs"]), torch.from_numpy(data["tg"])
    S, M = data["w"].shape[0], data["xs"].shape[0]
    group = DistGroup()
    out = {}
    for name in SELECTIONS:
        loss, grads = pipeline_grads(group, params_np, xs, tg,
                                     **selection_kwargs(name, S, M))
        out[f"{name}/loss"] = loss.numpy()
        for k, g in grads.items():
            out[f"{name}/grad_{k}"] = g.numpy()
    _, grads = pipeline_grads(AllReduceInBackward(), params_np, xs, tg,
                              lowering="ppermute")
    for k, g in grads.items():
        out[f"all_reduce_in_backward/grad_{k}"] = g.numpy()
    x = torch.full((1, 3), float(rank + 1))
    for k in (1, -1):
        out[f"shift_{k}"] = fifo_shift(x, group, k).numpy()
        out[f"shift_{k}_wrap"] = fifo_shift(x, group, k, wrap=True).numpy()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


def ef_step(w, t, e, group):
    """One step of the reference's error-feedback descent on a distributed
    quadratic (`tests/test_compression.py`)."""
    mean_g, e = compressed_psum_mean(w - t, e, group)
    return w - 0.3 * mean_g, e


def ef_run(w, t, steps: int, group):
    e = torch.zeros_like(w)
    for _ in range(steps):
        w, e = ef_step(w, t, e, group)
    return w, e


def compression_rank(rank: int, inputs: str, reference: str,
                     out_dir: str) -> None:
    """This rank's row of the compressed mean, each error-feedback step
    from the reference's state after the step before, and a whole run."""
    torch.set_num_threads(1)
    data, ref = np.load(inputs), np.load(reference)
    group = DistGroup()
    row = slice(rank, rank + 1)
    g = torch.from_numpy(data["g"][row])
    mean, err = compressed_psum_mean(g, torch.zeros_like(g), group)
    t = torch.from_numpy(data["targets"][row])
    steps = [ef_step(torch.from_numpy(ref["traj_w"][i][row]), t,
                     torch.from_numpy(ref["traj_e"][i][row]), group)
             for i in range(int(data["ef_steps"]))]
    w, _ = ef_run(torch.from_numpy(data["w0"][row]), t,
                  int(data["ef_steps"]), group)
    np.savez(Path(out_dir) / f"rank{rank}.npz", mean=mean.numpy(),
             err=err.numpy(), w=w.numpy(),
             steps_w=np.stack([s[0].numpy() for s in steps], 1),
             steps_e=np.stack([s[1].numpy() for s in steps], 1))


def load_ranks(out_dir, world: int) -> dict:
    """Every rank's arrays, stacked along a new leading stage axis."""
    parts = [np.load(Path(out_dir) / f"rank{r}.npz") for r in range(world)]
    return {k: np.concatenate([p[k] for p in parts]) if parts[0][k].ndim
            else np.stack([p[k] for p in parts]) for k in parts[0].files}


def sleeping_rank(rank: int, seconds: float) -> None:
    import time
    time.sleep(seconds)


# ------------------------------------------------ the sharded model path --

#: the cases of `tests/test_torch_mesh.py`: (arch, shape cell, init seed)
MESH_CASES = {"serve": ("qwen2-7b", "decode_32k", 1),
              "train": ("qwen2-7b", "train_4k", 2),
              "moe": ("qwen3-moe-30b-a3b", "decode_32k", 3),
              "rwkv": ("rwkv6-1.6b", "decode_32k", 4),
              "hybrid": ("jamba-1.5-large-398b", "decode_32k", 5),
              "encdec": ("whisper-medium", "decode_32k", 6)}
#: (B, S) of a case's tokens where not (4, 16); the serve case's prompt of
#: 12 leaves a cache of 16 positions, which the model axis divides
MESH_SHAPES = {"serve": (4, 12), "moe": (4, 32)}
MESH_DECODE_STEPS = 4
MESH_LR = 1e-2
#: `draw_requests` arguments (requests, vocab, max_new, seed) and `serve`'s
#: (slots, max_seq)
MESH_SERVE_REQUESTS = (3, 512, 5, 0)
MESH_SERVE_SLOTS = (4, 32)


def _whole(x):
    from repro_torch.models.sharding import is_dtensor
    return x.full_tensor() if is_dtensor(x) else x


def _flat(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def _case_params(data: dict, case: str) -> dict:
    """A case's parameters from the test's ``.npz`` (flat paths), through
    `params_from_numpy`."""
    from repro_torch.models.common import params_from_numpy
    tree: dict = {}
    prefix = case + "/p"
    for k, v in data.items():
        if k.startswith(prefix):
            keys = [part.strip("'") for part in
                    k[len(prefix) + 1:-1].split("][")]
            node = tree
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = v
    return params_from_numpy(tree, "cpu")


def mesh_model(case: str):
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.models import build
    arch, cell, _ = MESH_CASES[case]
    bundle = configs.get(arch)
    return build(reduced(bundle.model), bundle.parallel_for(cell, False))


def serve_case(model, rules, params, tokens, steps: int):
    """Prefill ``tokens`` (B, n) into a float32 cache of n + ``steps``
    positions, then ``steps`` greedy decode steps: (prefill logits, each
    step's logits, the B x steps tokens fed), as numpy arrays."""
    B, n = tokens.shape
    with torch.no_grad():
        cache = {k: v.float() if v.is_floating_point() else v for k, v in
                 model.init_cache(B, n + steps, "cpu", rules).items()}
        logits, cache = model.prefill_fn(
            params, {"tokens": rules.distribute(tokens, ("batch", "seq"))},
            rules, cache)
        pre = _whole(logits)
        tok = torch.argmax(pre[:, -1], -1).to(torch.int32)[:, None]
        outs, fed = [], []
        for i in range(steps):
            fed.append(tok[:, 0])
            lg, cache = model.decode_fn(
                params, {"tokens": rules.distribute(tok, ("batch", "seq")),
                         "pos": n + i}, cache, rules)
            lg = _whole(lg)
            outs.append(lg.numpy())
            tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
    return pre.numpy(), outs, torch.stack(fed, 1).numpy()


def served_tokens(done) -> np.ndarray:
    """Every finished request's id, count and tokens, in id order."""
    return np.array([t for r in sorted(done, key=lambda r: r.rid)
                     for t in [r.rid, len(r.generated)] + list(r.generated)])


def _blocks(out: dict, name: str, tree) -> None:
    for path, leaf in _flat(tree):
        out[f"{name}/local{path}"] = leaf.to_local().numpy()


def _checkpoints(out: dict, mesh, root: Path, state) -> None:
    """Save ``state`` (on the 2 x 2 mesh) and restore it on 1 x 4 and on one
    device; train runs resumed and replayed against an uninterrupted one."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import Rules
    from repro_torch.train.loop import train
    from repro_torch.train.step import (make_abstract_train_state,
                                        make_train_state_specs)
    from repro_torch.tree import tree_map

    model = mesh_model("train")
    full = {k: _whole(v) for k, v in _flat(state)}
    mgr = CheckpointManager(str(root / "state"))
    mgr.save(1, state, blocking=True)
    like = make_abstract_train_state(model)
    mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    rules14 = Rules.make(mesh14, model.par)
    placements = tree_map(rules14.spec_placements,
                          make_train_state_specs(model, rules14))
    on14, _ = mgr.restore(1, like, "cpu", mesh14, placements)
    one, _ = mgr.restore(1, like, "cpu")
    out["ckpt/restored_1x4"] = max(
        float((_whole(v).double() - full[k].double()).abs().max())
        for k, v in _flat(on14))
    out["ckpt/restored_one"] = max(
        float((v.double() - full[k].double()).abs().max())
        for k, v in _flat(one))

    rules = Rules.make(mesh, model.par)
    kw = dict(seed=0, ckpt_every=2, lr=MESH_LR, device="cpu", log_every=100)
    whole = train(model, rules, steps=3, ckpt_dir=str(root / "a"), **kw)
    first = train(model, rules, steps=2, ckpt_dir=str(root / "b"), **kw)
    rest = train(model, rules, steps=1, ckpt_dir=str(root / "b"), **kw)
    # a fault at step 2 restores the checkpoint of step 2 and replays it
    replay = train(model, rules, steps=3, ckpt_dir=str(root / "c"),
                   fail_at=2, **kw)
    out["ckpt/losses"] = np.array(whole.losses)
    out["ckpt/resumed"] = np.array(first.losses + rest.losses)
    out["ckpt/replayed"] = np.array(replay.losses)


def mesh_rank(rank: int, inputs: str, out_dir: str) -> None:
    """This rank's part of `tests/test_torch_mesh.py`: every case on a
    2 x 2 ``("data", "model")`` DeviceMesh; rank 0 also writes the gathered
    results."""
    import json

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.serve import draw_requests, serve
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import Rules
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import _accumulated_grads, make_train_step

    torch.set_num_threads(1)
    data = dict(np.load(inputs))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {"coord": np.array(mesh.get_coordinate())}

    def tokens(case):
        return torch.from_numpy(data[case + "/tokens"])

    # serve layout
    model = mesh_model("serve")
    rules = Rules.make(mesh, model.par)
    model.param_specs(rules)
    out["serve/dropped"] = np.array(json.dumps(rules.dropped))
    params = model.distribute(_case_params(data, "serve"), rules)
    _blocks(out, "serve", params)
    pre, steps, fed = serve_case(model, rules, params, tokens("serve"),
                                 MESH_DECODE_STEPS)
    out["serve/prefill"], out["serve/tokens"] = pre, fed
    for i, lg in enumerate(steps):
        out[f"serve/decode{i}"] = lg
    done, _ = serve(model, _case_params(data, "serve"),
                    draw_requests(*MESH_SERVE_REQUESTS), *MESH_SERVE_SLOTS,
                    device="cpu", mesh=mesh)
    out["serve_run/tokens"] = served_tokens(done)

    # train layout
    model = mesh_model("train")
    rules = Rules.make(mesh, model.par)
    bundle = make_train_step(model, rules, lr=MESH_LR, warmup=1)
    out["train/dropped"] = np.array(json.dumps(rules.dropped))
    params = model.distribute(_case_params(data, "train"), rules)
    _blocks(out, "train", params)
    opt = adamw_init(params, "float32")
    opt["step"] = rules.distribute(opt["step"], ())
    state = {"params": params, "opt": opt}
    toks = tokens("train")
    batch = {"tokens": rules.distribute_spec(
        toks, bundle.batch_spec({"tokens": toks})["tokens"])}
    with rules.context():
        grads, _ = _accumulated_grads(model, rules, params, batch)
    for path, g in _flat(grads):
        out["train/grad" + path] = _whole(g).numpy()
    _blocks(out, "train_grad", grads)
    new, metrics = bundle.step_fn(state, batch)
    out["train/loss"] = _whole(metrics["loss"]).numpy()
    _blocks(out, "train_after", new["params"])

    # the MoE's loss and aux loss
    model = mesh_model("moe")
    rules = Rules.make(mesh, model.par)
    params = model.distribute(_case_params(data, "moe"), rules)
    with torch.no_grad():
        _, met = model.loss_fn(params, {"tokens": rules.distribute(
            tokens("moe"), ("batch", "seq"))}, rules)
    out["moe/loss"] = _whole(met["loss"]).numpy()
    out["moe/aux"] = _whole(met["aux"]).numpy()

    # the other families' train forward
    for case in ("rwkv", "hybrid", "encdec"):
        model = mesh_model(case)
        rules = Rules.make(mesh, model.par)
        params = model.distribute(_case_params(data, case), rules)
        batch = {"tokens": rules.distribute(tokens(case), ("batch", "seq"))}
        if case + "/frames" in data:
            batch["frames"] = rules.distribute(
                torch.from_numpy(data[case + "/frames"]),
                ("batch", "seq", "embed_act"))
        with torch.no_grad():
            logits = model.forward(params, batch, rules, "train")[0]
        out[case + "/logits"] = _whole(logits).numpy()

    # int8 moments of a parameter whose last dimension (300) is split
    # where no shard holds whole blocks of 256, against the plain tensors
    from repro_torch.optim import adamw_update
    w = torch.from_numpy(data["q/w"])
    names = ("wfsdp", "wtp")
    dw = rules.distribute(w, names)
    states = [({"w": w}, adamw_init({"w": w}, "int8"),
               Rules.make({"data": 1, "model": 1}, model.par)),
              ({"w": dw}, adamw_init({"w": dw}, "int8"), rules)]
    done = []
    for p, opt, r in states:
        with r.context(), torch.no_grad():
            for i in range(2):
                g = r.distribute(torch.from_numpy(data[f"q/g{i}"]), names)
                p, opt, _ = adamw_update(p, {"w": g}, opt, 1e-2,
                                         state_dtype="int8")
        done.append({k: _whole(v) for k, v in _flat({"p": p, "m": opt["m"],
                                                      "v": opt["v"]})})
    out["int8/codes_equal"] = np.array(all(
        torch.equal(done[0][k], done[1][k]) for k in done[0]
        if done[0][k].dtype == torch.int8))
    out["int8/max_err"] = np.array(max(
        float((done[0][k].double() - done[1][k].double()).abs().max())
        for k in done[0] if done[0][k].is_floating_point()))

    # a "wtp2" leaf, numbered model-major
    out["wtp2/local['x']"] = rules.distribute(
        torch.from_numpy(data["wtp2"]), ("wtp2", None)).to_local().numpy()

    _checkpoints(out, mesh, Path(out_dir) / "ckpt", new)

    # refusals
    try:
        rules.constrain(torch.zeros(4, 4), "batch", None)
    except TypeError as e:
        out["neg/constrain"] = np.array(str(e))
    try:
        train_main(["--arch", "smollm-135m", "--distributed", "--device",
                    "cpu", "--ckpt", str(Path(out_dir) / "neg")])
    except ValueError as e:
        out["neg/launch"] = np.array(str(e))
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
