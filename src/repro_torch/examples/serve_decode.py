"""Batched serving: prefill a batch of prompts, then decode with the KV
cache (greedy).

The port of the repository's ``examples/serve_decode.py``:

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        [--arch smollm-135m] [--new-tokens 16] [--device cuda|cpu]

The model runs at its reduced config on the card unless ``--device cpu``.
``--selftimed`` skips the model entirely and replays the decode loop as a
cyclic PPN on the self-timed engine (`repro_torch.runtime.selftimed`): the
KV feedback channel ``decode(s,t) -> decode(s,t+1)`` is executed as a
bounded queue, the report shows the loop's real frontier occupancy, and
``--shrink-feedback`` demonstrates the structural deadlock a too-small
state buffer produces.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def selftimed(slots: int, steps: int, shrink_feedback: int) -> int:
    """Replay the decode loop self-timed; returns a process exit code."""
    from ..core.analysis import analyze
    from ..runtime.selftimed import execute_ppn
    from ..runtime.selftimed.validate import executable_capacities
    from ..serve.batching import decode_loop_ppn

    ppn = decode_loop_ppn(slots, steps)
    a = analyze(ppn).classify().size(pow2=True)
    caps = executable_capacities(a)
    fb = "decode->decode.state[0]"
    if shrink_feedback:
        caps[fb] = max(0, caps[fb] - shrink_feedback)
        print(f"shrinking feedback channel {fb} to {caps[fb]} slots")
    rep = execute_ppn(ppn, caps, policy="concurrent",
                      record_timeline=True, on_deadlock="report")
    print(rep.render())
    return 0 if rep.completed else 1


def main(arch: str, new_tokens: int, device: str = "cuda") -> None:
    import torch

    from .. import configs
    from ..configs.base import reduced
    from ..models import Rules, build
    from ..models.common import resolve_device

    dev = resolve_device(device)
    bundle = configs.get(arch)
    cfg = reduced(bundle.model)
    par = bundle.parallel_for("decode_32k", False)
    model = build(cfg, par)
    rules = Rules.make({"data": 1, "model": 1}, par)

    params = model.init(0, dev)
    B, S_prompt, S_max = 4, 24, 64
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S_prompt)).astype(np.int32)).to(dev)

    with torch.no_grad():
        cache = model.init_cache(B, S_max, dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill_fn(params, {"tokens": prompts}, rules,
                                         cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        print(f"prefill {B}×{S_prompt} tokens in "
              f"{time.perf_counter()-t0:.2f}s")

        generated = [next_tok]
        t0 = time.perf_counter()
        for t in range(new_tokens):
            logits, cache = model.decode_fn(
                params, {"tokens": next_tok, "pos": S_prompt + t}, cache,
                rules)
            next_tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
            generated.append(next_tok)
        out = torch.cat(generated, dim=1).cpu()
        dt = time.perf_counter() - t0
    print(f"decoded {new_tokens} tokens × {B} seqs in {dt:.2f}s "
          f"({B*new_tokens/dt:.1f} tok/s on {dev})")
    print("sample token ids:", out[0].numpy()[:16])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--selftimed", action="store_true",
                    help="replay the decode loop as a cyclic PPN on the "
                         "self-timed engine (no model)")
    ap.add_argument("--slots", type=int, default=4,
                    help="--selftimed: batch slots")
    ap.add_argument("--shrink-feedback", type=int, default=0, metavar="N",
                    help="--selftimed: shrink the KV feedback channel by N "
                         "slots and watch the deadlock report")
    args = ap.parse_args()
    if args.selftimed:
        sys.exit(selftimed(args.slots, args.new_tokens, args.shrink_feedback))
    main(args.arch, args.new_tokens, args.device)
