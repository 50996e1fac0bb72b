"""The moe, hybrid and encoder-decoder archs, reduced, in float32 on the
card against the CPU: `family_parity` runs one arch's train forward, a
prefill then a decode, and ``loss_fn``'s gradients on both devices.
`chip_smoke.py` (phase 16) and the card tests (`tests/test_torch_cuda.py`)
hold its errors to their bars.

The reduced models are compared at the reference's init with every
attention's ``wq`` and ``wk`` times `FAMILY_QK_SCALE` (1/4): at the init's
scale the scores (RMS about 16 at the reduced width) amplify a float32
rounding difference about sevenfold an attention, and over whisper's six
attentions and jamba's eight sublayers two correct paths on the CPU read
1.5e-5 and 4.1e-5 of the largest logit apart, with gradients up to 2.6e-4
apart (`tests/test_torch_families.py`).  A decode through an int8 KV cache
may see a code move by one where the card's K or V sits at a rounding tie;
`FAMILY_INT8_DECODE` = 2e-2 of the largest logit is an absolute 0.05 on
logits of about 3.
"""
from __future__ import annotations

#: the tokens of each comparison, (B, S)
FAMILY_SMALL = dict(B=2, S=16)
#: the factor on every attention's wq and wk, and the bar of a decode
#: through an int8 KV cache (see the module docstring)
FAMILY_QK_SCALE = 0.25
FAMILY_INT8_DECODE = 2e-2


def family_parity(arch: str, seed: int, dev) -> dict:
    """One reduced arch in float32 on the card against the CPU (TF32
    off): a train forward, a prefill of S - 1 tokens and the decode of
    token S, and ``loss_fn``'s gradients, every attention's ``wq`` and
    ``wk`` times `FAMILY_QK_SCALE` (see the module docstring).  Returns the
    errors, relative to the largest logit or each leaf's largest gradient
    entry, and kernel 5's launches in the forward and in the backward.
    Raises AssertionError where a leaf gets no gradient on the card."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.serve import MESH
    from repro_torch.models import Rules, build
    from repro_torch.tree import tree_items, tree_map

    bundle = configs.get(arch)
    model = build(reduced(bundle.model),
                  bundle.parallel_for("decode_32k", multi_pod=False))
    rules = Rules.make(MESH, model.par)
    cfg = model.cfg
    host = tree_map(lambda a: a.float(), model.init(seed, "cpu"))
    for path, leaf in tree_items(host):
        if path.endswith("['wq']") or path.endswith("['wk']"):
            leaf.mul_(FAMILY_QK_SCALE)
    rng = np.random.default_rng(seed + 16)
    B, S = FAMILY_SMALL["B"], FAMILY_SMALL["S"]
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))

    def on(device, tree):
        return tree_map(lambda a: a.to(device), tree)

    def rel(got, want) -> float:
        got, want = got.detach().cpu().float(), want.detach().cpu().float()
        return float((got - want).abs().max()
                     / max(float(want.abs().max()), 1e-30))

    def fwd(device):
        """The train logits, the decode logits after the prefill, and kernel
        5's launches in the train forward."""
        with torch.no_grad():
            p, bt = on(device, host), on(device, batch)
            cuda_lib.FLASH_ATTENTION.launches = 0
            train = model.forward(p, bt, rules, "train")[0]
            if device != "cpu":
                torch.cuda.synchronize()
            launched = cuda_lib.FLASH_ATTENTION.launches
            pre = dict(bt, tokens=bt["tokens"][:, :S - 1])
            dec = {"tokens": bt["tokens"][:, S - 1:], "pos": S - 1}
            if "frames" in bt:
                dec["frames"] = bt["frames"][:, :1]
            cache = {k: v.float() if v.is_floating_point() else v
                     for k, v in model.init_cache(B, S, device).items()}
            _, cache = model.prefill_fn(p, pre, rules, cache)
            return train, model.decode_fn(p, dec, cache, rules)[0], launched

    def grads(device):
        p = tree_map(lambda a: a.detach().to(device, copy=True)
                     .requires_grad_(a.is_floating_point()), host)
        total, _ = model.loss_fn(p, on(device, batch), rules)
        total.backward()
        return total, dict(tree_items(p))

    want_train, want_dec, _ = fwd("cpu")
    got_train, got_dec, launched_fwd = fwd(dev)
    want_total, want_g = grads("cpu")
    cuda_lib.FLASH_ATTENTION.launches = 0
    got_total, got_g = grads(dev)
    torch.cuda.synchronize()
    missing = [k for k, p in got_g.items() if p.grad is None]
    if missing:
        raise AssertionError(f"{arch}: no gradient on the card for "
                             f"{missing}")
    g_errs = {k: rel(got_g[k].grad, want_g[k].grad) for k in want_g}
    worst = max(g_errs, key=g_errs.get)
    return {"train": rel(got_train, want_train),
            "decode": rel(got_dec, want_dec),
            "loss": rel(got_total, want_total),
            "grad": g_errs[worst], "grad_leaf": worst, "leaves": len(got_g),
            "launches_forward": launched_fwd,
            "launches_backward": cuda_lib.FLASH_ATTENTION.launches}
