"""repro_torch — the PyTorch/CUDA port of `repro`, for one NVIDIA H100.

The analysis layers (`core`, `lang`, `runtime.lowering`/`simulator`/
`validate`) are copies of the reference package's jax-free modules under
the same names; the port imports nothing of `repro` and nothing of jax.
Every Pallas kernel on the main path is a hand-written CUDA C++ kernel for
``sm_90a`` (`csrc/`), built with nvcc at first launch (`kernels/cuda_lib`):

    analyze(get(kernel)).classify().fifoize().size().plan()
        .compile(backend="cuda")        # fused ring kernel / addressable
        .validate(backend="cuda")       # trace replay through a real ring

Entry points run on the card unless the caller passes ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version instead.
"""
__version__ = "0.1.0"
