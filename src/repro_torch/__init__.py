"""repro_torch — the PyTorch/CUDA port of `repro`, for one NVIDIA H100.

The analysis layers (`core`, `lang`, `comm.planner`, `dse`,
`runtime.lowering`/`simulator`/`validate`) are copies of the reference
package's jax-free modules under the same names (`launch.roofline` prices
design points with the card's constants in `device`); the port imports
nothing of `repro` and nothing of jax.
Every Pallas kernel of the reference is a hand-written CUDA C++ kernel for
``sm_90a`` (`csrc/`), built with nvcc at first launch (`kernels/cuda_lib`):

    analyze(get(kernel)).classify().fifoize().size().plan()
        .compile(backend="cuda")        # fused ring kernel / addressable
        .validate(backend="cuda")       # trace replay through a real ring

    kernels.stencil_fifo.jacobi_fifo_op     # the hand-written Fig. 3 stencil
    kernels.flash_attention.attention_op    # blocked GQA flash attention
    kernels.gla_timemix.timemix_op          # chunkwise RWKV-6/GLA time-mix

    analyze(get(kernel), sizes=symbolic)    # one template, any size
    python -m repro_torch.dse run ...       # design-space exploration, its
                                            # measured cost taken on the card

Entry points run on the card unless the caller passes ``device="cpu"`` or
CPU tensors.  There every kernel wrapper runs its plain PyTorch version
instead, and `attention_op` and `timemix_op` run their oracles unless asked
for the kernel, as the reference's ops do off the TPU.
"""
__version__ = "0.1.0"
