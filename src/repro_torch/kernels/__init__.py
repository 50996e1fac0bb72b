"""Kernels of the port, each with its wrapper, its plain PyTorch version
and its oracle, and the loader that builds the hand-written CUDA sources in
`repro_torch/csrc/` (`cuda_lib`):

* `stencil_fifo` — the hand-written Fig. 3 jacobi-1d (`jacobi_fifo`,
  `jacobi_fifo_op`, `jacobi_naive_op`), its oracle and the device-memory
  traffic model;
* `stencil_bands` — the jacobi-2d and heat-3d oracles of the generated
  ring (`runtime/cuda_codegen.py` holds that kernel);
* `flash_attention` — blocked GQA flash attention (`attention_op`) and the
  chunked oracle;
* `gla_timemix` — the chunkwise RWKV-6/GLA time-mix (`timemix_op`) and the
  sequential oracle.
"""
