"""Kernels of the port: the PyTorch stencil oracles (`stencil_fifo.ref`,
`stencil_bands.ref`) and the loader that builds the hand-written CUDA
sources in `repro_torch/csrc/` (`cuda_lib`)."""
