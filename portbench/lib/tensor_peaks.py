"""The published dense bf16 tensor-core peak of one NVIDIA H100 SXM (NVIDIA's
data sheet, without sparsity, at the full 700 W power limit; a card set
below it runs slower under load, so a run records the card's power limit
beside its numbers).  `lib.peaks` holds the float32 and memory peaks."""

PEAK_FLOPS_BF16 = 989e12           # FLOP/s, bf16 products on the tensor cores
