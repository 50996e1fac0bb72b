"""Published peaks of one NVIDIA H100 SXM, the port's target card.

The counterpart of the TPU v5e constants in `repro.launch.mesh`.  Sources:
NVIDIA's H100 data sheet and the Hopper architecture white paper (SXM part,
dense rates without sparsity, at the full 700 W power limit; a card set
below it runs slower under load).  Measured numbers are taken on the card
and recorded with its name and power limit; these are the ceilings a
kernel's roofline bound is computed against.
"""
HBM_BW = 3.35e12                   # B/s, device memory
# B/s, NVLink 4 out of one card in one direction (18 links of 25 GB/s):
# the rate the dry run prices every collective's wire bytes at, on every
# mesh axis ("pod" too, which would cross a slower network), as the
# reference prices each of its axes at one ICI rate
LINK_BW = 450e9
PEAK_FLOPS_FP32 = 67e12            # FLOP/s outside the tensor cores
PEAK_FLOPS_BF16 = 989e12           # FLOP/s, bf16/f16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12           # FLOP/s, TF32 on the tensor cores
# float32 products at float32's accuracy: the faster of the CUDA cores and
# three TF32 passes on the tensor cores (hi*hi + hi*lo + lo*hi)
PEAK_FLOPS_FP32_PRODUCTS = max(PEAK_FLOPS_FP32, PEAK_FLOPS_TF32 / 3)
# B/s, shared memory over the whole card: 132 SMs x 128 B a clock (32 banks
# of 4 B, the white paper's per-SM shared-memory rate) x the 1.98 GHz boost
# clock; where the generated ring keeps its channels
SMEM_BW = 132 * 128 * 1.98e9


def roofline_seconds(bytes_moved: float, flops: float,
                     peak_flops: float = PEAK_FLOPS_FP32):
    """The least time the card could take for work that must move
    ``bytes_moved`` through device memory and do ``flops`` operations at
    ``peak_flops`` (float32 work against `PEAK_FLOPS_FP32`, float32
    products that the tensor cores can take against
    `PEAK_FLOPS_FP32_PRODUCTS`; work on bf16 or f16 inputs against
    `PEAK_FLOPS_BF16`, the rate the card offers for them): the larger of the
    two, and which one bounds it."""
    move, compute = bytes_moved / HBM_BW, flops / peak_flops
    return (move, "bytes") if move >= compute else (compute, "operations")
