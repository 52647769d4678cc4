"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
700 W power limit): the least time of a piece of work is the larger of
its operations over the operations peak and its bytes over the memory
bandwidth."""

# HBM3 bandwidth
BYTES_PER_S = 3.35e12
# TF32 on the tensor cores: no float32-accurate path (float32 SIMT at 67,
# 3xTF32 at a third of this) runs faster, so a float32 configuration's
# share of it cannot pass 100% whatever a later change implements
FLOAT32_FLOP_PER_S = 495e12


def least_s(flops, nbytes, flop_per_s=FLOAT32_FLOP_PER_S):
    return max(flops / flop_per_s, nbytes / BYTES_PER_S)
