"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W power limit)."""

BF16_FLOPS = 989e12      # bf16 tensor cores, dense
F32_FLOPS = 67e12        # float32 outside the tensor cores (TF32 off)
HBM_BYTES_PER_S = 3.35e12

# The peak of a cell's stated precision.
PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}
