"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the card's full 700 W), frozen here as the
yardstick's own copy."""

PEAK_BF16_FLOPS = 989.4e12      # tensor cores, bf16 and fp16
PEAK_HBM_BYTES_PER_S = 3.35e12  # HBM3
