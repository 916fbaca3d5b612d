"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet, dense,
no sparsity), at its full 700 W limit: the rooflines' and the MFU's
denominators."""
BF16_FLOPS_PER_S = 989e12  # tensor cores, bf16 and fp16
HBM_BYTES_PER_S = 3.35e12
