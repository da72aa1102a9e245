"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  Every share of peak or of
a roofline is taken against these, with the card's power limit printed
beside it."""

BF16_FLOPS = 989e12          # bf16 tensor-core operations a second
# float32 products on the tensor cores as 3xTF32 (three 495 TFLOP/s TF32
# products each): the rate the port's f32 kernels (B1, B2 at f32, B5) use
F32_3XTF32_FLOPS = 165e12
HBM_BYTES_PER_S = 3.35e12    # HBM3 bandwidth

FLOPS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
         "float32": F32_3XTF32_FLOPS}
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
