"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).

A float32 bound takes the split-TF32 rate: three TF32 products (495 TFLOP/s)
for each float32 one, the fastest rate at which the card computes float32
products (the CUDA cores' FMA rate, 67 TFLOP/s, is slower).
"""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = TF32_FLOPS / 3          # 165 TFLOP/s, split TF32
HBM_BYTES_PER_S = 3.35e12

_BY_TYPE = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}


def peak_flops(dtype_name: str) -> float:
    """The peak rate of products in `dtype_name` ("bfloat16" or
    "float32")."""
    return _BY_TYPE[dtype_name]
