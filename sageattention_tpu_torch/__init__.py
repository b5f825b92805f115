"""sageattention_tpu_torch: SageAttention in PyTorch, forward and backward, with
hand-written CUDA kernels for NVIDIA Hopper (H100, sm_90a).

The port of the JAX package ``sageattention_tpu``, which stays the
reference.  Importing this package builds nothing and needs no GPU: the
kernels are compiled with ``nvcc`` on their first use on a CUDA tensor.
"""

from sageattention_tpu_torch import models
from sageattention_tpu_torch.core import (
    sageattn,
    sageattn_qk_int8_pv_bf16,
    sageattn_qk_int8_pv_fp8,
    sageattn_qk_int8_pv_int8,
    sageattn_varlen,
)

__all__ = ["sageattn", "sageattn_qk_int8_pv_bf16", "sageattn_qk_int8_pv_int8",
           "sageattn_qk_int8_pv_fp8", "sageattn_varlen", "models"]
