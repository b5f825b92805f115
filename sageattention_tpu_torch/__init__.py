"""sageattention_tpu_torch: SageAttention in PyTorch, forward and backward, with
hand-written CUDA kernels for NVIDIA Hopper (H100, sm_90a).

The port of the JAX package ``sageattention_tpu``, which stays the
reference, with its top-level names.  Importing this package builds nothing and needs no GPU: the
kernels are compiled with ``nvcc`` on their first use on a CUDA tensor.
"""

from sageattention_tpu_torch import models, quant
from sageattention_tpu_torch.core import (
    sageattn,
    sageattn_qk_int8_pv_bf16,
    sageattn_qk_int8_pv_fp8,
    sageattn_qk_int8_pv_int8,
    sageattn_varlen,
)
from sageattention_tpu_torch.kvcache import (
    PagedKVCache,
    QuantKVCache,
    append_kv,
    calibrate,
    init_kv_cache,
    init_paged_kv_cache,
    paged_append,
    paged_prefill,
    sageattn_decode,
    sageattn_paged_decode,
)
from sageattention_tpu_torch.ops import reference
from sageattention_tpu_torch.speculative import speculative_verify

__version__ = "0.1.0"

__all__ = [
    "sageattn",
    "sageattn_varlen",
    "sageattn_qk_int8_pv_bf16",
    "sageattn_qk_int8_pv_int8",
    "sageattn_qk_int8_pv_fp8",
    "quant",
    "reference",
    "QuantKVCache",
    "PagedKVCache",
    "init_kv_cache",
    "init_paged_kv_cache",
    "append_kv",
    "paged_append",
    "paged_prefill",
    "calibrate",
    "sageattn_decode",
    "sageattn_paged_decode",
    "speculative_verify",
    "models",
    "__version__",
]
