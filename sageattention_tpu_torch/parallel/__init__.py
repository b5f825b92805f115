"""Parallel attention and sharded serving over ``torch.distributed``: the
counterpart of the JAX package's ``parallel`` (the same names).

``make_mesh`` names the ("data", "seq", "heads") dims of a device mesh over
the process group; ``ring``, ``ulysses`` and ``make_parallel_sageattn``
split attention over it, differentiable end to end; ``decode`` shards the
quantized KV cache for serving.  Importing it starts nothing.
"""

from sageattention_tpu_torch.parallel.api import make_parallel_sageattn
from sageattention_tpu_torch.parallel.decode import (
    make_sharded_append,
    make_sharded_decode,
    make_sharded_paged_append,
    make_sharded_paged_decode,
)
from sageattention_tpu_torch.parallel.mesh import make_mesh
from sageattention_tpu_torch.parallel.ring import make_ring_attention, ring_sageattn
from sageattention_tpu_torch.parallel.ulysses import make_ulysses_attention, ulysses_sageattn

__all__ = [
    "make_mesh",
    "ring_sageattn",
    "make_ring_attention",
    "ulysses_sageattn",
    "make_ulysses_attention",
    "make_parallel_sageattn",
    "make_sharded_decode",
    "make_sharded_append",
    "make_sharded_paged_decode",
    "make_sharded_paged_append",
]
