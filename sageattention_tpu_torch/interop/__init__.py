"""The drop-in integration: ``F.scaled_dot_product_attention`` replaced by
the port's ``sageattn``.

    from sageattention_tpu_torch.interop import patch_torch_sdpa

    undo = patch_torch_sdpa()      # every SDPA call now runs sageattn
    ...
    undo()                         # the original SDPA again

The JAX package's tensor bridge (``from_torch``, ``to_torch``,
``sageattn_torch``) and its JAX-side patch have no counterpart: the port
takes torch tensors itself.
"""

from sageattention_tpu_torch.interop.torch_adapter import patch_torch_sdpa

__all__ = ["patch_torch_sdpa"]
