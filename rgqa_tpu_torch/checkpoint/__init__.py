"""Weight conversion from the JAX package's trees and reference ``.pth`` files."""

from rgqa_tpu_torch.checkpoint.convert import (
    from_jax_params,
    load_reference_pth,
    port_key,
    to_reference_state_dict,
)

__all__ = ["from_jax_params", "load_reference_pth", "port_key", "to_reference_state_dict"]
