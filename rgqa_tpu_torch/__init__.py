"""rgqa_tpu_torch: the PyTorch + CUDA port of ``rgqa_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays as the reference.  It
imports ``torch`` and never ``jax`` or ``flax``; framework-free modules
of the JAX package (``rgqa_tpu.config``, ``rgqa_tpu.metrics``,
``rgqa_tpu.checkpoint.torch_import``) are reused as they are.  The
module layout mirrors ``rgqa_tpu``'s, so each module's counterpart has
the same path.

Ported so far (slice 1): LXMERT GQA inference with MSP rejection, whose
attention runs through the hand-written Hopper kernel
``csrc/fused_attention.cu``.
"""

__version__ = "0.1.0"
