"""rgqa_tpu_torch: the PyTorch + CUDA port of ``rgqa_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays as the reference.  It
imports ``torch`` and nothing of ``jax``, ``flax`` or the JAX package:
what it needs of framework-free JAX-package modules (the config, the
metrics, the checkpoint key map, the data feed) it keeps as its own
copies, each held to its original by a test.  The module layout mirrors
``rgqa_tpu``'s, so each module's counterpart has the same path.  Its
entry points run on the card unless the caller asks for the CPU.

Ported so far: LXMERT GQA inference with MSP rejection (slice 1),
LXMERT GQA fine-tuning with RP pseudo-UQ pairs (slice 2) and ViLT-B/32
GQA inference with MSP rejection (slice 3).  Every attention call runs
through hand-written Hopper kernels in ``csrc/``: the forward (short and
long streams), its backward, and the dropout forward and backward.
"""

__version__ = "0.3.0"
