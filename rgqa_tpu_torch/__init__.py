"""rgqa_tpu_torch: the PyTorch + CUDA port of ``rgqa_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays as the reference.  It
imports ``torch`` and nothing of ``jax``, ``flax`` or the JAX package:
what it needs of framework-free JAX-package modules (the config, the
metrics, the checkpoint key map, the data feed) it keeps as its own
copies, each held to its original by a test.  The module layout mirrors
``rgqa_tpu``'s, so each module's counterpart has the same path.  Its
entry points run on the card unless the caller asks for the CPU.

Ported so far: LXMERT GQA inference with MSP rejection (slice 1),
LXMERT GQA fine-tuning with RP pseudo-UQ pairs (slice 2), ViLT-B/32 GQA
inference with MSP rejection (slice 3) and fine-tuning (slice 4), the
kernel experiments (slice 5, ``experiments/``), ViLT beyond 256 tokens
(slice 6) and the rejection scorers (slice 10, ``scorers/``: energy,
ODIN, Mahalanobis, MC-dropout, branched, ensembles, a calibrated
threshold); since then every path of the JAX package's GQA runner and
CLIs, and (slice 21) LXMERT pretraining, the VQA task and NLVR2.  Every
attention call
runs through hand-written Hopper kernels in ``csrc/``: the forward (short
and long streams), its backward (both), and the dropout forward and
backward; the experiments run four more (dual, cat, headfold, epilogue).
"""

__version__ = "0.3.0"
