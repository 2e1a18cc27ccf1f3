"""Data layer of the port: numpy-only copies of the JAX package's feed.

``rgqa_tpu.data`` cannot be imported where jax is absent (its
``__init__`` pulls in jax and flax), so the port carries its own copies
of the tokenizer, the feature pack reader and packer, the synthetic data generator
and the dataset encoder, plus a CUDA-side prefetching feed.
"""

from rgqa_tpu_torch.data.batching import batch_indices, batch_iterator, device_prefetch, to_device
from rgqa_tpu_torch.data.dataset import EncodedGQA, GQADataset, build_targets
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.data.tokenizer import WordPieceTokenizer, load_vocab
from rgqa_tpu_torch.data.tsv import PackedFeatures

__all__ = [
    "batch_indices",
    "batch_iterator",
    "build_targets",
    "device_prefetch",
    "to_device",
    "EncodedGQA",
    "GQADataset",
    "SyntheticSpec",
    "make_synthetic_gqa",
    "WordPieceTokenizer",
    "load_vocab",
    "PackedFeatures",
]
