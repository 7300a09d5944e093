"""Graph substrate: CSR storage, synthetic datasets, partitioning, sampling.

Everything in this package is *host-side* (numpy): in DGL — and in LeapGNN,
which builds on it — graph sampling and partition bookkeeping run on CPU,
feeding fixed-shape tensors to the accelerator. We keep that split: this
package never imports jax.
"""
from repro_torch.graph.structs import CSRGraph, GraphDataset
from repro_torch.graph.synthetic import make_dataset, DATASETS
from repro_torch.graph.partition import hash_partition, ldg_partition, range_partition
from repro_torch.graph.sampler import sample_tree_block, layerwise_sample, TreeBlock

__all__ = [
    "CSRGraph", "GraphDataset", "make_dataset", "DATASETS",
    "hash_partition", "ldg_partition", "range_partition",
    "sample_tree_block", "layerwise_sample", "TreeBlock",
]
