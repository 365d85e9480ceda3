"""Synthetic datasets, vertical partitioning and batch pipelines (numpy
copies of ``repro.data.synthetic``, ``repro.data.vertical`` and
``repro.data.pipeline``)."""
from repro_torch.data.pipeline import (batch_iterator, synthesize_tokens,
                                       token_batch_iterator)
from repro_torch.data.synthetic import (DATASETS, DatasetSpec, make_dataset,
                                        make_id_universe)
from repro_torch.data.vertical import VerticalPartition, partition_features

__all__ = [
    "DATASETS", "DatasetSpec", "make_dataset", "make_id_universe",
    "VerticalPartition", "partition_features",
    "batch_iterator", "synthesize_tokens", "token_batch_iterator",
]
