"""Synthetic datasets and vertical partitioning (numpy copies of
``repro.data.synthetic`` and ``repro.data.vertical``)."""
from repro_torch.data.synthetic import (DATASETS, DatasetSpec, make_dataset,
                                        make_id_universe)
from repro_torch.data.vertical import VerticalPartition, partition_features

__all__ = [
    "DATASETS", "DatasetSpec", "make_dataset", "make_id_universe",
    "VerticalPartition", "partition_features",
]
