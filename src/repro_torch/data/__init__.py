from repro_torch.data.partition import Partition, PartitionAssignment
from repro_torch.data.pipeline import DynamicDataPipeline, StaticAllocationPipeline
from repro_torch.data.synthetic import SyntheticTokenDataset

__all__ = ["Partition", "PartitionAssignment", "DynamicDataPipeline",
           "StaticAllocationPipeline", "SyntheticTokenDataset"]
