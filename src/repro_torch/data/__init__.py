"""Data of the port: synthetic token streams and their pipeline."""
from repro_torch.data.pipeline import (
    DeviceBatcher,
    InfiniteStream,
    ShardedBatcher,
    take,
)
from repro_torch.data.synthetic import token_batches

__all__ = ["token_batches", "InfiniteStream", "DeviceBatcher",
           "ShardedBatcher", "take"]
