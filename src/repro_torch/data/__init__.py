"""Data of the port: synthetic token streams and their pipeline, and the
paper's logistic-regression datasets."""
from repro_torch.data.pipeline import (
    DeviceBatcher,
    InfiniteStream,
    Prefetcher,
    ShardedBatcher,
    take,
)
from repro_torch.data.synthetic import (
    LogRegData,
    logreg_grad_np,
    logreg_grad_torch,
    logreg_loss_np,
    logreg_loss_torch,
    make_epsilon_like,
    make_rcv1_like,
    token_batches,
)

__all__ = ["token_batches", "LogRegData", "make_epsilon_like",
           "make_rcv1_like", "logreg_loss_np", "logreg_grad_np",
           "logreg_loss_torch", "logreg_grad_torch", "InfiniteStream",
           "DeviceBatcher", "Prefetcher", "ShardedBatcher", "take"]
