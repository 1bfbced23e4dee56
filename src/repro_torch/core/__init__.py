"""Core of the port: the paper's contribution (Mem-SGD) as composable
PyTorch modules, the bucketed engine and the sync.

* ``repro_torch.core.compression`` — k-contraction operators (Def. 2.1/2.2).
* ``repro_torch.core.memory``      — error-feedback memory primitive.
* ``repro_torch.core.memsgd``      — Algorithm 1 as a GradientTransformation.
* ``repro_torch.core.buckets``     — flat-buffer engine (tree -> buckets).
* ``repro_torch.core.distributed`` — PARALLEL-MEM-SGD sync.
* ``repro_torch.core.theory``      — Theorem 2.4 stepsizes / averaging / bounds.
* ``repro_torch.core.encoding``    — packed sparse wire codec (and its QSGD
  quantized tier).
"""
from repro_torch.core.compression import (
    Compressor,
    top_k,
    rand_k,
    blockwise_top_k,
    random_coordinate,
    identity,
    make_compressor,
)
from repro_torch.core.memory import init_memory, memory_step, tree_memory_step
from repro_torch.core.memsgd import (
    memsgd,
    memsgd_bucketed,
    memsgd_flat,
    MemSGDState,
    leaf_compressor_from_ratio,
    constant_eta,
)
from repro_torch.core.buckets import (
    BucketPlan,
    accumulate_local,
    bucket_memory_step,
    init_bucket_memory,
    init_local_accum,
    make_plan,
    pack,
    unpack,
)
from repro_torch.core.distributed import (
    PodConfig,
    SyncConfig,
    TransportConfig,
    WireConfig,
    amortized_bytes_per_step,
    bucketed_message_bytes,
    bucketed_sync_gradients,
    message_bytes,
    sparse_sync_gradients,
)
from repro_torch.core.encoding import (
    WireSpec,
    decode as wire_decode,
    decode_quant as wire_decode_quant,
    dequantize_rows,
    encode as wire_encode,
)

__all__ = [
    "Compressor",
    "top_k",
    "rand_k",
    "blockwise_top_k",
    "random_coordinate",
    "identity",
    "make_compressor",
    "init_memory",
    "memory_step",
    "tree_memory_step",
    "memsgd",
    "memsgd_bucketed",
    "memsgd_flat",
    "MemSGDState",
    "leaf_compressor_from_ratio",
    "constant_eta",
    "BucketPlan",
    "accumulate_local",
    "bucket_memory_step",
    "init_bucket_memory",
    "init_local_accum",
    "make_plan",
    "pack",
    "unpack",
    "PodConfig",
    "SyncConfig",
    "TransportConfig",
    "WireConfig",
    "amortized_bytes_per_step",
    "bucketed_message_bytes",
    "bucketed_sync_gradients",
    "message_bytes",
    "sparse_sync_gradients",
    "WireSpec",
    "dequantize_rows",
    "wire_decode",
    "wire_decode_quant",
    "wire_encode",
]
