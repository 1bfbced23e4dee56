"""Serving on the PyTorch port: batched greedy decoding with each family's
cache, the trainer -> replica delta stream and the fan-out hub; the twin
of ``examples/serve_batched.py``.

  * dense GQA transformer  -> KV cache
  * RWKV6                  -> O(1) state cache (no KV growth)
  * RecurrentGemma hybrid  -> RG-LRU state + windowed KV ring

plus the **delta stream** (``repro_torch.launch.delta_stream``): a
serving replica tracks a live Mem-SGD trainer through packed sparse
parameter deltas instead of dense broadcasts, then serves from the
refreshed weights; and the **fan-out hub** (``repro_torch.launch.fanout``):
one encoded message per step serves a steady float32 replica, a bf16 edge
replica at half the bytes, and a late joiner that resyncs from a
wire-compressed snapshot.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py [--platform cpu]
"""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.distributed import SyncConfig, WireConfig
from repro_torch.data import DeviceBatcher, token_batches
from repro_torch.launch.serve import apply_delta, decode_loop, replica_copy
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.utils.platform import resolve_device
from repro_torch.utils.tree import tree_leaves


def cache_bytes(cache) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(cache)
               if isinstance(x, torch.Tensor))


def max_abs_diff(a, b) -> float:
    return max(float(torch.max(torch.abs(x.float() - y.float())))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def bitwise(a, b) -> bool:
    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def prompts_for(cfg, B, PL, seed, dev) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, PL), generator=gen,
                         dtype=torch.int32).to(dev)


def trainer(arch, dev):
    """A bucketed Mem-SGD trainer that emits its deltas: (model, step,
    state, batches)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    tc = TrainConfig(optimizer="memsgd", eta=0.5, emit_deltas=True,
                     sync=SyncConfig(ratio=0.02, bucketed=True,
                                     wire=WireConfig(wire="packed")))
    state = init_train_state(model, tc, device=dev, seed=0)
    batches = DeviceBatcher(token_batches(cfg.vocab_size, 8, 32, seed=1),
                            dev)
    return model, make_train_step(model, tc), state, iter(batches)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).platform)
    B, prompt_len, gen, max_len = 4, 8, 16, 64
    for arch in ("qwen3-4b", "rwkv6-3b", "recurrentgemma-9b"):
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = model.init(seed=0, device=dev)
        cache = model.init_cache(B, max_len, device=dev)
        print(f"\n=== {arch} ({cfg.family}) ===")
        print(f"cache: {cache_bytes(cache) / 1e6:.2f} MB for max_len="
              f"{max_len} (family="
              f"{'O(1) state' if cfg.family == 'rwkv' else 'KV'})")
        toks = decode_loop(model, params, prompts_for(cfg, B, prompt_len, 1,
                                                      dev),
                           n_tokens=gen, max_len=max_len)
        print(f"generated {toks.shape[1]} tokens x {toks.shape[0]} seqs; "
              f"sample: {toks[0, :8].tolist()}")
        assert int(torch.max(toks)) < cfg.vocab_size
    exact = delta_stream_demo(dev)
    steady, late = fanout_demo(dev)
    print(f"\nbitwise: delta replica {exact}, steady replica {steady}, "
          f"late joiner {late}")
    assert exact and steady and late


def delta_stream_demo(dev, arch: str = "rwkv6-3b", steps: int = 3) -> bool:
    """Train ``steps`` Mem-SGD steps while a serving replica follows them
    through the packed delta stream, then serve from the replica."""
    print(f"\n=== delta stream ({arch}) ===")
    model, step, (params, memory, opt, count), batches = trainer(arch, dev)
    dspec = step.delta_spec
    # the replica boots from the same params (one dense copy, ever); every
    # refresh after that is a sparse delta message. The deep copy keeps it
    # apart from the trainer's in-place steps.
    replica = replica_copy(params)
    for i in range(steps):
        params, memory, opt, count, m, delta = step(params, memory, opt,
                                                    count, next(batches))
        replica = apply_delta(replica, dspec, delta)
        print(f"step {i}: loss {float(m['loss']):.4f}, streamed "
              f"{dspec.nbytes / 1e3:.1f} kB (dense refresh: "
              f"{dspec.dense_nbytes / 1e3:.1f} kB)")
    drift = max_abs_diff(params, replica)
    print(f"replica drift after {steps} refreshes: {drift} (exact: "
          f"{drift == 0.0})")
    toks = decode_loop(model, replica, prompts_for(model.cfg, 4, 8, 2, dev),
                       n_tokens=8, max_len=64)
    print(f"replica serves: {toks[0].tolist()}")
    return bitwise(params, replica)


def fanout_demo(dev, arch: str = "rwkv6-3b", steps: int = 6):
    """One trainer, one hub, three replicas: steady float32 (bitwise), a
    bf16 edge (half the bytes, bounded drift) and a late joiner that fell
    off the replay log (snapshot resync)."""
    from repro_torch.launch.fanout import FanoutHub

    print(f"\n=== fan-out hub ({arch}) ===")
    model, step, (params, memory, opt, count), batches = trainer(arch, dev)
    dspec = step.delta_spec
    # the hub copies the boot params before the first (in-place) step
    hub = FanoutHub(dspec, params, log_bound=3, snapshot_every=2)
    steady = hub.join()  # synced every step: pure replay
    edge = hub.join("bfloat16")  # the lossy half-size tier
    for i in range(steps):
        params, memory, opt, count, m, delta = step(params, memory, opt,
                                                    count, next(batches))
        hub.publish(i, delta)
        hub.sync(steady)
        hub.sync(edge)
    late = hub.join()  # cursor 0 fell off the log: snapshot resync
    hub.sync(late)
    drift = max_abs_diff(params, edge.params)
    exact = bitwise(params, steady.params)
    late_exact = bitwise(params, late.params)
    s = hub.stats()
    print(f"steady replica bitwise: {exact}; late joiner (snapshot resync "
          f"x{late.resyncs}) bitwise: {late_exact}; bf16 edge drift: "
          f"{drift:.2e}")
    for rid, r in s["replicas"].items():
        print(f"  replica {rid} [{r['tier']}]: {r['bytes_rx'] / 1e6:.2f} MB "
              f"rx (dense broadcast would be "
              f"{r['dense_equiv_bytes'] / 1e6:.2f} MB)")
    print(f"fleet total: {s['served_bytes'] / 1e6:.2f} MB served vs "
          f"{s['dense_broadcast_bytes'] / 1e6:.2f} MB dense broadcast "
          f"(x{s['fanout_ratio']:.1f})")
    return exact, late_exact


if __name__ == "__main__":
    main()
