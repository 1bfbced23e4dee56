#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. Device: a CUDA device must be present; prints its name and power limit.
2. Build every kernel of the main path from ``src/repro_torch/kernels/csrc``
   with nvcc; prints the build seconds and the compiler's register report.
3. Each kernel against its plain PyTorch version on the card, on the main
   path's shape and on edge cases (tie-heavy, zero-heavy, eta = 0, wide
   rows, odd widths, unaligned rows): outputs must match bit for bit.
   Times the kernel, the plain version and one PyTorch library call that
   computes the same function, with CUDA events, beside the bandwidth bound.
4. The main path: ``train()`` of the bucketed Mem-SGD step on qwen3-4b at
   full width, depth cut to 4 layers, from the port's own seeded init.
   Launch counts are zeroed just before and read just after. Then a few
   more steps run under torch.profiler: wall and device-busy time per
   step, and the kernels that take the most device time.
5. A small input: one train step of the qwen3-4b smoke config in float32
   on the card and on the CPU (the plain versions) must agree.

Prints a ``{"kernels": [...]}`` line, then the card's name and power limit,
then the result line ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# main-path configuration: qwen3-4b at full width, depth cut to 4 layers
ARCH, N_LAYERS, BATCH, SEQ, STEPS = "qwen3-4b", 4, 4, 512, 4
RATIO, ETA = 0.01, 0.5
PATH_SHAPE, PATH_K = (1154560, 1024), 10  # its sparse bucket, k = 0.01 * 1024


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    # float32 products in full float32 (PyTorch's default, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build("fused_memsgd")
    print(f"build: fused_memsgd in {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(path, ROOT)}")
    for line in _build.BUILD_LOGS.get("fused_memsgd", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def fused_library(m, g, eta, k):
    """One PyTorch library top-k (torch.topk + gather + scatter) computing
    the fused step; a yardstick only, never called by the port. torch.topk
    promises no tie order, so it is timed, not compared."""
    u = torch.add(m, torch.mul(g, eta))
    _, idx = torch.topk(torch.abs(u), k, dim=1)
    vals = torch.gather(u, 1, idx)
    return u.scatter_(1, idx, 0.0), vals, idx


def kernel_cases(dev):
    """Yields (label, m, g, eta, k) on the card, made from seeds, one at a
    time so that only one case's tensors are alive."""
    gen = torch.Generator(device=dev)

    def randn(shape, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev)

    for (R, C) in [(8, 64), (16, 128), (8, 1024), (24, 100), (3, 33),
                   (1, 257)]:
        for k in (1, 4, 16):
            if k <= C:
                yield (f"({R},{C}) k={k}", randn((R, C), R * C + k),
                       randn((R, C), R + C + k), 0.37, k)
    m = torch.round(randn((16, 256), 1) * 2) / 2
    g = torch.round(randn((16, 256), 2) * 2) / 2
    for k in (1, 8, 32):
        yield (f"tie-heavy halves (16,256) k={k}", m, g, 1.0, k)
    gen.manual_seed(3)
    ints = torch.randint(-3, 4, (32, 512), generator=gen, device=dev)
    yield ("tie-heavy small integers (32,512) k=24", ints.float(),
           torch.zeros((32, 512), device=dev), 1.0, 24)
    z = torch.zeros((8, 96), device=dev)
    z[:, 5], z[:, 90] = 3.0, -1.0
    yield ("zero-heavy (8,96) k=8", z, torch.zeros_like(z), 0.5, 8)
    yield ("eta=0 (13,200) k=11", randn((13, 200), 5), randn((13, 200), 6),
           0.0, 11)
    for k in (10, 64):
        yield (f"C=8192 (64,8192) k={k}", randn((64, 8192), 7),
               randn((64, 8192), 8), 0.37, k)
    yield ("C=20000 (6,20000) k=5", randn((6, 20000), 9),
           randn((6, 20000), 10), 0.37, 5)
    flat_m, flat_g = randn((8 * 1024 + 1,), 11), randn((8 * 1024 + 1,), 12)
    yield ("unaligned rows (8,1024) k=16", flat_m[1:].view(8, 1024),
           flat_g[1:].view(8, 1024), 0.37, 16)
    yield (f"main path {PATH_SHAPE} k={PATH_K}", randn(PATH_SHAPE, 13) * 0.01,
           randn(PATH_SHAPE, 14), ETA, PATH_K)


def phase_kernel(dev) -> dict:
    from repro_torch.kernels.fused_memsgd import fused_memsgd_cuda
    from repro_torch.kernels.ref import fused_memsgd_ref

    worst = 0.0
    bad = []
    for label, m, g, eta, k in kernel_cases(dev):
        got = fused_memsgd_cuda(m, g, eta, k)
        want = fused_memsgd_ref(m, g, eta, k)
        del m, g
        torch.cuda.synchronize()
        ok = all(same_bits(a, b) for a, b in zip(got, want))
        err = max(float((a - b).abs().max()) if a.numel() else 0.0
                  for a, b in zip(got[:2], want[:2]))
        worst = max(worst, err)
        print(f"  fused_memsgd {label}: "
              f"{'bitwise equal' if ok else 'MISMATCH'} (max |err| {err:g})")
        if not ok:
            bad.append(label)
        del got, want
    if bad:
        fail(f"fused_memsgd differs from its plain version on {bad}")

    # times at the main path's shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    m = torch.randn(PATH_SHAPE, generator=gen, device=dev) * 0.01
    gen.manual_seed(14)
    g = torch.randn(PATH_SHAPE, generator=gen, device=dev)
    R, C = PATH_SHAPE
    ms = cuda_ms(lambda: fused_memsgd_cuda(m, g, ETA, PATH_K), iters=10,
                 warmup=2)
    plain_ms = cuda_ms(lambda: fused_memsgd_ref(m, g, ETA, PATH_K), iters=3)
    library_ms = cuda_ms(lambda: fused_library(m, g, ETA, PATH_K), iters=3)
    nbytes = 3 * R * C * 4 + R * PATH_K * 8
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * R * C / F32_FLOPS_PER_S * 1e3
    del m, g
    torch.cuda.empty_cache()
    print(f"  fused_memsgd {PATH_SHAPE} k={PATH_K}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
          f"{max(byte_ms, op_ms):.4f} ms ({nbytes} bytes)")
    return {
        "name": "fused_memsgd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_memsgd.cu",
        "replaces": "src/repro/kernels/fused_memsgd.py:61",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": library_ms, "ok": True,
    }


def phase_train(dev) -> int:
    """The main path through ``train()``; returns the fused kernel's
    launches in that run."""
    from repro_torch.configs import get_config
    from repro_torch.core.buckets import make_plan
    from repro_torch.core.distributed import SyncConfig, bucketed_message_bytes
    from repro_torch.data import DeviceBatcher, token_batches
    from repro_torch.kernels.fused_memsgd import fused_memsgd_cuda
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.models import build_model
    from repro_torch.utils.telemetry import Telemetry
    from repro_torch.utils.tree import tree_leaves

    class StepClock(Telemetry):
        """The driver's telemetry sink, stamping the host clock as each
        step's loss is drained (one step late, so after the step ran)."""

        def __init__(self):
            super().__init__()
            self.times = []

        def step(self, i, loss, **kw):
            rec = super().step(i, loss, **kw)
            self.times.append(time.perf_counter())
            return rec

    cfg = get_config(ARCH).replace(n_layers=N_LAYERS)
    model = build_model(cfg)
    tc = TrainConfig(optimizer="memsgd", eta=ETA,
                     sync=SyncConfig(ratio=RATIO, bucketed=True))
    dense_sync = SyncConfig(strategy="dense", bucketed=True)
    plan = make_plan(model.param_shapes(), cols=tc.sync.bucket_cols,
                     dense_below=tc.sync.dense_below)
    sparse = [s.shape for s in plan.buckets if s.kind == "sparse"]
    print(f"train: {ARCH} {N_LAYERS} layers at full width, "
          f"{model.n_params()} params, buckets "
          f"{[(s.kind, s.shape) for s in plan.buckets]}, k="
          f"{tc.sync.k_for(tc.sync.bucket_cols)}, batch {BATCH} x seq {SEQ}, "
          f"wire {bucketed_message_bytes(tc.sync, plan)} B/step (dense "
          f"{bucketed_message_bytes(dense_sync, plan)} B)")
    if sparse != [PATH_SHAPE]:
        fail(f"sparse buckets {sparse}, expected [{PATH_SHAPE}]")
    params = model.init(seed=0, device=dev)
    before = [p.clone() for p in tree_leaves(params)]
    batches = DeviceBatcher(
        token_batches(cfg.vocab_size, BATCH, SEQ, seed=0), dev)
    tel = StepClock()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_memsgd_cuda.launches = 0
    params, memory, _, count, _ = train(
        model, tc, batches, STEPS, device=dev, params=params, log_every=1,
        telemetry=tel)
    torch.cuda.synchronize()
    launches = fused_memsgd_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    losses = tel.losses
    # a loss is drained once the NEXT step is issued, so each interval
    # between drains inside the loop is one step; the last drain, after
    # the loop, only waits out the final step's tail and is left out
    step_ms = [1e3 * (b - a) for a, b in zip(tel.times, tel.times[1:-1])]
    changed = sum(int((a != b).sum())
                  for a, b in zip(before, tree_leaves(params)))
    print(f"train: losses {losses}; step ms after the first {step_ms} "
          f"(mean {sum(step_ms) / len(step_ms):.2f}); peak memory "
          f"{peak / 2**30:.2f} GiB; fused_memsgd launches {launches}; "
          f"{changed} parameter entries changed")
    lnv = math.log(cfg.vocab_size)
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"expected {STEPS} finite losses, got {losses}")
    if not lnv - 1 <= losses[0] <= lnv + 2:
        fail(f"first loss {losses[0]} outside [ln V - 1, ln V + 2] "
             f"= [{lnv - 1:.3f}, {lnv + 2:.3f}]")
    if launches != STEPS * len(sparse):
        fail(f"fused_memsgd launched {launches} times in {STEPS} steps, "
             f"expected {STEPS * len(sparse)}")
    if count != STEPS or changed == 0:
        fail(f"count {count}, {changed} parameter entries changed")
    profile_steps(model, tc, params, memory, batches, dev)
    return launches


def profile_steps(model, tc, params, memory, batches, dev, n: int = 5) -> None:
    """Where a main-path step's time goes: torch.profiler over ``n``
    steady steps continuing the run above (launches here are not
    counted). Prints the wall time per step, the device's busy time per
    step (kernel time, one stream) and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import take
    from repro_torch.launch.train import make_train_step

    step = make_train_step(model, tc)
    opt, count = (), STEPS
    it = iter(batches)
    params, memory, opt, count, _ = step(params, memory, opt, count, next(it))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in take(it, n):
            params, memory, opt, count, _ = step(params, memory, opt,
                                                 count, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile: {n} steps, wall {wall:.2f} ms/step, device busy "
          f"{busy:.2f} ms/step ({100 * busy / wall:.1f}% of wall, "
          f"idle {100 * (1 - busy / wall):.1f}%)")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms/step "
              f"x{e.count // n:<4d} {e.key[:90]}")


def phase_small(dev) -> None:
    """One float32 step of the smoke config on the card and on the CPU
    (plain versions) from the same params and batch must agree: loss to
    1e-5 relative, the applied update to 1e-3 relative L2 (matrix
    products sum in another order on the card, which can flip a rare
    near-tie in the selection)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.distributed import SyncConfig
    from repro_torch.data import token_batches
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step)
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    model = build_model(cfg)
    tc = TrainConfig(eta=ETA, sync=SyncConfig(ratio=RATIO, bucketed=True))
    batch = next(token_batches(cfg.vocab_size, 4, 64, seed=1))
    host = model.init(seed=0, device="cpu")
    out = {}
    for d in (torch.device("cpu"), dev):
        params, memory, opt, count = init_train_state(
            model, tc, device=d,
            params=tree_map(lambda t: t.to(d, copy=True), host))
        before = [p.clone() for p in tree_leaves(params)]
        step = make_train_step(model, tc)
        params, memory, opt, count, met = step(
            params, memory, opt, count,
            {k: torch.as_tensor(v, device=d) for k, v in batch.items()})
        upd = torch.cat([(a - b).reshape(-1).cpu() for a, b in
                         zip(before, tree_leaves(params))])
        out[d.type] = (float(met["loss"]), upd)
    (l_cpu, u_cpu), (l_gpu, u_gpu) = out["cpu"], out["cuda"]
    rel_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    rel_upd = float((u_gpu - u_cpu).norm() / u_cpu.norm())
    print(f"small input: loss card {l_gpu} vs cpu {l_cpu} (rel {rel_loss:.2e}),"
          f" update rel L2 {rel_upd:.2e}")
    if rel_loss > 1e-5 or rel_upd > 1e-3:
        fail("the card's step disagrees with the CPU's on the small input")


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernel = phase_kernel(dev)
    kernel["launches"] = phase_train(dev)
    phase_small(dev)
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
