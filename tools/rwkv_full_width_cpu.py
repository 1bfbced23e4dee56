"""rwkv6-3b at full width on the CPU: the JAX reference against the port.

Both packages take the same bucketed Mem-SGD steps (ratio 0.01, bfloat16
compute, one worker) from the same init (the reference's, carried over
with ``repro_torch.convert``) on the same batches, at each eta. Each
package runs in a process of its own, one after the other, so that only
one holds its state. Prints each package's losses and their largest
relative gap per eta; a cast point that differs at d_model 2560 shows as
a gap from the first step on.

    PYTHONPATH=src python tools/rwkv_full_width_cpu.py \
        [--layers 2] [--steps 4] [--batch 4] [--seq 512] [--etas 0.5,0.1]

At the defaults the reference's process peaks near 24 GiB of host
memory and the port's holds less; on 8 cores a step takes ~35 s in the
reference and ~15 s in the port, ~8 minutes in all.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

ARCH = "rwkv6-3b"


def _batches(args):
    from repro_torch.data import take, token_batches

    return list(take(token_batches(65536, args.batch, args.seq, seed=0),
                     args.steps))


def run_ref(args, work):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config
    from repro.core.distributed import SyncConfig
    from repro.launch.train import (TrainConfig, init_train_state,
                                    make_train_step, state_shardings)
    from repro.models import build_model
    from repro.utils.compat import make_mesh

    model = build_model(get_config(ARCH).replace(n_layers=args.layers))
    mesh = make_mesh((1, 1), ("data", "model"))
    batches = _batches(args)
    out = {}
    for eta in args.etas:
        tc = TrainConfig(optimizer="memsgd", eta=eta,
                         sync=SyncConfig(ratio=0.01, bucketed=True))
        params, memory, opt, count = init_train_state(
            model, mesh, tc, rng=jax.random.PRNGKey(0))
        if not os.path.exists(f"{work}/params.pkl"):
            with open(f"{work}/params.pkl", "wb") as f:
                pickle.dump(jax.tree.map(np.asarray, params), f, protocol=5)
        pshard, mshard, _, _ = state_shardings(model, mesh, tc)
        params = jax.device_put(params, pshard)
        memory = jax.device_put(memory, mshard)
        step = make_train_step(model, mesh, tc)
        losses, t0 = [], time.perf_counter()
        for b in batches:
            params, memory, opt, count, met = step(
                params, memory, opt, count,
                {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(met["loss"]))
            print(f"ref eta {eta} step {len(losses) - 1} loss {losses[-1]} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
        out[str(eta)] = losses
        del params, memory
    return out


def run_port(args, work):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core.distributed import SyncConfig
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step)
    from repro_torch.models import build_model

    model = build_model(get_config(ARCH).replace(n_layers=args.layers))
    with open(f"{work}/params.pkl", "rb") as f:
        params_np = pickle.load(f)
    batches = _batches(args)
    out = {}
    for eta in args.etas:
        tc = TrainConfig(optimizer="memsgd", eta=eta,
                         sync=SyncConfig(ratio=0.01, bucketed=True))
        params, memory, opt, count = init_train_state(
            model, tc, device="cpu", params=params_from_jax(params_np))
        step = make_train_step(model, tc)
        losses, t0 = [], time.perf_counter()
        for b in batches:
            params, memory, opt, count, met = step(
                params, memory, opt, count,
                {k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(met["loss"]))
            print(f"port eta {eta} step {len(losses) - 1} loss {losses[-1]} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
        out[str(eta)] = losses
        del params, memory
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--etas", default="0.5,0.1")
    ap.add_argument("--side", choices=("ref", "port"))
    ap.add_argument("--work")
    args = ap.parse_args(argv)
    args.etas = [float(x) for x in args.etas.split(",")]
    if args.side:
        res = (run_ref if args.side == "ref" else run_port)(args, args.work)
        with open(f"{args.work}/{args.side}.json", "w") as f:
            json.dump(res, f)
        return
    print(f"{ARCH}, full width, {args.layers} layers, batch {args.batch} x "
          f"seq {args.seq}, bucketed ratio 0.01, bfloat16, etas {args.etas}")
    with tempfile.TemporaryDirectory() as work:
        for side in ("ref", "port"):
            env = dict(os.environ, JAX_PLATFORMS="cpu")
            subprocess.run([sys.executable, __file__, "--side", side,
                            "--work", work, *(argv or sys.argv[1:])],
                           env=env, check=True)
        res = {side: json.load(open(f"{work}/{side}.json"))
               for side in ("ref", "port")}
    for eta in map(str, args.etas):
        r, p = res["ref"][eta], res["port"][eta]
        gap = max(abs(a - b) / abs(a) for a, b in zip(r, p))
        print(f"eta {eta}: reference {r}\n         port      {p}\n"
              f"         largest relative gap {gap:.3e}")


if __name__ == "__main__":
    main()
