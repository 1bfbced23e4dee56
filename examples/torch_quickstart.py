"""Quickstart on the PyTorch port: Mem-SGD (the paper's Algorithm 1) in
30 lines — the twin of ``examples/quickstart.py``.

Compresses each gradient to its top-1% coordinates with error feedback
and still converges — the point of the paper. On the card the top-k runs
the port's CUDA kernel.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--platform cpu]
"""
import argparse

import torch

from repro_torch.core import constant_eta, leaf_compressor_from_ratio, memsgd
from repro_torch.optim import apply_updates
from repro_torch.utils.platform import resolve_device


def loss_fn(p, x, y):
    pred = x @ p["w"] + p["b"]
    return torch.mean((pred - y) ** 2)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).platform)

    # a toy regression task: params {w, b}, data y = x @ w* + b*
    gen = torch.Generator().manual_seed(0)
    w_star = torch.randn((64, 8), generator=gen).to(dev)
    X = torch.randn((512, 64), generator=gen).to(dev)
    Y = X @ w_star + 0.3
    params = {"w": torch.zeros((64, 8), device=dev),
              "b": torch.zeros((8,), device=dev)}

    # Mem-SGD: top-k compression (k = 1% of each tensor) + error feedback.
    tx = memsgd(leaf_compressor_from_ratio(0.01), constant_eta(0.05))
    state = tx.init(params)

    for step in range(600):
        live = {k: v.requires_grad_(True) for k, v in params.items()}
        grads = dict(zip(live, torch.autograd.grad(loss_fn(live, X, Y),
                                                   list(live.values()))))
        updates, state = tx.update(grads, state)
        with torch.no_grad():
            params = apply_updates(params, updates)
        if step % 100 == 0:
            print(f"step {step:4d}  loss {loss_fn(params, X, Y):.5f}")

    with torch.no_grad():
        final = float(loss_fn(params, X, Y))
    print(f"final loss {final:.5f}  (only 1% of coordinates communicated/step)")
    assert final < 0.01
    return final


if __name__ == "__main__":
    main()
