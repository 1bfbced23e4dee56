"""Inputs at the edges of the port's top-k kernels' design
(``src/repro_torch/kernels/csrc/topk_select.cu``), made with numpy from a
seed: shared by the card-only tests (``test_torch_cuda.py``) and the CPU
tests against the reference (``test_torch_topk.py``)."""
import numpy as np


def edge_rows(kind, seed=11):
    """(x, k) for the edges of the top-k kernels' design: the candidate
    list's bound (k <= 32), its overflow, the all-zero fast path, the
    radix digits, the persistent grid's row walk and the rows' copies."""
    rng = np.random.default_rng(seed)
    signs = lambda shape: np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    if kind in ("k=32", "k=33"):
        return rng.standard_normal((8, 2560)), int(kind[2:])
    if kind == "2000 equal magnitudes":
        x = rng.standard_normal((4, 2560)) * 0.1
        for r in range(4):
            cols = rng.choice(2560, 2000, replace=False)
            x[r, cols] = 3.0 * signs(2000)
        return x, 26
    if kind == "lane-stratified (list overflows)":
        # lane l of a warp reads columns j with (j // 4) % 32 == l: every
        # entry of lane l above every entry of lane l + 1
        lane = (np.arange(2560) // 4) % 32
        x = (32 - lane) * 10.0 + rng.random((4, 2560))
        return x * signs(x.shape), 26
    if kind == "every lane's maximum equal":
        x = rng.standard_normal((4, 2560)) * 0.1
        x[:, 4 * np.arange(32)] = 5.0 * signs((4, 32))
        return x, 26
    if kind == "C < 32":
        return rng.standard_normal((7, 20)), 5
    if kind == "C = k < 32":
        return rng.standard_normal((4, 3)), 3
    if kind == "R below the grid":
        return rng.standard_normal((5, 2560)), 26
    if kind == "R past the grid, not a multiple of the block":
        return rng.standard_normal((7925, 1024)), 10
    if kind == "subnormal only":
        bits = rng.integers(1, 2**23, (6, 2560), dtype=np.uint32)
        bits |= (rng.random((6, 2560)) < 0.5).astype(np.uint32) << 31
        return bits.view(np.float32), 26
    if kind == "+-inf":
        x = rng.standard_normal((6, 2560))
        x[0, [5, 900, 2559]] = [np.inf, -np.inf, np.inf]
        x[1, rng.choice(2560, 40, replace=False)] = np.inf * signs(40)
        return x, 26
    if kind == "embed mix of zero and random rows":
        x = np.zeros((1000, 2560))
        x[:, ::7] = -0.0
        live = rng.choice(1000, 13, replace=False)
        x[live] = rng.standard_normal((13, 2560)) * 0.01
        return x, 26
    if kind == "one exponent":
        return (1.0 + rng.random((8, 2560))) * signs((8, 2560)), 64
    if kind == "C % 4 != 0":
        return rng.standard_normal((6, 1023)), 26
    if kind == "wider than shared memory":
        return rng.standard_normal((3, 60000)), 26
    raise ValueError(kind)


EDGE_KINDS = ["k=32", "k=33", "2000 equal magnitudes",
              "lane-stratified (list overflows)",
              "every lane's maximum equal", "C < 32", "C = k < 32",
              "R below the grid",
              "R past the grid, not a multiple of the block",
              "subnormal only", "+-inf", "embed mix of zero and random rows",
              "one exponent", "C % 4 != 0", "wider than shared memory"]
