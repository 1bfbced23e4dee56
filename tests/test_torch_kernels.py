"""The port's fused Mem-SGD update against the reference.

On the CPU the port's wrapper runs its plain PyTorch version; the
reference runs its Pallas kernel in interpret mode (as its own tests do)
and its jnp oracle. Same inputs, made with numpy from a seed, go to both.

Tolerances: indices exact; values and memory within 1e-6, the reference's
own allowance for ``m + eta*g`` rounding differently when a compiler
contracts it into one FMA (``tests/test_topk_threshold.py``); with
eta = 0 (u == m) everything is bitwise.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as ref_kernels
import repro.kernels.ops as ref_ops
from repro_torch.kernels import ops
from repro_torch.kernels.fused_memsgd import (
    MAX_COLS,
    SELECTION_LAUNCHES,
    check_inputs,
    fused_memsgd_cuda,
)
from repro_torch.kernels.ref import densify_rows_ref, row_topk_ref
from repro_torch.utils.platform import (
    FUSED_LOOP_CUTOVER,
    FUSED_LOOP_CUTOVER_BF16,
    fused_loop_cutover,
    topk_loop_cutover,
)

SHAPES = [(8, 64), (16, 128), (8, 1024), (24, 100), (3, 33), (1, 257)]
KS = [1, 4, 16]
ETA = 0.37


def _inputs(shape, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":  # many exact magnitude ties
        m, g = np.round(m * 2) / 2, np.round(g * 2) / 2
    elif kind == "zeros":  # rows with fewer than k nonzeros
        m = np.zeros(shape, np.float32)
        m[:, 5], m[:, 90] = 3.0, -1.0
        g = np.zeros(shape, np.float32)
    return m, g


def _port(m, g, eta, k, **kw):
    out = ops.fused_memsgd_update(torch.from_numpy(m), torch.from_numpy(g),
                                  eta, k, **kw)
    return [t.numpy() for t in out]


def _assert_close(got, want):
    (gm, gv, gi), (wm, wv, wi) = got, [np.asarray(x) for x in want]
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gm, wm, rtol=0, atol=1e-6)


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", KS)
def test_fused_update_matches_pallas_kernel(shape, k):
    m, g = _inputs(shape, sum(shape) + k)
    want = ref_kernels.fused_memsgd_update(jnp.asarray(m), jnp.asarray(g),
                                           ETA, k)
    _assert_close(_port(m, g, ETA, k), want)


@pytest.mark.parametrize("shape,k,kind,eta", [
    ((16, 256), 8, "ties", 1.0),
    ((8, 96), 8, "zeros", 0.5),
    ((13, 128), 9, "normal", ETA),  # R % 8 != 0: the reference pads rows
    ((17, 100), 4, "normal", ETA),
])
def test_fused_update_edge_cases(shape, k, kind, eta):
    """Against both the Pallas kernel and the jnp oracle."""
    m, g = _inputs(shape, 7, kind)
    got = _port(m, g, eta, k)
    mj, gj = jnp.asarray(m), jnp.asarray(g)
    _assert_close(got, ref_kernels.fused_memsgd_update(mj, gj, eta, k))
    _assert_close(got, ref_kernels.fused_memsgd_ref(mj, gj, eta, k))


def test_eta_zero_is_bitwise():
    """u == m exactly, so no rounding can differ: bitwise equal to both
    reference functions."""
    m, g = _inputs((13, 200), 5)
    got = _port(m, g, 0.0, 11)
    mj, gj = jnp.asarray(m), jnp.asarray(g)
    _assert_bitwise(got, ref_kernels.fused_memsgd_update(mj, gj, 0.0, 11))
    _assert_bitwise(got, ref_kernels.fused_memsgd_ref(mj, gj, 0.0, 11))


@functools.cache
def _tie_oracle():
    m, g = _inputs((8, 64), 3, "ties")
    return m, g, ref_kernels.fused_memsgd_ref(jnp.asarray(m), jnp.asarray(g),
                                              1.0, 6)


@pytest.mark.parametrize("method", ["auto", "loop", "threshold"])
def test_every_method_gives_the_contract(method):
    m, g, want = _tie_oracle()
    _assert_bitwise(_port(m, g, 1.0, 6, method=method), want)


def test_unknown_method_raises():
    m, g = _inputs((8, 64), 0)
    with pytest.raises(ValueError, match="unknown top-k method"):
        _port(m, g, 0.1, 2, method="bogus")


def test_row_topk_and_densify_match_reference():
    x, _ = _inputs((16, 256), 11, "ties")
    vals, idx = row_topk_ref(torch.from_numpy(x), 12)
    wv, wi = ref_kernels.row_topk_ref(jnp.asarray(x), 12)
    _assert_bitwise([vals.numpy(), idx.numpy()], [wv, wi])
    dense = densify_rows_ref(torch.from_numpy(x), vals, idx)
    want = ref_kernels.densify_rows_ref(jnp.asarray(x), wv, wi)
    _assert_bitwise([dense.numpy()], [want])


def test_cpu_tensors_take_the_plain_version_uncounted():
    m, g = _inputs((8, 64), 1)
    before = fused_memsgd_cuda.launches
    _port(m, g, ETA, 4)
    assert fused_memsgd_cuda.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    m = torch.zeros((4, 32))
    bf = m.to(torch.bfloat16)
    # its float32 and bf16 forms take these (m, g) pairs, and name the rest
    for a, b in ((m, m), (bf, m), (bf, bf)):
        check_inputs(a, b, 2)
    for a, b in ((m.half(), m.half()), (m, bf), (m.double(), m.double()),
                 (bf, m.half())):
        with pytest.raises(TypeError, match=str(b.dtype)):
            check_inputs(a, b, 2)
    with pytest.raises(ValueError, match="one shape"):
        check_inputs(m, torch.zeros((4, 16)), 2)
    with pytest.raises(ValueError, match="k <= C"):
        check_inputs(m, m, 33)
    with pytest.raises(ValueError, match="contiguous"):
        check_inputs(torch.zeros((32, 4)).T, torch.zeros((32, 4)).T, 2)
    with pytest.raises(ValueError, match="columns"):
        wide = torch.zeros((1, 60000))
        check_inputs(wide, wide, 2)
    # a bf16 row is half the bytes: the buffer holds twice the columns
    wide = torch.zeros((1, 60000), dtype=torch.bfloat16)
    check_inputs(wide, wide, 2)
    with pytest.raises(ValueError, match="columns"):
        wide = torch.zeros((1, 120000), dtype=torch.bfloat16)
        check_inputs(wide, wide, 2)
    meta = torch.zeros((4, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_memsgd_cuda(meta, meta, 0.1, 2)


@pytest.mark.parametrize("selection", ["loop", "threshold"])
def test_both_selections_take_the_plain_version_on_the_cpu(selection):
    """On CPU tensors either branch runs ``fused_memsgd_ref``, uncounted,
    bitwise equal to the reference's interpret-mode Pallas kernel of that
    selection."""
    m, g = _inputs((8, 64), 7, "ties")
    before = dict(SELECTION_LAUNCHES)
    got = fused_memsgd_cuda(torch.from_numpy(m), torch.from_numpy(g), 1.0,
                            20, selection)
    assert SELECTION_LAUNCHES == before
    want = ref_kernels.fused_memsgd_update(
        jnp.asarray(m), jnp.asarray(g), 1.0, 20, interpret=True,
        method=selection)
    _assert_bitwise([t.numpy() for t in got], want)


def test_unknown_selection_and_the_threshold_branch_width_raise():
    m = torch.zeros((4, 32))
    with pytest.raises(ValueError, match="unknown fused_memsgd selection"):
        fused_memsgd_cuda(m, m, 0.1, 2, "radix")
    # the threshold branch's histogram lowers its widest row below the
    # loop's: a warp's row buffer, its candidate list (and histogram) and
    # its mbarrier fill a block's 227 KB
    wide = torch.zeros((1, MAX_COLS["threshold"] + 4))
    check_inputs(wide, wide, 2, "loop")
    with pytest.raises(ValueError, match="threshold selection"):
        check_inputs(wide, wide, 2, "threshold")
    assert MAX_COLS == {"loop": 57596, "threshold": 57340}


def test_fused_auto_reads_its_own_cutover():
    """``fused_memsgd_update(method="auto")`` resolves from the fused
    kernel's own cutover (a CUDA device object, nothing allocated), the
    top-k kernels' "auto" from theirs (each from its own sweep on the
    card); on the CPU both follow the reference's table."""
    cuda = torch.device("cuda")
    # the fused sweep on the card: the threshold branch at every k
    assert FUSED_LOOP_CUTOVER == {"cpu": 4, "cuda": 0}
    assert fused_loop_cutover(cuda) == 0
    for k in range(1, 65):
        assert ops._resolve_method("auto", k, cuda, fused_loop_cutover) == \
            "threshold"
        assert ops._resolve_method("auto", k, cuda) == (
            "threshold" if k > 26 else "loop")
        assert ops._resolve_method("auto", k, "cpu", fused_loop_cutover) \
            == ref_ops._resolve_method("auto", k)
        for method in ("loop", "threshold"):
            assert ops._resolve_method(method, k, cuda,
                                       fused_loop_cutover) == method
    assert topk_loop_cutover(cuda) == 26
    with pytest.raises(ValueError, match="no fused cutover"):
        fused_loop_cutover("meta")
    with pytest.raises(ValueError, match="unknown top-k method"):
        ops._resolve_method("radix", 4, cuda, fused_loop_cutover)


def test_fused_auto_reads_the_bf16_form_s_cutover():
    """With bf16 m, "auto" resolves from the bf16 form's own sweep on the
    card: the loop branch up to k = 26; the CPU's entry is the
    reference's, as at float32."""
    cuda = torch.device("cuda")
    bf16 = torch.bfloat16
    assert FUSED_LOOP_CUTOVER_BF16 == {"cpu": 4, "cuda": 26}
    assert fused_loop_cutover(cuda, bf16) == 26
    assert fused_loop_cutover("cpu", bf16) == fused_loop_cutover("cpu")
    cut = functools.partial(fused_loop_cutover, dtype=bf16)
    for k in range(1, 65):
        assert ops._resolve_method("auto", k, cuda, cut) == (
            "threshold" if k > 26 else "loop")
