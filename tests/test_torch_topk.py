"""The port's per-row top-k (``repro_torch.kernels.ops.row_topk``) against
the reference's ``repro.kernels.ops.row_topk``.

On the CPU every port method runs the plain version (the iterative
argmax); the reference runs its Pallas kernels in interpret mode, as its
own tests do. Same inputs, made with numpy from a seed, go to both. The
contract (decreasing |x|, ties to the lowest index, values keep their
sign) fixes the output uniquely, so values and indices must agree bit for
bit, in float32 and in bf16.
"""
import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _topk_edges import EDGE_KINDS, edge_rows
from repro.kernels import ops as ref_ops
from repro.utils.platform import topk_loop_cutover as ref_topk_loop_cutover
from repro_torch.kernels import _build, ops
from repro_torch.kernels.topk_select import (
    LAUNCHES,
    check_inputs,
    row_topk_loop_cuda,
    row_topk_threshold_cuda,
)
from repro_torch.utils.platform import topk_loop_cutover


def _x(shape, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":  # many exact magnitude ties, both signs
        x = np.round(x * 2) / 2
    elif kind == "zeros":  # fewer nonzeros than k; signed zeros elsewhere
        x = np.zeros(shape, np.float32)
        x[:, ::3] = -0.0
        x[:, 5], x[:, 40] = 3.0, -1.0
    return x


def _port(x, k, dtype=torch.float32, **kw):
    vals, idx = ops.row_topk(torch.from_numpy(x).to(dtype), k, **kw)
    if dtype == torch.bfloat16:
        return vals.view(torch.int16).numpy(), idx.numpy()
    return vals.numpy(), idx.numpy()


def _ref(x, k, dtype=jnp.float32, **kw):
    vals, idx = ref_ops.row_topk(jnp.asarray(x).astype(dtype), k,
                                 interpret=True, **kw)
    vals = np.asarray(vals)
    if dtype == jnp.bfloat16:
        vals = vals.view(np.int16)
    return vals, np.asarray(idx)


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# the shape on which each port method meets the reference's same method;
# elsewhere every port method meets the reference's loop, computed once
# per (shape, k): the contract fixes the output, so all methods give it
METHOD_SHAPE = (8, 300)


@functools.cache
def _ref_once(shape, k, method):
    return _ref(_x(shape, seed=shape[0] * shape[1] + k), k, method=method)


@pytest.mark.parametrize("method", ["loop", "threshold", "auto"])
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("shape", [(16, 128), (5, 77), METHOD_SHAPE])
def test_row_topk_matches_reference(shape, k, method):
    x = _x(shape, seed=shape[0] * shape[1] + k)
    ref_method = method if shape == METHOD_SHAPE else "loop"
    _assert_bitwise(_port(x, k, method=method),
                    _ref_once(shape, k, ref_method))


@pytest.mark.parametrize("method", ["loop", "threshold"])
@pytest.mark.parametrize("shape,k,kind", [((16, 256), 12, "ties"),
                                          ((9, 96), 8, "zeros")])
def test_tie_and_zero_heavy_rows_match_reference(shape, k, kind, method):
    x = _x(shape, seed=7, kind=kind)
    got, want = _port(x, k, method=method), _ref(x, k, method=method)
    # the contract's own oracle, bit for bit (selected -0.0 stays -0.0)
    oracle = ref_ops.row_topk_ref(jnp.asarray(x), k)
    _assert_bitwise(got, [np.asarray(a) for a in oracle])
    if kind == "zeros" and method == "threshold":
        # the reference's threshold kernel orders the pairs with a one-hot
        # einsum, which turns a selected -0.0 into +0.0 (a fault of the
        # reference: its oracle keeps the sign), so here the values are
        # compared as numbers and the indices exactly
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        zero = got[0] == 0
        assert np.signbit(got[0][zero]).any()
        assert not np.signbit(want[0][zero]).any()
    else:
        _assert_bitwise(got, want)


def _exact_topk(x, k):
    """The contract computed with numpy on the magnitudes' bit patterns
    (exact for every float32, subnormals and infinities included)."""
    bits = (x.view(np.uint32) & 0x7FFFFFFF).astype(np.int64)
    cols = np.broadcast_to(np.arange(x.shape[1]), x.shape)
    idx = np.lexsort((cols, -bits), axis=-1)[:, :k]
    return np.take_along_axis(x, idx, axis=1), idx.astype(np.int32)


def _edge_port(kind, method):
    x, k = edge_rows(kind)
    x = np.ascontiguousarray(x, np.float32)
    wrapper = {"loop": row_topk_loop_cuda,
               "threshold": row_topk_threshold_cuda}[method]
    return x, k, [t.numpy() for t in wrapper(torch.from_numpy(x), k)]


@pytest.mark.parametrize("method", ["loop", "threshold"])
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_design_edges_are_exact(kind, method):
    """The inputs at the edges of the CUDA kernels' design (the card-only
    tests feed the same ones to the kernels) through the port's wrapper on
    the CPU, bit for bit against the contract computed on bit patterns."""
    x, k, got = _edge_port(kind, method)
    _assert_bitwise(got, _exact_topk(x, k))


@functools.cache
def _edge_oracle(kind):
    x, k = edge_rows(kind)
    x = np.ascontiguousarray(x, np.float32)
    return [np.asarray(a) for a in ref_ops.row_topk_ref(jnp.asarray(x), k)]


def _edge_ref(kind, method):
    x, k = edge_rows(kind)
    return _edge_oracle(kind), _ref(np.ascontiguousarray(x, np.float32), k,
                                    method=method)


# XLA's CPU arithmetic flushes subnormals to zero, so on the CPU the
# reference sees a subnormal-only row as all zero; that edge is held to
# the exact contract above only
REF_EDGE_KINDS = [kind for kind in EDGE_KINDS if kind != "subnormal only"]


@pytest.mark.parametrize("method", ["loop", "threshold"])
@pytest.mark.parametrize("kind", REF_EDGE_KINDS)
def test_design_edges_match_reference(kind, method):
    """The same edges against the reference's oracle and its Pallas kernel
    of the same selection (interpret mode)."""
    _, _, got = _edge_port(kind, method)
    oracle, want = _edge_ref(kind, method)
    _assert_bitwise(got, oracle)
    if method == "threshold":
        # the reference's threshold kernel orders the pairs with a one-hot
        # einsum, which turns a selected -0.0 into +0.0 and a selected
        # +-inf into NaN (faults of the reference, ROADMAP Queue 3): the
        # indices exactly, the values where the reference keeps them
        np.testing.assert_array_equal(got[1], want[1])
        kept = np.isfinite(want[0]) & (want[0] != 0)
        np.testing.assert_array_equal(got[0][kept].view(np.uint32),
                                      want[0][kept].view(np.uint32))
    else:
        _assert_bitwise(got, want)


@pytest.mark.parametrize("col_block", [16, 64, 100, 512])
def test_col_block_does_not_change_the_result(col_block):
    """The port has no column tile: its threshold select equals the
    reference's tiled select whatever tile the reference takes."""
    x = _x((8, 300), seed=3, kind="ties")
    _assert_bitwise(
        _port(x, 16, method="threshold"),
        _ref(x, 16, method="threshold", col_block=col_block))


@pytest.mark.parametrize("method", ["loop", "threshold"])
def test_bf16_plain_path_matches_reference(method):
    x = _x((12, 128), seed=5)
    _assert_bitwise(_port(x, 8, dtype=torch.bfloat16, method=method),
                    _ref(x, 8, dtype=jnp.bfloat16, method=method))


def test_resolve_method_matches_reference():
    assert topk_loop_cutover("cpu") == ref_topk_loop_cutover("cpu")
    for method in ("auto", "loop", "threshold"):
        for k in range(1, 12):
            assert ops._resolve_method(method, k, "cpu") == \
                ref_ops._resolve_method(method, k)
    for bad in ("bogus", "argmax"):
        with pytest.raises(ValueError, match="unknown top-k method"):
            ops._resolve_method(bad, 4)
        with pytest.raises(ValueError, match="unknown top-k method"):
            ref_ops._resolve_method(bad, 4)
    with pytest.raises(ValueError, match="no top-k cutover"):
        topk_loop_cutover("meta")


def test_cpu_tensors_take_the_plain_version_uncounted():
    before = dict(LAUNCHES)
    x = torch.from_numpy(_x((8, 64), seed=1))
    want = ops.row_topk_ref(x, 5)
    for got in (row_topk_loop_cuda(x, 5), row_topk_threshold_cuda(x, 5)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert LAUNCHES == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((4, 32))
    check_inputs(x.to(torch.bfloat16), 2)  # the bf16 forms take it
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError, match=str(dtype)):
            check_inputs(x.to(dtype), 2)
    with pytest.raises(ValueError, match="k <= C"):
        check_inputs(x, 33)
    with pytest.raises(ValueError, match="k <= C"):
        ops.row_topk(x, 0)
    with pytest.raises(ValueError, match=r"\(R, C\)"):
        check_inputs(torch.zeros(8), 2)
    with pytest.raises(ValueError, match="contiguous"):
        check_inputs(torch.zeros((32, 4)).T, 2)
    with pytest.raises(ValueError, match="k <= C"):
        row_topk_threshold_cuda(x, 33)
    with pytest.raises(ValueError, match="unknown top-k method"):
        ops.row_topk(x, 2, method="sort")
    meta = torch.zeros((4, 32), device="meta")
    for wrapper in (row_topk_loop_cuda, row_topk_threshold_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            wrapper(meta, 2)


def test_library_path_covers_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    for name in ("topk_select", "fused_memsgd"):
        assert [p.name for p in _build.sources(name)] == [
            f"{name}.cu", "row_buffer.cuh", "topk_common.cuh"]
    before = {n: _build.library_path(n)
              for n in ("topk_select", "fused_memsgd")}
    for name in ("topk_common.cuh", "row_buffer.cuh"):
        header = csrc / name
        header.write_text(header.read_text() + "\n// edited\n")
        after = {n: _build.library_path(n) for n in before}
        assert all(after[n] != before[n] for n in before)
        before = after
    src = csrc / "topk_select.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("topk_select") != after["topk_select"]
    assert _build.library_path("fused_memsgd") == after["fused_memsgd"]
