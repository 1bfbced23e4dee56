"""Tests of the port that need the card (marker ``cuda``).

They import nothing of JAX, so they run where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each test decides inside itself whether a CUDA device is present and
skips where there is none.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from _topk_edges import EDGE_KINDS, edge_rows
from repro_torch.configs import get_smoke_config
from repro_torch.core.distributed import SyncConfig
from repro_torch.data import token_batches
from repro_torch.kernels import ops, topk_select
from repro_torch.kernels.fused_memsgd import (
    MAX_COLS,
    MAX_COLS_BY_DTYPE,
    SELECTION_LAUNCHES,
    fused_memsgd_cuda,
    launch_geometry,
)
from repro_torch.kernels.ref import fused_memsgd_ref, row_topk_ref
from repro_torch.kernels.topk_select import (
    LAUNCHES,
    row_topk_loop_cuda,
    row_topk_threshold_cuda,
)
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import (
    TrainConfig,
    init_train_state,
    make_train_step,
)
from repro_torch.models import build_model
from repro_torch.utils.platform import fused_loop_cutover
from repro_torch.utils.tree import tree_leaves, tree_map

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(shape, seed, kind):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":
        m, g = np.round(m * 2) / 2, np.round(g * 2) / 2
    elif kind == "zeros":
        m = np.zeros(shape, np.float32)
        m[:, 5], m[:, 90] = 3.0, -1.0
        g = np.zeros(shape, np.float32)
    return torch.from_numpy(m).cuda(), torch.from_numpy(g).cuda()


@pytest.mark.parametrize("shape,k,kind,eta", [
    ((8, 1024), 10, "normal", 0.37),
    ((16, 256), 8, "ties", 1.0),
    ((8, 96), 8, "zeros", 0.5),
    ((3, 33), 16, "normal", 0.0),
    ((4, 8192), 64, "normal", 0.37),
])
def test_kernel_is_bitwise_equal_to_its_plain_version(shape, k, kind, eta):
    _need_card()
    m, g = _inputs(shape, 2, kind)
    before = fused_memsgd_cuda.launches
    got = fused_memsgd_cuda(m, g, eta, k)
    assert fused_memsgd_cuda.launches == before + 1
    want = fused_memsgd_ref(m, g, eta, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _fused_edges():
    """(label, m, g, eta, k) at the edges of the fused kernel's design,
    made with numpy from a seed: k around the candidate list's bound (32)
    and capacity (256), k = C, a list that overflows, all-zero and
    signed-zero rows, ties, subnormal and +-inf rows, eta = 0, C % 4 != 0,
    a row count that leaves the last block's warps spare, and the widest
    row both branches hold."""
    rng = np.random.default_rng(21)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    for k in (13, 20, 32, 33, 256, 257):
        yield f"k={k}", f32(8, 1024), f32(8, 1024), 0.37, k
    yield "k=C", f32(4, 300), f32(4, 300), 0.37, 300
    # lane l reads the columns j with (j // 4) % 32 == l: every entry of
    # lane l above every entry of lane l + 1 overflows the candidate list
    lane = (np.arange(1024) // 4) % 32
    x = ((32 - lane) * 10.0 + rng.random((4, 1024))) * np.where(
        rng.random((4, 1024)) < 0.5, -1.0, 1.0)
    yield ("candidate list overflows", x.astype(np.float32),
           np.zeros((4, 1024), np.float32), 1.0, 10)
    z = np.zeros((6, 256), np.float32)
    z[:, 1::3] = -0.0
    yield "all-zero rows, signed zeros", z, z.copy(), 0.5, 20
    m = np.zeros((6, 256), np.float32)
    m[:, ::5] = -0.0
    m[:3, 7], m[:3, 200] = 2.0, -1.0
    yield "mostly signed zeros", m, np.zeros_like(m), 1.0, 20
    yield ("tie-heavy halves", np.round(f32(16, 512) * 2) / 2,
           np.round(f32(16, 512) * 2) / 2, 1.0, 40)
    yield ("tie-heavy small integers", rng.integers(-3, 4, (8, 1024))
           .astype(np.float32), np.zeros((8, 1024), np.float32), 1.0, 20)
    bits = rng.integers(1, 2**23, (6, 1024), dtype=np.uint32)
    x = f32(6, 1024)
    x[0, [5, 900, 1023]] = [np.inf, -np.inf, np.inf]
    yield ("subnormal and +-inf rows", np.concatenate(
        [bits.view(np.float32), x]), np.zeros((12, 1024), np.float32),
        1.0, 10)
    yield "eta=0", f32(8, 1024), f32(8, 1024), 0.0, 20
    yield "C % 4 != 0", f32(6, 1023), f32(6, 1023), 0.37, 26
    yield "spare warps", f32(5, 1024), f32(5, 1024), 0.37, 10
    C = MAX_COLS["threshold"]
    yield "widest row", f32(2, C), f32(2, C), 0.37, 300


FUSED_EDGES = [e[0] for e in _fused_edges()]


@pytest.mark.parametrize("selection", ["loop", "threshold"])
@pytest.mark.parametrize("label", FUSED_EDGES)
def test_fused_threshold_branch_on_its_edges(label, selection):
    """Both branches share one design (the candidate list, a warp for
    every row, the bulk copy), so both are held on its edges."""
    _need_card()
    _, m, g, eta, k = next(e for e in _fused_edges() if e[0] == label)
    m, g = torch.from_numpy(m).cuda(), torch.from_numpy(g).cuda()
    before = dict(SELECTION_LAUNCHES)
    got = fused_memsgd_cuda(m, g, eta, k, selection)
    assert SELECTION_LAUNCHES == {
        n: before[n] + (n == selection) for n in before}
    want = fused_memsgd_ref(m, g, eta, k)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("selection", ["loop", "threshold"])
def test_fused_threshold_branch_on_unaligned_rows(selection):
    _need_card()
    flat = torch.from_numpy(np.random.default_rng(22).standard_normal(
        2 * (8 * 1024 + 1)).astype(np.float32)).cuda()
    m, g = flat[1:8 * 1024 + 1].view(8, 1024), flat[-8 * 1024:].view(8, 1024)
    want = fused_memsgd_ref(m, g, 0.37, 20)
    for a, b in zip(fused_memsgd_cuda(m, g, 0.37, 20, selection), want):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("cols", [1, 20, 1023, 1024, 2560, 20000, 57340])
def test_fused_launch_plan_fits_the_card(cols):
    _need_card()
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    pairs = ((torch.float32, torch.float32), (BF16, torch.float32),
             (BF16, BF16))
    for selection, (m_dt, g_dt), rows in (
            (s, p, r) for s in ("loop", "threshold") for p in pairs
            for r in (1, 5, 1154560)):
        g = launch_geometry(selection, rows, cols, dev, m_dt, g_dt)
        # never more shared memory than a block may use; the row always
        # in shared memory; a warp for every row
        assert 0 < g.smem_bytes <= props.shared_memory_per_block_optin
        assert g.in_smem
        assert 1 <= g.warps_per_block <= g.warps_per_sm
        assert g.warps_per_sm * 32 <= props.max_threads_per_multi_processor
        assert g.blocks == -(-rows // g.warps_per_block)
    with pytest.raises(RuntimeError, match="launch plan failed"):
        launch_geometry("threshold", 1, MAX_COLS["threshold"] + 4, dev)
    with pytest.raises(RuntimeError, match="launch plan failed"):
        launch_geometry("threshold", 1,
                        MAX_COLS_BY_DTYPE[BF16]["threshold"] + 8, dev, BF16)


def test_fused_threshold_branch_refuses_a_row_over_shared_memory():
    _need_card()
    m = torch.zeros((1, MAX_COLS["threshold"] + 4), device="cuda")
    with pytest.raises(ValueError, match="threshold selection"):
        fused_memsgd_cuda(m, m, 0.1, 20, "threshold")
    fused_memsgd_cuda(m, m, 0.1, 20, "loop")  # the loop branch holds it


@pytest.mark.parametrize("shape,k,method,branch", [
    # the fused sweep: "auto" takes the threshold branch at every k
    # (FUSED_LOOP_CUTOVER["cuda"] = 0); the loop branch by name
    ((8, 1024), 1, "auto", "threshold"), ((8, 1024), 32, "auto", "threshold"),
    ((8, 1024), 33, "auto", "threshold"), ((8, 1024), 10, "loop", "loop"),
    ((8, 1024), 20, "threshold", "threshold"),
    # rows of rwkv6-3b's (1002500, 1024) bucket at the bucketed path's k
    # and the topk preset's
    ((4096, 1024), 10, "auto", "threshold"),
    ((4096, 1024), 20, "auto", "threshold"),
])
def test_fused_update_picks_the_branch_by_the_cutover(shape, k, method,
                                                      branch):
    _need_card()
    assert ops._resolve_method(method, k, "cuda",
                               fused_loop_cutover) == branch
    m, g = _inputs(shape, 5, "normal")
    before = dict(SELECTION_LAUNCHES)
    got = ops.fused_memsgd_update(m, g, 0.5, k, method=method)
    assert {n: SELECTION_LAUNCHES[n] - before[n] for n in before} == {
        "loop": int(branch == "loop"), "threshold": int(branch != "loop"),
        "loop_bf16": 0, "threshold_bf16": 0}
    for a, b in zip(got, fused_memsgd_ref(m, g, 0.5, k)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_kernel_takes_bfloat16_and_refuses_other_dtypes_on_the_card():
    """A bf16 CUDA m goes to the bf16 form (never to the plain version);
    a pair of dtypes the kernel has no form for raises by name."""
    _need_card()
    m = torch.zeros((8, 64), device="cuda")
    before = dict(SELECTION_LAUNCHES)
    for g in (m, m.to(BF16)):
        fused_memsgd_cuda(m.to(BF16), g, 0.1, 4)
    assert SELECTION_LAUNCHES["loop_bf16"] - before["loop_bf16"] == 2
    for a, b in ((m.half(), m.half()), (m, m.to(BF16)),
                 (m.double(), m.double())):
        with pytest.raises(TypeError, match=str(b.dtype)):
            fused_memsgd_cuda(a, b, 0.1, 4)


@pytest.mark.parametrize("selection", ["loop", "threshold"])
@pytest.mark.parametrize("shape,k,kind", [
    ((8, 2560), 26, "normal"),
    ((16, 256), 8, "ties"),
    ((8, 96), 8, "zeros"),
    ((5, 77), 77, "normal"),    # k = C, C not a multiple of 4
    ((3, 60000), 9, "normal"),  # a row wider than shared memory
])
def test_topk_kernels_are_bitwise_equal_to_the_plain_version(
        shape, k, kind, selection):
    _need_card()
    x, _ = _inputs(shape, 3, kind)
    name = f"row_topk_{selection}"
    wrapper = {"loop": row_topk_loop_cuda,
               "threshold": row_topk_threshold_cuda}[selection]
    before = LAUNCHES[name]
    got = wrapper(x, k)
    assert LAUNCHES[name] == before + 1
    want = row_topk_ref(x, k)
    for out in (got, ops.row_topk(x, k, method=selection)):
        for a, b in zip(out, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("selection", ["loop", "threshold"])
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_topk_kernels_on_the_design_edges(kind, selection):
    _need_card()
    x, k = edge_rows(kind)
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()
    wrapper = {"loop": row_topk_loop_cuda,
               "threshold": row_topk_threshold_cuda}[selection]
    got, want = wrapper(x, k), row_topk_ref(x, k)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("selection", ["loop", "threshold"])
@pytest.mark.parametrize("shape,k", [
    ((4096, 32), 1),    # rwkv6-3b's mix_w2 rows
    ((4096, 64), 1),    # bonus, gn, decay_w2
    ((2048, 160), 2),   # mix_w1
    ((64, 8960), 90),   # chan/wv (argmax_onehot takes the threshold)
])
def test_topk_kernels_on_the_rwkv_row_shapes(shape, k, selection):
    """The per-leaf (C, k) of rwkv6-3b at full width that qwen3-4b never
    gives the kernels: rows narrower than a warp's copy, and k > 64."""
    _need_card()
    x, _ = _inputs(shape, 7, "normal")
    wrapper = {"loop": row_topk_loop_cuda,
               "threshold": row_topk_threshold_cuda}[selection]
    for a, b in zip(wrapper(x, k), row_topk_ref(x, k)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("selection", ["loop", "threshold"])
@pytest.mark.parametrize("shape,k", [
    ((4096, 512), 5),     # granite-moe-3b-a800m's expert w_gate / w_up
    ((4096, 1536), 15),   # its w_down and attention rows
    ((12288, 40), 1),     # its router
    ((4096, 768), 8),     # qwen3-moe-30b-a3b's expert w_gate / w_up
    ((4096, 128), 1),     # its router
    ((2048, 2048), 20),   # its w_down and attention rows
    ((1024, 4096), 41),   # yi-9b, granite-3-8b
    ((1024, 6144), 61),   # internvl2-26b
])
def test_topk_kernels_on_the_new_leaf_shapes(shape, k, selection):
    """The per-leaf (C, k) of the MoE family and the wide dense family at
    full width (rows cut): narrow expert rows, routers of C = 40 and 128,
    and the loop kernel at k = 41 and 61."""
    _need_card()
    x, _ = _inputs(shape, 8, "normal")
    wrapper = {"loop": row_topk_loop_cuda,
               "threshold": row_topk_threshold_cuda}[selection]
    for a, b in zip(wrapper(x, k), row_topk_ref(x, k)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("selection,k", [("loop", 10), ("threshold", 20)])
def test_fused_kernel_at_the_moe_bucket(selection, k):
    """granite-moe-3b-a800m's (935136, 1024) bucket at 8 layers: the
    bucketed path's k and the topk preset's."""
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    m = torch.randn((935136, 1024), generator=gen, device="cuda") * 0.01
    g = torch.randn((935136, 1024), generator=gen, device="cuda")
    got = fused_memsgd_cuda(m, g, 0.5, k, selection)
    want = fused_memsgd_ref(m, g, 0.5, k)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("selection", ["loop", "threshold"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_topk_kernels_on_griffin_s_rows_of_four(offset, k, selection):
    """recurrentgemma-9b's conv_w at full width: 4096 rows of C = 4 (k = 1
    on its per-leaf path; k = 4 = C), at 16-byte alignment and 4 or 12
    bytes past it (a 16-byte row of 4 floats then straddles two)."""
    _need_card()
    flat = torch.from_numpy(
        np.random.default_rng(offset).standard_normal(4096 * 4 + 3)
        .astype(np.float32)).cuda()
    x = flat[offset:offset + 4096 * 4].view(4096, 4)
    wrapper = {"loop": row_topk_loop_cuda,
               "threshold": row_topk_threshold_cuda}[selection]
    for a, b in zip(wrapper(x, k), row_topk_ref(x, k)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_topk_kernels_on_unaligned_rows():
    _need_card()
    flat = torch.from_numpy(
        np.random.default_rng(4).standard_normal(8 * 1024 + 1)
        .astype(np.float32)).cuda()
    x = flat[1:].view(8, 1024)  # contiguous, 4 bytes past 16-byte alignment
    want = row_topk_ref(x, 26)
    for wrapper in (row_topk_loop_cuda, row_topk_threshold_cuda):
        for a, b in zip(wrapper(x, 26), want):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("cols,in_smem", [
    (1, True), (20, True), (1023, True), (2560, True), (20000, True),
    (60000, False), (1 << 20, False)])
def test_topk_launch_plan_fits_the_card(cols, in_smem):
    """``in_smem`` is the float32 form's; a bf16 row is half the bytes (at
    60000 columns it fits)."""
    _need_card()
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    optin = props.shared_memory_per_block_optin
    for name, dtype, rows in ((n, d, r) for n in topk_select.KERNELS
                              for d in (torch.float32, BF16)
                              for r in (1, 5, 152064)):
        g = topk_select.launch_geometry(name, rows, cols, dev, dtype)
        # never more shared memory than a block may use; a row buffer
        # per warp when a row fits, else the device-memory form
        row = -(-cols * dtype.itemsize // 16) * 16
        fits = row + 2048 + 1024 + 16 <= optin
        assert fits == in_smem or dtype == BF16
        assert 0 < g.smem_bytes <= optin
        assert g.in_smem == fits
        assert 1 <= g.warps_per_block <= g.warps_per_sm
        assert g.warps_per_sm * 32 <= props.max_threads_per_multi_processor
        # every row has its warp, or the SMs hold every block at once
        per_sm = g.warps_per_sm // g.warps_per_block
        assert g.blocks == min(-(-rows // g.warps_per_block),
                               props.multi_processor_count * per_sm)


def test_topk_kernels_take_bfloat16_and_refuse_float16_on_the_card():
    """A bf16 CUDA tensor goes to the bf16 forms, counted under their own
    names; float16 and float64 raise by name."""
    _need_card()
    x = torch.zeros((8, 64), device="cuda", dtype=BF16)
    before = dict(LAUNCHES)
    for fn in (row_topk_loop_cuda, row_topk_threshold_cuda):
        vals, _ = fn(x, 4)
        assert vals.dtype == BF16
    assert {n: LAUNCHES[n] - before[n] for n in LAUNCHES} == {
        n: int(n.endswith("_bf16")) for n in LAUNCHES}
    for dtype in (torch.float16, torch.float64):
        for fn in (row_topk_loop_cuda, row_topk_threshold_cuda):
            with pytest.raises(TypeError, match=str(dtype)):
                fn(x.to(dtype), 4)


def _card_against_cpu(bucketed, arch="qwen3-4b", optimizer="memsgd",
                      eta=0.5):
    """One float32 smoke step from the same params and batch on the CPU
    and on the card: loss to 1e-5 relative, applied update to 1e-3
    relative L2. Returns the kernel launches of each device's step."""
    model = build_model(get_smoke_config(arch).replace(
        compute_dtype="float32"))
    tc = TrainConfig(optimizer=optimizer, eta=eta,
                     sync=SyncConfig(ratio=0.01, bucketed=bucketed))
    batch = next(token_batches(512, 4, 64, seed=1))
    host = model.init(seed=0, device="cpu")
    out, launched = {}, {}
    for dev in ("cpu", "cuda"):
        params, memory, opt, count = init_train_state(
            model, tc, device=dev,
            params=tree_map(lambda t: t.to(dev, copy=True), host))
        before = [p.clone() for p in tree_leaves(params)]
        step = make_train_step(model, tc)
        fused, topk = fused_memsgd_cuda.launches, dict(LAUNCHES)
        params, memory, opt, count, met = step(
            params, memory, opt, count,
            {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        launched[dev] = {"fused_memsgd": fused_memsgd_cuda.launches - fused,
                         **{n: LAUNCHES[n] - topk[n] for n in LAUNCHES}}
        # a float32 step launches no bf16 form
        assert not any(launched[dev].pop(n + "_bf16")
                       for n in topk_select.KERNELS)
        out[dev] = (met["loss"], torch.cat(
            [(a - b).reshape(-1).cpu()
             for a, b in zip(before, tree_leaves(params))]))
    (l_cpu, u_cpu), (l_gpu, u_gpu) = out["cpu"], out["cuda"]
    l_cpu, l_gpu = float(l_cpu), float(l_gpu)
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    assert float((u_gpu - u_cpu).norm() / u_cpu.norm()) < 1e-3
    return launched


def test_train_step_on_the_card_matches_the_cpu():
    """The bucketed step: one fused kernel launch on the card."""
    _need_card()
    launched = _card_against_cpu(bucketed=True)
    assert not any(launched["cpu"].values())
    assert launched["cuda"] == {"fused_memsgd": 1, "row_topk_loop": 0,
                                "row_topk_threshold": 0}


def test_per_leaf_step_on_the_card_matches_the_cpu():
    _need_card()
    launched = _card_against_cpu(bucketed=False)
    assert not any(launched["cpu"].values())
    # nine sparse leaves, k = 3 each: the loop kernel once per leaf
    assert launched["cuda"] == {"fused_memsgd": 0, "row_topk_loop": 9,
                                "row_topk_threshold": 0}


@pytest.mark.parametrize("bucketed", [True, False])
def test_rwkv_step_on_the_card_matches_the_cpu(bucketed):
    """rwkv6-3b's smoke step: one fused launch on the bucketed path, one
    top-k launch per sparse leaf on the per-leaf path (every k <= 64: the
    loop)."""
    _need_card()
    launched = _card_against_cpu(bucketed, arch="rwkv6-3b")
    assert not any(launched["cpu"].values())
    shapes = build_model(get_smoke_config("rwkv6-3b")).param_shapes()
    sparse = sum(p.numel() >= SyncConfig().dense_below
                 for p in tree_leaves(shapes))
    assert launched["cuda"] == {
        "fused_memsgd": int(bucketed),
        "row_topk_loop": 0 if bucketed else sparse,
        "row_topk_threshold": 0}


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-30b-a3b"])
def test_moe_step_on_the_card_matches_the_cpu(arch, bucketed):
    """The MoE smoke configs' step: one fused launch on the bucketed path,
    one loop top-k launch per sparse leaf on the per-leaf path."""
    _need_card()
    launched = _card_against_cpu(bucketed, arch=arch)
    assert not any(launched["cpu"].values())
    shapes = build_model(get_smoke_config(arch)).param_shapes()
    sparse = sum(p.numel() >= SyncConfig().dense_below
                 for p in tree_leaves(shapes))
    assert launched["cuda"] == {
        "fused_memsgd": int(bucketed),
        "row_topk_loop": 0 if bucketed else sparse,
        "row_topk_threshold": 0}


@pytest.mark.parametrize("bucketed", [True, False])
def test_griffin_step_on_the_card_matches_the_cpu(bucketed, monkeypatch):
    """recurrentgemma-9b's smoke step at 3 layers (rec, rec, attn) in
    float32, card against CPU from the same params and batch: the loss
    within 1e-5 relative, the gradients within 1e-5 relative L2 (float32
    products summed in other orders), and the CPU's step taken from the
    card's gradients gives the card's update bit for bit (the sync is
    exact), so that a near-tie in the selection, flipped by the gradients'
    last bits, is told apart from a fault (at this input the two devices'
    end-to-end bucketed updates lie 2.1e-3 apart in relative L2: one such
    flip). One fused launch on the bucketed path, one loop top-k launch
    per sparse leaf on the per-leaf path."""
    _need_card()
    model = build_model(get_smoke_config("recurrentgemma-9b").replace(
        compute_dtype="float32", n_layers=3))
    tc = TrainConfig(eta=0.5, sync=SyncConfig(ratio=0.01, bucketed=bucketed))
    batch = next(token_batches(512, 4, 64, seed=1))
    host = model.init(seed=0, device="cpu")
    real_grad = torch.autograd.grad

    def step_on(dev, grads=None):
        """(loss, update on the host, gradients on the host, launches) of
        one step on ``dev``, from ``grads`` in place of its own if given."""
        tapped = []

        def grad(outputs, inputs, *args, **kwargs):
            out = real_grad(outputs, inputs, *args, **kwargs)
            tapped.append([g.detach().cpu() for g in out])
            if grads is not None:
                out = tuple(r.to(g.device) for r, g in zip(grads, out))
            return out

        params, memory, opt, count = init_train_state(
            model, tc, device=dev,
            params=tree_map(lambda t: t.to(dev, copy=True), host))
        before = [p.clone() for p in tree_leaves(params)]
        fused, topk = fused_memsgd_cuda.launches, dict(LAUNCHES)
        monkeypatch.setattr(torch.autograd, "grad", grad)
        params, memory, opt, count, met = make_train_step(model, tc)(
            params, memory, opt, count,
            {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        monkeypatch.setattr(torch.autograd, "grad", real_grad)
        launched = {"fused_memsgd": fused_memsgd_cuda.launches - fused,
                    **{n: LAUNCHES[n] - topk[n] for n in LAUNCHES}}
        assert not any(launched.pop(n + "_bf16") for n in topk_select.KERNELS)
        upd = torch.cat([(a - b).reshape(-1).cpu()
                         for a, b in zip(before, tree_leaves(params))])
        return float(met["loss"]), upd, tapped[0], launched

    l_cpu, _, g_cpu, launched_cpu = step_on("cpu")
    l_gpu, u_gpu, g_gpu, launched = step_on("cuda")
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    gc, gg = (torch.cat([g.reshape(-1) for g in gs]) for gs in (g_cpu, g_gpu))
    assert float((gg - gc).norm() / gc.norm()) < 1e-5
    u_from_card = step_on("cpu", g_gpu)[1]
    assert torch.equal(u_from_card.view(torch.int32), u_gpu.view(torch.int32))
    assert not any(launched_cpu.values())
    shapes = model.param_shapes()
    sparse = sum(p.numel() >= SyncConfig().dense_below
                 for p in tree_leaves(shapes))
    assert launched == {
        "fused_memsgd": int(bucketed),
        "row_topk_loop": 0 if bucketed else sparse,
        "row_topk_threshold": 0}


@pytest.mark.parametrize("S", [64, 1])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-30b-a3b"])
def test_moe_layer_on_the_card_matches_the_cpu(arch, S):
    """moe_ffn in float32 from numpy-seeded params and tokens: the same
    routing and capacity mask on both devices, then the output within
    rtol 1e-5 and atol 1e-5 of its largest entry (products summed in
    another order on the card), the aux loss within rtol 1e-5."""
    _need_card()
    from repro_torch.models import moe

    cfg = get_smoke_config(arch)
    m = cfg.moe
    rng = np.random.default_rng(3)
    D, E, Fe = cfg.d_model, m.n_experts, m.d_expert

    def normal(shape, d_in):
        return torch.from_numpy((rng.standard_normal(shape) / d_in ** 0.5)
                                .astype(np.float32))

    host = {"router": normal((D, E), D), "w_gate": normal((E, D, Fe), D),
            "w_up": normal((E, D, Fe), D), "w_down": normal((E, Fe, D), Fe)}
    x = torch.from_numpy(rng.standard_normal(
        (4 if S > 1 else 16, S, D)).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in host.items()}
        xd = x.to(dev)
        xg = xd if S > 1 else xd.reshape(1, -1, D)
        _, top_i, _ = moe.route(p, cfg, xg)
        keep, _ = moe.assign_slots(top_i, E, moe.capacity(xg.shape[1], cfg))
        y, aux = moe.moe_ffn(p, cfg, xd)
        out[dev] = (top_i.cpu(), keep.cpu(), y.cpu(), float(aux))
    (ti_c, k_c, y_c, a_c), (ti_g, k_g, y_g, a_g) = out["cpu"], out["cuda"]
    assert torch.equal(ti_c, ti_g) and torch.equal(k_c, k_g)
    torch.testing.assert_close(y_g, y_c, rtol=1e-5,
                               atol=1e-5 * float(y_c.abs().max()))
    assert abs(a_g - a_c) <= 1e-5 * abs(a_c)


def test_cli_trains_the_per_leaf_path_on_the_card():
    _need_card()
    launches = LAUNCHES["row_topk_loop"]
    *_, count, history = train_mod.main(
        ["--steps", "2", "--batch", "2", "--seq", "32"])
    assert count == 2 and LAUNCHES["row_topk_loop"] - launches == 18
    assert all(math.isfinite(x) for _, x in history)


def test_cli_trains_on_the_card():
    _need_card()
    launches = fused_memsgd_cuda.launches
    *_, count, history = train_mod.main(
        ["--bucketed", "--steps", "2", "--batch", "2", "--seq", "32"])
    assert count == 2 and fused_memsgd_cuda.launches - launches == 2
    assert all(math.isfinite(x) for _, x in history)


def test_topk_preset_in_a_one_rank_nccl_group(tmp_path):
    """The topk preset (packed wire, the fused kernel's threshold branch
    at ratio 0.05) through a 1-rank NCCL group: the same bits as the
    unpacked wire, and the gather through NCCL."""
    _need_card()
    import torch.distributed as dist

    model = build_model(get_smoke_config("qwen3-4b"))
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(token_batches(512, 4, 64, seed=1)).items()}
    host = model.init(seed=0, device="cpu")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        out = {}
        for wire in ("packed", "unpacked"):
            tc = TrainConfig(eta=0.5, sync=SyncConfig.preset(
                "topk", ratio=0.05, wire=wire))
            params, memory, opt, count = init_train_state(
                model, tc, device="cuda",
                params=tree_map(lambda t: t.to("cuda", copy=True), host))
            before = dict(SELECTION_LAUNCHES)
            params, memory, *_ = make_train_step(model, tc)(
                params, memory, opt, count, batch)
            torch.cuda.synchronize()
            assert SELECTION_LAUNCHES["threshold"] - before["threshold"] == 1
            out[wire] = tree_leaves(params) + list(memory)
    finally:
        dist.destroy_process_group()
    for a, b in zip(out["packed"], out["unpacked"]):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_cli_trains_the_topk_preset_on_the_card():
    """The bucket's k = 20 takes the fused kernel's branch that the fused
    cutover names (FUSED_LOOP_CUTOVER["cuda"]: the threshold branch)."""
    _need_card()
    branch = ops._resolve_method("auto", 20, "cuda", fused_loop_cutover)
    before = dict(SELECTION_LAUNCHES)
    *_, count, history = train_mod.main(
        ["--preset", "topk", "--ratio", "0.02", "--steps", "2", "--batch",
         "2", "--seq", "32"])
    assert count == 2
    assert SELECTION_LAUNCHES[branch] - before[branch] == 2
    assert all(math.isfinite(x) for _, x in history)


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("optimizer,eta", [("memsgd_momentum", 0.05),
                                           ("adam_compressed", 3e-3)])
def test_optimizer_modes_on_the_card_match_the_cpu(optimizer, eta, bucketed):
    """memsgd_momentum and adam_compressed: the same kernels as memsgd
    (one fused launch, or one loop top-k launch per sparse leaf)."""
    _need_card()
    launched = _card_against_cpu(bucketed, optimizer=optimizer, eta=eta)
    assert not any(launched["cpu"].values())
    assert launched["cuda"] == {"fused_memsgd": int(bucketed),
                                "row_topk_loop": 0 if bucketed else 9,
                                "row_topk_threshold": 0}


def _row(kind, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(d).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2) / 2
    elif kind == "zeros":
        x = np.zeros(d, np.float32)
        x[1::3] = -0.0
    return torch.from_numpy(x).cuda()


# the single-row regime: compression.top_k sends one (1, d) row
SINGLE_ROWS = [(2000, 1), (2000, 3), (47236, 10), (47236, 30),
               (1 << 20, 1024)]


@pytest.mark.parametrize("kind", ["random", "ties", "zeros"])
@pytest.mark.parametrize("d,k", SINGLE_ROWS)
def test_top_k_single_row_is_bitwise_on_the_card(d, k, kind):
    """compression.top_k on a CUDA vector launches the kernel that
    ``row_topk(method="auto")`` picks, once, and gives the plain
    version's pairs and dense form bit for bit; both kernels agree with
    it where k <= 64 (k = 1024 orders its pairs through
    ``write_selected``)."""
    _need_card()
    from repro_torch.core.compression import top_k

    x = _row(kind, d, seed=d + k)
    want = row_topk_ref(x.reshape(1, -1), k)
    name = ("row_topk_threshold" if k > ops.topk_loop_cutover("cuda")
            else "row_topk_loop")
    before = dict(LAUNCHES)
    vals, idx = top_k(k).sparse(x)
    torch.cuda.synchronize()
    assert {n: LAUNCHES[n] - before[n] for n in LAUNCHES} == {
        n: int(n == name) for n in LAUNCHES}
    assert torch.equal(vals.view(torch.int32), want[0].reshape(-1).view(
        torch.int32))
    assert torch.equal(idx, want[1].reshape(-1))
    dense = top_k(k).dense(x)
    expect = torch.zeros_like(x).index_copy_(0, want[1].reshape(-1).long(),
                                             want[0].reshape(-1))
    assert torch.equal(dense.view(torch.int32), expect.view(torch.int32))
    if k <= 64:
        for fn in (row_topk_loop_cuda, row_topk_threshold_cuda):
            got = fn(x.reshape(1, -1), k)
            assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, want))


def test_blockwise_top_k_on_the_card_matches_the_cpu():
    """(47, 1024) rows with a padded tail, k_b = 2: the same pairs and
    dense form as on the CPU."""
    _need_card()
    from repro_torch.core.compression import blockwise_top_k

    x = _row("random", 47236, seed=3)
    comp = blockwise_top_k(2, 1024)
    got, want = comp.sparse(x), comp.sparse(x.cpu())
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    assert torch.equal(comp.dense(x).cpu(), comp.dense(x.cpu()))


def test_memsgd_flat_logreg_on_the_card_matches_the_cpu():
    """2000 steps of the paper's protocol on a small epsilon-like set: the
    weighted average's loss below ln 2 on the card, within rtol 1e-3 of
    the CPU's."""
    _need_card()
    from repro_torch.core.compression import top_k
    from repro_torch.core.memsgd import memsgd_flat
    from repro_torch.core.theory import WeightedAverage, paper_stepsize
    from repro_torch.data import (logreg_grad_torch, logreg_loss_torch,
                                  make_epsilon_like)

    data = make_epsilon_like(n=2000, d=500)
    idx = np.random.default_rng(0).integers(data.n, size=2000).tolist()
    out = {}
    for dev in ("cpu", "cuda"):
        A = torch.from_numpy(data.A.astype(np.float32)).to(dev)
        b = torch.from_numpy(data.b.astype(np.float32)).to(dev)
        x = torch.zeros(data.d, device=dev)
        tx = memsgd_flat(top_k(2), paper_stepsize(2.0, data.lam, 250.0),
                         data.d)
        s = tx.init(x)
        avg = WeightedAverage(250.0)
        a_s = avg.init(x)
        for t, i in enumerate(idx):
            u, s = tx.update(logreg_grad_torch(A, b, data.lam, x, i), s)
            x = x + u
            a_s = avg.update(a_s, x, t)
        out[dev] = float(logreg_loss_torch(A, b, data.lam, avg.value(a_s)))
    assert math.isfinite(out["cuda"]) and out["cuda"] < math.log(2)
    assert abs(out["cuda"] - out["cpu"]) <= 1e-3 * out["cpu"]


def test_torch_quickstart_on_the_card():
    _need_card()
    import importlib.util
    import os
    import sys

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "torch_quickstart.py")
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["torch_quickstart"] = mod
    spec.loader.exec_module(mod)
    before = LAUNCHES["row_topk_loop"]
    assert mod.main([]) < 0.01
    assert LAUNCHES["row_topk_loop"] - before == 2 * 600  # w and b a step


def test_random_operators_draw_on_the_card():
    """rand_k and random_coordinate draw from a generator on the card:
    memsgd_flat(rand_k) keeps its generator on the params' device and
    converges on a quadratic; one memory_step's two forms select the same
    coordinates."""
    _need_card()
    from repro_torch.core.compression import rand_k, random_coordinate
    from repro_torch.core.memory import memory_step
    from repro_torch.core.memsgd import constant_eta, memsgd_flat

    d, k = 64, 4
    target = torch.ones(d, device="cuda")
    tx = memsgd_flat(rand_k(k), constant_eta(0.5 * k / d), d, seed=3)
    w = torch.zeros(d, device="cuda")
    s = tx.init(w)
    assert s.rng.device.type == "cuda"
    for _ in range(3000):
        u, s = tx.update(w - target, s)
        w = w + u
    assert float(torch.linalg.norm(w - target)) < 1e-2
    gen = torch.Generator(device="cuda").manual_seed(4)
    upd = memory_step(rand_k(6), torch.zeros(50, device="cuda"),
                      torch.randn(50, device="cuda", generator=gen), 0.5, gen)
    vals, idx = upd.sparse
    assert sorted(torch.nonzero(upd.applied).reshape(-1).tolist()) == \
        sorted(idx.tolist())
    kept = random_coordinate(16.0).dense(target, gen)
    assert 0 < int((kept != 0).sum()) < d


def _pod_mean_rows(rows, cols, k_row, n_data, seed):
    """A pod mean as the two-level sync forms it: n_data shards' per-row
    top-k_row, densified, summed, / n_data (at most n_data * k_row
    nonzeros a row, zeros of both signs among them)."""
    rng = np.random.default_rng(seed)
    out = torch.zeros((rows, cols))
    for _ in range(n_data):
        u = torch.from_numpy(rng.standard_normal((rows, cols)).astype(
            np.float32))
        u[::7] = -0.0
        vals, idx = row_topk_ref(u, k_row)
        out.scatter_add_(1, idx.long(), vals)
    return out / n_data


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("k_live", [1, 7, 20])
def test_mask_live_k_and_the_pod_reselect_on_the_card(k_live, dtype):
    """The pod re-select (both top-k kernels at k_max = n_data * k_row on a
    pod mean, mostly zeros; at bf16 the bf16 forms) and ``mask_live_k`` on
    CUDA tensors, bit for bit their plain versions."""
    _need_card()
    pm = _pod_mean_rows(300, 1024, 10, 2, seed=k_live).to(dtype)
    want = topk_select.mask_live_k(*row_topk_ref(pm, 20), k_live)
    for fn in (row_topk_loop_cuda, row_topk_threshold_cuda):
        got = topk_select.mask_live_k(*fn(pm.cuda(), 20), k_live)
        for a, b in zip(got, want):
            assert a.is_cuda
            assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("value_dtype,selection,reselect", [
    ("float32", "argmax_onehot", "row_topk_loop"),
    # the reference's argmax loop re-selects on the pod mean's float32 keys
    ("bfloat16", "argmax_onehot", "row_topk_loop"),
    # its threshold select on the bf16 pod mean: the bf16 kernel ("auto"
    # at k_max = 20: the loop)
    ("bfloat16", "threshold_onehot", "row_topk_loop_bf16"),
])
def test_two_level_sync_on_the_card_matches_the_cpu(tmp_path, value_dtype,
                                                    selection, reselect):
    """The two-level bucketed sync (runtime pod k, packed wire, the repack
    boundary) over a (1, 1) gloo layout on the card: the CPU's update,
    memory and realized bytes bit for bit, from the same inputs, with the
    re-select kernel the selection and the wire's dtype take."""
    _need_card()
    import torch.distributed as dist

    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import bucketed_sync_gradients
    from repro_torch.launch.mesh import make_layout

    rng = np.random.default_rng(5)
    grads = {"w": torch.from_numpy(rng.standard_normal((300, 700)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(90).astype(
            np.float32))}
    plan = bk.make_plan(grads, cols=1024, dense_below=100)
    mem = [torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32))
           for s in plan.buckets]
    cfg = SyncConfig.preset("pod_budgeted", ratio=0.02, pod_axis="pod",
                            value_dtype=value_dtype, selection=selection)
    ks = tuple(5 if s.kind == "sparse" else 1 for s in plan.buckets)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        layout = make_layout(1, 1)
        out = {}
        for dev in ("cpu", "cuda"):
            level = {"intra": 0, "cross": 0}
            before = dict(LAUNCHES)
            upd, new_m, nbytes = bucketed_sync_gradients(
                cfg, plan, [m.to(dev) for m in mem],
                tree_map(lambda t: t.to(dev), grads), 0.3, layout=layout,
                pod_ks=ks, level_bytes=level)
            out[dev] = (tree_leaves(upd) + list(new_m), nbytes, level)
            assert LAUNCHES[reselect] - before[reselect] == int(
                dev == "cuda")
    finally:
        dist.destroy_process_group()
    assert out["cpu"][1:] == out["cuda"][1:]
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))


def test_overlap_modes_on_the_card_match_the_cpu(tmp_path):
    """The bucket pipeline on the card: a 2-bucket two-level sync
    (runtime pod k, the repack boundary, packed wire) over a (1, 1) gloo
    layout, two chained steps across a live-k switch (5 -> 3), at overlap
    None, False and True on the card and on the CPU: every run's updates,
    memory and realized bytes bit for bit the CPU's overlap None run."""
    _need_card()
    import torch.distributed as dist

    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import bucketed_sync_gradients
    from repro_torch.launch.mesh import make_layout

    rng = np.random.default_rng(6)
    grads = {"w": torch.from_numpy(rng.standard_normal((300, 700)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(90).astype(
            np.float32))}
    plan = bk.make_plan(grads, cols=1024, dense_below=100)
    mem0 = [torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32))
            for s in plan.buckets]
    cfg = SyncConfig.preset("pod_budgeted", ratio=0.02, pod_axis="pod")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        layout = make_layout(1, 1)
        out = {}
        for dev in ("cpu", "cuda"):
            for overlap in (None, False, True):
                c = dataclasses.replace(cfg, overlap=overlap)
                mem, got = [m.to(dev) for m in mem0], []
                for k in (5, 3):
                    level = {"intra": 0, "cross": 0}
                    ks = tuple(k if s.kind == "sparse" else 1
                               for s in plan.buckets)
                    upd, mem, nbytes = bucketed_sync_gradients(
                        c, plan, mem, tree_map(lambda t: t.to(dev), grads),
                        0.3, layout=layout, pod_ks=ks, level_bytes=level)
                    got.append((tree_leaves(upd), nbytes, level))
                out[dev, overlap] = (
                    [t.cpu() for u, _, _ in got for t in u]
                    + [t.cpu() for t in mem], [g[1:] for g in got])
    finally:
        dist.destroy_process_group()
    want_t, want_bytes = out["cpu", None]
    for key, (ts, nbytes) in out.items():
        assert nbytes == want_bytes, key
        assert len(ts) == len(want_t)
        for a, b in zip(ts, want_t):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), key


def _bf16_rows(kind, seed=31):
    """(x as a bf16 CPU tensor, k) at the edges of the top-k kernels' bf16
    forms: 8 values to a 16-byte load, so a lane owns columns j with
    (j // 8) % 32 == lane and the bulk copy needs C % 8 == 0."""
    rng = np.random.default_rng(seed)
    signs = lambda shape: np.where(rng.random(shape) < 0.5, -1.0, 1.0)  # noqa
    if kind == "lane-stratified at bf16 (list overflows)":
        lane = (np.arange(2560) // 8) % 32
        x = ((32 - lane) * 10.0 + rng.random((4, 2560))) * signs((4, 2560))
        return torch.from_numpy(x.astype(np.float32)).to(BF16), 26
    if kind == "bf16 subnormals":
        bits = rng.integers(1, 128, (6, 2560)).astype(np.int16)
        bits |= ((rng.random((6, 2560)) < 0.5) << 15).astype(np.int16)
        return torch.from_numpy(bits).view(BF16), 26
    if kind == "C % 8 != 0, C % 4 == 0":
        return torch.randn((6, 1020), generator=_gen(seed)).to(BF16), 26
    if kind == "k > the list's capacity":
        return torch.randn((4, 1024), generator=_gen(seed)).to(BF16), 300
    if kind == "k = C > the list's capacity":
        return torch.randn((3, 600), generator=_gen(seed)).to(BF16), 600
    if kind == "wider than shared memory at bf16":
        return torch.randn((2, 130000), generator=_gen(seed)).to(BF16), 26
    if kind == "rows of 4":
        return torch.randn((4096, 4), generator=_gen(seed)).to(BF16), 1
    x, k = edge_rows(kind)  # the float32 edges, rounded to bf16
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(BF16), k


def _gen(seed):
    return torch.Generator().manual_seed(seed)


BF16_EDGE_KINDS = EDGE_KINDS + [
    "lane-stratified at bf16 (list overflows)", "bf16 subnormals",
    "C % 8 != 0, C % 4 == 0", "k > the list's capacity",
    "k = C > the list's capacity", "wider than shared memory at bf16",
    "rows of 4"]


@pytest.mark.parametrize("selection", ["loop", "threshold"])
@pytest.mark.parametrize("kind", BF16_EDGE_KINDS)
def test_bf16_topk_kernels_on_the_design_edges(kind, selection):
    """Both bf16 forms, bitwise their plain version (vals in bf16), on
    every float32 edge rounded to bf16 (bf16's 8 significant bits make
    ties common) and on the bf16 form's own edges."""
    _need_card()
    x, k = _bf16_rows(kind)
    name = f"row_topk_{selection}"
    wrapper = {"loop": row_topk_loop_cuda,
               "threshold": row_topk_threshold_cuda}[selection]
    before = LAUNCHES[name + "_bf16"]
    got, want = wrapper(x.cuda(), k), row_topk_ref(x, k)
    assert LAUNCHES[name + "_bf16"] == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("offset", [1, 4])
def test_bf16_topk_kernels_on_unaligned_rows(offset):
    """Rows 2 and 8 bytes past 16-byte alignment: the lanes' plain loads."""
    _need_card()
    flat = torch.randn(8 * 1024 + 8, generator=_gen(offset)).to(BF16)
    x = flat[offset:offset + 8 * 1024].view(8, 1024)
    want = row_topk_ref(x, 26)
    for fn in (row_topk_loop_cuda, row_topk_threshold_cuda):
        for a, b in zip(fn(x.cuda(), 26), want):
            assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))


def _bf16_fused_edges():
    """(label, m, g (float32 CPU tensors), eta, k) at the edges of the
    fused kernel's bf16 form: the float32 form's edges (eta 0 and 0.37,
    not exact in bf16; k > 256 and k = C; ties; +-inf), the paths' k,
    C % 8 != 0, the widest bf16 row."""
    rng = np.random.default_rng(41)
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    for label, m, g, eta, k in _fused_edges():
        yield label, torch.from_numpy(m), torch.from_numpy(g), eta, k
    for k in (10, 20):
        yield f"(8,1024) k={k}", f32(8, 1024), f32(8, 1024), 0.37, k
    yield "C % 8 != 0, C % 4 == 0", f32(6, 1020), f32(6, 1020), 0.37, 26
    C = MAX_COLS_BY_DTYPE[BF16]["threshold"]
    yield "widest bf16 row", f32(2, C), f32(2, C), 0.37, 300


BF16_FUSED_EDGES = [e[0] for e in _bf16_fused_edges()]


@pytest.mark.parametrize("g_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("selection", ["loop", "threshold"])
@pytest.mark.parametrize("label", BF16_FUSED_EDGES)
def test_bf16_fused_kernel_on_its_edges(label, selection, g_dtype):
    """The bf16 form (bf16 m, float32 or bf16 g), both branches, bitwise
    the plain version: u rounded in bf16 as the reference's, new_m and
    vals bf16."""
    _need_card()
    _, m, g, eta, k = next(e for e in _bf16_fused_edges() if e[0] == label)
    m, g = m.to(BF16), g.to(g_dtype)
    before = dict(SELECTION_LAUNCHES)
    got = fused_memsgd_cuda(m.cuda(), g.cuda(), eta, k, selection)
    assert {n: SELECTION_LAUNCHES[n] - before[n] for n in before} == {
        n: int(n == selection + "_bf16") for n in before}
    want = fused_memsgd_ref(m, g, eta, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("g_dtype", [torch.float32, BF16])
def test_bf16_fused_kernel_on_unaligned_rows(g_dtype):
    _need_card()
    m = torch.randn((8, 1024), generator=_gen(3)).to(BF16)
    g = torch.randn((8, 1024), generator=_gen(4)).to(g_dtype)
    want = fused_memsgd_ref(m, g, 0.37, 20)
    # m 2 bytes past 16-byte alignment: the lanes' plain loads and stores
    mc = torch.empty(8 * 1024 + 1, dtype=BF16, device="cuda")[1:].view(
        8, 1024).copy_(m)
    for sel in ("loop", "threshold"):
        got = fused_memsgd_cuda(mc, g.cuda(), 0.37, 20, sel)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))


def test_bf16_bucket_memory_step_on_the_card_matches_the_cpu():
    """``bucket_memory_step`` over bf16 memory: the sparse bucket through
    the bf16 fused kernel ("auto" at k = 8: the loop branch, by the bf16
    form's cutover), the dense bucket promoted to float32, as on the CPU,
    bit for bit."""
    _need_card()
    from repro_torch.core import buckets as bk

    rng = np.random.default_rng(9)
    tree = {"w": torch.from_numpy(rng.standard_normal((128, 256)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(64).astype(
            np.float32))}
    plan = bk.make_plan(tree, cols=512)
    mem = [torch.from_numpy(rng.standard_normal(s.shape).astype(
        np.float32)).to(BF16) for s in plan.buckets]
    out = {}
    for dev in ("cpu", "cuda"):
        before = SELECTION_LAUNCHES["loop_bf16"]
        applied, new_m, _ = bk.bucket_memory_step(
            plan, [m.to(dev) for m in mem], tree_map(lambda t: t.to(dev),
                                                     tree), 0.37,
            lambda c: c // 64)
        assert SELECTION_LAUNCHES["loop_bf16"] - before == int(
            dev == "cuda")
        out[dev] = [t.cpu() for t in tree_leaves(applied) + list(new_m)]
    for a, b in zip(out["cpu"], out["cuda"]):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


# ---------------------------------------------------------------------------
# Qsparse-local-SGD: the quantizer, the quantized sync and the accumulator
# ---------------------------------------------------------------------------


class _CpuDrawnNoise:
    """``QuantNoise``'s draws made on the CPU and moved to the device, so
    that the card and the CPU quantize on the same uniforms."""

    def __init__(self, seed, step):
        from repro_torch.optim.qsgd import QuantNoise

        self._noise = QuantNoise(seed, step)

    def uniforms(self, bucket, level, index, shape, device):
        return self._noise.uniforms(bucket, level, index, shape,
                                    "cpu").to(device)


def _quant_rows(kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((512, 10)).astype(np.float32)
    if kind == "dyadic":
        x = np.round(x * 8) / 8
    elif kind == "zeros":  # exact zeros, -0.0 and a zero row
        x[::3, ::2] = 0.0
        x[1::3, 1::2] = -0.0
        x[7] = 0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("s", [1, 15, 32767])
@pytest.mark.parametrize("kind", ["normal", "dyadic", "zeros"])
def test_quantizer_on_the_card_matches_the_cpu(kind, s):
    """``quantize_rows`` and ``dequantize_rows`` on the card on uniforms
    drawn on the CPU: the CPU's norms, codes and values bit for bit (the
    norm's fixed order and float64 root, the dequantization's two float32
    products)."""
    _need_card()
    from repro_torch.core.encoding import dequantize_rows
    from repro_torch.optim.qsgd import QuantNoise, quantize_rows

    vals = _quant_rows(kind, seed=s)
    u = QuantNoise(2, 3).uniforms(0, 1, 0, vals.shape, "cpu")
    got = quantize_rows(vals.cuda(), s, u.cuda())
    want = quantize_rows(vals, s, u)
    got += (dequantize_rows(*got, s),)
    want += (dequantize_rows(*want, s),)
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("wire", ["packed", "unpacked"])
@pytest.mark.parametrize("accumulate", [False, True])
def test_quantized_sync_on_the_card_matches_the_cpu(wire, accumulate):
    """The quantized bucketed sync at one worker on the same CPU-drawn
    uniforms, directly or through the local-step accumulator at H = 1:
    the card's update and memory the CPU's bit for bit, one fused launch
    on the card; the accumulator path the direct path's bit for bit
    (``accumulate_local``'s product and sum are two rounded ops on the
    card too)."""
    _need_card()
    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import (SyncConfig, WireConfig,
                                              bucketed_sync_gradients)

    rng = np.random.default_rng(4)
    tree = {"w": torch.from_numpy(rng.standard_normal((128, 256)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(64).astype(
            np.float32))}
    plan = bk.make_plan(tree, cols=512)
    mem = [torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32))
           for s in plan.buckets]
    cfg = SyncConfig(ratio=0.02, bucketed=True, bucket_cols=512,
                     wire=WireConfig(wire=wire, quant=15))
    out = {}
    for dev in ("cpu", "cuda"):
        for acc in sorted({False, accumulate}):
            g = tree_map(lambda t: t.to(dev), tree)
            kw = dict(quant_noise=_CpuDrawnNoise(5, 6))
            before = SELECTION_LAUNCHES["threshold"] + \
                SELECTION_LAUNCHES["loop"]
            if acc:
                bufs = bk.accumulate_local(plan, bk.init_local_accum(
                    plan, device=dev), g, 0.37)
                upd, new_m, _ = bucketed_sync_gradients(
                    cfg, plan, [m.to(dev) for m in mem], None, 1.0,
                    grad_bufs=bufs, **kw)
            else:
                upd, new_m, _ = bucketed_sync_gradients(
                    cfg, plan, [m.to(dev) for m in mem], g, 0.37, **kw)
            launched = (SELECTION_LAUNCHES["threshold"]
                        + SELECTION_LAUNCHES["loop"] - before)
            assert launched == int(dev == "cuda")
            out[dev, acc] = [t.cpu() for t in tree_leaves(upd) + list(new_m)]
    for key in out:
        for a, b in zip(out[key], out["cpu", False]):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_local_steps_launch_only_at_the_sync_step_on_the_card():
    """The qsparse_local step on the card (H = 2, the smoke config): the
    local step launches no kernel, the sync step the fused kernel once per
    sparse bucket; the accumulator after the local step within 1e-5
    relative L2 of the CPU's (one step's gradients, summed in each
    device's order), the sync step's loss within 1e-5 of the CPU's."""
    _need_card()
    from repro_torch.core import buckets as bk

    model = build_model(get_smoke_config("qwen3-4b").replace(
        compute_dtype="float32"))
    sync = SyncConfig.preset("qsparse_local", ratio=0.02, local_steps=2)
    tc = TrainConfig(eta=0.5, sync=sync)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b, _ in zip(token_batches(model.cfg.vocab_size, 2, 32,
                                             seed=0), range(2))]
    host = model.init(seed=0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        params, memory, opt, count = init_train_state(
            model, tc, device=dev,
            params=tree_map(lambda t: t.to(dev, copy=True), host))
        step = make_train_step(model, tc)
        acc = bk.init_local_accum(step.plan, device=dev)
        before = dict(SELECTION_LAUNCHES)
        b0 = {k: v.to(dev) for k, v in batches[0].items()}
        params, memory, acc, opt, count, _ = step.accum(params, memory, acc,
                                                        opt, count, b0)
        local = {n: SELECTION_LAUNCHES[n] - before[n] for n in before}
        kept = [a.cpu().clone() for a in acc]
        b1 = {k: v.to(dev) for k, v in batches[1].items()}
        params, memory, acc, opt, count, met = step(params, memory, acc,
                                                    opt, count, b1)
        synced = {n: SELECTION_LAUNCHES[n] - before[n] - local[n]
                  for n in before}
        out[dev] = (local, synced, kept, met["loss"])
        assert count == 2 and all(float(a.abs().max()) == 0 for a in acc)
    n_sparse = sum(s.kind == "sparse" for s in step.plan.buckets)
    assert not any(out["cuda"][0].values())
    assert sum(out["cuda"][1].values()) == n_sparse
    assert not any(out["cpu"][0].values()) and not any(out["cpu"][1].values())
    l_cpu, l_gpu = float(out["cpu"][3]), float(out["cuda"][3])
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    # one step's gradients on the two devices: within float32 rounding
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        assert float((a - b).norm() / b.norm().clamp(min=1e-30)) < 1e-5


# -- the serving side ---------------------------------------------------------

# arch -> (smoke config overrides, decode steps, max_len): each KV ring
# wraps (qwen3-4b's window of 8; griffin's local attention window of 64)
SERVE_FAMILIES = {
    "qwen3-4b": (dict(sliding_window=8), 12, 16),
    "granite-moe-3b-a800m": ({}, 8, 16),
    "rwkv6-3b": ({}, 10, 16),
    "recurrentgemma-9b": (dict(n_layers=3), 70, 80),
}


@pytest.mark.parametrize("arch", list(SERVE_FAMILIES))
def test_decode_on_the_card_matches_the_cpu(arch):
    """Float32 decode of each family on the card and on the CPU from the
    same params: every step's logits and the final caches within rtol
    1e-4, atol 1e-4 of the largest (products summed in other orders)."""
    _need_card()
    over, S, max_len = SERVE_FAMILIES[arch]
    cfg = get_smoke_config(arch).replace(compute_dtype="float32", **over)
    model = build_model(cfg)
    host = model.init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32))
    out = {}
    for d in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(d, copy=True), host)
        cache = model.init_cache(2, max_len, torch.float32, device=d)
        logits = []
        for t in range(S):
            lg, cache = model.decode_step(params, cache, toks[:, t].to(d))
            logits.append(lg.cpu())
        out[d] = (torch.stack(logits, 1),
                  [x.cpu() for x in tree_leaves(cache)
                   if isinstance(x, torch.Tensor)])
    want, got = out["cpu"], out["cuda"]
    for g, w in zip([got[0]] + got[1], [want[0]] + want[1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


def _serve_stream(d):
    """A rwkv6-3b smoke plan's delta spec (W = 2, ratio 0.05) and seeded
    update buffers with support <= each wire's k', on ``d``."""
    from repro_torch.core import buckets as bk
    from repro_torch.launch import delta_stream as ds

    model = build_model(get_smoke_config("rwkv6-3b"))
    plan = bk.make_plan(model.param_shapes())
    dspec = ds.make_delta_spec(plan, SyncConfig(ratio=0.05, bucketed=True),
                               workers=2)
    gen = torch.Generator().manual_seed(4)
    bufs = []
    for spec, w in zip(plan.buckets, dspec.wires):
        g = torch.randn(spec.shape, generator=gen)
        if spec.kind == "sparse":
            vals, idx = row_topk_ref(g, w.k)
            g = torch.zeros_like(g).scatter_(1, idx.long(), vals)
        bufs.append(g.to(d))
    return model, dspec, bufs


def test_delta_encode_and_apply_on_the_card_match_the_cpu():
    """``encode_delta_bufs`` (the row top-k kernel's re-select), the bf16
    transcode and ``apply_delta`` on the card: the CPU's bytes and params
    bit for bit, the re-select counted as a kernel launch."""
    _need_card()
    from repro_torch.launch import delta_stream as ds

    model, dspec, bufs = _serve_stream("cpu")
    want = ds.encode_delta_bufs(dspec, bufs)
    before = sum(LAUNCHES.values())
    got = ds.encode_delta_bufs(dspec, [b.cuda() for b in bufs])
    n_sparse = sum(w.kind == "sparse" for w in dspec.wires)
    assert sum(LAUNCHES.values()) == before + n_sparse
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    for g, w in zip(ds.transcode_delta(dspec, got),
                    ds.transcode_delta(dspec, want)):
        assert torch.equal(g.cpu(), w)
    host = model.init(seed=0, device="cpu")
    card = tree_map(lambda t: t.cuda(), host)
    ds.apply_delta(host, dspec, want)
    ds.apply_delta(card, dspec, got)
    for a, b in zip(tree_leaves(card), tree_leaves(host)):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_snapshot_codec_on_the_card_matches_the_cpu(dtype):
    """Exact diff records (signed zeros, irregular support, row chunks)
    and the lossy top-k cap (the row top-k kernel) on the card: the CPU's
    bytes and decode bit for bit."""
    _need_card()
    from repro_torch.core import encoding as enc

    gen = torch.Generator().manual_seed(6)
    base = torch.randn((300, 1024), generator=gen).to(dtype)
    cur = base.clone()
    flip = torch.rand(base.shape, generator=gen) < 0.02
    cur[flip] = -cur[flip]
    cur[0, 7], base[0, 7] = -0.0, 0.0
    mem = (torch.randn((300, 1024), generator=gen) * 0.01).to(dtype)
    for kw, x in ((dict(base=base), cur), (dict(k=51), mem)):
        want = enc.snapshot_encode(x, **kw)
        got = enc.snapshot_encode(
            x.cuda(), **{k: (v.cuda() if torch.is_tensor(v) else v)
                         for k, v in kw.items()})
        assert got.spec == want.spec and got.exact == want.exact
        assert torch.equal(got.buf.cpu(), want.buf)
        assert abs(got.dropped_frac - want.dropped_frac) <= 1e-6
        dec = enc.snapshot_decode(got, base=kw["base"].cuda()
                                  if "base" in kw else None)
        assert torch.equal(dec.cpu().view(torch.uint8),
                           enc.snapshot_decode(want, base=kw.get("base"))
                           .view(torch.uint8))
