"""The port's decoder transformer against ``repro.models`` on the smoke
configs, from the reference's own init carried over through numpy:
qwen3-4b, and the seven architectures of the MoE and the rest of the dense
family (``NEW_ARCHS``: qkv bias, prefix embeddings, MoE layers); every
architecture's config and full-width per-leaf bytes (recurrentgemma-9b's
model is held in ``tests/test_torch_griffin.py``).

Tolerances: in float32 compute the loss within rtol 1e-5 and each
gradient leaf within rtol 1e-4 (atol 1e-4 of the leaf's largest entry:
the two frameworks sum matrix products and reductions in other orders,
and the reference's RMSNorm has a hand-written backward); the MoE
configs' aux loss within rtol 1e-5. In the default bfloat16 compute the
loss within 2e-2: bf16 rounds at other places in the two frameworks.
Configs, parameter trees and the conversion round trip: exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.core.distributed import message_bytes as ref_message_bytes
from repro.launch.sharding import sync_col_axes as ref_sync_col_axes
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.models.model import _xent as ref_xent
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.distributed import SyncConfig, message_bytes
from repro_torch.launch.sharding import sync_col_axes
from repro_torch.data import token_batches
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.model import _xent
from repro_torch.utils.tree import tree_flatten, tree_leaves

ARCH = "qwen3-4b"
# the architectures this file holds beside qwen3-4b: the MoE family and
# the rest of the dense family
NEW_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b", "qwen1.5-4b",
             "yi-9b", "granite-3-8b", "internvl2-26b", "musicgen-medium")


@functools.cache
def _ref_params(arch):
    model = ref_build_model(ref_get_smoke_config(arch))
    return jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def params_np():
    return _ref_params(ARCH)


@pytest.fixture(scope="module")
def batch_np():
    return next(token_batches(512, 2, 32, seed=3))


def _ref_loss_grads(dtype, params_np, batch_np, arch=ARCH):
    model = ref_build_model(
        ref_get_smoke_config(arch).replace(compute_dtype=dtype))
    fn = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    (loss, metrics), grads = fn(
        jax.tree.map(jnp.asarray, params_np),
        {k: jnp.asarray(v) for k, v in batch_np.items()})
    return float(loss), jax.tree.map(np.asarray, grads), float(metrics["aux"])


def _port_loss_grads(dtype, params_np, batch_np, arch=ARCH):
    model = build_model(get_smoke_config(arch).replace(compute_dtype=dtype))
    leaves, treedef = tree_flatten(params_from_jax(params_np))
    live = [p.requires_grad_(True) for p in leaves]
    loss, metrics = model.loss(
        treedef.unflatten(live),
        {k: torch.from_numpy(v) for k, v in batch_np.items()})
    grads = torch.autograd.grad(loss, live)
    return (float(loss.detach()), [g.numpy() for g in grads],
            float(metrics["aux"].detach()))


def _check_param_tree(arch):
    """Same keys, shapes and dtypes; the port flattens in JAX's order
    (torch tensors are leaves to jax.tree)."""
    ref = ref_build_model(ref_get_smoke_config(arch)).param_shapes()
    got = build_model(get_smoke_config(arch)).param_shapes()
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    leaves, _ = tree_flatten(got)
    assert all(a is b for a, b in zip(leaves, jax.tree.leaves(got)))
    for a, b in zip(leaves, jax.tree.leaves(ref)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype) == f"torch.{b.dtype}"


def _check_convert_roundtrip(params_np):
    back = params_to_jax(params_from_jax(params_np))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _check_float32_loss_and_grads(params_np, batch_np, arch=ARCH):
    want_loss, want_grads, want_aux = _ref_loss_grads(
        "float32", params_np, batch_np, arch)
    loss, grads, aux = _port_loss_grads("float32", params_np, batch_np, arch)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5)
    assert (aux > 0) == (get_smoke_config(arch).moe is not None)
    for g, r in zip(grads, jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(r).max()))


def test_param_tree_matches_reference():
    _check_param_tree(ARCH)


def test_convert_roundtrip_is_bitwise(params_np):
    _check_convert_roundtrip(params_np)


def test_float32_loss_and_grads_match_reference(params_np, batch_np):
    _check_float32_loss_and_grads(params_np, batch_np)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_param_tree_matches_reference(arch):
    _check_param_tree(arch)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_convert_roundtrip_is_bitwise(arch):
    _check_convert_roundtrip(_ref_params(arch))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_float32_loss_and_grads_match_reference(arch, batch_np):
    """The MoE configs' loss carries their aux loss, summed over layers."""
    _check_float32_loss_and_grads(_ref_params(arch), batch_np, arch)


def test_prefix_embeds_match_reference(batch_np):
    """internvl2-26b's stub vision prefix: seeded embeddings replace the
    first P token positions (their labels ignored)."""
    arch = "internvl2-26b"
    cfg = get_smoke_config(arch)
    P = cfg.n_prefix_embeddings
    B = batch_np["tokens"].shape[0]
    batch = dict(batch_np)
    batch["prefix_embeds"] = np.random.default_rng(7).standard_normal(
        (B, P, cfg.d_model)).astype(np.float32)
    batch["labels"] = batch["labels"].copy()
    batch["labels"][:, :P] = -1
    _check_float32_loss_and_grads(_ref_params(arch), batch, arch)
    # the prefix changes the loss
    plain = {k: v for k, v in batch.items() if k != "prefix_embeds"}
    no_prefix, _, _ = _port_loss_grads("float32", _ref_params(arch), plain,
                                       arch)
    with_prefix, _, _ = _port_loss_grads("float32", _ref_params(arch), batch,
                                         arch)
    assert no_prefix != with_prefix


# the rest of the dense family and recurrentgemma-9b (griffin) at full
# width, depth cut as on the card:
# (layers, parameters, per-leaf bytes per step at ratio 0.01)
FULL_WIDTH = {"qwen1.5-4b": (2, 937_192_960, 76_257_280),
              "yi-9b": (2, 870_338_560, 69_775_360),
              "granite-3-8b": (2, 803_229_696, 64_401_408),
              "internvl2-26b": (1, 1_528_842_240, 121_503_744),
              "musicgen-medium": (2, 81_796_608, 6_420_480),
              "recurrentgemma-9b": (3, 2_753_654_784, 220_811_264)}


@pytest.mark.parametrize("arch", list(FULL_WIDTH))
def test_full_width_per_leaf_bytes_match_reference(arch):
    """Shapes only, nothing allocated: the parameter count, the per-leaf
    column axes and bytes per step equal the reference's and the figures
    the card's run checks."""
    n_layers, n_params, nbytes = FULL_WIDTH[arch]
    model = build_model(get_config(arch).replace(n_layers=n_layers))
    rmodel = ref_build_model(ref_get_config(arch).replace(n_layers=n_layers))
    shapes, ref_shapes = model.param_shapes(), rmodel.param_shapes()
    assert model.n_params() == rmodel.n_params() == n_params
    cols, ref_cols = sync_col_axes(shapes), ref_sync_col_axes(ref_shapes)
    assert cols == jax.tree.map(int, ref_cols)
    got = message_bytes(SyncConfig(ratio=0.01), shapes, cols)
    want = ref_message_bytes(RefSyncConfig(ratio=0.01), ref_shapes, ref_cols)
    assert got == int(want) == nbytes


def _shared_fields(x, other):
    """``x``'s dataclass fields that ``other`` also defines, as a dict
    (nested configs as dicts)."""
    return {f.name: (_shared_fields(v, getattr(other, f.name))
                     if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(x) if hasattr(other, f.name)
            for v in (getattr(x, f.name),)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    """Every ported architecture's config() and smoke_config() equal the
    reference's, field for field, over the fields both define (the hybrid
    config of recurrentgemma-9b too); the port leaves out only the
    reference's remat field, which serves its dry-run."""
    for ours, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_smoke_config(arch), ref_get_smoke_config(arch))):
        assert _shared_fields(ours, ref) == _shared_fields(ref, ours)
        missing = {f.name for f in dataclasses.fields(ref)} - {
            f.name for f in dataclasses.fields(ours)}
        assert missing == {"remat"}
        assert ref.remat == "none"
        assert (ours.hybrid is None) == (ref.hybrid is None) == (
            ref.family != "hybrid")
        if ref.hybrid is not None:
            assert dataclasses.asdict(ours.hybrid) == dataclasses.asdict(
                ref.hybrid)


def test_registry_is_the_reference_s():
    assert ARCH_IDS == REF_ARCH_IDS
    for arch, family in (("qwen3-moe-30b-a3b", "moe"),
                         ("recurrentgemma-9b", "hybrid")):
        assert build_model(get_smoke_config(arch)).cfg.family == family
    unknown = ModelConfig(arch_id="x", family="ssm", n_layers=2, d_model=256,
                          n_heads=4, n_kv_heads=1, d_ff=512, vocab_size=512)
    with pytest.raises(ValueError, match="unknown family 'ssm'"):
        build_model(unknown)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("recurrentgemma-2b")


def test_bfloat16_loss_matches_reference(params_np, batch_np):
    want_loss, _, _ = _ref_loss_grads("bfloat16", params_np, batch_np)
    loss, grads, _ = _port_loss_grads("bfloat16", params_np, batch_np)
    assert abs(loss - want_loss) <= 2e-2, (loss, want_loss)
    assert all(np.isfinite(g).all() for g in grads)


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    scale = rng.standard_normal((64,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    np.testing.assert_allclose(
        L.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x), 1e-6).numpy(),
        np.asarray(RL.rmsnorm(jnp.asarray(scale), jnp.asarray(x), 1e-6)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                     1e6).numpy(),
        np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    k = rng.standard_normal((2, 16, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 64)).astype(np.float32)
    got = L._sdpa(torch.from_numpy(x), torch.from_numpy(k),
                  torch.from_numpy(v), L.causal_mask(16, 5), 2)
    want = RL._sdpa(jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
                    RL.causal_mask(16, 5), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_xent_masks_the_padded_vocab():
    cfg = get_smoke_config(ARCH).replace(vocab_size=500)  # padded to 512
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 8, 512)).astype(np.float32)
    labels = rng.integers(0, 500, (2, 8)).astype(np.int32)
    labels[0, :3] = -1  # ignored positions
    loss, n = _xent(cfg, torch.from_numpy(logits), torch.from_numpy(labels))
    want, wn = ref_xent(ref_get_smoke_config(ARCH).replace(vocab_size=500),
                        jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    assert float(n) == float(wn) == 13


def test_long_sequences_raise():
    """Above 2048 positions attention takes the blocked path, whose blocks
    of 1024 must tile the sequence, as the reference's reshape needs: 2049
    raises by name (tests/test_torch_griffin.py holds the blocked path
    against the reference's)."""
    cfg = get_smoke_config(ARCH)
    params = build_model(cfg).init(device="cpu")
    blk = {k: v[0] for k, v in params["blocks"]["attn"].items()}
    x = torch.zeros((1, 2049, cfg.d_model))
    with pytest.raises(ValueError, match="blocked attention over S=2049"):
        L.attention(blk, cfg, x, torch.zeros((1, 2049), dtype=torch.int32))


def test_own_init_is_seeded():
    model = build_model(get_smoke_config(ARCH))
    a, b = model.init(seed=1, device="cpu"), model.init(seed=1, device="cpu")
    c = model.init(seed=2, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
