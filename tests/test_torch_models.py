"""The port's dense decoder against ``repro.models`` on the qwen3-4b smoke
config, from the reference's own init carried over through numpy.

Tolerances: in float32 compute the loss within rtol 1e-5 and each
gradient leaf within rtol 1e-4 (atol 1e-4 of the leaf's largest entry:
the two frameworks sum matrix products and reductions in other orders,
and the reference's RMSNorm has a hand-written backward). In the default
bfloat16 compute the loss within 2e-2: bf16 rounds at other places in the
two frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.models.model import _xent as ref_xent
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.data import token_batches
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.model import _xent
from repro_torch.utils.tree import tree_flatten, tree_leaves

ARCH = "qwen3-4b"


@pytest.fixture(scope="module")
def params_np():
    model = ref_build_model(ref_get_smoke_config(ARCH))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def batch_np():
    return next(token_batches(512, 2, 32, seed=3))


def _ref_loss_grads(dtype, params_np, batch_np):
    model = ref_build_model(
        ref_get_smoke_config(ARCH).replace(compute_dtype=dtype))
    fn = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    (loss, _), grads = fn(jax.tree.map(jnp.asarray, params_np),
                          {k: jnp.asarray(v) for k, v in batch_np.items()})
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_grads(dtype, params_np, batch_np):
    model = build_model(get_smoke_config(ARCH).replace(compute_dtype=dtype))
    leaves, treedef = tree_flatten(params_from_jax(params_np))
    live = [p.requires_grad_(True) for p in leaves]
    loss, _ = model.loss(treedef.unflatten(live),
                         {k: torch.from_numpy(v) for k, v in batch_np.items()})
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), [g.numpy() for g in grads]


def test_param_tree_matches_reference():
    """Same keys, shapes and dtypes; the port flattens in JAX's order
    (torch tensors are leaves to jax.tree)."""
    ref = ref_build_model(ref_get_smoke_config(ARCH)).param_shapes()
    got = build_model(get_smoke_config(ARCH)).param_shapes()
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    leaves, _ = tree_flatten(got)
    assert all(a is b for a, b in zip(leaves, jax.tree.leaves(got)))
    for a, b in zip(leaves, jax.tree.leaves(ref)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype) == f"torch.{b.dtype}"


def test_convert_roundtrip_is_bitwise(params_np):
    back = params_to_jax(params_from_jax(params_np))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_float32_loss_and_grads_match_reference(params_np, batch_np):
    want_loss, want_grads = _ref_loss_grads("float32", params_np, batch_np)
    loss, grads = _port_loss_grads("float32", params_np, batch_np)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for g, r in zip(grads, jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(r).max()))


def test_bfloat16_loss_matches_reference(params_np, batch_np):
    want_loss, _ = _ref_loss_grads("bfloat16", params_np, batch_np)
    loss, grads = _port_loss_grads("bfloat16", params_np, batch_np)
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
    cfg = get_smoke_config(ARCH)
    params = build_model(cfg).init(device="cpu")
    blk = {k: v[0] for k, v in params["blocks"]["attn"].items()}
    x = torch.zeros((1, 2049, cfg.d_model))
    with pytest.raises(NotImplementedError, match="blocked"):
        L.attention(blk, cfg, x, torch.zeros((1, 2049), dtype=torch.int32))


def test_own_init_is_seeded():
    model = build_model(get_smoke_config(ARCH))
    a, b = model.init(seed=1, device="cpu"), model.init(seed=1, device="cpu")
    c = model.init(seed=2, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
