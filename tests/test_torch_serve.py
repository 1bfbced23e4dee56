"""The port's serving side (``repro_torch.launch.serve``, the models'
decode halves) against ``repro.models`` / ``repro.launch.serve`` on the
CPU.

The weights are the reference's own init carried over through numpy
(``convert.params_from_jax``), the tokens numpy draws from a seed. Each
family decodes token by token through both packages: qwen3-4b with a
sliding window of 8 (its KV ring wraps at the ninth token),
granite-moe-3b-a800m (the MoE layer at S == 1: the batch's tokens route
as one group), rwkv6-3b, and recurrentgemma-9b at 3 layers (``rec, rec,
attn``) past its local attention's window of 64 (70 tokens: the ring
wraps at the 65th). Tolerances on every step's logits and on the final
caches:

- float32 compute and cache: rtol 1e-4, atol 1e-4 of the largest
  |value|, the float32 gradient tolerance of each family's forward test
  (the two frameworks sum products in other orders; measured at most
  1.5e-5 of the largest);
- float32 compute with the default bf16 cache: rtol 1e-2, atol 1e-2 of
  the largest. Both round k, v and the conv inputs to bf16 at the same
  points, but the attention's probabilities then round to the cache's
  bf16 and its bf16 product is summed in other orders: a bf16 ulp of the
  attention output (measured at most 6e-4 of the largest logit);
- bf16 compute and cache (the defaults): rtol 0.1, atol 0.15, the
  tolerance the reference's own decode-against-forward tests hold (bf16
  rounds at other places in the two frameworks; measured at most 4 bf16
  ulps of the largest logit).

The greedy tokens must be equal wherever the reference's top-2 margin
exceeds the tolerance; the smallest margin is printed. The decode
against the port's own forward mirrors the reference's tests of it
(``tests/test_attention.py``, ``test_recurrent_models.py``,
``test_models_smoke.py``) at their tolerances; ``prefill_logits`` is held
against the reference's at the decode's tolerances.
"""
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import build_model as ref_build_model
from repro.models import griffin as RG
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.distributed import SyncConfig
from repro_torch.data import DeviceBatcher, token_batches
from repro_torch.launch import serve
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models import build_model
from repro_torch.models import griffin as PG
from repro_torch.utils.tree import tree_leaves

B = 2
# arch -> (config overrides, decode steps, max_len): each ring wraps
FAMILIES = {
    "qwen3-4b": (dict(sliding_window=8), 12, 16),
    "granite-moe-3b-a800m": ({}, 8, 16),
    "rwkv6-3b": ({}, 10, 16),
    "recurrentgemma-9b": (dict(n_layers=3), 70, 80),
}
# (compute dtype, cache dtype) -> (rtol, atol as a fraction of the
# largest |value| or absolute)
DTYPES = {("float32", "float32"): (1e-4, 1e-4, True),
          ("float32", "bfloat16"): (1e-2, 1e-2, True),
          ("bfloat16", "bfloat16"): (0.1, 0.15, False)}


def _config(arch, compute, ref=False):
    over, _, _ = FAMILIES[arch]
    get = ref_get_smoke_config if ref else get_smoke_config
    return get(arch).replace(compute_dtype=compute, **over)


@functools.cache
def _ref_params(arch):
    model = ref_build_model(_config(arch, "float32", ref=True))
    return jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0)))


def _tokens(arch, S, seed=3):
    vocab = get_smoke_config(arch).vocab_size
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S)).astype(np.int32)


def _cache_leaves(cache):
    """The cache's tensors (not the index), as float32 numpy."""
    return [np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
            else x.float().numpy() for x in tree_leaves(cache)
            if getattr(x, "ndim", 0) > 0]


@functools.cache
def _decode_both(arch, compute, cache_dtype):
    """Every step's logits of both packages and their final caches."""
    _, S, max_len = FAMILIES[arch]
    toks = _tokens(arch, S)
    rmodel = ref_build_model(_config(arch, compute, ref=True))
    pmodel = build_model(_config(arch, compute))
    rp = jax.tree.map(jnp.asarray, _ref_params(arch))
    pp = params_from_jax(_ref_params(arch))
    rcache = rmodel.init_cache(B, max_len, getattr(jnp, cache_dtype))
    pcache = pmodel.init_cache(B, max_len, getattr(torch, cache_dtype),
                               device="cpu")
    step = jax.jit(rmodel.decode_step)
    rl, pl = [], []
    for t in range(S):
        lg, rcache = step(rp, rcache, jnp.asarray(toks[:, t]))
        rl.append(lg)
        lg, pcache = pmodel.decode_step(pp, pcache,
                                        torch.from_numpy(toks[:, t]))
        pl.append(lg.float().numpy())
    assert pcache["index"] == int(rcache["index"]) == S
    rl = [np.asarray(x, np.float32) for x in rl]
    return (np.stack(rl, 1), np.stack(pl, 1), _cache_leaves(rcache),
            _cache_leaves(pcache))


def _close(got, want, rtol, atol, relative):
    atol = atol * float(np.abs(want).max()) if relative else atol
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    return atol


@pytest.mark.parametrize("dtypes", list(DTYPES), ids="-".join)
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_decode_matches_reference(arch, dtypes):
    """Every step's logits, the final caches (ring wrapped), and the
    greedy tokens where the reference's top-2 margin exceeds the
    tolerance."""
    rtol, atol, relative = DTYPES[dtypes]
    ref_logits, logits, ref_cache, cache = _decode_both(arch, *dtypes)
    tol = _close(logits, ref_logits, rtol, atol, relative)
    assert len(cache) == len(ref_cache)
    for got, want in zip(cache, ref_cache):
        assert got.shape == want.shape
        _close(got, want, rtol, atol, relative)
    V = get_smoke_config(arch).vocab_size
    real = ref_logits[..., :V]
    top2 = np.sort(real, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    want_tok = np.argmax(real, axis=-1)
    got_tok = serve.greedy_tokens(torch.from_numpy(logits), V).numpy()
    sure = margin > 2 * tol
    assert sure.any()
    np.testing.assert_array_equal(got_tok[sure], want_tok[sure])
    print(f"{arch} {dtypes}: smallest top-2 margin {margin.min():.3g}, "
          f"{int(sure.sum())} of {sure.size} tokens past 2x the tolerance "
          f"{tol:.3g}")


def test_kv_ring_wraps_at_the_window():
    """The caches the decode test compares are rings: qwen3-4b holds 8
    slots for 12 tokens, griffin's attention layer 64 for 70."""
    cache = build_model(_config("qwen3-4b", "float32")).init_cache(
        B, 16, device="cpu")
    assert cache["k"].shape[2] == 8 and FAMILIES["qwen3-4b"][1] > 8
    layers = build_model(_config("recurrentgemma-9b", "float32")).init_cache(
        B, 80, device="cpu")["layers"]
    assert layers[2]["k"].shape[1] == 64
    assert FAMILIES["recurrentgemma-9b"][1] > 64


def test_rg_lru_step_and_recurrent_block_step_match_reference():
    """The RG-LRU's step and the recurrent block's step (the conv's
    window summed at once) against the reference's on float32 inputs:
    rtol 1e-5, atol 1e-6."""
    cfg = _config("recurrentgemma-9b", "float32")
    R, W, D = cfg.hybrid.lru_width, cfg.hybrid.conv_width, cfg.d_model
    rcfg = _config("recurrentgemma-9b", "float32", ref=True)
    rp = jax.tree.map(np.asarray, jax.jit(
        lambda key: RG.init_recurrent_block(key, rcfg, jnp.float32))(
            jax.random.PRNGKey(0)))
    pp = params_from_jax(rp)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    h = rng.standard_normal((B, R)).astype(np.float32)
    conv = rng.standard_normal((B, W - 1, R)).astype(np.float32)
    y_r, h_r = jax.jit(RG.rg_lru_step)(rp, jnp.asarray(x[:, 0, :R]),
                                       jnp.asarray(h))
    y_p, h_p = PG.rg_lru_step(pp, torch.from_numpy(x[:, 0, :R]),
                              torch.from_numpy(h))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_r), rtol=1e-5,
                               atol=1e-6)
    o_r, s_r = jax.jit(RG.recurrent_block_step)(rp, jnp.asarray(x), {
        "h": jnp.asarray(h), "conv": jnp.asarray(conv)})
    o_p, s_p = PG.recurrent_block_step(pp, torch.from_numpy(x), {
        "h": torch.from_numpy(h), "conv": torch.from_numpy(conv)})
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_r), rtol=1e-5,
                               atol=1e-5)
    for k in ("h", "conv"):
        np.testing.assert_allclose(s_p[k].numpy(), np.asarray(s_r[k]),
                                   rtol=1e-5, atol=1e-6)


# -- decode against the port's own forward ------------------------------------


def _decode_all(model, params, toks, max_len):
    cache = model.init_cache(toks.shape[0], max_len, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = model.decode_step(params, cache, toks[:, t])
        outs.append(lg)
    return torch.stack(outs, 1), cache


@pytest.mark.parametrize("arch,over,Bs,S,max_len,atol", [
    ("yi-9b", {}, 2, 12, 16, 0.15),  # tests/test_attention.py:52
    ("qwen3-4b", dict(sliding_window=8), 1, 16, 16, 0.15),  # :76
    ("rwkv6-3b", {}, 2, 16, 16, 0.2),  # tests/test_recurrent_models.py:59
    ("recurrentgemma-9b", {}, 2, 12, 12, 0.2),  # :134
])
def test_decode_matches_own_forward(arch, over, Bs, S, max_len, atol):
    """Token-by-token decode through the cache reproduces the full
    forward's logits (the reference's tests, bf16 defaults, rtol 0.1)."""
    cfg = get_smoke_config(arch).replace(**over)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (Bs, S), generator=gen)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks})
        dec, cache = _decode_all(model, params, toks, max_len)
    if over.get("sliding_window"):
        assert cache["k"].shape[2] == over["sliding_window"]  # a ring
    np.testing.assert_allclose(dec.float().numpy(), full.float().numpy(),
                               atol=atol, rtol=0.1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_decode_step(arch):
    """tests/test_models_smoke.py:72: one decode step of each smoke
    config gives finite (2, V_padded) logits and advances the index."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    cache = model.init_cache(2, 64, device="cpu")
    with torch.no_grad():
        logits, cache2 = model.decode_step(
            params, cache, torch.zeros((2,), dtype=torch.int32))
    assert logits.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())
    assert cache2["index"] == 1


def test_cache_shapes_are_meta_and_match_reference():
    """``cache_shapes`` gives the caches' shapes and dtypes on the meta
    device, the reference's ``eval_shape`` of them (its ``index`` a host
    int here)."""
    for arch in FAMILIES:
        cfg = _config(arch, "bfloat16")
        got = [x for x in tree_leaves(build_model(cfg).cache_shapes(2, 80))
               if isinstance(x, torch.Tensor)]
        want = [x for x in jax.tree.leaves(ref_build_model(_config(
            arch, "bfloat16", ref=True)).cache_shapes(2, 80)) if x.ndim > 0]
        assert all(x.device.type == "meta" for x in got)
        assert [tuple(x.shape) for x in got] == [x.shape for x in want]
        assert [str(x.dtype) for x in got] == [f"torch.{x.dtype}"
                                              for x in want]


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-3b",
                                  "recurrentgemma-9b"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_prefill_logits_match_reference(arch, compute):
    """``prefill_logits`` (the LM head on the last position only; qwen3-4b
    with its window of 8 binding at 24 tokens) against the reference's,
    and against the tail of the port's own forward."""
    cfg = _config(arch, compute)
    rmodel = ref_build_model(_config(arch, compute, ref=True))
    params_np = _ref_params(arch)
    toks = _tokens(arch, 24, seed=1)
    want = np.asarray(jax.jit(rmodel.prefill_logits)(
        jax.tree.map(jnp.asarray, params_np), {"tokens": jnp.asarray(toks)}),
        np.float32)
    model = build_model(cfg)
    params = params_from_jax(params_np)
    step = serve.make_prefill_step(
        model, ShapeConfig("smoke_prefill", 24, B, "prefill"))
    with torch.no_grad():
        got = step(params, {"tokens": torch.from_numpy(toks)}).float()
        full, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, cfg.padded_vocab)
    rtol, atol, relative = DTYPES[compute, compute]
    _close(got.numpy(), want, rtol, atol, relative)
    np.testing.assert_allclose(got.numpy(), full[:, -1].float().numpy(),
                               atol=1e-2, rtol=1e-2)
    with pytest.raises(ValueError):
        step(params, {"tokens": torch.from_numpy(toks[:, :8])})


def test_shapes_registry_matches_reference():
    from repro.configs import SHAPES as REF_SHAPES

    assert {k: (s.name, s.seq_len, s.global_batch, s.kind, s.is_decode)
            for k, s in SHAPES.items()} == {
        k: (s.name, s.seq_len, s.global_batch, s.kind, s.is_decode)
        for k, s in REF_SHAPES.items()}


# -- the serve loop ----------------------------------------------------------


def test_greedy_masks_the_padded_vocab_and_ties_to_the_first_index():
    logits = torch.tensor([[1.0, 3.0, 3.0, 9.0], [2.0, 0.5, 2.0, 7.0]])
    assert serve.greedy_tokens(logits, 3).tolist() == [1, 0]


def test_decode_loop_matches_reference():
    """``decode_loop`` teacher-forces the prompt and generates greedily,
    as the reference's on the same weights (float32, qwen3-4b with its
    ring)."""
    from repro.launch.serve import decode_loop as ref_decode_loop
    from repro.utils.compat import make_mesh

    arch = "qwen3-4b"
    prompts = _tokens(arch, 6, seed=9)
    want = np.asarray(ref_decode_loop(
        ref_build_model(_config(arch, "float32", ref=True)),
        make_mesh((1, 1), ("data", "model")),
        jax.tree.map(jnp.asarray, _ref_params(arch)), jnp.asarray(prompts),
        n_tokens=10, max_len=16, cache_dtype=jnp.float32))
    got = serve.decode_loop(build_model(_config(arch, "float32")),
                            params_from_jax(_ref_params(arch)),
                            torch.from_numpy(prompts), n_tokens=10,
                            max_len=16, cache_dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (B, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_ep_raises_by_name():
    model = build_model(get_smoke_config("granite-moe-3b-a800m"))
    with pytest.raises(NotImplementedError, match="model axis"):
        serve.make_serve_step(model, 2, moe_ep=True)
    with pytest.raises(NotImplementedError, match="model axis"):
        serve.make_prefill_step(model, SHAPES["prefill_32k"], moe_ep=True)


def test_init_cache_defaults_to_the_card():
    """Without a device the caches go to CUDA, which raises by name here
    (no GPU)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for arch in FAMILIES:
        with pytest.raises(RuntimeError, match="no GPU"):
            build_model(get_smoke_config(arch)).init_cache(2, 16)
    from repro_torch.models import griffin, rwkv, transformer

    builders = [
        lambda: transformer.init_cache(get_smoke_config("qwen3-4b"), 2, 16),
        lambda: rwkv.init_state(get_smoke_config("rwkv6-3b"), 2),
        lambda: griffin.init_state(get_smoke_config("recurrentgemma-9b"), 2,
                                   16)]
    for build in builders:
        with pytest.raises(RuntimeError, match="no GPU"):
            build()


def test_end_to_end_train_checkpoint_serve():
    """tests/test_system.py:29 in process: train 25 steps with dense
    checkpoints every 10, round-trip the final params exactly, serve from
    them."""
    cfg = get_smoke_config("granite-3-8b")
    model = build_model(cfg)
    tc = TrainConfig(optimizer="memsgd", eta=0.5, sync=SyncConfig(ratio=0.02))
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp, max_to_keep=2)
        batches = DeviceBatcher(token_batches(cfg.vocab_size, 4, 64, seed=0),
                                "cpu")
        params, memory, opt, count, history = train(
            model, tc, batches, n_steps=25, device="cpu", checkpointer=ck,
            ckpt_every=10, log_every=0)
        batch = {k: torch.from_numpy(v) for k, v in next(
            token_batches(cfg.vocab_size, 4, 64, seed=0)).items()}
        with torch.no_grad():
            final_loss = float(model.loss(params, batch)[0])
            init_loss = float(model.loss(model.init(seed=0, device="cpu"),
                                         batch)[0])
        assert final_loss < init_loss
        assert ck.steps() == [10, 20] and ck.latest_step() == 20
        ck.save(25, {"params": params})
        restored, meta = ck.restore(like={"params": params})
        assert meta["step"] == 25
        for a, b in zip(tree_leaves(restored["params"]), tree_leaves(params)):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        prompts = torch.zeros((2, 4), dtype=torch.int32)
        toks = serve.decode_loop(model, params, prompts, n_tokens=5,
                                 max_len=32)
        assert toks.shape == (2, 5)
        assert int(toks.max()) < cfg.vocab_size
