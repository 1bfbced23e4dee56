"""Where the float32 gradients of rwkv6-3b's smoke model lose precision,
in the JAX reference and in the port, on the CPU.

Each float32 evaluation is held against a float64 evaluation of the same
model (the port with every float32 cast point of the WKV, the norms and
the loss raised to float64), from the reference's init, on one batch per
seed. Prints, per seed, the largest gap of any gradient leaf relative to
the leaf's largest entry, and the leaf:

- the reference in float32 and the port in float32, and the two against
  each other;
- the port with a literal per-chunk port of the reference's scan body in
  place of its batched chunks (the chunked form's association);
- the port with every matrix product rounded from float64, and with the
  decay LoRA's first product alone so rounded (the CPU BLAS);
- the float64 evaluation with one piece at a time in float32: the WKV,
  the matrix products, the ddlerp token shift, the two norms;

then the rounding of one float32 matrix product in each library against
float64, at the smoke model's narrow shapes and at full width.

    PYTHONPATH=src python tools/rwkv_grad_precision.py [--seeds 3,4,5,7]

Seed 3 is the batch of tests/test_torch_rwkv.py. About 15 s a seed.
"""
from __future__ import annotations

import argparse
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data import token_batches
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import rwkv as PW
from repro_torch.utils.tree import tree_flatten

ARCH = "rwkv6-3b"
F64 = torch.float64


def ref_grads(params_np, batch):
    model = ref_build_model(
        ref_get_smoke_config(ARCH).replace(compute_dtype="float32"))
    fn = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    _, g = fn(jax.tree.map(jnp.asarray, params_np),
              {k: jnp.asarray(v) for k, v in batch.items()})
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(g)]


def port_grads(params_np, batch, dtype="float32"):
    model = build_model(get_smoke_config(ARCH).replace(compute_dtype=dtype))
    leaves, treedef = tree_flatten(params_from_jax(params_np))
    live = [p.to(getattr(torch, dtype)).requires_grad_(True) for p in leaves]
    loss, _ = model.loss(treedef.unflatten(live),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    return [g.to(F64).numpy() for g in torch.autograd.grad(loss, live)]


@contextlib.contextmanager
def patched(obj, **attrs):
    old = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


def _rmsnorm64(scale, x, eps=1e-6):
    xf = x.to(F64)
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return out.to(x.dtype) * scale.to(x.dtype)


def _groupnorm64(scale, x, eps=1e-5):
    xc = x.to(F64) - torch.mean(x.to(F64), dim=-1, keepdim=True)
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * scale.to(F64)).to(x.dtype)


def _xent64(cfg, logits, labels):
    logits = logits.to(F64)
    labels = labels.to(torch.int64)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(F64)
    n = mask.sum().clamp(min=1.0)
    return ((torch.logsumexp(logits, dim=-1) - ll) * mask).sum() / n, n


def float64_grads(params_np, batch, **one_piece_in_float32):
    """The port in float64 throughout, but for the pieces given (module ->
    attributes to patch in)."""
    with patched(PW, _F32=F64), \
            patched(L, rmsnorm=_rmsnorm64, groupnorm_heads=_groupnorm64), \
            patched(M, _xent=_xent64), contextlib.ExitStack() as stack:
        for mod, attrs in one_piece_in_float32.values():
            stack.enter_context(patched(mod, **attrs))
        return port_grads(params_np, batch, "float64")


def _f32(t):
    return t.float() if torch.is_tensor(t) and t.is_floating_point() else t


def _wkv32(r, k, v, log_w, bonus, state, chunk):
    o, S = _WKV(*map(_f32, (r, k, v, log_w, bonus, state)), chunk)
    return o.to(r.dtype), S.to(r.dtype)


def _ddlerp32(p, x, x_prev):
    return tuple(o.to(x.dtype) for o in _DDLERP(
        {k: _f32(v) for k, v in p.items()}, _f32(x), _f32(x_prev)))


def _matmul32(a, b):
    class Rounded(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return _matmul(a.float(), b.float()).to(a.dtype)

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            return (_matmul(g, b.mT),
                    _matmul(a.reshape(-1, a.shape[-1]).T,
                            g.reshape(-1, g.shape[-1])))

    return Rounded.apply(a, b)


_WKV, _DDLERP, _RMS, _GN = (PW.wkv_chunked, PW._ddlerp, L.rmsnorm,
                            L.groupnorm_heads)
PIECES = {
    "the WKV": (PW, dict(wkv_chunked=_wkv32)),
    "the products' forward": (torch.Tensor, dict(__matmul__=_matmul32)),
    "the ddlerp": (PW, dict(_ddlerp=_ddlerp32)),
    "the norms": (L, dict(rmsnorm=_RMS, groupnorm_heads=_GN)),
}


def wkv_literal(r, k, v, log_w, bonus, state, chunk):
    """The reference's scan body, one chunk at a time."""
    B, T, H, n = r.shape
    NC = T // chunk
    rs, ks, vs, lw = (a.to(torch.float32).reshape(B, NC, chunk, H, n)
                      .movedim(1, 0) for a in (r, k, v, log_w))
    u, S = bonus.to(torch.float32), state.to(torch.float32)
    tri = torch.tril(torch.ones((chunk, chunk)), -1)
    outs = []
    for c in range(NC):
        rc, kc, vc, lwc = rs[c], ks[c], vs[c], lw[c]
        cum = torch.cumsum(lwc, 1)
        q, kap = rc * torch.exp(cum - lwc), kc * torch.exp(-cum)
        att = torch.einsum("bchi,bshi->bhcs", q, kap) * tri
        outs.append(torch.einsum("bchi,bhij->bchj", q, S)
                    + torch.einsum("bhcs,bshj->bchj", att, vc)
                    + torch.sum(rc * (u * kc), -1, keepdim=True) * vc)
        S = (torch.exp(cum[:, -1])[..., None] * S + torch.einsum(
            "bshi,bshj->bhij", kc * torch.exp(cum[:, -1:] - cum), vc))
    return torch.stack(outs, 1).reshape(B, T, H, n).to(r.dtype), S


_matmul = torch.Tensor.__matmul__


def _matmul64(a, b):
    """a @ b with float64 accumulation, rounded once to a's dtype; the
    gradients are formed the same way."""
    class Exact(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return _matmul(a.to(F64), b.to(F64)).to(a.dtype)

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            ga = _matmul(g.to(F64), b.to(F64).mT).to(a.dtype)
            gb = _matmul(a.to(F64).reshape(-1, a.shape[-1]).T,
                         g.to(F64).reshape(-1, g.shape[-1]))
            return ga, gb.to(b.dtype)

    return Exact.apply(a, b)


def _decay_log_exact(p, xw):
    lora = torch.tanh(_matmul64(xw, p["decay_w1"])) @ p["decay_w2"]
    return -PW.DECAY_CLAMP * torch.sigmoid((p["w0"] + lora).to(torch.float32))


def worst(grads, truth, names):
    errs = [float(np.abs(g - t).max() / np.abs(t).max())
            for g, t in zip(grads, truth)]
    i = int(np.argmax(errs))
    return f"{errs[i]:.3g} ({names[i]})"


def matmul_rounding(seed=0):
    rng = np.random.default_rng(seed)
    for M_, K, N in ((64, 256, 8), (64, 256, 20), (64, 256, 256),
                     (2048, 2560, 64), (2048, 2560, 2560)):
        e = {"torch": 0.0, "jax": 0.0}
        for _ in range(5):
            a = rng.standard_normal((M_, K)).astype(np.float32)
            b = (rng.standard_normal((K, N)) / 16).astype(np.float32)
            exact = a.astype(np.float64) @ b.astype(np.float64)
            got = {"torch": (torch.from_numpy(a) @ torch.from_numpy(b)).numpy(),
                   "jax": np.asarray(jnp.asarray(a) @ jnp.asarray(b))}
            for k, v in got.items():
                e[k] = max(e[k], float(np.abs(v - exact).max()
                                       / np.abs(exact).max()))
        print(f"  float32 product ({M_}, {K}) x ({K}, {N}): torch (CPU BLAS) "
              f"{e['torch']:.3g}, jax (XLA) {e['jax']:.3g} of the largest "
              f"entry, x{e['torch'] / e['jax']:.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="3,4,5,7")
    args = ap.parse_args(argv)
    params_np = jax.tree.map(np.asarray, ref_build_model(
        ref_get_smoke_config(ARCH)).init(jax.random.PRNGKey(0)))
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params_np)[0]]
    print(f"{ARCH} smoke config, float32 gradients against float64; "
          f"largest gap / leaf's largest entry (leaf)")
    for seed in map(int, args.seeds.split(",")):
        batch = next(token_batches(512, 2, 32, seed=seed))
        truth = float64_grads(params_np, batch)
        ref, port = ref_grads(params_np, batch), port_grads(params_np, batch)
        with patched(PW, wkv_chunked=wkv_literal):
            literal = port_grads(params_np, batch)
        with patched(torch.Tensor, __matmul__=_matmul64):
            exact = port_grads(params_np, batch)
        with patched(PW, _decay_log=_decay_log_exact):
            lora = port_grads(params_np, batch)
        print(f"seed {seed}: reference {worst(ref, truth, names)}; port "
              f"{worst(port, truth, names)}; port - reference "
              f"{worst(port, ref, names)}\n  port, literal per-chunk WKV "
              f"{worst(literal, truth, names)}; port, every product exact "
              f"{worst(exact, truth, names)}; port, the decay LoRA's first "
              f"product exact {worst(lora, truth, names)}")
        one = [f"{name} "
               f"{worst(float64_grads(params_np, batch, **{name: piece}), truth, names)}"
               for name, piece in PIECES.items()]
        print(f"  float64 but for one piece in float32: {'; '.join(one)}")
    matmul_rounding()


if __name__ == "__main__":
    main()
