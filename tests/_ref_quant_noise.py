"""The reference's QSGD rounding noise, behind the port's ``QuantNoise``
interface, so that a port sync quantizes on the reference's own draws.

The reference's quantize stage draws ``jax.random.uniform(key, shape)``
(its ``bernoulli`` compares those uniforms with p_up) with the key folded
as ``PRNGKey(seed)``, then the step count, the bucket, the level tag, then
the axis indices: at level 1 every gather axis (the data axis, then the
pod axis on a (pod, data) mesh), at level 2 the pod axis alone. The port
draws ``uniforms(bucket, level, index, shape, device)`` with index the
worker's global rank at level 1 (rank = pod * n_data + data) and its pod
at level 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch


class RefNoise:
    """``QuantNoise(seed, step)``'s interface over the reference's key
    chain. ``n_data``: the data axis size on a (pod, data) mesh (level 1
    folds the data index, then the pod); None: one data axis."""

    n_data = None

    def __init__(self, seed, step, n_data=None):
        self.seed, self.step = int(seed), int(step)
        if n_data is not None:
            self.n_data = n_data

    def key(self, bucket, level, index):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), self.step)
        key = jax.random.fold_in(jax.random.fold_in(key, bucket), level)
        if level == 2 or self.n_data is None:
            folds = (index,)
        else:
            folds = (index % self.n_data, index // self.n_data)
        for f in folds:
            key = jax.random.fold_in(key, f)
        return key

    def uniforms(self, bucket, level, index, shape, device):
        u = jax.random.uniform(self.key(bucket, level, index), tuple(shape),
                               jnp.float32)
        return torch.from_numpy(np.array(u)).to(device)


def pod_noise(n_data):
    """``RefNoise`` for a (pod, n_data) mesh, with QuantNoise's
    constructor (seed, step)."""
    return type("PodRefNoise", (RefNoise,), {"n_data": n_data})
