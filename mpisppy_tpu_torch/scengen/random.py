###############################################################################
# Counter-based random bits: the port's copy of the jax.random pieces the
# scenario samplers use (threefry2x32 with the partitionable bit layout).
#
#   prng_key(seed)        = (0, seed)
#   fold_in(key, d)       = threefry2x32(key, (0, d))
#   random_bits(key, sh)  = y0 ^ y1 of threefry2x32(key, (hi, lo)) where
#                           (hi, lo) are the 32-bit words of each element's
#                           flat index in `sh`
#   uniform(key, sh)      = bitcast((bits >> 9) | 0x3F800000) - 1.0   (f32)
#
# A Bernoulli(p) draw is uniform(key, sh) < p, as in jax.random.bernoulli.
#
# These reproduce jax.random bit for bit (jax_threefry_partitionable=True,
# the default of the JAX the package was written against), so a scenario
# drawn here equals the one the JAX package draws from the same seed
# (tests/test_torch_scengen.py).  jax.random.normal is NOT ported: it is
# sqrt(2) * erf_inv(u) with XLA's own f32 ErfInv polynomial, which
# torch.special.erfinv does not reproduce bit for bit.
#
# torch has few uint32 operations, so every 32-bit word is held in an
# int64 tensor in [0, 2**32) and masked after each add and shift.  Keys
# are (..., 2) int64 tensors; a batch of keys (one per scenario) draws a
# batch of arrays, the batch dimension standing in for jax.vmap.  All of
# it runs on whatever device the key lies on.
###############################################################################
from __future__ import annotations

import torch

Tensor = torch.Tensor

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000  # the bit pattern of 1.0f


def _rotl(v: Tensor, r: int) -> Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0: Tensor, x1: Tensor) -> tuple[Tensor, Tensor]:
    """The 20-round Threefry-2x32 block cipher (Salmon et al. 2011, as in
    jax.random): key words k0, k1 and counter words x0, x1, all int64
    holding uint32 values, broadcast against each other."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> Tensor:
    """jax.random.PRNGKey(seed) for a 32-bit seed: the key (0, seed)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: Tensor, data) -> Tensor:
    """jax.random.fold_in: key (2,) and data an int or an integer tensor
    of any shape; returns keys of shape data.shape + (2,)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data & MASK)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: Tensor, shape) -> Tensor:
    """32 random bits per element (int64 in [0, 2**32)): keys (..., 2)
    give bits of shape key.shape[:-1] + shape."""
    shape = tuple(shape)
    count = 1
    for d in shape:
        count *= d
    idx = torch.arange(count, dtype=torch.int64, device=key.device)
    k0 = key[..., 0, None]
    k1 = key[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & MASK)
    return (y0 ^ y1).reshape(key.shape[:-1] + shape)


def bits_to_unit_float(bits: Tensor) -> Tensor:
    """[0, 1) f32 from 32 random bits: the top 23 bits as the mantissa of
    a number in [1, 2), minus 1 (exact)."""
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Tensor, shape) -> Tensor:
    """jax.random.uniform in f32 on [0, 1): keys (..., 2) give
    key.shape[:-1] + shape."""
    return bits_to_unit_float(random_bits(key, shape))
