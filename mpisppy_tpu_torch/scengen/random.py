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
#   normal(key, sh)       = sqrt(2) * erfinv(u), u uniform on
#                           [nextafter(-1, 0), 1)
#
# A Bernoulli(p) draw is uniform(key, sh) < p, as in jax.random.bernoulli.
#
# These reproduce jax.random bit for bit (jax_threefry_partitionable=True,
# the default of the JAX the package was written against), so a scenario
# drawn here equals the one the JAX package draws from the same seed
# (tests/test_torch_scengen.py, tests/test_torch_random_normal.py).
# normal needs XLA's own f32 arithmetic, written out below: its ErfInv
# is Giles' single-precision polynomial, its log1p a Cephes rational
# below |x| = sqrt(2) - 1 and its CPU log (Cephes logf) above, every
# Horner step a fused multiply-add.  torch.special.erfinv and
# torch.log1p each differ from XLA's in the last bits of a few percent
# of draws.
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


# -- normal ----------------------------------------------------------------
_SQRT2 = 1.41421356237309504880
_LO = -0.99999994039535522461  # nextafter(-1, 0) in f32
# Giles' f32 ErfInv coefficients, highest degree first (w < 5, w >= 5)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p rational for small |x| (Cephes), lowest degree last
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# Cephes logf polynomial
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _f32(v: float) -> float:
    """The f32 value of a Python float (as a float)."""
    return torch.tensor(v, dtype=torch.float32).item()


def _fma(a, b, c) -> Tensor:
    """Fused multiply-add in f32: a*b + c rounded once (emulated in f64;
    the product of two f32 values is exact there)."""
    def d(v):
        return v.double() if isinstance(v, Tensor) else _f32(v)
    return (d(a) * d(b) + d(c)).float()


def _horner(coeffs, x: Tensor) -> Tensor:
    p = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _xla_log(x: Tensor) -> Tensor:
    """XLA's f32 log on the CPU (Cephes logf) for positive normal x."""
    m, e = torch.frexp(x)                    # m in [0.5, 1)
    e = e.float()
    small = m < _f32(0.707106781186547524)
    t = m - 1.0
    e = e - small.float()
    t = t + torch.where(small, m, torch.zeros_like(m))
    t2 = t * t
    t3 = t2 * t
    p = _LOG_P
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(y, t3, y1)
    y = _fma(y, t3, y2)
    y = _fma(y, t3, e * _f32(-2.12194440e-4))
    t = t - t2 * 0.5
    return (t + y) + e * _f32(0.693359375)


def _xla_log1p(x: Tensor) -> Tensor:
    """XLA's f32 log1p: a Cephes rational below |x| = sqrt(2) - 1,
    log(1 + x) above."""
    x2 = x * x
    r = _horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)
    small = x + (x2 * -0.5 + (x * x2) * r)
    large = _xla_log(x + 1.0)
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, large)


def erfinv(u: Tensor) -> Tensor:
    """XLA's f32 ErfInv (Giles' single-precision polynomial) for u in
    [-1, 1]; +-1 map to +-inf, as in XLA."""
    w = -_xla_log1p(-(u * u))
    lt = w < 5.0
    # sqrt correctly rounded (f64, then f32): torch's f32 sqrt on the CPU
    # is off by an ulp on some inputs, XLA's is not
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.full_like(w, _f32(a)),
                        torch.full_like(w, _f32(b)))
        p = _fma(p, w, c)
    r = p * u
    return torch.where(u.abs() == 1.0, u * float("inf"), r)


def normal(key: Tensor, shape) -> Tensor:
    """jax.random.normal in f32: keys (..., 2) give key.shape[:-1] +
    shape standard normals, sqrt(2) * erfinv(u) with u uniform on
    [nextafter(-1, 0), 1) drawn from the same bits as uniform()."""
    f = uniform(key, shape)
    u = torch.clamp(f * 2.0 + _f32(_LO), min=_f32(_LO))
    return erfinv(u) * _f32(_SQRT2)
