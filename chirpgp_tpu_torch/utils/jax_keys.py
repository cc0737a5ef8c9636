"""JAX's key schedule and normal draws, in NumPy, without JAX.

The JAX package's committed Table-I columns and its toymodel records
(``results/data/toydata_*.npz``) come from JAX's pregenerated keys,
``jax.random.split(jax.random.PRNGKey(999), num)``, through its
partitionable Threefry-2x32.  Torch's generators cannot replay those
streams, so this module remakes them bit for bit in NumPy uint32
arithmetic: the keys, the random bits, and the normal draws in float64
(64-bit draws) and float32 (32-bit draws).  On top of those,
:func:`jax_toymodel_measurements` remakes the JAX package's record-maker
(``chirpgp_tpu.apps.sweeps.toymodel_measurements``) from a JAX key, so a
driver of the port can run on the same records as the JAX package's.

The inverse error function is the one step that is not bit for bit:
float64 draws go through SciPy's ``erfinv`` (within ~1e-11 of XLA's),
float32 draws through XLA's own single-precision polynomial (Giles) in
NumPy float32 (within 3 ulp: XLA's ``log1p`` is its own).  Where XLA's
CPU code fuses a multiply and an add (``jnp.linspace``, the erfinv
polynomial), so does this module.
"""

import math

import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "split",
           "jax_rnd_keys", "random_bits", "jax_normal",
           "jax_linspace", "jax_ou_mag",
           "jax_toymodel_draws", "jax_toymodel_measurements"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, x1, x2):
    """JAX's Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under ``key`` (two uint32 words), in NumPy uint32 arithmetic."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the words ``(seed >> 32, seed & (2**32
    - 1))`` of a non-negative integer seed below 2**63."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"prng_key: seed {seed} outside [0, 2**63)")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int):
    if n >= 2 ** 32:
        raise ValueError(f"{n} counters exceed 2**32")
    return np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` (partitionable Threefry): ``num``
    keys, shape (num, 2) uint32.  Key ``i`` does not depend on ``num``."""
    b1, b2 = threefry2x32(key, *_counters(num))
    return np.stack([b1, b2], axis=-1)


def jax_rnd_keys(num: int = 1000, seed: int = 999) -> np.ndarray:
    """The JAX package's pregenerated keys
    (``chirpgp_tpu.apps.sweeps.generate_rnd_keys``): ``split(prng_key(
    seed), num)``."""
    return split(prng_key(seed), num)


def random_bits(key, shape, width: int) -> np.ndarray:
    """``jax.random.bits`` of ``width`` 32 or 64 over ``shape``, counters
    in C order: the two hash words XOR-ed (32) or concatenated (64)."""
    shape = (int(shape),) if np.ndim(shape) == 0 else tuple(shape)
    b1, b2 = threefry2x32(key, *_counters(int(np.prod(shape, dtype=np.int64))))
    if width == 32:
        bits = b1 ^ b2
    elif width == 64:
        bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    else:
        raise ValueError(f"random_bits: width {width} is not 32 or 64")
    return bits.reshape(shape)


# XLA's single-precision erfinv (Giles): coefficients for w < 5 and w >= 5.
_ERFINV32_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERFINV32_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _fma_f32(x, y, z) -> np.ndarray:
    """``fma(x, y, z)`` of float32 operands, as XLA's CPU code contracts a
    multiply and an add: the product is exact in float64, and the sum is
    rounded once more to float32."""
    f64 = np.float64
    return (np.asarray(x, f64) * np.asarray(y, f64)
            + np.asarray(z, f64)).astype(np.float32)


def _fma_f64(x, y, z) -> np.ndarray:
    """``fma(x, y, z)`` of float64 operands, elementwise, rounded once
    (exact rational arithmetic)."""
    from fractions import Fraction
    return np.array([float(Fraction(float(a)) * Fraction(float(b))
                           + Fraction(float(c)))
                     for a, b, c in np.broadcast(x, y, z)], np.float64)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's single-precision erfinv, its Horner steps contracted to
    fused multiply-adds as XLA's CPU code runs them.  XLA's log1p is its
    own, so a draw can still part from JAX's by an ulp or two."""
    f = np.float32
    x = np.asarray(x, f)
    w = -np.log1p(-x * x)
    lt = w < f(5.0)
    w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0)).astype(f)
    p = np.where(lt, f(_ERFINV32_LO[0]), f(_ERFINV32_HI[0])).astype(f)
    for lo, hi in zip(_ERFINV32_LO[1:], _ERFINV32_HI[1:]):
        p = _fma_f32(p, w, np.where(lt, f(lo), f(hi)))
    out = (p * x).astype(f)
    return np.where(np.abs(x) == f(1.0), x * np.finfo(f).max, out).astype(f)


def jax_normal(key, shape, dtype=np.float64) -> np.ndarray:
    """``jax.random.normal(key, shape, dtype)`` for float64 or float32:
    a uniform on (-1, 1) from the mantissa bits, then sqrt(2) erfinv."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        bits = random_bits(key, shape, 64)
        u = ((bits >> np.uint64(12)) | np.uint64(0x3FF0000000000000)) \
            .view(np.float64) - 1.0
        import scipy.special
        erfinv = scipy.special.erfinv
    elif dtype == np.float32:
        bits = random_bits(key, shape, 32)
        u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)) \
            .view(np.float32) - np.float32(1.0)
        erfinv = _erfinv_f32
    else:
        raise ValueError(f"jax_normal: dtype {dtype} is not float32/64")
    lo = np.nextafter(dtype.type(-1.0), dtype.type(0.0))
    u = np.maximum(lo, u * (dtype.type(1.0) - lo) + lo).astype(dtype)
    return (dtype.type(math.sqrt(2.0)) * erfinv(u)).astype(dtype)


def jax_linspace(start: float, stop: float, num: int,
                 dtype=torch.float64) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in ``dtype``, bit for bit as
    XLA's CPU code computes it: ``start (1 - i r) + i (stop r)`` with ``r =
    1 / (num - 1)``, the last product and the sum fused (in float64 also
    ``1 - i r``), and the last point ``stop``."""
    like = dict(dtype=dtype)
    a, b = torch.tensor(start, **like), torch.tensor(stop, **like)
    if num == 1:
        return a[None]
    r = 1 / torch.tensor(float(num - 1), **like)
    iota = torch.arange(num - 1, **like)
    if dtype == torch.float32:
        head = _fma_f32(iota.numpy(), (b * r).numpy(),
                        (a * (1 - iota * r)).numpy())
    elif dtype == torch.float64:
        rest = a.numpy() * _fma_f64(-iota.numpy(), r.numpy(), 1.0)
        head = _fma_f64(iota.numpy(), (b * r).numpy(), rest)
    else:
        raise ValueError(f"jax_linspace: dtype {dtype} is not float32/64")
    return torch.cat([torch.from_numpy(head), b[None]])


def jax_ou_mag(key, T: int, dtype=np.float64, ell: float = 1.0,
               sigma: float = 1.0):
    """The magnitude ``chirpgp_tpu.toymodels.random_ou_mag(ell, sigma,
    key)`` makes for a path of T steps, from JAX's draws of ``key`` (one
    key (2,) or a batch (N, 2)), in ``dtype`` (NumPy): a function of
    ``ts`` (T,) giving the path (T,), or (N, T) for a batch.

    As ``simulate_sde`` of a one-dimensional state: ``x0 = sigma z0``
    with ``z0`` drawn from the key itself, then the exact OU step
    ``x_k = exp(-dt / ell) x_{k-1} + sqrt(sigma^2 (1 - exp(-2 dt / ell)))
    dw_k``, its constants in the path's dtype, the increments from the
    key's first split."""
    keys = np.asarray(key, np.uint32).reshape(-1, 2)
    z0 = torch.from_numpy(np.stack([jax_normal(k, (1,), dtype)
                                    for k in keys]))[:, 0]
    dws = torch.from_numpy(np.stack([jax_normal(split(k)[0], (T,), dtype)
                                     for k in keys]))

    def mag(ts):
        like = dict(dtype=ts.dtype, device=ts.device)
        dt = torch.tensor(float(ts[1] - ts[0]), **like)
        decay = torch.exp(-dt / ell)
        scale = torch.sqrt(sigma ** 2 * (1.0 - torch.exp(-2.0 * dt / ell)))
        x = torch.sqrt(torch.tensor(sigma ** 2, **like)) * z0.to(**like)
        steps, path = dws.to(**like), []
        for k in range(steps.shape[1]):
            x = decay * x + scale * steps[:, k]
            path.append(x)
        path = torch.stack(path, dim=1)
        return path if np.ndim(key) == 2 else path[0]

    return mag


def jax_toymodel_draws(key, mag_name: str, T: int = 3141,
                       dtype=torch.float64):
    """The random parts of the JAX package's toymodel record of ``key``
    (one key (2,) or a batch (N, 2)): the magnitude function of
    ``mag_name`` (an OU path per key for ``"random"``) and the standard
    normals (N, T) of the measurement noise, in ``dtype`` on the host.
    As in the JAX package, each key is split once, the noise first and the
    OU magnitude second; the OU path draws x0 from the magnitude's key and
    its increments from that key's first split (:func:`jax_ou_mag`)."""
    from chirpgp_tpu_torch.toymodels import constant_mag, damped_exp_mag

    keys = np.asarray(key, np.uint32).reshape(-1, 2)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    pairs = [split(k) for k in keys]
    noise = torch.from_numpy(
        np.stack([jax_normal(kn, (T,), np_dtype) for kn, _ in pairs]))
    if mag_name == "const":
        return constant_mag(1.0), noise
    if mag_name == "damped":
        return damped_exp_mag(0.3), noise
    if mag_name == "random":
        return jax_ou_mag(np.stack([km for _, km in pairs]), T,
                          np_dtype), noise
    raise ValueError(f"Unknown magnitude {mag_name!r}")


def jax_toymodel_measurements(key, mag_name: str, dt: float = 1e-3,
                              T: int = 3141, Xi: float = 0.1,
                              num_harmonics: int = 1,
                              dtype=torch.float64, device="cuda"):
    """The JAX package's toymodel record of ``key`` (its
    ``toymodel_measurements``, under ``jax.vmap`` for a batch of keys):
    ``(ts, true_freqs, ys)``.

    ``key`` is one JAX key (2,) or a batch (N, 2); a batch gives (N, T)
    arrays.  The draws are :func:`jax_toymodel_draws`'; every overtone of
    a harmonic record has the same magnitude.  The record is made on the
    host in ``dtype`` (JAX's draws in that dtype: float32 as the JAX
    package runs without x64) and returned on ``device``.
    """
    from chirpgp_tpu_torch.toymodels import (
        gen_chirp, gen_harmonic_chirp, meow_freq)

    batched = np.ndim(key) == 2
    mag, noise = jax_toymodel_draws(key, mag_name, T, dtype)
    ts = jax_linspace(dt, dt * T, T, dtype)
    freq_func, phase_func = meow_freq(offset=8.0)
    if num_harmonics == 1:
        chirp = gen_chirp(ts, mag, phase_func)
    else:
        chirp = gen_harmonic_chirp(ts, [mag] * num_harmonics, phase_func)
    ys = chirp + math.sqrt(Xi) * noise
    out = [x.expand(ys.shape) for x in (ts, freq_func(ts))] + [ys]
    if not batched:
        out = [x[0] for x in out]
    return tuple(x.to(device) for x in out)
