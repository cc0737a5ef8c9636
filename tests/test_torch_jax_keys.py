"""PyTorch port vs JAX: the NumPy copy of JAX's key schedule and normal
draws (``chirpgp_tpu_torch/utils/jax_keys.py``) and the JAX package's
record-maker remade from a JAX key.

Tolerances: the keys and the random bits bit for bit; float64 normals
1e-11 (SciPy's erfinv is not XLA's); float32 normals within 3 ulp, at
most 2% of them unequal (measured: 3 ulp and 1.3% over 200 x 3141 draws;
XLA's float32 log1p is its own); the float64 records within 1e-10 of
``toymodel_measurements``; the float32 records of
``gen_toymodel_data`` against the committed ``results/data/toydata*``:
``keys`` and ``ts`` bit for bit, ``ys`` within 5e-5 (K=1) and 3e-4 (K=3)
absolute.  The committed records are XLA's float32 chirp, which sits
1.6e-5 (K=1) and 6.6e-5 (K=3) from the float64 chirp by itself, so no
float32 remake can hold them to 1e-6; the measured gaps are 4.4e-5 and
2.4e-4 over the 100 seeds, their medians 3e-7 or less.
"""

from pathlib import Path

import numpy as np
import numpy.testing as npt
import jax
import jax.numpy as jnp
import pytest
import torch

import chirpgp_tpu.apps.sweeps as js
import chirpgp_tpu_torch.utils.jax_keys as jk
from chirpgp_tpu_torch.experiments import gen_toymodel_data

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOYDATA_YS_ATOL = {1: 5e-5, 3: 3e-4}


@pytest.mark.parametrize("seed", [0, 1, 555, 999, 2 ** 31 + 5, 2 ** 40 + 3])
def test_prng_key_and_split_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    npt.assert_array_equal(jk.prng_key(seed), np.asarray(key))
    for num in (1, 2, 3, 100):
        npt.assert_array_equal(jk.split(jk.prng_key(seed), num),
                               np.asarray(jax.random.split(key, num)))
    npt.assert_array_equal(jk.split(np.asarray(key)),
                           np.asarray(jax.random.split(key)))


def test_pregenerated_keys_and_bits_equal_jax():
    npt.assert_array_equal(jk.jax_rnd_keys(1000),
                           np.asarray(js.generate_rnd_keys(1000)))
    key = jk.jax_rnd_keys(5)[4]
    for width, dtype in ((32, jnp.uint32), (64, jnp.uint64)):
        for shape in ((7,), (3, 5)):
            npt.assert_array_equal(
                jk.random_bits(key, shape, width),
                np.asarray(jax.random.bits(jnp.asarray(key), shape, dtype)))


def test_normal_f64_agrees_with_jax():
    for key in jk.jax_rnd_keys(4):
        for shape in ((3141,), (200, 1)):
            npt.assert_allclose(
                jk.jax_normal(key, shape, np.float64),
                np.asarray(jax.random.normal(jnp.asarray(key), shape,
                                             dtype=jnp.float64)),
                atol=1e-11, rtol=0)
    key = jk.jax_rnd_keys(1)[0]
    npt.assert_array_equal(jk.jax_normal(key, 50),
                           jk.jax_normal(key, (50,), np.float64))


def test_normal_f32_agrees_with_jax():
    unequal, total = 0, 0
    for key in jk.jax_rnd_keys(20):
        for shape in ((3141,), (100, 1)):
            want = np.asarray(jax.random.normal(jnp.asarray(key), shape,
                                                dtype=jnp.float32))
            got = jk.jax_normal(key, shape, np.float32)
            assert got.dtype == np.float32
            ulps = np.abs(got - want) / np.spacing(np.abs(want))
            assert ulps.max() <= 3, ulps.max()
            unequal += int(np.sum(got != want))
            total += got.size
    assert unequal <= 0.02 * total, unequal / total


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_linspace_equals_jax(dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    for dt, T in ((1e-3, 3141), (1e-3, 40), (1e-3, 300), (0.01, 500),
                  (1 / 4096, 1000)):
        want = np.asarray(jnp.linspace(dt, dt * T, T, dtype=jdtype))
        got = jk.jax_linspace(dt, dt * T, T, dtype).numpy()
        npt.assert_array_equal(got, want)


@pytest.mark.parametrize("mag", ["const", "damped", "random"])
@pytest.mark.parametrize("num_harmonics", [1, 3])
def test_toymodel_measurements_match_jax_f64(mag, num_harmonics):
    keys = js.generate_rnd_keys(3)
    kw = dict(T=500, num_harmonics=num_harmonics)
    want = jax.vmap(lambda k: js.toymodel_measurements(k, mag, **kw))(keys)
    got = jk.jax_toymodel_measurements(np.asarray(keys), mag, **kw,
                                       dtype=torch.float64, device="cpu")
    for g_, w in zip(got, want):
        assert g_.shape == (3, 500) and g_.dtype == torch.float64
        npt.assert_allclose(g_.numpy(), np.asarray(w), atol=1e-10, rtol=0)
    one = jk.jax_toymodel_measurements(np.asarray(keys[1]), mag, **kw,
                                       device="cpu")
    for g_, o in zip(got, one):
        assert o.shape == (500,)
        npt.assert_array_equal(o.numpy(), g_[1].numpy())


@pytest.mark.parametrize("num_harmonics", [1, 3])
def test_gen_toymodel_data_reproduces_committed_files(num_harmonics,
                                                      tmp_path, capsys):
    gen_toymodel_data.main(["--seeds", "2", "--num-harmonics",
                            str(num_harmonics), "--out", str(tmp_path)])
    prefix = "toydata" if num_harmonics == 1 else f"toydata_h{num_harmonics}"
    for mag in ("const", "damped", "random"):
        got = np.load(tmp_path / f"{prefix}_{mag}.npz")
        want = np.load(ROOT / f"results/data/{prefix}_{mag}.npz")
        assert set(got.files) == set(want.files)
        for k in got.files:
            assert got[k].dtype == want[k].dtype, k
        npt.assert_array_equal(got["keys"], want["keys"][:2])
        npt.assert_array_equal(got["ts"], want["ts"])
        npt.assert_allclose(got["true_freqs"], want["true_freqs"],
                            rtol=2e-6, atol=0)
        npt.assert_allclose(got["ys"], want["ys"][:2],
                            atol=TOYDATA_YS_ATOL[num_harmonics], rtol=0)
    assert f"saved {tmp_path / prefix}_random.npz ys(2, 3141)" \
        in capsys.readouterr().out
