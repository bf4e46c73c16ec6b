"""The port's O(3) algebra (ops/o3.py) and MACE's radial functions against
the JAX package, on the CPU.

- real spherical harmonics of seeded vectors, the closed forms (l <= 3) and
  the Legendre recurrence (l = 4, 6): f32 to 1e-6 absolute (the values are
  O(1) to O(5); the two packages evaluate the same expressions, XLA's
  sqrt and division within an ulp or two of PyTorch's), bf16 to one bf16
  ulp of each value (2^-7 relative: both round at the same points, but
  the norm's sum of squares is taken in f32 and rounded once by each, in
  whatever order it chooses);
- the CG machinery (``real_cg``, ``tp_paths``, ``combined_cg``,
  ``summed_cg``): bit for bit, host numpy in both packages;
- ``couple``'s equivariance: for random unit vectors and a random
  rotation R, ``couple(Y_l1(R a), Y_l2(R b)) = D_l3(R) couple(Y_l1(a),
  Y_l2(b))`` with D fitted by least squares from the port's harmonics, to
  1e-5;
- MACE's radial embedding (Bessel, Gaussian and Chebyshev bases, the
  polynomial cutoff, the Agnesi and Soft transforms over the covalent
  radii): f32 to 1e-5 of the largest value, bf16 bit for bit but for the
  transforms (f32 out of both packages, then the same f32 tolerance).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydragnn_tpu.ops import o3 as j_o3
from hydragnn_tpu.ops import radial as j_radial
from hydragnn_tpu_torch.ops import o3 as t_o3
from hydragnn_tpu_torch.ops import radial as t_radial

torch.set_num_threads(2)

SH_ATOL = 1e-6
BF16_ULP = 2.0**-7
EQUIV_ATOL = 1e-5
RADIAL_RTOL = 1e-5


def _vectors(n=257, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v[0] = [0.0, 0.0, 2.0]  # the pole
    v[1] = [1e-3, -2e-3, 0.5]
    return v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lmax", [0, 1, 2, 3, 4, 6])
def pytest_real_sph_harm_matches_jax(lmax, dtype):
    v = _vectors()
    want = np.asarray(j_o3.real_sph_harm(jnp.asarray(v).astype(getattr(jnp, dtype)), lmax)
                      .astype(jnp.float32))
    got = t_o3.real_sph_harm(torch.from_numpy(v).to(getattr(torch, dtype)), lmax)
    assert str(got.dtype)[6:] == dtype and got.shape == (v.shape[0], t_o3.sh_dim(lmax))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=SH_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=BF16_ULP)


def pytest_sh_general_recurrence_matches_closed_forms():
    """The port's two routes are the same polynomials up to l = 3 (f64,
    to 1e-10: they associate the products differently)."""
    u = torch.from_numpy(_vectors(seed=3)).double()
    u = u / u.norm(dim=-1, keepdim=True)
    closed = t_o3.real_sph_harm(u, 3)
    general = t_o3._real_sph_harm_general(u, 3)
    np.testing.assert_allclose(general.numpy(), closed.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("l1,l2,l3", [(l1, l2, l3) for l1 in range(4) for l2 in range(4)
                                      for l3 in range(abs(l1 - l2), min(l1 + l2, 3) + 1)])
def pytest_real_cg_bit_for_bit(l1, l2, l3):
    want, got = j_o3.real_cg(l1, l2, l3), t_o3.real_cg(l1, l2, l3)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("lmaxes", [(0, 2, 2), (1, 1, 1), (2, 2, 2), (1, 3, 3), (3, 2, 2)])
def pytest_cg_block_tensors_bit_for_bit(lmaxes):
    assert t_o3.tp_paths(*lmaxes) == j_o3.tp_paths(*lmaxes)
    (gw, pw, ow), (gg, pg, og) = j_o3.combined_cg(*lmaxes), t_o3.combined_cg(*lmaxes)
    assert pg == pw and og == ow and gg.dtype == gw.dtype and gg.tobytes() == gw.tobytes()
    sw, sg = j_o3.summed_cg(*lmaxes), t_o3.summed_cg(*lmaxes)
    assert sg.dtype == sw.dtype and sg.tobytes() == sw.tobytes()


def _random_rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def _wigner_d(l, rot, n=2000, seed=0):
    """D_l with Y_l(R v) = D_l Y_l(v), fitted over samples (float64)."""
    v = torch.from_numpy(np.random.default_rng(seed).normal(size=(n, 3)))
    sl = t_o3.irrep_slice(l)
    y = t_o3.real_sph_harm(v, l)[:, sl].numpy()
    yr = t_o3.real_sph_harm(v @ torch.from_numpy(rot).T, l)[:, sl].numpy()
    d, *_ = np.linalg.lstsq(y, yr, rcond=None)
    return d.T


@pytest.mark.parametrize("path", [(1, 1, 0), (1, 1, 1), (1, 1, 2), (1, 2, 3), (2, 2, 2),
                                  (2, 1, 1), (3, 2, 1)])
def pytest_couple_is_equivariant(path):
    l1, l2, l3 = path
    rng = np.random.default_rng(7)
    rot = _random_rotation(rng)
    a, b = (torch.from_numpy(rng.normal(size=(16, 3))) for _ in range(2))
    R = torch.from_numpy(rot)

    def coupled(x, y):
        return t_o3.couple(t_o3.real_sph_harm(x, l1)[:, t_o3.irrep_slice(l1)],
                           t_o3.real_sph_harm(y, l2)[:, t_o3.irrep_slice(l2)], l1, l2, l3)

    want = coupled(a, b).numpy() @ _wigner_d(l3, rot).T
    got = coupled(a @ R.T, b @ R.T).numpy()
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=EQUIV_ATOL)


def _edges():
    rng = np.random.default_rng(4)
    r = np.concatenate([[1e-6, 0.3], rng.uniform(0.5, 6.0, 61)]).astype(np.float32)
    z = rng.choice([1, 6, 8, 26, 78, 0, 120], size=9).astype(np.int32)
    s, t = rng.integers(0, 9, r.shape[0]), rng.integers(0, 9, r.shape[0])
    return r, z, s, t


RADIAL = {
    "bessel": dict(radial_type="bessel"),
    "gaussian": dict(radial_type="gaussian"),
    "chebyshev": dict(radial_type="chebyshev"),
    "bessel_agnesi": dict(radial_type="bessel", distance_transform="Agnesi"),
    "bessel_soft": dict(radial_type="bessel", distance_transform="Soft"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(RADIAL))
def pytest_radial_embedding_matches_jax(name, dtype):
    r, z, s, t = _edges()
    kw = RADIAL[name]
    emb = j_radial.RadialEmbedding(r_max=5.0, num_basis=8, envelope_exponent=5, **kw)
    jr = jnp.asarray(r).astype(getattr(jnp, dtype))
    want = emb.apply({}, jr, z=jnp.asarray(z), senders=jnp.asarray(s), receivers=jnp.asarray(t))
    got = t_radial.radial_embedding(
        torch.from_numpy(r).to(getattr(torch, dtype)), 5.0, 8, envelope_exponent=5,
        z=torch.from_numpy(z), senders=torch.from_numpy(s), receivers=torch.from_numpy(t), **kw)
    assert str(got.dtype)[6:] == str(want.dtype)
    want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
    assert np.isfinite(got).all()
    if dtype == "bfloat16" and "distance_transform" not in kw:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RADIAL_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def pytest_polynomial_cutoff_and_chebyshev_match_jax(dtype):
    r, _, _, _ = _edges()
    jr = jnp.asarray(r).astype(getattr(jnp, dtype))
    tr = torch.from_numpy(r).to(getattr(torch, dtype))
    for jf, tf in ((lambda x: j_radial.polynomial_cutoff(x, 5.0, 6),
                    lambda x: t_radial.polynomial_cutoff(x, 5.0, 6)),
                   (lambda x: j_radial.chebyshev_basis(x / 6.0, 7),
                    lambda x: t_radial.chebyshev_basis(x / 6.0, 7))):
        want = np.asarray(jf(jr).astype(jnp.float32))
        got = tf(tr)
        assert str(got.dtype)[6:] == dtype
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got.float().numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=RADIAL_RTOL * float(np.abs(want).max()))


def pytest_covalent_radii_are_the_jax_table():
    assert t_radial.COVALENT_RADII.tobytes() == j_radial.COVALENT_RADII.tobytes()
