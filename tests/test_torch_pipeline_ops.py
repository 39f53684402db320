"""Value parity of the port's row-major and full-covariance ops with the
JAX package's, in float32 on the CPU: the same numpy inputs (from a seed)
go to both.

Covered: frustum.{lift_gaussian, conical_frustum_to_gaussian,
cylinder_to_gaussian, cast_rays}, encoding.{expected_sin,
gaussian_fourier_enc, windowed_pos_enc, integrated_pos_enc, windowed_ipe},
contraction.contract_gaussian, render.{volumetric_rendering,
volumetric_density, distance_from_depth} and the row-major
sample_along_rays / resample_along_rays, parametrised over diagonal and
full covariance, cone and cylinder, safe and fast trig, recurrent and
direct IPE. JAX's random draws (uniform jitter, Fourier frequencies, the
random background) are handed to the port.

Tolerance: atol 1e-6. The inputs keep every output near unit scale (ray
distances up to 4, IPE degrees 0-4), where float32's spacing is below
1e-6, so the two libraries' operation orders fit inside it. Two documented
exceptions: the recurrent IPE 3-4 degrees past a restart (1e-5, see
_close_ipe) and the unstable closed-form frustum (see
test_conical_frustum_to_gaussian).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from durf_tpu import ops as jops
from durf_tpu.ops import encoding as jenc
from durf_tpu_torch import ops as tops

ATOL = 1e-6
MIN_DEG, MAX_DEG = 0, 5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(t_val, j_val, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t_val.detach().numpy(), np.asarray(j_val), atol=atol, rtol=rtol)


def _close_ipe(t_feat, j_feat, recurrent, lead=0):
    """IPE features [..., lead + 2 * 3 * n_deg], degree by degree: atol
    1e-6, except in the recurrent form 3 and 4 degrees past a restart,
    where the double-angle chain has amplified the two libraries' last-ulp
    difference in the seed sin / cos 8-16 fold (16 ulp: 1e-5)."""
    t_feat, j_feat = t_feat.detach().numpy(), np.asarray(j_feat)
    np.testing.assert_allclose(t_feat[..., :lead], j_feat[..., :lead], atol=ATOL, rtol=0.0)
    n_deg = MAX_DEG - MIN_DEG
    for half in range(2):
        for deg in range(n_deg):
            lo = lead + half * 3 * n_deg + 3 * deg
            atol = 1e-5 if recurrent and deg % 5 >= 3 else ATOL
            np.testing.assert_allclose(t_feat[..., lo:lo + 3], j_feat[..., lo:lo + 3], atol=atol,
                                       rtol=0.0, err_msg=f"degree {deg}")


def _rays(b=5, seed=0):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = (rng.normal(size=(b, 3)) * 0.2).astype(np.float32)
    radii = np.full((b, 1), 0.05, np.float32)
    return origins, dirs, radii


def _fenceposts(b=5, n=9, seed=1):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(0.2, 4.0, size=(b, n)).astype(np.float32), axis=-1)


def _gaussians(diag, b=4, s=6, seed=2):
    """Means [b, s, 3] in [-1, 1] and covariances: diagonal [b, s, 3] or
    full [b, s, 3, 3] (A A^T + a small diagonal, so PSD)."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(-1.0, 1.0, size=(b, s, 3)).astype(np.float32)
    if diag:
        return mean, rng.uniform(0.0, 0.05, size=(b, s, 3)).astype(np.float32)
    a = rng.normal(0.0, 0.1, size=(b, s, 3, 3)).astype(np.float32)
    cov = a @ np.swapaxes(a, -1, -2) + 1e-3 * np.eye(3, dtype=np.float32)
    return mean, cov.astype(np.float32)


@pytest.mark.parametrize("diag", [True, False])
def test_lift_gaussian(diag):
    _, dirs, _ = _rays()
    rng = np.random.default_rng(3)
    t_mean, t_var, r_var = (rng.uniform(0.0, 2.0, size=(5, 8)).astype(np.float32) for _ in range(3))
    j = jops.lift_gaussian(_j(dirs), _j(t_mean), _j(t_var), _j(r_var), diag)
    t = tops.lift_gaussian(_t(dirs), _t(t_mean), _t(t_var), _t(r_var), diag)
    assert t[1].shape == ((5, 8, 3) if diag else (5, 8, 3, 3))
    for tv, jv in zip(t, j):
        _close(tv, jv)


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("diag", [True, False])
def test_conical_frustum_to_gaussian(diag, stable):
    _, dirs, radii = _rays()
    t_vals = _fenceposts()
    args = (dirs, t_vals[:, :-1], t_vals[:, 1:], radii)
    j = jops.conical_frustum_to_gaussian(*map(_j, args), diag, stable)
    t = tops.conical_frustum_to_gaussian(*map(_t, args), diag, stable)
    if stable:
        for tv, jv in zip(t, j):
            _close(tv, jv)
        return
    # The exact closed form cancels catastrophically in float32, which is
    # why both packages keep it for reference only: its means (ratios of
    # differences of 4th and 3rd powers) agree to rtol 1e-5, and its
    # variances, E[t^2] - E[t]^2 of numbers near 16 after those ratios,
    # carry ~1e-4 of rounding in either library (measured 1.1e-4 apart).
    _close(t[0], j[0], rtol=1e-5)
    _close(t[1], j[1], atol=2e-4)


@pytest.mark.parametrize("diag", [True, False])
def test_cylinder_to_gaussian(diag):
    _, dirs, radii = _rays()
    t_vals = _fenceposts()
    args = (dirs, t_vals[:, :-1], t_vals[:, 1:], radii)
    j = jops.cylinder_to_gaussian(*map(_j, args), diag)
    t = tops.cylinder_to_gaussian(*map(_t, args), diag)
    for tv, jv in zip(t, j):
        _close(tv, jv)


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
def test_cast_rays(ray_shape, diag):
    origins, dirs, radii = _rays()
    args = (_fenceposts(), origins, dirs, radii)
    j = jops.cast_rays(*map(_j, args), ray_shape, diag)
    t = tops.cast_rays(*map(_t, args), ray_shape, diag)
    for tv, jv in zip(t, j):
        _close(tv, jv)
    with pytest.raises(ValueError, match="ray_shape"):
        tops.cast_rays(*map(_t, args), "sphere", diag)


@pytest.mark.parametrize("safe", [True, False])
def test_expected_sin(safe):
    rng = np.random.default_rng(4)
    x = rng.uniform(-3.0, 3.0, size=(6, 7)).astype(np.float32)
    x_var = rng.uniform(0.0, 2.0, size=(6, 7)).astype(np.float32)
    j = jenc.expected_sin(_j(x), _j(x_var), safe)
    t = tops.expected_sin(_t(x), _t(x_var), safe)
    for tv, jv in zip(t, j):
        _close(tv, jv)


@pytest.mark.parametrize("append_identity", [False, True])
def test_gaussian_fourier_enc_with_the_jax_draw(append_identity):
    x = np.random.default_rng(5).uniform(-0.5, 0.5, size=(4, 6, 3)).astype(np.float32)
    key, scale, nf = jax.random.key(7), 0.3, 5
    j = jenc.gaussian_fourier_enc(_j(x), scale, key, nf, append_identity)
    bvals = np.asarray(jax.random.normal(key, (nf, 3), jnp.float32)) * scale
    t = tops.gaussian_fourier_enc(_t(x), scale, num_features=nf, append_identity=append_identity,
                                  bvals=_t(bvals))
    _close(t, j)
    # Without a draw handed in, the generator draws the frequencies.
    gen = torch.Generator().manual_seed(0)
    drawn = tops.gaussian_fourier_enc(_t(x), scale, gen, nf, append_identity)
    assert drawn.shape == t.shape and not torch.equal(drawn, t)


@pytest.mark.parametrize("alpha", [10.0, 2.4])
@pytest.mark.parametrize("append_identity", [True, False])
def test_windowed_pos_enc(alpha, append_identity):
    x = np.random.default_rng(6).uniform(-1.0, 1.0, size=(7, 3)).astype(np.float32)
    j = jenc.windowed_pos_enc(_j(x), MIN_DEG, MAX_DEG, alpha, append_identity)
    t = tops.windowed_pos_enc(_t(x), MIN_DEG, MAX_DEG, alpha, append_identity)
    _close(t, j)


IPE_CASES = [
    # (diag, safe, recurrent); the recurrent form is diagonal only (with a
    # full covariance both packages take the direct form).
    (True, True, False),
    (True, False, False),
    (True, True, True),
    (False, True, False),
    (False, False, False),
    (False, True, True),
]


@pytest.mark.parametrize("diag,safe,recurrent", IPE_CASES)
def test_integrated_pos_enc(diag, safe, recurrent):
    mean, cov = _gaussians(diag)
    j = jops.integrated_pos_enc((_j(mean), _j(cov)), MIN_DEG, MAX_DEG, diag, safe, recurrent)
    t = tops.integrated_pos_enc((_t(mean), _t(cov)), MIN_DEG, MAX_DEG, diag, safe, recurrent)
    assert t.shape == (4, 6, 2 * 3 * (MAX_DEG - MIN_DEG))
    _close_ipe(t, j, recurrent and diag)


@pytest.mark.parametrize("alpha", [10.0, 3.3])
@pytest.mark.parametrize("diag,safe,recurrent", IPE_CASES)
def test_windowed_ipe(diag, safe, recurrent, alpha):
    mean, cov = _gaussians(diag, seed=3)
    j = jops.windowed_ipe((_j(mean), _j(cov)), MIN_DEG, MAX_DEG, alpha, diag, safe, recurrent)
    t = tops.windowed_ipe((_t(mean), _t(cov)), MIN_DEG, MAX_DEG, alpha, diag, safe, recurrent)
    _close_ipe(t, j, recurrent and diag, lead=3)


def test_full_covariance_ipe_ignores_tf32():
    """The full-covariance projection is exact elementwise arithmetic, so
    the TF32 switch cannot change it (the JAX package pins HIGHEST)."""
    mean, cov = _gaussians(False, seed=4)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        outs = []
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            outs.append(tops.integrated_pos_enc((_t(mean), _t(cov)), MIN_DEG, MAX_DEG, False))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("threshold", [0.1, 1.0])
def test_contract_gaussian(threshold):
    """Both sides of the threshold: inside, the Jacobian is the identity and
    the Gaussian passes unchanged."""
    mean, cov = _gaussians(False, seed=5)
    mean[0, :3] *= 0.05  # |x| < 0.1: inside either threshold
    mean[1] *= 3.0  # outside either
    j = jops.contract_gaussian(_j(mean), _j(cov), threshold)
    t = tops.contract_gaussian(_t(mean), _t(cov), threshold)
    for tv, jv in zip(t, j):
        _close(tv, jv)
    inside = np.linalg.norm(mean, axis=-1) <= threshold
    assert inside.any() and (~inside).any()
    np.testing.assert_array_equal(t[0].numpy()[inside], mean[inside])
    np.testing.assert_array_equal(t[1].numpy()[inside], cov[inside])
    # Its diagonal is the diagonal variant's covariance.
    _, diag = tops.contract_gaussian_diag(_t(mean), _t(np.diagonal(cov, axis1=-2, axis2=-1)),
                                          threshold)
    _close(torch.diagonal(t[1], dim1=-2, dim2=-1), diag.numpy())


def _composite_inputs(b=4, s=9, seed=10):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(b, s, 3)).astype(np.float32)
    density = (rng.uniform(size=(b, s, 1)) * 0.5).astype(np.float32)
    t_vals = np.sort(rng.uniform(0.2, 4.0, size=(b, s + 1)).astype(np.float32), axis=-1)
    _, dirs, _ = _rays(b=b)
    return rgb, density, t_vals, dirs


@pytest.mark.parametrize("background", ["white", "gray", "black", "random"])
def test_volumetric_rendering(background):
    args = _composite_inputs()
    key = jax.random.key(11)
    j = jops.volumetric_rendering(*map(_j, args), background, key)
    bg = np.asarray(jax.random.uniform(key, (1, 3), dtype=jnp.float32))
    t = tops.volumetric_rendering(*map(_t, args), background, bg_color=_t(bg))
    for tv, jv in zip(t, j):
        _close(tv, jv)
    with pytest.raises(ValueError, match="background"):
        tops.volumetric_rendering(*map(_t, args), "purple")


def test_volumetric_density_and_distance():
    _, density, t_vals, dirs = _composite_inputs(seed=12)
    density[0] = 0.0  # a ray with nothing on it: acc 0, distance NaN -> far
    j = jops.volumetric_density(_j(density), _j(t_vals), _j(dirs))
    t = tops.volumetric_density(_t(density), _t(t_vals), _t(dirs))
    for tv, jv in zip(t, j):
        _close(tv, jv)
    from durf_tpu.ops.render import distance_from_depth as j_distance

    acc = t[0].sum(dim=-1)
    jd = j_distance(_j(t[1].numpy()), _j(acc.numpy()), _j(t_vals))
    td = tops.distance_from_depth(t[1], acc, _t(t_vals))
    _close(td, jd)
    assert float(td[0]) == float(t_vals[0, -1])


@pytest.mark.parametrize("diag", [True, False])
def test_row_major_sampling_with_the_jax_draws(diag):
    origins, dirs, radii = _rays()
    b, s = 5, 8
    near, far = np.full((b, 1), 0.2, np.float32), np.full((b, 1), 4.0, np.float32)
    key = jax.random.key(13)
    jt, (jm, jc) = jops.sample_along_rays(
        key, *map(_j, (origins, dirs, radii)), s, _j(near), _j(far), True, False, "cone",
        diag=diag,
    )
    t_rand = np.asarray(jax.random.uniform(key, [b, s + 1]))
    tt, (tm, tc) = tops.sample_along_rays(
        *map(_t, (origins, dirs, radii)), s, _t(near), _t(far), False, "cone",
        randomized=True, t_rand=_t(t_rand), diag=diag,
    )
    assert tm.shape == (b, s, 3) and tc.shape == ((b, s, 3) if diag else (b, s, 3, 3))
    for tv, jv in zip((tt, tm, tc), (jt, jm, jc)):
        _close(tv, jv)

    weights = np.random.default_rng(14).uniform(size=(b, s)).astype(np.float32)
    n = 6
    key = jax.random.key(15)
    jt2, (jm2, jc2) = jops.resample_along_rays(
        key, *map(_j, (origins, dirs, radii)), jt, _j(weights), True, "cone", True, 0.01,
        num_samples=n, diag=diag,
    )
    jitter = np.asarray(jax.random.uniform(key, (b, n + 1),
                                           maxval=1.0 / (n + 1) - np.finfo(np.float32).eps))
    tt2, (tm2, tc2) = tops.resample_along_rays(
        *map(_t, (origins, dirs, radii)), tt, _t(weights), "cone", 0.01, num_samples=n,
        randomized=True, jitter=_t(jitter), diag=diag,
    )
    for tv, jv in zip((tt2, tm2, tc2), (jt2, jm2, jc2)):
        _close(tv, jv)
    with pytest.raises(ValueError, match="diagonal"):
        tops.sample_along_rays(*map(_t, (origins, dirs, radii)), s, _t(near), _t(far), False,
                               "cone", diag=False, cm=True)


def test_ops_export_every_name_of_the_jax_package():
    import inspect

    for name in jops.__all__:
        assert name in tops.__all__, name
        j_params = list(inspect.signature(getattr(jops, name)).parameters)
        t_params = list(inspect.signature(getattr(tops, name)).parameters)
        # The port takes a torch.Generator where JAX takes a key, and calls
        # an axis `dim`, as PyTorch does.
        j_params = [{"key": "generator", "axis": "dim"}.get(p, p) for p in j_params]
        assert set(j_params) <= set(t_params), (name, j_params, t_params)
