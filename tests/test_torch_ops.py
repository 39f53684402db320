"""Value parity of the port's ops (durf_tpu_torch.mathx / .ops) with the JAX
package's, in float32 on the CPU: the same numpy inputs go to both.

Tolerance: atol 1e-5 (both sides are float32 with different operation
orders); 1e-4 for IPE degrees >= 8, where sin(2^k x) amplifies the input's
rounding by 2^k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from durf_tpu import mathx as jmathx
from durf_tpu import ops as jops
from durf_tpu_torch import mathx as tmathx
from durf_tpu_torch import ops as tops

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(t_val, j_val, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(
        t_val.detach().numpy(), np.asarray(j_val), atol=atol, rtol=rtol
    )


@pytest.fixture(autouse=True)
def _full_fp32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("fn", ["safe_sin", "safe_cos"])
def test_safe_trig(fn):
    x = np.array([0.0, 1.0, -3.0, 300.0, -1e3, 1e5, 3.3e6], np.float32)
    _close(getattr(tmathx, fn)(_t(x)), getattr(jmathx, fn)(jnp.asarray(x)), atol=1e-4)


def _pdf_case(kind):
    rng = np.random.default_rng(3)
    bins = np.sort(rng.uniform(0, 10, size=(6, 17)).astype(np.float32), axis=-1)
    weights = rng.uniform(size=(6, 16)).astype(np.float32)
    if kind == "zeros":
        weights[:] = 0.0
    elif kind == "duplicates":
        weights[:, 3:9] = 0.0  # zero-weight bins duplicate CDF values
        weights[0, :] = 0.0
        weights[0, 5] = 1.0
    return bins, weights


@pytest.mark.parametrize("kind", ["random", "zeros", "duplicates"])
def test_sorted_piecewise_constant_pdf(kind):
    bins, weights = _pdf_case(kind)
    j = jmathx.sorted_piecewise_constant_pdf(
        jax.random.key(0), jnp.asarray(bins), jnp.asarray(weights), 24, False
    )
    t = tmathx.sorted_piecewise_constant_pdf(_t(bins), _t(weights), 24)
    _close(t, j)


def _rays(b=5, seed=0):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 0.3
    origins = (rng.normal(size=(b, 3)) * 0.5).astype(np.float32)
    radii = np.full((b, 1), 0.01, np.float32)
    return origins, dirs, radii


@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
def test_cast_rays_cm(ray_shape):
    origins, dirs, radii = _rays()
    rng = np.random.default_rng(1)
    t_vals = np.sort(rng.uniform(0.5, 20, size=(5, 9)).astype(np.float32), axis=-1)
    jm, jc = jops.cast_rays_cm(
        jnp.asarray(t_vals), jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(radii), ray_shape
    )
    tm, tc = tops.cast_rays_cm(_t(t_vals), _t(origins), _t(dirs), _t(radii), ray_shape)
    _close(tm, jm, atol=1e-4)
    _close(tc, jc, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("lindisp", [False, True])
def test_sample_along_rays(lindisp):
    origins, dirs, radii = _rays()
    near = np.full((5, 1), 0.5, np.float32)
    far = np.full((5, 1), 30.0, np.float32)
    jt, (jm, jc) = jops.sample_along_rays(
        None, jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(radii), 16,
        jnp.asarray(near), jnp.asarray(far), False, lindisp, "cone", diag=True, cm=True,
    )
    tt, (tm, tc) = tops.sample_along_rays(
        _t(origins), _t(dirs), _t(radii), 16, _t(near), _t(far), lindisp, "cone",
        diag=True, cm=True,
    )
    _close(tt, jt, atol=1e-5, rtol=1e-6)
    _close(tm, jm, atol=1e-4, rtol=1e-6)
    _close(tc, jc, atol=1e-6, rtol=1e-4)


def test_resample_along_rays():
    origins, dirs, radii = _rays()
    rng = np.random.default_rng(2)
    t_vals = np.sort(rng.uniform(0.5, 20, size=(5, 9)).astype(np.float32), axis=-1)
    weights = rng.uniform(size=(5, 8)).astype(np.float32)
    weights[1] = 0.0
    jt, (jm, jc) = jops.resample_along_rays(
        None, jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(radii),
        jnp.asarray(t_vals), jnp.asarray(weights), False, "cone", True, 0.01,
        num_samples=12, diag=True, cm=True,
    )
    tt, (tm, tc) = tops.resample_along_rays(
        _t(origins), _t(dirs), _t(radii), _t(t_vals), _t(weights), "cone", 0.01, num_samples=12,
        diag=True, cm=True,
    )
    _close(tt, jt, atol=1e-5, rtol=1e-6)
    _close(tm, jm, atol=1e-4, rtol=1e-6)
    _close(tc, jc, atol=1e-6, rtol=1e-4)


def test_pos_enc():
    x = np.random.default_rng(4).normal(size=(7, 3)).astype(np.float32)
    _close(tops.pos_enc(_t(x), 0, 4, True), jops.pos_enc(jnp.asarray(x), 0, 4, True))


def _gauss(shape=(3, 6, 5), seed=5, scale=1.5):
    rng = np.random.default_rng(seed)
    mean = (rng.uniform(-scale, scale, size=shape)).astype(np.float32)
    var = (rng.uniform(0, 1e-3, size=shape)).astype(np.float32)
    return mean, var


def _by_degree(t_feat, j_feat, n_deg, lead=0, recurrent=False):
    """Compare [lead + 2*3*n_deg, ...] feature planes degree by degree.

    1e-4 where the input's rounding is amplified: degrees >= 8 (sin(2^k x)),
    and in the recurrent form the degrees 3 and 4 steps past a restart,
    where the double-angle chain has amplified the seed sin/cos's last-ulp
    difference between the two libraries 8-16 fold."""
    t_feat, j_feat = t_feat.detach().numpy(), np.asarray(j_feat)
    np.testing.assert_allclose(t_feat[:lead], j_feat[:lead], atol=ATOL)
    for half in range(2):
        for deg in range(n_deg):
            lo = lead + half * 3 * n_deg + 3 * deg
            amplified = deg >= 8 or (recurrent and deg % 5 >= 3)
            atol = 1e-4 if amplified else ATOL
            np.testing.assert_allclose(
                t_feat[lo : lo + 3], j_feat[lo : lo + 3], atol=atol, err_msg=f"degree {deg}"
            )


@pytest.mark.parametrize(
    "safe,recurrent", [(True, False), (False, False), (True, True)]
)
def test_integrated_pos_enc_cm(safe, recurrent):
    mean, var = _gauss()
    j = jops.integrated_pos_enc_cm(jnp.asarray(mean), jnp.asarray(var), 0, 10, safe, recurrent)
    t = tops.integrated_pos_enc_cm(_t(mean), _t(var), 0, 10, safe, recurrent)
    _by_degree(t, j, 10, recurrent=recurrent)


@pytest.mark.parametrize("alpha", [10.0, 3.4])
@pytest.mark.parametrize("recurrent", [False, True])
def test_windowed_ipe_cm(alpha, recurrent):
    mean, var = _gauss(seed=6)
    j = jops.windowed_ipe_cm(jnp.asarray(mean), jnp.asarray(var), 0, 10, alpha, True, recurrent)
    t = tops.windowed_ipe_cm(_t(mean), _t(var), 0, 10, alpha, True, recurrent)
    _by_degree(t, j, 10, lead=3, recurrent=recurrent)


def test_contract():
    x = np.random.default_rng(7).normal(size=(11, 3)).astype(np.float32) * 5
    x[0] = 0.01
    _close(tops.contract(_t(x), 0.1), jops.contract(jnp.asarray(x), 0.1), atol=1e-6)


@pytest.mark.parametrize("scale", [0.2, 5.0, 200.0])
def test_contract_gaussian_diag(scale):
    mean, var = _gauss(seed=8, scale=scale)
    mean[:, 0, 0] = 0.01  # inside the 0.1 threshold
    jm, jc = jops.contract_gaussian_diag(jnp.asarray(mean), jnp.asarray(var), 0.1, axis=0)
    tm, tc = tops.contract_gaussian_diag(_t(mean), _t(var), 0.1, dim=0)
    _close(tm, jm, atol=1e-6, rtol=1e-6)
    _close(tc, jc, atol=1e-9, rtol=1e-5)


def test_axis_angle_and_box_frames():
    rng = np.random.default_rng(9)
    rotvec = rng.normal(size=(4, 3)).astype(np.float32)
    rotvec[0] = 0.0
    _close(tops.axis_angle_to_matrix(_t(rotvec)), jops.axis_angle_to_matrix(jnp.asarray(rotvec)), atol=1e-6)
    origins, dirs, _ = _rays(b=6)
    pos = rng.normal(size=(6, 4, 3)).astype(np.float32)
    rot = np.asarray(jops.axis_angle_to_matrix(jnp.asarray(rotvec)))
    rot = np.broadcast_to(rot, (6, 4, 3, 3)).copy()
    jo, jd = jops.world_to_box_frames(*(jnp.asarray(a) for a in (origins, dirs, pos, rot)))
    to, td = tops.world_to_box_frames(_t(origins), _t(dirs), _t(pos), _t(rot))
    _close(to, jo, atol=1e-5)
    _close(td, jd, atol=1e-6)


def _box_rays():
    """Rays in a box frame: hits, misses, axis-parallel misses (±inf slab
    distances) and a ray origin inside the box."""
    o = np.array(
        [[0, 0, 5], [3, 3, 5], [2, 0, 5], [0, 0, 0], [0, 0, -5], [-2.5, 0.5, 5]], np.float32
    )
    d = np.array(
        [[0, 0, -1], [0, 0, -1], [0, 0, -1], [1, 0, 0], [0, 0, -1], [0.6, 0, -0.8]], np.float32
    )
    return o, d


def test_ray_box_intersection_hits_and_misses():
    o, d = _box_rays()
    ext = np.ones((6, 3), np.float32)
    j = jops.ray_box_intersection(jnp.asarray(o), jnp.asarray(d), -jnp.asarray(ext), jnp.asarray(ext))
    t = tops.ray_box_intersection(_t(o), _t(d), -_t(ext), _t(ext))
    for tv, jv in zip(t, j):
        assert np.isfinite(tv.numpy()).all()
        _close(tv, jv)
    assert t[2].numpy().tolist() == [1, 0, 0, 1, 0, 1]


def test_ray_hitting_both_boxes_clamps_background():
    # One world ray down -z through two axis-aligned boxes at z = -4 and -8.
    origins = np.zeros((1, 3), np.float32)
    dirs = np.array([[0, 0, -1]], np.float32)
    pos = np.array([[[0, 0, -4], [0, 0, -8]]], np.float32)
    rot = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 2, 3, 3)).copy()
    ext = np.full((1, 2, 3), 0.5, np.float32)
    jo, jd = jops.world_to_box_frames(*(jnp.asarray(a) for a in (origins, dirs, pos, rot)))
    j = jops.ray_box_intersection(jo, jd, -jnp.asarray(ext), jnp.asarray(ext))
    to, td = tops.world_to_box_frames(_t(origins), _t(dirs), _t(pos), _t(rot))
    t = tops.ray_box_intersection(to, td, -_t(ext), _t(ext))
    for tv, jv in zip(t, j):
        _close(tv, jv)
    hit = t[2]
    assert hit.sum().item() == 2.0
    # The model's background mask, max(0, 1 - sum(hit)), is 0, not -1.
    assert torch.clamp(1.0 - hit.sum(dim=-1), min=0.0).item() == 0.0


@pytest.mark.parametrize("background", ["white", "gray", "black"])
def test_volumetric_rendering_cm(background):
    rng = np.random.default_rng(10)
    b, s = 4, 9
    rgb = rng.uniform(size=(3, b, s)).astype(np.float32)
    density = (rng.uniform(size=(b, s)) * 3).astype(np.float32)
    t_vals = np.sort(rng.uniform(0.5, 20, size=(b, s + 1)).astype(np.float32), axis=-1)
    _, dirs, _ = _rays(b=b)
    j = jops.volumetric_rendering_cm(
        jnp.asarray(rgb), jnp.asarray(density), jnp.asarray(t_vals), jnp.asarray(dirs), background
    )
    t = tops.volumetric_rendering_cm(_t(rgb), _t(density), _t(t_vals), _t(dirs), background)
    for tv, jv in zip(t, j):
        _close(tv, jv, atol=1e-5, rtol=1e-6)
