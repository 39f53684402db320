"""E1, the model's encodings as one kernel (ops/kernels/encode.py), on the
CPU: each mode's wrapper equals the composition the model ran before it
bitwise (recurrent and direct forms, contraction on and off, rays hitting
0, 1 and 2 boxes, a window mid-ramp, the per-object route's zero sample,
compacted slots); the kernel's window formula from a float alpha is
barf_window's bitwise; the chain rule csrc/encode.cu's backward writes out,
replayed here in float64, matches autograd through the plain composition;
the model calls the windowed and background modes once a level and the
view mode once on coordinate-major samples, never on row-major ones; and
`enc.samples` counts every encoded sample. The kernel itself runs only on
the card (chip_smoke.py --only encode).
"""

import ctypes
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from durf_tpu_torch import metrics, ops
from durf_tpu_torch.configs import MLPConfig, ModelConfig
from durf_tpu_torch.data.synthetic import example_ray_batch
from durf_tpu_torch.models import construct_model
from durf_tpu_torch.ops import encoding
from durf_tpu_torch.ops.kernels import encode as e1

B, S = 8, 6
# Rays 0-3 hit no box, 4-5 one, 6 the other, 7 both (the clamp).
HITS = [[0, 0]] * 4 + [[1, 0], [1, 0], [0, 1], [1, 1]]


def _samples(dtype=torch.float32, seed=0):
    """[3, B, S] means from near the origin (inside the contraction's 0.1)
    to 60 away, and variances with a few negatives (the clamp)."""
    rng = np.random.default_rng(seed)
    scale = np.geomspace(0.01, 60.0, B * S).reshape(1, B, S)
    mean = rng.normal(size=(3, B, S)) * scale
    var = rng.uniform(-1e-4, 1e-2, size=(3, B, S)) * (1 + scale)
    return torch.tensor(mean, dtype=dtype), torch.tensor(var, dtype=dtype)


def _hit(dtype=torch.float32):
    return torch.tensor(HITS, dtype=dtype)


def _model_background(mean, cov, hit, min_deg, max_deg, contraction, safe, recurrent):
    """The background's encoding as MipNerf.forward composed it before E1."""
    if hit is not None:
        bkgd = torch.clamp(1.0 - hit.sum(dim=-1), min=0.0).detach()
        mask = bkgd[None, :, None]
        mean, cov = mask * mean, mask * cov
    if contraction:
        mean, cov = ops.contract_gaussian_diag(mean, cov, threshold=0.1, dim=0)
    return ops.integrated_pos_enc_cm(mean, cov, min_deg, max_deg, safe=safe, recurrent=recurrent)


FORMS = [dict(recurrent=True, safe=True), dict(recurrent=False, safe=True),
         dict(recurrent=False, safe=False)]
FORM_IDS = ["recurrent", "direct-safe", "direct"]


@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("contraction", [True, False], ids=["contracted", "uncontracted"])
@pytest.mark.parametrize("masked", [True, False], ids=["hit-mask", "no-objects"])
def test_background_mode_is_the_models_composition_bitwise(form, contraction, masked):
    mean, var = _samples()
    hit = _hit() if masked else None
    got = e1.background_ipe(mean, var, hit, 0, 10, contraction, 0.1, **form)
    want = _model_background(mean, var, hit, 0, 10, contraction, **form)
    assert got.shape == (60, B, S) and torch.equal(got, want)
    if masked:  # rays hitting one box or two encode the zero sample
        zero = _model_background(torch.zeros_like(mean), torch.zeros_like(var), None, 0, 10,
                                 contraction, **form)
        assert torch.equal(got[:, 4:], zero[:, 4:])
        assert not torch.equal(got[:, :4], zero[:, :4])


@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("alpha", [10.0, 3.7, 0.0], ids=["open", "mid-ramp", "closed"])
def test_windowed_mode_is_windowed_ipe_cm_bitwise(form, alpha):
    mean, var = _samples()
    got = e1.windowed_ipe(mean, var, 0, 10, alpha, **form)
    want = ops.windowed_ipe_cm(mean, var, 0, 10, alpha, **form)
    assert got.shape == (63, B, S) and torch.equal(got, want)
    assert torch.equal(got[:3], mean)
    w = encoding.barf_window(alpha, 0, 10, torch.float32, "cpu")
    # Mid-ramp: degrees 0-2 open, 3 partial, 4-9 closed (exact zeros).
    if alpha == 3.7:
        assert w[:3].eq(1).all() and 0 < w[3] < 1 and w[4:].eq(0).all()
        assert got[3 + 4 * 3: 33].eq(0).all() and got[33 + 4 * 3:].eq(0).all()


@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
def test_windowed_mode_on_the_zero_sample_and_compacted_slots(form):
    """The per-object route's c0 ([3, 1, 1] zeros) and the compaction's k
    gathered rays encode as the plain composition does."""
    zero = torch.zeros((3, 1, 1))
    c0 = e1.windowed_ipe(zero, zero, 0, 10, 10.0, **form)
    assert c0.shape == (63, 1, 1) and torch.equal(c0, ops.windowed_ipe_cm(zero, zero, 0, 10, 10.0,
                                                                           **form))
    assert c0[3:33].eq(0).all() and c0[33:].eq(1).all()  # sin 0 = 0, cos 0 = 1
    mean, var = _samples()
    idx = torch.tensor([7, 4, 6, 5])
    got = e1.windowed_ipe(mean.index_select(1, idx), var.index_select(1, idx), 0, 10, 10.0, **form)
    full = ops.windowed_ipe_cm(mean, var, 0, 10, 10.0, **form)
    assert torch.equal(got, full.index_select(1, idx))


@pytest.mark.parametrize("deg", [4, 2, 0])
def test_view_mode_is_pos_enc_bitwise(deg):
    dirs = torch.nn.functional.normalize(torch.randn((B, 3), generator=torch.Generator()
                                                     .manual_seed(deg)), dim=-1)
    got = e1.view_pe(dirs, deg)
    assert got.shape == (B, 3 + 6 * deg)
    assert torch.equal(got, ops.pos_enc(dirs, 0, deg, append_identity=True))


def test_cpu_gradients_are_autograd_of_the_plain_composition():
    mean, var = _samples()
    hit = _hit()
    g = torch.randn((60, B, S), generator=torch.Generator().manual_seed(1))
    m1, v1 = mean.clone().requires_grad_(), var.clone().requires_grad_()
    e1.background_ipe(m1, v1, hit, 0, 10, True, 0.1, safe=True, recurrent=True).backward(g)
    m2, v2 = mean.clone().requires_grad_(), var.clone().requires_grad_()
    _model_background(m2, v2, hit, 0, 10, True, safe=True, recurrent=True).backward(g)
    assert torch.equal(m1.grad, m2.grad) and torch.equal(v1.grad, v2.grad)
    assert e1.encode.launches == e1.encode_bwd.launches == 0


@pytest.mark.parametrize("alpha", [0.0, 1.0 / 3.0, 2.5, 3.7, 9.99, 10.0, 12.0])
def test_window_from_a_float_alpha_is_barf_windows_bitwise(alpha):
    """csrc/encode.cu's window(): alpha arrives as a C float (ctypes rounds
    as torch.as_tensor does), then (1 - cos(clamp(alpha - k, 0, 1) * pi_f))
    * 0.5 in float32, each step rounded."""
    a = np.float32(ctypes.c_float(alpha).value)
    assert a == np.float32(torch.as_tensor(alpha, dtype=torch.float32).item())
    ks = np.arange(0, 10, dtype=np.float32)
    t = np.clip(a - ks, np.float32(0), np.float32(1)).astype(np.float32)
    arg = (t * np.float32(math.pi)).astype(np.float32)
    c = torch.cos(torch.from_numpy(arg)).numpy()
    w = ((np.float32(1) - c) * np.float32(0.5)).astype(np.float32)
    want = encoding.barf_window(alpha, 0, 10, torch.float32, "cpu").numpy()
    assert w.tobytes() == want.tobytes()
    value, on_card = e1._alpha(torch.tensor(alpha), torch.device("cpu"))
    assert on_card is None and value == float(torch.tensor(alpha))


# The chain rule of csrc/encode.cu's encode_bwd, replayed in float64.
def _ipe_vjp(x, v, gs, gc, min_deg, w):
    """(dx, dv) of the windowed IPE [w_k e_k sin, w_k e_k cos] of planes x,
    v from the cotangents gs, gc ([D, 3, ...])."""
    dx, dv = torch.zeros_like(x), torch.zeros_like(v)
    for i in range(gs.shape[0]):
        k = min_deg + i
        e = torch.exp(-0.5 * 4.0**k * torch.clamp(v, min=0.0))
        fs, fc = w[i] * e * torch.sin(2.0**k * x), w[i] * e * torch.cos(2.0**k * x)
        dx = dx + 2.0**k * (gs[i] * fc - gc[i] * fs)
        dv = dv - 0.5 * 4.0**k * (gs[i] * fs + gc[i] * fc)
    return dx, torch.where(v >= 0, dv, torch.zeros_like(dv))


def _split(g, d, first):
    return (g[first: first + 3 * d].reshape((d, 3) + g.shape[1:]),
            g[first + 3 * d:].reshape((d, 3) + g.shape[1:]))


def _background_vjp(mean, var, hit, g, min_deg, max_deg, contraction, threshold):
    d = max_deg - min_deg
    m = torch.clamp(1.0 - hit.sum(-1), min=0.0)[None, :, None] if hit is not None else 1.0
    x, vin = m * mean, m * var
    if contraction:
        mc, vc = ops.contract_gaussian_diag(x, vin, threshold=threshold, dim=0)
        _, dd = ops.contraction._contract_with_row_sums(x, threshold, 0)
    else:
        mc, vc, dd = x, vin, torch.ones_like(x)
    gm, gvc = _ipe_vjp(mc, vc, *_split(g, d, 0), min_deg, [1.0] * d)
    gv = gvc * dd * dd
    gx = gm
    if contraction:
        sq = (x * x).sum(0, keepdim=True)
        u = 1.0 / torch.sqrt(torch.clamp(sq, min=1e-12))
        du = torch.where(sq >= 1e-12, -u**3, torch.zeros_like(u))
        live = sq > 1e-12
        sigma = torch.where(live, x.sum(0, keepdim=True), torch.zeros_like(u))
        q = 2.0 * gvc * vin * dd
        xg, qs, qx = (x * gm).sum(0, keepdim=True), q.sum(0, keepdim=True), (q * x).sum(0, True)
        out = (2 * u - u**2) * gm + (2 - 2 * u) * du * x * (xg + qs)
        out = out + torch.where(live, 2 * (u**4 - u**3) * (q * sigma + qx)
                                + 2 * sigma * (4 * u**3 - 3 * u**2) * du * x * qx,
                                torch.zeros_like(out))
        inside = torch.sqrt(torch.clamp(sq, min=1e-12)) <= threshold
        gx = torch.where(inside, gm, out)
    return m * gx, m * gv


@pytest.mark.parametrize("contraction", [True, False], ids=["contracted", "uncontracted"])
@pytest.mark.parametrize("masked", [True, False], ids=["hit-mask", "no-objects"])
def test_background_backward_chain_rule_matches_autograd(contraction, masked):
    mean, var = _samples(torch.float64, seed=3)
    hit = _hit(torch.float64) if masked else None
    g = torch.randn((60, B, S), dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    m, v = mean.clone().requires_grad_(), var.clone().requires_grad_()
    encoding.background_ipe_cm(m, v, hit, 0, 10, contraction, 0.1, recurrent=False).backward(g)
    dx, dv = _background_vjp(mean, var, hit, g, 0, 10, contraction, 0.1)
    torch.testing.assert_close(dx, m.grad, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(dv, v.grad, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("alpha", [10.0, 3.7])
def test_windowed_backward_chain_rule_matches_autograd(alpha):
    mean, var = _samples(torch.float64, seed=4)
    g = torch.randn((63, B, S), dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    m, v = mean.clone().requires_grad_(), var.clone().requires_grad_()
    ops.windowed_ipe_cm(m, v, 0, 10, alpha, recurrent=True).backward(g)
    w = encoding.barf_window(alpha, 0, 10, torch.float64, "cpu")
    dx, dv = _ipe_vjp(mean, var, *_split(g, 10, 3), 0, w)
    torch.testing.assert_close(g[:3] + dx, m.grad, rtol=1e-8, atol=1e-8)
    torch.testing.assert_close(dv, v.grad, rtol=1e-8, atol=1e-8)


def test_view_backward_chain_rule_matches_autograd():
    dirs = torch.randn((B, 3), dtype=torch.float64, generator=torch.Generator().manual_seed(6))
    g = torch.randn((B, 27), dtype=torch.float64, generator=torch.Generator().manual_seed(7))
    x = dirs.clone().requires_grad_()
    ops.pos_enc(x, 0, 4, append_identity=True).backward(g)
    want = g[:, :3].clone()
    for k in range(4):
        y = 2.0**k * dirs
        want += 2.0**k * (g[:, 3 + 3 * k: 6 + 3 * k] * torch.cos(y)
                          + g[:, 15 + 3 * k: 18 + 3 * k] * torch.cos(y + 0.5 * math.pi))
    torch.testing.assert_close(want, x.grad, rtol=1e-12, atol=1e-12)


def test_other_devices_raise_and_the_kernel_takes_at_most_32_degrees():
    meta = torch.zeros((3, 2, 2), device="meta")
    for call in (lambda: e1.windowed_ipe(meta, meta, 0, 10, 10.0),
                 lambda: e1.background_ipe(meta, meta, None, 0, 10, True),
                 lambda: e1.view_pe(torch.zeros((2, 3), device="meta"), 4)):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()
    with pytest.raises(ValueError, match="32 degrees"):
        e1._run(e1.Spec(e1.WINDOWED, 0, 33), torch.zeros((3, 1)), torch.zeros((3, 1)))


def _tiny(**fields):
    return ModelConfig(
        num_samples=4, max_deg_point=3, deg_view=2, use_pallas_mlp=True,
        mlp=MLPConfig(net_depth=1, net_width=8, net_width_condition=8),
        box_mlp=MLPConfig(net_depth=1, net_width=8, net_width_condition=8), **fields,
    )


def _forward(cfg, batch_size=6):
    batch = example_ray_batch(batch_size=batch_size)
    model = construct_model(cfg, batch, device="cpu")
    with torch.no_grad():
        model(batch["rays"].to("cpu"), torch.from_numpy(batch["ext"]), 1)
    return cfg


@pytest.fixture
def spy(monkeypatch):
    calls = {"windowed": 0, "background": 0, "view": 0}
    for mode, name in (("windowed", "windowed_ipe"), ("background", "background_ipe"),
                       ("view", "view_pe")):
        real = getattr(e1, name)

        def counted(*args, _real=real, _mode=mode, **kwargs):
            calls[_mode] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(e1, name, counted)
    return calls


# At 256 rays a capacity of 0.25 keeps k = 128 (compaction's floor).
COMPACTED = ({"obj_ray_capacity": 0.25}, 256)


@pytest.mark.parametrize("fields,batch", [({}, 6), ({"num_levels": 3}, 6), COMPACTED],
                         ids=["two-levels", "three-levels", "compacted"])
def test_a_coord_major_forward_calls_each_mode_once_a_level(spy, fields, batch):
    cfg = _forward(_tiny(**fields), batch)
    assert spy == {"windowed": cfg.num_levels, "background": cfg.num_levels, "view": 1}


@pytest.mark.parametrize("fields", [{"coord_major": False}, {"diag_covariance": False}],
                         ids=["row-major", "full-covariance"])
def test_row_major_and_full_covariance_forwards_never_call_the_wrapper(spy, fields):
    _forward(_tiny(**fields))
    assert spy == {"windowed": 0, "background": 0, "view": 0}


@pytest.mark.parametrize(
    "fields,batch,per_level",
    [({}, 6, 2 * 6 * 4), (*COMPACTED, 256 * 4 + 128 * 4),
     ({"fused_objects": False}, 6, 2 * 6 * 4 + 1), ({"coord_major": False}, 6, 2 * 6 * 4 + 1),
     ({"dynamics": False}, 6, 6 * 4)],
    ids=["fused", "compacted", "per-object", "row-major", "static"],
)
def test_enc_samples_counts_every_encoded_sample(fields, batch, per_level):
    """4 samples a ray and level: the background's, the objects' (on the
    compacted route the k = 128 gathered rays'), and the per-object routes'
    zero sample."""
    metrics.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        cfg = _forward(_tiny(**fields), batch)
    counts = metrics.counters()
    assert counts["enc.samples"] == cfg.num_levels * per_level
    assert "enc.kernel_samples" not in counts  # the CPU runs the plain compositions
