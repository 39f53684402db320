"""The port's AlexNet-LPIPS (durf_tpu_torch/lpips.py) against the JAX
package's metric on the same random weights, in both file layouts (.npz and
an `lpips.LPIPS(net='alex').state_dict()` file): rtol 1e-4 (float32
convolutions, sums in another order). Also the metric's properties, the
loader's refusals and eval's `_lpips_fn` resolution order: the `lpips`
package (a stand-in module here: neither machine has it), then a local
weights file, else None."""

import sys
import types

import numpy as np
import pytest
import torch

from durf_tpu.lpips import load_lpips as j_load_lpips
from durf_tpu.lpips import save_random_weights as j_save_random_weights
from durf_tpu_torch import eval as teval
from durf_tpu_torch.lpips import (
    _CONVS,
    _SLICE_KEYS,
    LPIPS,
    _load_state,
    load_lpips,
    save_random_weights,
)


def _imgs(h=64, w=80):
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape).astype(np.float32), 0, 1)
    return a, b


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "w.npz")
    save_random_weights(path)
    return path


def test_random_weights_file_is_the_jax_fixture(npz, tmp_path):
    j_path = str(tmp_path / "j.npz")
    j_save_random_weights(j_path)
    ours, theirs = np.load(npz), np.load(j_path)
    assert sorted(ours.files) == sorted(theirs.files)
    for k in ours.files:
        np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("shape", [(64, 80), (47, 93)])
def test_npz_metric_matches_jax(npz, shape):
    a, b = _imgs(*shape)
    ours, theirs = load_lpips(npz, "cpu"), j_load_lpips(npz)
    np.testing.assert_allclose(ours(a, b), theirs(a, b), rtol=1e-4)
    np.testing.assert_allclose(ours(b, a), theirs(b, a), rtol=1e-4)
    assert ours(a, a) == 0.0


def test_batched_images_and_tensors(npz):
    a, b = _imgs()
    metric = load_lpips(npz, "cpu")
    batch = metric(np.stack([a, b]), np.stack([b, b]))
    np.testing.assert_allclose(batch, 0.5 * metric(a, b), rtol=1e-5)
    assert metric(torch.from_numpy(a), torch.from_numpy(b)) == metric(a, b)


def test_metric_properties(npz):
    a, _ = _imgs()
    metric = load_lpips(npz, "cpu")
    noise = np.random.default_rng(7).normal(0, 1, a.shape).astype(np.float32)
    near, far = np.clip(a + 0.02 * noise, 0, 1), np.clip(a + 0.4 * noise, 0, 1)
    assert 0.0 < metric(a, near) < metric(a, far)


def test_torch_state_dict_layout_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    sd = {}
    for key, (o, i, k, _, _) in zip(_SLICE_KEYS, _CONVS):
        sd[f"net.{key}.weight"] = torch.from_numpy(
            rng.normal(0, 0.05, (o, i, k, k)).astype(np.float32))
        sd[f"net.{key}.bias"] = torch.from_numpy(rng.normal(0, 0.01, o).astype(np.float32))
    for idx, (o, *_rest) in enumerate(_CONVS):
        sd[f"lin{idx}.model.1.weight"] = torch.from_numpy(
            rng.uniform(0, 1, (1, o, 1, 1)).astype(np.float32))
    path = str(tmp_path / "lpips_alex.pth")
    torch.save(sd, path)
    a, b = _imgs()
    ours = load_lpips(path, "cpu")
    np.testing.assert_allclose(ours(a, b), j_load_lpips(path)(a, b), rtol=1e-4)
    assert ours(a, a) == 0.0


def test_missing_file_and_default_device_raise(npz):
    with pytest.raises(FileNotFoundError):
        load_lpips("/nonexistent/weights.pth", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_lpips(npz)


def test_metric_keeps_tf32_off_in_its_scope(npz, monkeypatch):
    """The convolutions see allow_tf32=False, whatever the caller set, and
    the caller's setting comes back."""
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    metric = LPIPS(*_load_state(npz))
    before = torch.backends.cudnn.allow_tf32
    a, b = _imgs()
    metric(a, b)
    assert seen and not any(seen)
    assert torch.backends.cudnn.allow_tf32 == before


def test_lpips_fn_resolution_order(npz, monkeypatch):
    monkeypatch.delenv("DURF_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setitem(sys.modules, "lpips", None)  # not installed
    assert teval._lpips_fn(device="cpu") is None
    monkeypatch.setenv("DURF_LPIPS_WEIGHTS", npz)
    a, b = _imgs()
    np.testing.assert_allclose(teval._lpips_fn(device="cpu")(a, b),
                               load_lpips(npz, "cpu")(a, b), rtol=0)

    # The package wins over the weights file: it gets NCHW images in [-1, 1].
    calls = []

    class FakeNet(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            calls.append(net)

        def forward(self, x, y):
            calls.append((x.shape, float(x.min()), float(y.max())))
            return (x - y).abs().mean().reshape(1, 1, 1, 1)

    monkeypatch.setitem(sys.modules, "lpips", types.SimpleNamespace(LPIPS=FakeNet))
    fn = teval._lpips_fn(npz, device="cpu")
    got = fn(a, b)
    assert calls[0] == "alex"
    assert calls[1] == ((1, 3, 64, 80), float(2 * a.min() - 1), float(2 * b.max() - 1))
    np.testing.assert_allclose(got, 2 * np.abs(a - b).mean(), rtol=1e-5)


def test_small_images_give_nan_as_in_jax(npz):
    """At 20x16 AlexNet's second pool leaves an empty map: the reference's
    metric returns NaN (durf_tpu/lpips.py:82, 129) and so does the port,
    where it raised before; at 40x40 both are finite and agree."""
    ours, theirs = load_lpips(npz, "cpu"), j_load_lpips(npz)
    a, b = _imgs(16, 20)
    assert np.isnan(theirs(a, b)) and np.isnan(ours(a, b))
    a, b = _imgs(40, 40)
    np.testing.assert_allclose(ours(a, b), theirs(a, b), rtol=1e-4)
