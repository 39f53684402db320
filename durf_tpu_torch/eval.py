"""Evaluation CLI: test-split PSNR / SSIM / depth-MSE (/ LPIPS) from a
checkpoint (the port's counterpart of the JAX package's `eval.py`).

Restore the latest checkpoint -> render every test view in chunks on one
card -> image metrics and saved renders. SSIM and LPIPS run on the device;
LPIPS (AlexNet) is optional: the `lpips` package where it is installed,
else durf_tpu_torch.lpips on a local weights file.

Usage:
  python -m durf_tpu_torch.eval --data_dir=... --train_dir=... \
      --gin_file=configs/waymo_fast.gin [--out_dir=...] [--lpips] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from durf_tpu_torch import mathx, vis
from durf_tpu_torch.checkpoints import CheckpointManager
from durf_tpu_torch.configs import Config, load_config
from durf_tpu_torch.data import get_dataset
from durf_tpu_torch.data.format import to_uint8, write_png, write_tiff_float32
from durf_tpu_torch.devices import resolve_device
from durf_tpu_torch.models.mipnerf import construct_model
from durf_tpu_torch.train import (
    TRAIN_SEED,
    evaluate_image,
    make_alpha_schedule,
    make_render_fn,
)


def restore_for_eval(config: Config, data_dir: str, train_dir: str, split: str = "test",
                     device="cuda"):
    """The apps' bootstrap: the split's dataset, the model restored from the
    latest checkpoint in `train_dir`, its step, and the chunk renderer
    (train.make_render_fn), on the card unless the caller asks for the CPU.
    The model is built from the train split's first batch, as training
    built it; `obj_ray_capacity` stays as the config sets it (-1, the
    gin files' auto mode, means no compaction at eval)."""
    device = resolve_device(device)
    dataset = get_dataset(split, data_dir, config)
    train_ds = get_dataset("train", data_dir, config)
    model = construct_model(config.model, train_ds.peek(), device, seed=TRAIN_SEED)
    ckpt = CheckpointManager(train_dir, keep=config.checkpoint_keep)
    if ckpt.latest_step is None:
        raise FileNotFoundError(f"no checkpoint found in {train_dir}")
    raw = ckpt.restore_raw()
    model.load_state_dict(raw["model"])
    render_chunk = make_render_fn(model, config, device)
    return dataset, model, int(raw["step"]), render_chunk


def _lpips_fn(weights: Optional[str] = None, device="cuda"):
    """Optional LPIPS (AlexNet) metric on `device`; None when unavailable.

    Resolution order: the `lpips` pip package (the reference notebook's
    dependency, render_eval_durf.ipynb cell 5) when importable, else
    durf_tpu_torch.lpips fed by a LOCAL weights file (`weights`, or
    $DURF_LPIPS_WEIGHTS), since a machine without network access cannot
    download the torchvision backbone the package needs."""
    device = resolve_device(device)
    try:
        lpips = importlib.import_module("lpips")
    except ImportError:
        lpips = None
    if lpips is not None:
        net = lpips.LPIPS(net="alex").to(device)

        def fn(a, b) -> float:
            def to_t(x):
                x = torch.as_tensor(x, dtype=torch.float32, device=device)
                return x.permute(2, 0, 1)[None] * 2 - 1

            with torch.no_grad():
                return float(net(to_t(a), to_t(b)))

        return fn
    weights = weights or os.environ.get("DURF_LPIPS_WEIGHTS")
    if weights and os.path.exists(weights):
        from durf_tpu_torch.lpips import load_lpips

        return load_lpips(weights, device)
    return None


def evaluate(
    config: Config,
    data_dir: str,
    train_dir: str,
    out_dir: Optional[str] = None,
    use_lpips: bool = False,
    log_fn=print,
    lpips_weights: Optional[str] = None,
    device="cuda",
) -> dict:
    """Score every test view of the latest checkpoint (durf_tpu/eval.py:94-175):
    per-image psnr, ssim, LIDAR-masked depth_mse (and lpips), their means,
    avg_error with LPIPS, eval_rays_per_sec over the whole loop (metrics
    and file writes included) and the step. With `out_dir`, writes
    pred_/gt_/depth_%03d.png, depth_%03d.tiff (raw float32 metric depth)
    and metrics.json."""
    device = resolve_device(device)
    dataset, _, step, render_chunk = restore_for_eval(config, data_dir, train_dir,
                                                      device=device)
    alpha = float(make_alpha_schedule(config)(step))
    lpips = _lpips_fn(lpips_weights, device) if use_lpips else None
    if use_lpips and lpips is None:
        log_fn(
            "lpips requested but neither the lpips package nor a local "
            "weights file (--lpips_weights / $DURF_LPIPS_WEIGHTS) is "
            "available; skipping"
        )

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    per_image = []
    t_start = time.time()
    total_rays = 0
    for i in range(dataset.size):
        case = next(dataset)
        out = evaluate_image(render_chunk, case, alpha, chunk=config.chunk)
        gt = case["pixels"]
        mse = float(((out["rgb"] - gt) ** 2).mean())
        psnr = float(mathx.mse_to_psnr(torch.tensor(mse)))
        rgb_d = torch.from_numpy(np.asarray(out["rgb"], np.float32)).to(device)
        gt_d = torch.from_numpy(np.asarray(gt, np.float32)).to(device)
        ssim = float(mathx.compute_ssim(rgb_d, gt_d, max_val=1.0))
        gt_depth = case["depth"].squeeze(-1)
        mask = gt_depth > 0
        depth_mse = float((((out["depth"] - gt_depth) ** 2) * mask).sum() / max(mask.sum(), 1))
        row = {"index": i, "psnr": psnr, "ssim": ssim, "depth_mse": depth_mse}
        if lpips is not None:
            row["lpips"] = lpips(rgb_d, gt_d)
        per_image.append(row)
        total_rays += int(np.prod(gt.shape[:2]))
        log_fn(f"view {i}: psnr={psnr:.2f} ssim={ssim:.3f} depth_mse={depth_mse:.4f}")

        if out_dir:
            write_png(os.path.join(out_dir, f"pred_{i:03d}.png"), to_uint8(out["rgb"]))
            write_png(os.path.join(out_dir, f"gt_{i:03d}.png"), to_uint8(gt))
            write_png(os.path.join(out_dir, f"depth_{i:03d}.png"),
                      to_uint8(vis.visualize_depth(out["depth"], out["acc"])))
            # Raw metric depth as float32 TIFF (reference utils.py:220-223).
            write_tiff_float32(os.path.join(out_dir, f"depth_{i:03d}.tiff"),
                               np.nan_to_num(out["depth"]).astype(np.float32))

    dt = time.time() - t_start
    summary = {
        "num_views": len(per_image),
        "psnr": float(np.mean([r["psnr"] for r in per_image])),
        "ssim": float(np.mean([r["ssim"] for r in per_image])),
        "depth_mse": float(np.mean([r["depth_mse"] for r in per_image])),
        "eval_rays_per_sec": total_rays / dt,
        "step": step,
        "per_image": per_image,
    }
    if lpips is not None:
        summary["lpips"] = float(np.mean([r["lpips"] for r in per_image]))
        # The paper's geometric-mean 'average' error (reference math.py:59-63).
        summary["avg_error"] = float(mathx.compute_avg_error(
            *(torch.tensor(summary[k]) for k in ("psnr", "ssim", "lpips"))))
    if out_dir:
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=2)
    log_fn(
        f"eval @ step {summary['step']}: psnr={summary['psnr']:.2f} "
        f"ssim={summary['ssim']:.3f} depth_mse={summary['depth_mse']:.4f} "
        f"({summary['eval_rays_per_sec']:.0f} rays/s)"
    )
    return summary


def main(argv=None, log_fn=print) -> dict:
    """The eval CLI (see the module docstring); returns the summary."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--gin_file", action="append", default=[])
    p.add_argument("--gin_param", action="append", default=[])
    p.add_argument("--out_dir", default=None)
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--lpips", action="store_true")
    p.add_argument(
        "--lpips_weights",
        default=None,
        help="local AlexNet-LPIPS weights (lpips state_dict .pt/.pth or the "
        ".npz layout) for durf_tpu_torch.lpips when the lpips package is "
        "unavailable; also read from $DURF_LPIPS_WEIGHTS",
    )
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    config = load_config(args.gin_file, args.gin_param)
    if args.chunk is not None:
        config.chunk = args.chunk
    return evaluate(
        config, args.data_dir, args.train_dir, args.out_dir, args.lpips, log_fn=log_fn,
        lpips_weights=args.lpips_weights, device=args.device,
    )


if __name__ == "__main__":
    main()
