"""The plain reference of the dynamic scene-graph Mip-NeRF: a frozen copy, in
plain PyTorch, of the port's coordinate-major diagonal route, the one every
cell runs (durf_tpu_torch/models/mipnerf.py, models/mlp.py's plain path and
the ops it calls). It imports nothing of the port and computes every MLP
product in float32 (TF32 off, see `strict_fp32`), or, for the correctness
control, with its operands rounded to a lower precision (`dot`).

Per level: stratified or inverse-CDF samples -> conical-frustum Gaussians
([3, B, S] planes) -> (dynamic) ray/box slab test, object-ray compaction,
windowed IPE and the object MLPs on the box-hitting rays -> background
mask, contraction, IPE, background (or proposal) MLP -> raw merge ->
activations -> compositing. Every random draw comes from the generator the
caller hands in, in the port's order, so one generator seeded alike gives
both sides the same jitter.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

_TRIG_PERIOD = 100.0 * math.pi
_F32_EPS = float(torch.finfo(torch.float32).eps)
_RESTART = 5  # the recurrent IPE restarts from fresh transcendentals every 5 degrees


def strict_fp32() -> None:
    """float32 products at full precision: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Rays(NamedTuple):
    origins: Any  # [B, 3]
    directions: Any  # [B, 3]
    viewdirs: Any  # [B, 3]
    radii: Any  # [B, 1]
    lossmult: Any  # [B, 1]
    near: Any  # [B, 1]
    far: Any  # [B, 1]


# --- operand precision ------------------------------------------------------

FP8_MAX = 448.0  # largest finite float8 e4m3 value


class _Round(torch.autograd.Function):
    """Round to a lower precision and back; the gradient passes through."""

    @staticmethod
    def forward(ctx, t, kind):
        if kind == "bfloat16":
            return t.to(torch.bfloat16).float()
        # fp8 e4m3 with one scale per tensor, as an fp8 GEMM takes it.
        scale = torch.clamp(t.detach().abs().amax() / FP8_MAX, min=1e-30)
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def dot(a: torch.Tensor, w: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """a @ w with float32 sums; operands rounded to `precision` first unless
    it is float32."""
    if precision != "float32":
        a, w = _Round.apply(a, precision), _Round.apply(w, precision)
    return torch.matmul(a, w)


# --- the MLP ------------------------------------------------------------------

def reads_x(cfg: dict, i: int) -> bool:
    """Whether trunk layer i takes the input (layer 0 and the skip layers)."""
    return i == 0 or ((i - 1) % cfg["skip_layer"] == 0 and (i - 1) > 0)


def layer_dims(cfg: dict, in_dim: int) -> list:
    w = cfg["net_width"]
    return [in_dim if i == 0 else w + in_dim if reads_x(cfg, i) else w
            for i in range(cfg["net_depth"])]


class Dense(nn.Module):
    def __init__(self, in_dim: int, features: int, stack: int | None = None):
        super().__init__()
        lead = () if stack is None else (stack,)
        self.kernel = nn.Parameter(torch.zeros(lead + (in_dim, features)))
        self.bias = nn.Parameter(torch.zeros(lead + (features,)))


class NerfMLP(nn.Module):
    """Trunk of relu layers re-reading the input after every `skip_layer`
    layers, a density head, and with a view condition a bottleneck and a
    conditioned colour head; the same parameter names as the port's."""

    def __init__(self, cfg: dict, in_dim: int, cond_dim: int, num_stack: int | None = None):
        super().__init__()
        self.cfg, self.cond_dim, self.num_stack = cfg, cond_dim, num_stack
        layers = {f"trunk_{i}": Dense(d, cfg["net_width"], num_stack)
                  for i, d in enumerate(layer_dims(cfg, in_dim))}
        layers["density_head"] = Dense(cfg["net_width"], cfg["num_density_channels"], num_stack)
        head_width = cfg["net_width"]
        if cond_dim > 0:
            layers["bottleneck"] = Dense(cfg["net_width"], cfg["net_width"], num_stack)
            for i in range(cfg["net_depth_condition"]):
                d = cfg["net_width"] + cond_dim if i == 0 else cfg["net_width_condition"]
                layers[f"head_{i}"] = Dense(d, cfg["net_width_condition"], num_stack)
            head_width = cfg["net_width_condition"]
        layers["rgb_head"] = Dense(head_width, cfg["num_rgb_channels"], num_stack)
        self.layers = nn.ModuleDict(layers)

    def _weights(self, o):
        return {n: (l.kernel, l.bias) if o is None else (l.kernel[o], l.bias[o])
                for n, l in self.layers.items()}

    def _trunk(self, x, cond_rows, precision, *flat):
        """x [N, F] -> (raw_rgb [N, C], raw_density [N, 1])."""
        cfg = self.cfg
        names = list(self.layers)
        w = dict(zip(names, zip(flat[0::2], flat[1::2])))
        width = cfg["net_width"]
        h = None
        for i in range(cfg["net_depth"]):
            k, b = w[f"trunk_{i}"]
            if i == 0:
                h = dot(x, k, precision) + b
            elif reads_x(cfg, i):
                h = dot(h, k[:width], precision) + dot(x, k[width:], precision) + b
            else:
                h = dot(h, k, precision) + b
            h = torch.relu(h)
        dk, db = w["density_head"]
        raw_density = dot(h, dk, precision) + db
        g = h
        if cond_rows is not None:
            bk, bb = w["bottleneck"]
            g = dot(h, bk, precision) + bb
            for i in range(cfg["net_depth_condition"]):
                hk, hb = w[f"head_{i}"]
                g = dot(g, hk[:width], precision) + (cond_rows if i == 0 else 0) + hb
                g = torch.relu(g)
        rk, rb = w["rgb_head"]
        return dot(g, rk, precision) + rb, raw_density

    def forward(self, x_fm, condition, precision="float32", o=None, remat=False):
        """x_fm [F, B, S] feature-major samples, condition [B, F_c]; object
        `o` of a stacked module. Returns ([C, B, S] rgb, [1, B, S] density)."""
        f, b, s = x_fm.shape
        w = self._weights(o)
        cond_rows = None
        if condition is not None:
            head0 = w["head_0"][0][self.cfg["net_width"]:]
            cond_rows = dot(condition, head0, precision).repeat_interleave(s, dim=0)
        flat = [t for pair in w.values() for t in pair]
        x = x_fm.reshape(f, b * s).T
        if remat and torch.is_grad_enabled():
            rgb, den = checkpoint(self._trunk, x, cond_rows, precision, *flat, use_reentrant=False)
        else:
            rgb, den = self._trunk(x, cond_rows, precision, *flat)
        return rgb.T.reshape(-1, b, s), den.T.reshape(-1, b, s)


# --- ray ops --------------------------------------------------------------------

def safe_norm(x, dim=-1, keepdim=True):
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=dim, keepdim=keepdim), min=1e-12))


def safe_sin(x):
    return torch.sin(torch.where(torch.abs(x) < _TRIG_PERIOD, x, torch.remainder(x, _TRIG_PERIOD)))


def pos_enc(x, min_deg, max_deg):
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)], dtype=x.dtype, device=x.device)
    xb = torch.reshape(x[..., None, :] * scales[:, None], x.shape[:-1] + (-1,))
    return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))], dim=-1)


def axis_angle_to_matrix(rotvec):
    x, y, z = rotvec[..., 0], rotvec[..., 1], rotvec[..., 2]
    zero = torch.zeros_like(x)
    skew = torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], dim=-2)
    angle = safe_norm(rotvec)[..., None] + 1e-12
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device).expand(skew.shape)
    return eye + (torch.sin(angle) / angle) * skew + ((1 - torch.cos(angle)) / angle**2) * (skew @ skew)


def rotate_vec(rot, v):
    return torch.stack([rot[..., i, 0] * v[..., 0] + rot[..., i, 1] * v[..., 1]
                        + rot[..., i, 2] * v[..., 2] for i in range(3)], dim=-1)


def world_to_box_frames(origins, dirs, box_pos, box_rot):
    o = rotate_vec(box_rot, origins[:, None, :] - box_pos)
    d = rotate_vec(box_rot, dirs[:, None, :].expand(box_pos.shape))
    return o, d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def ray_box_intersection(ray_o, ray_d, aabb_min, aabb_max):
    """Slab test: (z_in, z_out, hit), zero distances for misses."""
    inv_d = torch.reciprocal(ray_d)
    t_lo, t_hi = (aabb_min - ray_o) * inv_d, (aabb_max - ray_o) * inv_d
    t_near = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
    t_far = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    hit = torch.logical_and(t_far > t_near, t_far > 0).to(ray_o.dtype)
    zero = torch.zeros_like(t_near)
    return torch.where(hit > 0, t_near, zero), torch.where(hit > 0, t_far, zero), hit


def cast_rays_cm(t_vals, origins, directions, radii):
    """Conical frustums between the fenceposts as Gaussians: ([3, B, S]
    means, [3, B, S] covariance diagonals), by the stable moments."""
    t0, t1 = t_vals[..., :-1], t_vals[..., 1:]
    mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
    denom = 3 * mu**2 + hw**2
    t_mean = mu + (2 * mu * hw**2) / denom
    t_var = (hw**2) / 3 - (4 / 15) * ((hw**4 * (12 * mu**2 - hw**2)) / denom**2)
    r_var = radii**2 * ((mu**2) / 4 + (5 / 12) * hw**2 - (4 / 15) * (hw**4) / denom)
    d_mag_sq = torch.clamp(torch.sum(directions**2, dim=-1), min=1e-10)
    means, covs = [], []
    for k in range(3):
        dk = directions[..., k][..., None]
        dd = dk**2
        means.append(dk * t_mean)
        covs.append(t_var * dd + r_var * (1 - dd / d_mag_sq[..., None]))
    return torch.stack(means) + origins.T[..., None], torch.stack(covs)


def draw_rand(shape, generator, like):
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def sample_along_rays(origins, directions, radii, n, near, far, lindisp, randomized, generator):
    t = torch.linspace(0.0, 1.0, n + 1, dtype=origins.dtype, device=origins.device)
    t_vals = 1.0 / (near * (1.0 - t) + far * t) if lindisp else near * (1.0 - t) + far * t
    t_vals = t_vals.expand(origins.shape[0], n + 1)
    if randomized:
        mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        upper = torch.cat([mids, t_vals[..., -1:]], dim=-1)
        lower = torch.cat([t_vals[..., :1], mids], dim=-1)
        t_vals = lower + (upper - lower) * draw_rand((origins.shape[0], n + 1), generator, origins)
    return t_vals, cast_rays_cm(t_vals, origins, directions, radii)


def piecewise_constant_pdf(bins, weights, n, randomized, generator):
    """Inverse-CDF samples of a piecewise-constant PDF (sorted)."""
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0)
    weights = weights + padding / weights.shape[-1]
    pdf = weights / (weight_sum + padding)
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], dim=-1)
    shape = cdf.shape[:-1] + (n,)
    if randomized:
        s = 1.0 / n
        jitter = draw_rand(shape, generator, cdf) * (s - _F32_EPS)
        u = torch.arange(n, dtype=cdf.dtype, device=cdf.device) * s + jitter
        u = torch.clamp(u, max=1.0 - _F32_EPS).contiguous()
    else:
        u = torch.linspace(0.0, 1.0 - _F32_EPS, n, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(shape).contiguous()
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), u, right=True) - 1, 0, cdf.shape[-1] - 2)
    b0, b1 = torch.gather(bins, -1, idx), torch.gather(bins, -1, idx + 1)
    c0, c1 = torch.gather(cdf, -1, idx), torch.gather(cdf, -1, idx + 1)
    t = torch.clamp(torch.nan_to_num((u - c0) / (c1 - c0), nan=0.0), 0, 1)
    return b0 + t * (b1 - b0)


def resample_along_rays(origins, directions, radii, t_vals, weights, padding, n, randomized,
                        stop_grad, generator):
    pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], dim=-1)
    wmax = torch.maximum(pad[..., :-1], pad[..., 1:])
    blurred = 0.5 * (wmax[..., :-1] + wmax[..., 1:]) + padding
    new_t = piecewise_constant_pdf(t_vals, blurred, n + 1, randomized, generator)
    if stop_grad:
        new_t = new_t.detach()
    return new_t, cast_rays_cm(new_t, origins, directions, radii)


def contract_gaussian_diag(mean, cov, threshold):
    """Scene contraction of [3, ...] means and its diagonal-Jacobian push of
    the covariance diagonal."""
    sq = torch.sum(mean * mean, dim=0, keepdim=True)
    n = torch.sqrt(torch.clamp(sq, min=1e-12))
    inside = (n <= threshold).to(mean.dtype)
    inv_n = torch.nan_to_num(1.0 / n)
    mean_c = inside * mean + (1.0 - inside) * (2.0 - inv_n) * torch.nan_to_num(mean / n)
    s = torch.where(sq > 1e-12, torch.sum(mean, dim=0, keepdim=True) / n, torch.zeros_like(n))
    inv_n2 = inv_n * inv_n
    d_out = 2.0 * inv_n - inv_n2 - 2.0 * mean * s * inv_n2 + 2.0 * mean * s * inv_n2 * inv_n
    d = inside + (1.0 - inside) * d_out
    return mean_c, d * d * cov


def ipe_pieces(x, x_var, min_deg, max_deg, recurrent, safe=True):
    """(sin, cos) feature planes of the integrated positional encoding,
    ordered (degree, coordinate)."""
    x_var = torch.clamp(x_var, min=0.0)
    sin_p, cos_p = [], []
    if recurrent:
        e = s = c = None
        for i, deg in enumerate(range(min_deg, max_deg)):
            if i % _RESTART == 0:
                scale = 2.0**deg
                e = torch.exp((-0.5 * scale * scale) * x_var)
                s, c = torch.sin(scale * x), torch.cos(scale * x)
            sin_p.extend((e * s).unbind(0))
            cos_p.extend((e * c).unbind(0))
            e2 = e * e
            e = e2 * e2
            s, c = 2.0 * s * c, c * c - s * s
        return sin_p, cos_p
    sinf = safe_sin if safe else torch.sin
    for deg in range(min_deg, max_deg):
        scale = 2.0**deg
        att = torch.exp(-0.5 * (scale * scale) * x_var)
        sin_p.extend((att * sinf(scale * x)).unbind(0))
        cos_p.extend((att * sinf(scale * x + 0.5 * math.pi)).unbind(0))
    return sin_p, cos_p


def barf_window(alpha, min_deg, max_deg, dtype, device):
    alpha = torch.as_tensor(alpha, dtype=dtype, device=device)
    k = torch.arange(min_deg, max_deg, dtype=dtype, device=device)
    return (1 - torch.cos(torch.clamp(alpha - k, 0, 1) * math.pi)) / 2


def compute_weights(density, t_vals, dirs):
    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    dd = density * (t_dists * torch.linalg.vector_norm(dirs[..., None, :], dim=-1))
    alpha = 1 - torch.exp(-dd)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]), torch.cumsum(dd[..., :-1], dim=-1)], -1))
    return torch.nan_to_num(alpha * trans, nan=1e-8), t_mids, t_dists


def composite(rgb_cm, density, t_vals, dirs, background, generator):
    weights, t_mids, t_dists = compute_weights(density, t_vals, dirs)
    comp = (weights[None] * rgb_cm).sum(dim=-1).T
    acc = weights.sum(dim=-1)
    depth = (weights * t_mids).sum(dim=-1)
    residual = 1.0 - acc[..., None]
    if background == "white":
        comp = comp + residual
    elif background == "gray":
        comp = comp + 0.5 * residual
    elif background == "random":
        comp = comp + draw_rand((1, 3), generator, comp) * residual
    elif background != "black":
        raise ValueError(f"unknown background {background!r}")
    return comp, depth, acc, weights, t_mids, t_dists


def capacity_k(batch: int, capacity: float) -> int:
    """Compacted ray count: ceil(capacity * batch) rounded up to 128, at
    least 128, at most the batch; capacity <= 0 keeps every ray."""
    if capacity <= 0.0:
        return batch
    return min(batch, max(128, int(math.ceil(batch * capacity / 128)) * 128))


ACT = {"relu": torch.relu, "sigmoid": torch.sigmoid, "softplus": nn.functional.softplus}


class MipNerf(nn.Module):
    """The background field and the per-object fields in oriented boxes,
    parameters named as the port names them."""

    def __init__(self, cfg: dict, num_objects: int, timesteps: int):
        super().__init__()
        self.cfg = cfg
        ipe = 2 * 3 * (cfg["max_deg_point"] - cfg["min_deg_point"])
        cond = 3 + 2 * 3 * cfg["deg_view"] if cfg["use_viewdirs"] else 0
        self.background_mlp = NerfMLP(cfg["mlp"], ipe, cond)
        self.dynamic = cfg["dynamics"] and num_objects > 0
        if self.dynamic:
            self.object_mlps = NerfMLP(cfg["box_mlp"], 3 + ipe, cond, num_stack=num_objects)
            self.box_centers = nn.Parameter(torch.zeros((timesteps, num_objects, 6)))
        # False cuts the objects' encoding from its inputs, so no gradient
        # reaches the samples (or the pose) through it: a planted fault.
        self.window_grad = True
        self.use_proposal = cfg["use_proposal"] and cfg["num_levels"] > 1
        if self.use_proposal:
            self.proposal_mlp = NerfMLP(cfg["proposal_mlp"], ipe, cond)
        if cfg["grid_sampling"] or not (cfg["coord_major"] and cfg["diag_covariance"]):
            raise NotImplementedError("the reference holds the coordinate-major diagonal route")

    def level_samples(self, i):
        c = self.cfg
        if c["use_proposal"] and c["proposal_samples"] > 0 and i < c["num_levels"] - 1:
            return c["proposal_samples"]
        return c["num_samples"]

    def forward(self, rays: Rays, ext, ts, background="gray", alpha=10.0, randomized=False,
                generator=None, precision="float32", remat=False, capacity=0.0):
        cfg = self.cfg
        origins, dirs = rays.origins, rays.directions
        batch = origins.shape[0]
        if self.dynamic:
            t = int(ts)
            box_pose, box_rot = self.box_centers[t, :, :3], self.box_centers[t, :, 3:]
            if cfg["no_pose_opt"]:
                box_pose = box_pose.detach()
            if cfg["no_yaw_opt"]:
                box_rot = box_rot.detach()
            n_obj = box_pose.shape[0]
            origins_o, dirs_o = world_to_box_frames(
                origins, dirs, box_pose.expand(batch, n_obj, 3),
                axis_angle_to_matrix(box_rot).expand(batch, n_obj, 3, 3))
            dims = ext.expand(batch, n_obj, 3)
            z_in, z_out, hit = ray_box_intersection(origins_o, dirs_o, -dims, dims)
            hit = hit.detach()
            miss_all = (hit.sum(dim=-1) == 0).to(origins.dtype)
            origins_s = (origins_o * hit[..., None]).sum(dim=-2) + miss_all[..., None] * origins
            dirs_s = (dirs_o * hit[..., None]).sum(dim=-2) + miss_all[..., None] * dirs
            z_out_ret = (hit * z_out).sum(dim=-1)
            dyn_mask = hit.sum(dim=-1, keepdim=True)
            anyhit = hit.sum(dim=-1) > 0
            k = capacity_k(batch, capacity)
        else:
            origins_s, dirs_s = origins, dirs
            z_out_ret = torch.zeros((batch,), device=origins.device)
            dyn_mask = torch.zeros((batch, 1), device=origins.device)
            box_pose = box_rot = torch.zeros((1, 3), device=origins.device)

        near, far = rays.near, rays.far
        if self.dynamic and cfg["use_box_nearfar"]:
            m = cfg["box_nearfar_margin"]
            near = (hit * (z_in - m)).sum(-1, keepdim=True) + miss_all[..., None] * rays.near
            far = (hit * (z_out + m)).sum(-1, keepdim=True) + miss_all[..., None] * rays.far
            near = torch.maximum(near, rays.near).detach()
            far = torch.minimum(torch.maximum(far, near + 1e-3), rays.far).detach()
        venc = pos_enc(rays.viewdirs, 0, cfg["deg_view"]) if cfg["use_viewdirs"] else None

        ret: List[Dict[str, Any]] = []
        t_vals = weights = None
        for lvl in range(cfg["num_levels"]):
            n = self.level_samples(lvl)
            if lvl == 0:
                t_vals, (mean, cov) = sample_along_rays(
                    origins_s, dirs_s, rays.radii, n, near, far, cfg["lindisp"], randomized, generator)
            else:
                t_vals, (mean, cov) = resample_along_rays(
                    origins_s, dirs_s, rays.radii, t_vals, weights, cfg["resample_padding"], n,
                    randomized, cfg["stop_level_grad"], generator)
            if cfg["disable_integration"]:
                cov = torch.zeros_like(cov)
            out: Dict[str, Any] = {}
            if self.dynamic:
                obj_rgb, obj_den = self._objects(mean, cov, venc, hit, anyhit, k, alpha, precision,
                                                  remat)
                out["obj_centroid"] = self._centroid(mean, obj_den, hit, ext)
                out["obj_hit_rays"] = anyhit.sum().to(torch.float32)
                bkgd = torch.clamp(1.0 - hit.sum(dim=-1), min=0.0).detach()[None, :, None]
                mean, cov = bkgd * mean, bkgd * cov
            if cfg["contraction"]:
                mean, cov = contract_gaussian_diag(mean, cov, cfg["contract_threshold"])
            sin_p, cos_p = ipe_pieces(mean, cov, cfg["min_deg_point"], cfg["max_deg_point"],
                                      cfg["recurrent_encode"], not cfg["fast_trig"])
            enc = torch.stack(sin_p + cos_p, dim=0)
            proposal = self.use_proposal and lvl < cfg["num_levels"] - 1
            mlp = self.proposal_mlp if proposal else self.background_mlp
            raw_rgb, raw_den = mlp(enc, venc, precision, remat=remat)
            if self.dynamic:
                raw_rgb, raw_den = raw_rgb + obj_rgb, raw_den + obj_den
            if randomized and cfg["density_noise"] > 0:
                raw_den = raw_den + cfg["density_noise"] * torch.randn(
                    raw_den.shape, generator=generator, dtype=raw_den.dtype, device=raw_den.device)
            rgb = ACT[cfg["rgb_activation"]](raw_rgb)
            density = ACT[cfg["density_activation"]](raw_den + cfg["density_bias"])
            comp, depth, acc, weights, t_mids, t_dists = composite(
                rgb, density[0], t_vals, dirs_s, background, generator)
            ret.append(dict(**out, rgb=comp, depth=depth, acc=acc, weights=weights, t_vals=t_vals,
                            t_mids=t_mids, t_dists=t_dists, pose=box_pose, rot=box_rot,
                            dyn_mask=dyn_mask, z_out=z_out_ret))
        return ret

    def _objects(self, mean, cov, venc, hit, anyhit, k, alpha, precision, remat=False):
        """sum_o hit_o * MLP_o(windowed IPE) on the k rays that come first
        when the box-hitting rays are put before the others (all rays when
        k is the batch), scattered back into zeros: ([3, B, S], [1, B, S])."""
        cfg = self.cfg
        batch = mean.shape[1]
        if k < batch:
            idx = torch.sort(anyhit.to(torch.int32), descending=True, stable=True).indices[:k]
            mean_c, cov_c = mean.index_select(1, idx), cov.index_select(1, idx)
            hit_c, venc_c = hit.index_select(0, idx), venc.index_select(0, idx)
        else:
            mean_c, cov_c, hit_c, venc_c = mean, cov, hit, venc
        if not self.window_grad:
            mean_c, cov_c = mean_c.detach(), cov_c.detach()
        sin_p, cos_p = ipe_pieces(mean_c, cov_c, cfg["min_deg_point"], cfg["max_deg_point"],
                                  cfg["recurrent_encode"], not cfg["fast_trig"])
        w = barf_window(alpha, cfg["min_deg_point"], cfg["max_deg_point"], mean.dtype, mean.device)
        sin_p = [w[i // 3] * p for i, p in enumerate(sin_p)]
        cos_p = [w[i // 3] * p for i, p in enumerate(cos_p)]
        enc = torch.stack(list(mean_c.unbind(0)) + sin_p + cos_p, dim=0)
        rgb = den = 0.0
        for o in range(hit.shape[1]):
            r, d = self.object_mlps(enc, venc_c, precision, o=o, remat=remat)
            gate = hit_c[:, o][None, :, None]
            rgb, den = rgb + gate * r, den + gate * d
        if k < batch:
            rgb = rgb.new_zeros((rgb.shape[0], batch, rgb.shape[2])).index_copy(1, idx, rgb)
            den = den.new_zeros((den.shape[0], batch, den.shape[2])).index_copy(1, idx, den)
        return rgb, den

    def _centroid(self, mean, obj_den, hit, ext):
        """The object-centering readout [N_obj, 3] (midrange or mean of the
        occupied in-slab canonical samples, weights detached)."""
        cfg = self.cfg
        x32 = mean.float()
        n_obj = hit.shape[1]
        sigma = ACT[cfg["density_activation"]](obj_den[0].float() + cfg["density_bias"])
        in_slab = (x32.abs()[None] <= ext[:, :, None, None]).all(dim=1).float()
        mask = hit.T[:, :, None].float() * in_slab
        if cfg["centering_mode"] == "mean":
            w = sigma.detach()[None] * mask
            num = torch.einsum("obs,cbs->oc", w, x32)
            return num / (w.sum(dim=(1, 2))[:, None] + 1e-6)
        beta, tau = cfg["centering_beta"], cfg["centering_tau"]
        w_occ = (torch.clamp(sigma, max=tau) / tau).detach()[None] * mask
        logw = torch.where(w_occ > 0.0, torch.log(torch.clamp(w_occ, min=1e-30)), -1e9)
        logw = logw.reshape(n_obj, 1, -1)
        xo = x32.reshape(1, 3, -1)
        hi = torch.logsumexp(beta * xo + logw, dim=-1)
        lo = torch.logsumexp(-beta * xo + logw, dim=-1)
        mid = (hi - lo) / (2.0 * beta)
        occupied = w_occ.sum(dim=(1, 2)) > 0.0
        return torch.where(occupied[:, None], mid, torch.zeros_like(mid))
