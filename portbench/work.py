"""The work a cell's inputs need, counted from shapes, and the chip's peaks.

A NeRF MLP's multiply-adds per sample are those of its trunk (the input
re-read at the skip layer), density head, bottleneck, conditioned head and
rgb head; the view condition's product is made once per ray, not per
sample. Forward operations are 2 per multiply-add, a backward's weight and
input gradients twice the forward's. The hand-written kernels' bounds are
the larger of operations at the bf16 tensor peak and bytes at the memory
peak, each input byte read once and each output byte written once.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W).
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def reads_x(mlp: dict, i: int) -> bool:
    return i == 0 or ((i - 1) % mlp["skip_layer"] == 0 and (i - 1) > 0)


def mlp_macs(mlp: dict, in_dim: int, cond_dim: int) -> int:
    """Multiply-adds per sample of one NeRF MLP (per-ray condition excluded)."""
    w, wc = mlp["net_width"], mlp["net_width_condition"]
    macs = 0
    for i in range(mlp["net_depth"]):
        d = in_dim if i == 0 else w + in_dim if reads_x(mlp, i) else w
        macs += d * w
    macs += w * mlp["num_density_channels"]
    head = w
    if cond_dim > 0:
        macs += w * w  # bottleneck
        for i in range(mlp["net_depth_condition"]):
            macs += (w if i == 0 else wc) * wc
        head = wc
    return macs + head * mlp["num_rgb_channels"]


def dims(model: dict) -> tuple:
    """(background input, object input, view condition) feature counts."""
    ipe = 2 * 3 * (model["max_deg_point"] - model["min_deg_point"])
    cond = 3 + 2 * 3 * model["deg_view"] if model["use_viewdirs"] else 0
    return ipe, 3 + ipe, cond


def level_samples(model: dict, i: int) -> int:
    if model["use_proposal"] and model["proposal_samples"] > 0 and i < model["num_levels"] - 1:
        return model["proposal_samples"]
    return model["num_samples"]


def level_mlps(model: dict) -> list:
    """The MLP config of each level's field (the proposal MLP on every level
    but the last when proposal levels are on)."""
    prop = model["use_proposal"] and model["num_levels"] > 1
    return [model["proposal_mlp"] if prop and i < model["num_levels"] - 1 else model["mlp"]
            for i in range(model["num_levels"])]


def forward_flops(model: dict, rays: int, hits_per_object) -> float:
    """MLP operations of one forward over `rays` rays: every level's field
    MLP on every sample, each object MLP on the samples of the rays that hit
    its box (`hits_per_object`, one count per object)."""
    bg_in, obj_in, cond = dims(model)
    total = 0.0
    for i, mlp in enumerate(level_mlps(model)):
        s = level_samples(model, i)
        total += 2.0 * mlp_macs(mlp, bg_in, cond) * rays * s
        if model["dynamics"]:
            total += 2.0 * mlp_macs(model["box_mlp"], obj_in, cond) * s * sum(hits_per_object)
    return total


def train_flops(model: dict, rays: int, hits_per_object) -> float:
    """Forward plus backward (weight and input gradients): 3x the forward;
    K2's recompute and the eager ops are left out."""
    return 3.0 * forward_flops(model, rays, hits_per_object)


def field_launches(model: dict, rays: int) -> list:
    """(macs per sample, input features, samples) of each level's field MLP
    launch: what K1 and K2 compute."""
    bg_in, _, cond = dims(model)
    return [(mlp_macs(mlp, bg_in, cond), bg_in, rays * level_samples(model, i))
            for i, mlp in enumerate(level_mlps(model))]


def mlp_weight_bytes(mlp: dict, in_dim: int, cond_dim: int) -> int:
    """bf16 bytes of an MLP's kernels and biases (the condition's rows
    included)."""
    return 2 * (mlp_macs(mlp, in_dim, cond_dim) + cond_dim * mlp["net_width_condition"]
                + 4 * mlp["net_width"])


def k1_bound_s(model: dict, rays: int) -> float:
    """K1's least time over one forward: per launch the larger of its
    operations at the bf16 peak and its bytes (float32 input planes read,
    float32 rgb and density written, bf16 weights) at the memory peak."""
    _, _, cond = dims(model)
    total = 0.0
    for (macs, f_in, n), mlp in zip(field_launches(model, rays), level_mlps(model)):
        ops = 2.0 * macs * n
        nbytes = 4 * f_in * n + 4 * 4 * n + mlp_weight_bytes(mlp, f_in, cond)
        total += max(ops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])
    return total


def k2_bound_s(model: dict, rays: int) -> float:
    """K2's least time over one backward: per launch the larger of the
    weight and input gradients' operations (twice the forward's) and its
    bytes (the float32 input planes and rgb / density cotangents read, the
    input gradient and float32 weight gradients written)."""
    _, _, cond = dims(model)
    total = 0.0
    for (macs, f_in, n), mlp in zip(field_launches(model, rays), level_mlps(model)):
        ops = 4.0 * macs * n
        nbytes = 4 * f_in * n + 4 * 4 * n + 4 * f_in * n + 2 * mlp_weight_bytes(mlp, f_in, cond)
        total += max(ops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])
    return total
