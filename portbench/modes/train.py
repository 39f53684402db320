"""Training cells: the port's `train.make_train_step` step, built as the
training app builds it, driven in a closed loop over the cell's traffic.

Set-up builds the one step object (model, optimizer state, step function)
from the seed's weights and drives it through its first CHECK_STEPS steps,
through the same call and feed the window uses, keeping what correctness
compares: each step's loss, the first gradient as Adam got it (its first
moment after one step over 1 - beta1) and the parameters' change after the
last of them. The window then goes on with the same object. After the
window the reference runs the same steps from the same weights on batches
it draws itself from the same inputs, with the same random draws.

The traffic is a scene (traffic/): written to disk and trained through the
app's data path (get_dataset, its auto capacity, device-resident pools,
each step's batch drawn by device_data.sample_batch); the reference reads
the same raw scene and draws the same rows, instance ids and object ids
with them.

A cell may start mid-run: the traffic's `start_step` (default 0) is the
step both sides begin at, for the schedules (learning rate, eps, the
objects' frequency window alpha), the batch draws and each step's random
stream, and Adam's count. It stands for a run resumed from its checkpoint
of that step whose optimizer moments were not carried: the weights are
the seed's, and Adam's moments and bias correction start afresh on both
sides.

Where the configuration trains the box poses, the readings also keep the
pose table's first gradient as Adam got it and its change as vectors; the
reference keeps besides, for each row (timestep) the check steps drew, its
gradient as Adam got it at the first step that drew the row, from which
compare.py picks the entries whose change it compares.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from portbench import cells, compare, traffic, weights
from portbench.reference import nerf as ref_nerf
from portbench.reference import scene as ref_scene
from portbench.reference import step as ref_step

# The training loop's own seed of each step's random stream
# (durf_tpu_torch.train.TRAIN_SEED); both sides seed their generator from it.
STEP_SEED = 20200823
CHECK_STEPS = 3
BETA1 = 0.9
POSE = "box_centers"


def trains_pose(c: dict) -> bool:
    """Whether the configuration trains the box poses (translation or yaw)."""
    m = c["model"]
    return m["dynamics"] and not (m["no_pose_opt"] and m["no_yaw_opt"])


# Planted faults of the reference in the program's place (control.py and
# the tests): the pose table frozen (translation and rotation); the
# objects' encoding cut from its inputs, which drops the photometric pose
# gradient and keeps the prior's.
FAULTS = ("pose_frozen", "window_bwd_zeroed")


def reference_shapes(c: dict, n_obj: int, timesteps: int) -> list:
    """(name, shape) of every MLP weight; the pose table is each side's own."""
    with torch.device("meta"):
        model = ref_nerf.MipNerf(c["model"], n_obj, timesteps)
    return [(n, tuple(p.shape)) for n, p in model.named_parameters() if n != POSE]


def resolve_capacity(c: dict, hit_share: float) -> float:
    """ModelConfig.obj_ray_capacity as the training app resolves auto (-1):
    the margin times the worst hit share, capped at 1; 0 without hits."""
    cap = c["model"]["obj_ray_capacity"]
    if cap >= 0:
        return cap
    return 0.0 if hit_share == 0.0 else min(1.0, c["model"]["obj_capacity_margin"] * hit_share)


class Inputs:
    """The cell's inputs from the seed, and the reference's view of them:
    the configuration as run, the scene, the MLP weights, and (read when
    first needed, after the window) the reference's pools, pose table,
    capacity and check batches and the hits per object of a batch."""

    def __init__(self, run):
        dev = self.device = run.device
        self.t = run.workload["traffic"]
        c = self.c = cells.run_config(run.config, run.workload)
        self.batch = self.t["batch"]
        self.start_step = self.t.get("start_step", 0)
        self.sample_seed = run.seed % (1 << 31)
        self.scene = traffic.Scene(self.t)
        self.w = weights.make(reference_shapes(c, self.scene.n_obj, self.scene.timesteps), run.seed, dev)
        self._read = None

    def read(self) -> dict:
        """The reference's reading of the train split: {pools, init, ext,
        hits, capacity}."""
        if self._read is None:
            dev, c = self.device, self.c
            split = self.scene.split(c, "train")
            r = {"pools": ref_scene.pools(split, dev), "init": torch.from_numpy(split["init"]).to(dev),
                 "ext": torch.from_numpy(split["ext"]).to(dev)}
            shares = torch.stack([traffic.hit_matrix(p, r["init"][ts], r["ext"][ts]).mean(dim=0)
                                  for ts, p in enumerate(r["pools"])])
            # Every timestep is drawn alike: the expected hits of a batch.
            r["hits"] = (self.batch * shares.mean(dim=0)).tolist()
            r["capacity"] = resolve_capacity(c, ref_scene.max_hit_fraction(split, c))
            self._read = r
        return self._read

    def ref_batch(self, i: int, half: bool = False) -> dict:
        """The reference's batch of step i (its first half with `half`):
        the drawn rows (their instance ids `inst` where the scene has
        usable masks), the timestep's boxes and the object ids 1..N_obj."""
        pools, ext = self.read()["pools"], self.read()["ext"]
        counts = [p["pixels"].shape[0] for p in pools]
        ts, idx = ref_scene.draw(len(pools), counts, self.batch, self.sample_seed, i, self.device)
        n = self.batch // (2 if half else 1)
        rows = {k: v.index_select(0, idx[:n]) for k, v in pools[ts].items()}
        out = {"rays": ref_nerf.Rays(*(rows[k] for k in traffic.RAY_KEYS)), "pixels": rows["pixels"],
               "depth": rows["depth"], "sky": rows["sky"], "ext": ext[ts], "ts": ts}
        if "inst" in rows:
            out["inst"] = rows["inst"]
        if ext.shape[1] > 0:
            out["obj_ids"] = torch.arange(1, ext.shape[1] + 1, dtype=torch.int32, device=self.device)
        return out

    def reference(self, precision="float32", half=False, fault=None) -> dict:
        """The reference's readings of CHECK_STEPS steps from `start_step`
        (with `fault`, one of FAULTS, planted)."""
        ref_nerf.strict_fp32()
        c, r = self.c, self.read()
        if fault == "pose_frozen":
            c = {**c, "model": {**c["model"], "no_pose_opt": True, "no_yaw_opt": True}}
        model = ref_nerf.MipNerf(c["model"], r["init"].shape[1], r["init"].shape[0]).to(self.device)
        model.window_grad = fault != "window_bwd_zeroed"
        weights.load(model, {**self.w, POSE: r["init"]})
        opt = ref_step.ScheduledAdam(c, list(model.named_parameters()), start=self.start_step)
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        pose = trains_pose(self.c) and model.dynamic
        out = {"loss": []}
        if pose:
            out["pose_rows"] = []
            out["pose_first_grad"] = torch.zeros_like(p0[POSE], device="cpu")
        for i in range(CHECK_STEPS):
            step = self.start_step + i
            batch = self.ref_batch(step, half)
            loss, grads = ref_step.train_step(model, opt, c, batch, step, STEP_SEED,
                                              precision=precision, capacity=r["capacity"])
            out["loss"].append(loss)
            if i == 0:
                out["grad"] = {n: float(g.norm()) for n, g in grads.items()}
                if pose:
                    out["pose_grad"] = grads[POSE].detach().cpu()
            if pose:
                row = batch["ts"]
                if row not in out["pose_rows"]:
                    out["pose_first_grad"][row] = grads[POSE][row].detach().cpu()
                out["pose_rows"].append(row)
        out["change"] = {n: float((p.detach() - p0[n]).norm()) for n, p in model.named_parameters()}
        if pose:
            out["pose_change"] = (model.box_centers.detach() - p0[POSE]).cpu()
        return out


class Driver:
    unit = "step"

    def __init__(self, run):
        from durf_tpu_torch import train as ptrain
        from durf_tpu_torch.models.mipnerf import construct_model

        self.run, dev = run, run.device
        x = self.inputs = Inputs(run)
        self.c, self.rays_per_unit = x.c, x.batch
        if dev.type == "cuda":
            from durf_tpu_torch.ops.kernels import build

            build.build_all()
        pc, example = self._load_scene(ptrain)
        model = construct_model(pc.model, example, dev, seed=ptrain.TRAIN_SEED)
        weights.load(model, x.w, keep=(POSE,))
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = ptrain.make_optimizer(pc, model)
        self.state = ptrain.create_train_state(pc, model, opt)
        start = x.start_step
        self.state.step = opt.count = start
        self.step_fn = ptrain.make_train_step(model, pc, opt, seed=STEP_SEED)
        self.losses = []
        self.readings = {"loss": []}
        pose = trains_pose(x.c) and POSE in p0
        for i in range(CHECK_STEPS):
            self.step(self.draw(start + i))
            self.readings["loss"].append(float(self.losses[-1]))
            if i == 0:
                # A parameter Adam has no state for got no gradient.
                self.readings["grad"] = {
                    n: float(opt.opt.state[p]["exp_avg"].norm()) / (1.0 - BETA1)
                    if "exp_avg" in opt.opt.state[p] else 0.0
                    for n, p in model.named_parameters()
                }
                if pose:
                    self.readings["pose_grad"] = (opt.opt.state[model.box_centers]["exp_avg"]
                                                  / (1.0 - BETA1)).cpu()
        self.readings["change"] = {n: float((p.detach() - p0[n]).norm())
                                   for n, p in model.named_parameters()}
        if pose:
            self.readings["pose_change"] = (model.box_centers.detach() - p0[POSE]).cpu()
        self.done = start + CHECK_STEPS
        self.losses = []

    def _load_scene(self, ptrain):
        """The training app's data path on the written scene: the train
        split's dataset, the auto capacity, the device-resident pools."""
        from durf_tpu_torch.data import device_data, get_dataset

        x = self.inputs
        pc = cells.program_config(x.c)
        self.dataset = get_dataset("train", x.scene.directory(), pc)
        if pc.model.obj_ray_capacity < 0.0:
            pc.model.obj_ray_capacity = ptrain.resolve_obj_capacity(pc, self.dataset, lambda *a: None)
        self.pools = [device_data.build_pools(self.dataset, self.run.device)]
        c2f = tuple(pc.c2f_steps)

        def draw(i):
            return device_data.sample_batch_c2f(self.pools, i, c2f, x.sample_seed, x.batch)

        self.draw = draw
        return pc, self.dataset.peek()

    @contextlib.contextmanager
    def loop(self):
        """The training app's loop runs with Python's cyclic collector off
        (train.run_training collects every Config.gc_every steps)."""
        gc.disable()
        try:
            yield
        finally:
            gc.enable()

    def step(self, batch) -> None:
        self.state, stats = self.step_fn(self.state, batch)
        self.losses.append(stats["train/loss"])

    def work(self) -> dict:
        """Counts per unit for the per-layer readers."""
        from portbench import work

        m, b = self.c["model"], self.rays_per_unit
        return {"flops": work.train_flops(m, b, self.inputs.read()["hits"]), "rays": b,
                "k1_bound_s": work.k1_bound_s(m, b), "k2_bound_s": work.k2_bound_s(m, b)}

    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def release(self) -> None:
        del self.state, self.step_fn, self.losses
        for name in ("pools", "dataset"):
            self.__dict__.pop(name, None)
        self.inputs.scene.close()

    def check(self) -> dict:
        """The numbers compared: the program's readings against the
        reference's on the same weights, inputs and draws."""
        return compare.train_numbers(self.readings, self.inputs.reference())
