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
the same raw scene and draws the same rows.
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
        """The reference's batch of step i (its first half with `half`)."""
        pools, ext = self.read()["pools"], self.read()["ext"]
        counts = [p["pixels"].shape[0] for p in pools]
        ts, idx = ref_scene.draw(len(pools), counts, self.batch, self.sample_seed, i, self.device)
        n = self.batch // (2 if half else 1)
        rows = {k: v.index_select(0, idx[:n]) for k, v in pools[ts].items()}
        return {"rays": ref_nerf.Rays(*(rows[k] for k in traffic.RAY_KEYS)), "pixels": rows["pixels"],
                "depth": rows["depth"], "sky": rows["sky"], "ext": ext[ts], "ts": ts}

    def reference(self, precision="float32", half=False) -> dict:
        """The reference's readings of CHECK_STEPS steps."""
        ref_nerf.strict_fp32()
        c, r = self.c, self.read()
        model = ref_nerf.MipNerf(c["model"], r["init"].shape[1], r["init"].shape[0]).to(self.device)
        weights.load(model, {**self.w, POSE: r["init"]})
        opt = ref_step.ScheduledAdam(c, list(model.named_parameters()))
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        out = {"loss": []}
        for i in range(CHECK_STEPS):
            loss, grads = ref_step.train_step(model, opt, c, self.ref_batch(i, half), i, STEP_SEED,
                                              precision=precision, capacity=r["capacity"])
            out["loss"].append(loss)
            if i == 0:
                out["grad"] = {n: float(g.norm()) for n, g in grads.items()}
        out["change"] = {n: float((p.detach() - p0[n]).norm()) for n, p in model.named_parameters()}
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
        self.step_fn = ptrain.make_train_step(model, pc, opt, seed=STEP_SEED)
        self.losses = []
        self.readings = {"loss": []}
        for i in range(CHECK_STEPS):
            self.step(self.draw(i))
            self.readings["loss"].append(float(self.losses[-1]))
            if i == 0:
                # A parameter Adam has no state for got no gradient.
                self.readings["grad"] = {
                    n: float(opt.opt.state[p]["exp_avg"].norm()) / (1.0 - BETA1)
                    if "exp_avg" in opt.opt.state[p] else 0.0
                    for n, p in model.named_parameters()
                }
        self.readings["change"] = {n: float((p.detach() - p0[n]).norm())
                                   for n, p in model.named_parameters()}
        self.done = CHECK_STEPS
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
