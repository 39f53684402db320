"""Render cells: full views of the benchmark's scene through the eval apps'
path: `train.make_render_fn` under `train.evaluate_image` (render_image in
chunks of Config.chunk rays), the model built from the train split's first
batch as the apps build it and its MLP weights from the seed; the views are
the split's test cases in the dataset's order, cycled.

The apps render a trained checkpoint, so the BARF window is the one at the
end of training (the alpha schedule at Config.max_steps). After the window
a sample of the rendered views, drawn from the seed, is rendered again by
the reference from its own reading of the scene and compared pixel by
pixel.
"""

from __future__ import annotations

import contextlib
import math
import random

import numpy as np
import torch

from portbench import cells, compare, traffic, weights
from portbench.modes.train import POSE, reference_shapes
from portbench.reference import nerf as ref_nerf
from portbench.reference import step as ref_step
from portbench.reference.step import alpha_schedule

TRAIN_SEED = 20200823  # durf_tpu_torch.train.TRAIN_SEED: the apps' model seed


class Inputs:
    """The scene, the MLP weights and the trained alpha, and (read when
    first needed, after the window) the reference's reading of the split."""

    def __init__(self, run):
        dev = self.device = run.device
        t = self.t = run.workload["traffic"]
        c = self.c = cells.run_config(run.config, run.workload)
        self.scene = traffic.Scene(t)
        self.alpha = alpha_schedule(c["max_steps"], c)
        self.w = weights.make(reference_shapes(c, self.scene.n_obj, self.scene.timesteps), run.seed, dev)
        self._read = None

    def read(self) -> dict:
        """{split, init, ext}: the reference's reading of the split."""
        if self._read is None:
            split = self.scene.split(self.c, self.t["split"])
            self._read = {"split": split, "init": torch.from_numpy(split["init"]).to(self.device),
                          "ext": torch.from_numpy(split["ext"]).to(self.device)}
        return self._read

    def view_rays(self, v: int) -> tuple:
        split = self.read()["split"]
        im = split["images"][v]
        rays = {k: torch.from_numpy(np.ascontiguousarray(im["rays"][k].reshape(-1, im["rays"][k].shape[-1])))
                .to(self.device) for k in traffic.RAY_KEYS}
        return rays, int(split["timesteps"][v]) - 1

    def hits(self) -> list:
        """Rays hitting each box, per view, averaged over the split's views."""
        r, per = self.read(), []
        for v in range(len(r["split"]["images"])):
            rays, ts = self.view_rays(v)
            per.append(traffic.hit_matrix(rays, r["init"][ts], r["ext"][ts]).sum(dim=0))
        return torch.stack(per).mean(dim=0).tolist()

    def reference(self, v: int, precision: str = "float32") -> dict:
        """The reference's render of view v: {rgb, depth, acc} [H*W, ...]."""
        ref_nerf.strict_fp32()
        c, r = self.c, self.read()
        model = ref_nerf.MipNerf(c["model"], r["init"].shape[1], r["init"].shape[0]).to(self.device)
        weights.load(model, {**self.w, POSE: r["init"]})
        rays, ts = self.view_rays(v)
        n, chunk = rays["origins"].shape[0], self.t["chunk"]
        outs = []
        for i in range(0, n, chunk):
            chunk_rays = ref_nerf.Rays(*(rays[k][i:i + chunk] for k in traffic.RAY_KEYS))
            outs.append(ref_step.render_rays(model, c, chunk_rays, r["ext"][ts], ts, self.alpha,
                                             precision, capacity=c["model"]["obj_ray_capacity"]))
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


class Driver:
    unit = "view"

    def __init__(self, run):
        from durf_tpu_torch.data import get_dataset
        from durf_tpu_torch.models.mipnerf import construct_model
        from durf_tpu_torch.train import evaluate_image, make_render_fn

        self.run, dev = run, run.device
        x = self.inputs = Inputs(run)
        if dev.type == "cuda":
            from durf_tpu_torch.ops.kernels import build

            build.build_all()
        pc = cells.program_config(x.c)
        train_ds = get_dataset("train", x.scene.directory(), pc)
        model = construct_model(pc.model, train_ds.peek(), dev, seed=TRAIN_SEED)
        weights.load(model, x.w, keep=(POSE,))
        self.dataset = get_dataset(x.t["split"], x.scene.directory(), pc)
        render_chunk = make_render_fn(model, pc, dev)

        def chunk_fn(rays, ext, ts, alpha):
            with torch.profiler.record_function("portbench.chunk"):
                return render_chunk(rays, ext, ts, alpha)

        self._evaluate = lambda case: evaluate_image(chunk_fn, case, x.alpha, chunk=pc.chunk)
        self.n_views = self.dataset.scene.n_examples
        h, w = self.dataset.scene.images[0].shape[:2]
        self.rays_per_unit = h * w
        self.chunks_per_unit = math.ceil(h * w / pc.chunk)
        self.outputs, self.n_bad = {}, 0
        self.done = 0

    def loop(self):
        """The apps render with Python's collector as it is."""
        return contextlib.nullcontext()

    def draw(self, i: int):
        """The split's next test case; the dataset hands them out in order."""
        return i % self.n_views, next(self.dataset)

    def step(self, item) -> None:
        v, case = item
        out = self._evaluate(case)
        self.outputs[v] = out
        self.n_bad += int(not all(np.isfinite(a).all() for a in out.values()))

    def work(self) -> dict:
        from portbench import work

        m, n = self.inputs.c["model"], self.rays_per_unit
        return {"flops": work.forward_flops(m, n, self.inputs.hits()), "rays": n,
                "k1_bound_s": work.k1_bound_s(m, n)}

    def failed(self) -> int:
        return self.n_bad

    def release(self) -> None:
        self.__dict__.pop("dataset", None)
        self.__dict__.pop("_evaluate", None)
        self.inputs.scene.close()

    def check(self) -> dict:
        """The widest gaps over a sample of the rendered views, drawn from
        the seed, against the reference's renders of them."""
        rng = random.Random(self.run.seed)
        views = rng.sample(sorted(self.outputs), min(self.inputs.t["check_views"], len(self.outputs)))
        numbers = {}
        for v in views:
            ref = self.inputs.reference(v)
            prog = {k: torch.from_numpy(np.ascontiguousarray(self.outputs[v][k])).reshape(ref[k].shape)
                    .to(ref[k].device) for k in ref}
            for k, val in compare.render_numbers(prog, ref).items():
                numbers[k] = max(numbers.get(k, 0.0), val)
        numbers["_views"] = views
        return numbers
