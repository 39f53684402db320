"""Data-parallel training (durf_tpu_torch/parallel/) on the CPU.

One module-scoped spawn of a 2-rank gloo group runs every check that needs
ranks and hands its results back to this process, which holds them against
the one-process run of the same config, weights and global batch of 256
rays (the tiny flagship, float32):
  * the step: loss, raw gradients and parameters after 2 steps within
    atol 1e-6 of one process, on the example batch, on a batch whose LIDAR
    rays all lie on rank 0 (the global denominators), with the centering
    prior on (both readouts, the pose trainable), under a compaction
    capacity the batch's hit rays overflow, and with density noise and a
    random background; both ranks' parameters equal;
  * the occupancy grid after a grid step, bitwise;
  * an eval chunk rendered over the group, bitwise against one rank's
    render of the whole chunk;
  * the training CLI with --multihost (rank 0 alone writes; a resume
    continues) and the bench's per-chip rate;
  * one step without random draws against the JAX package's one-device
    step on the same weights (params_to_flax) at test_torch_train_step.py's
    tolerances (the JAX step compiled at XLA's lowest optimization level,
    which keeps the test inside its time budget).
Also dryrun_multichip(2, device="cpu"), which spawns its own two ranks,
and without ranks: shard_batch against mesh.py, the ranks' draws as rows
of the one-process draws, and the reference pipeline's shared seed
(ROADMAP queue 3).
"""

import copy
import functools
import json
import types

import numpy as np
import pytest
import torch

from durf_tpu_torch import bench, entry, parallel
from durf_tpu_torch import eval as app_eval
from durf_tpu_torch import render as app_render
from durf_tpu_torch import train as ttrain
from durf_tpu_torch.configs import load_config
from durf_tpu_torch.data import device_data
from durf_tpu_torch.data.synthetic import example_ray_batch, generate_scene
from durf_tpu_torch.entry import flagship_config
from durf_tpu_torch.models.mipnerf import construct_model, obj_capacity_k
from durf_tpu_torch.parallel import RowShard, draw, shard_batch

B = 256
RANKS = 2
CASES = ("base", "lidar_on_rank0", "centering_midrange", "centering_mean", "overflow",
         "noise")
ATOL = 1e-6


def case_config(case: str):
    """The tiny flagship at its own schedules (lr(1) ~ 5e-6: at a constant
    5e-3, Adam's normalised first updates turn float-sum differences of
    ~1e-11 in gradients near 0 into parameter differences of ~6e-6)."""
    cfg = flagship_config(tiny=True)
    cfg.batch_size = B
    if case.startswith("centering"):
        cfg.centering_loss_mult = 0.1
        cfg.model.centering_mode = case.split("_")[1]
        cfg.model.no_pose_opt = False  # so that the prior moves the pose
    if case == "overflow":
        cfg.model.obj_ray_capacity = 0.25  # k = 128
    if case == "noise":  # the draws with a ray axis on samples, and one without
        cfg.model.density_noise = 1.0
        cfg.rand_bkgd = True
    if case == "grid":
        cfg.model.grid_sampling = True
        cfg.model.grid_resolution = 16
        cfg.model.grid_probes = 16
    if case == "jax":
        cfg.randomized = False
    return cfg


def case_batch(case: str) -> dict:
    host = example_ray_batch(batch_size=B)
    if case == "lidar_on_rank0":
        depth = host["depth"].copy()
        depth[B // RANKS:] = 0.0
        host["depth"] = depth
    if case == "overflow":
        host["ext"] = host["ext"] * 3.0  # 144 of the 256 rays hit a box
    return host


def run_case(case: str, group) -> dict:
    """(loss at step 0, its raw gradients, parameters after 2 steps) of the
    case on one process (parallel.Group()) or on a rank."""
    cfg, host = case_config(case), case_batch(case)
    device = torch.device("cpu")
    local = ttrain.batch_to(shard_batch(host, B, group), device)
    model = construct_model(cfg.model, host, device)
    loss, aux, grads = ttrain.make_grad_fn(copy.deepcopy(model), cfg, group=group)(0, local)
    loss = group.all_sum(loss)
    opt = ttrain.make_optimizer(cfg, model)
    state = ttrain.create_train_state(cfg, model, opt)
    step = ttrain.make_train_step(model, cfg, opt, group=group)
    for _ in range(1 if case in ("grid", "jax") else 2):
        state, stats = step(state, local)
    stats = ttrain.reduce_stats(stats, cfg, group)
    out = {
        "loss": loss.numpy(),
        "grads": {n: g.numpy().copy() for n, g in grads.items()},
        "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
        "stats": {k: np.asarray(v) for k, v in stats.items() if torch.is_tensor(v)},
    }
    if state.grid is not None:
        out["grid"] = state.grid.numpy()
    return out


def tiny_gin(path: str) -> str:
    """A gin file of tests/test_train.py's tiny training config."""
    lines = [
        'Config.dataset_loader = "carla_dyn"', 'Config.batching = "timestep"',
        "Config.batch_size = 32", "Config.factor = 4", "Config.spherify = True",
        "Config.centering = True", "Config.near = 0.0", "Config.far = 30.0",
        "Config.timesteps = 3", "Config.lr_delay_steps = 0", "Config.rand_bkgd = False",
        "Config.print_every = 2", "Config.save_every = 4", "Config.render_every = 4",
        "Config.chunk = 64",
        "MipNerfModel.num_samples = 8", "MipNerfModel.max_deg_point = 4",
        "MipNerfModel.deg_view = 2", "MipNerfModel.timesteps = 3",
        "MLP.net_depth = 2", "MLP.net_width = 16", "MLP.net_width_condition = 8",
        "BoxMLP.net_depth = 2", "BoxMLP.net_width = 8", "BoxMLP.net_width_condition = 8",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _cli(scene, train_dir, gin, max_steps):
    logs = []
    state = ttrain.main(["--multihost", "--device", "cpu", "--data_dir", scene,
                         "--train_dir", train_dir, "--gin_file", gin,
                         "--max_steps", str(max_steps)], log_fn=logs.append)
    return state, logs


def rank_checks(group, scene, train_dir, gin) -> dict:
    """Every check that needs ranks, on one rank of the spawned group."""
    torch.set_num_threads(1)
    out = {"rank": group.rank, "cases": {c: run_case(c, group) for c in CASES + ("grid", "jax")}}

    # An eval chunk over the group against this rank's render of it all.
    cfg, host = case_config("base"), case_batch("overflow")
    cfg.model.obj_ray_capacity = 0.25  # the budget across ranks in eval too
    model = construct_model(cfg.model, host, "cpu")
    args = (host["rays"], host["ext"], int(host["ts"]), 10.0)
    out["render_n"] = {k: v.numpy() for k, v in
                       ttrain.make_render_fn(model, cfg, group=group)(*args).items()}
    out["render_1"] = {k: v.numpy() for k, v in
                       ttrain.make_render_fn(model, cfg, "cpu")(*args).items()}

    state, logs = _cli(scene, train_dir, gin, 4)
    out["cli"] = {"step": state.step, "logs": logs,
                  "params": {n: p.detach().numpy().copy()
                             for n, p in state.model.named_parameters()}}
    group.barrier()  # the first run's files are all written
    state, logs = _cli(scene, train_dir, gin, 6)
    out["cli_resumed"] = {"step": state.step, "logs": logs}
    group.barrier()

    # The apps on that checkpoint over the group, and on this rank alone.
    common = ["--data_dir", scene, "--train_dir", train_dir, "--gin_file", gin,
              "--device", "cpu"]
    eval_dir, frames_dir = f"{train_dir}_eval", f"{train_dir}_frames"
    out["eval_n"] = app_eval.main(common + ["--multihost", "--out_dir", eval_dir],
                                  log_fn=lambda *a: None)
    config = load_config([gin], [])
    out["eval_1"] = app_eval.evaluate(config, scene, train_dir, log_fn=lambda *a: None,
                                      device="cpu")
    out["frames_n"] = app_render.main(
        common + ["--path", "interp", "--n_views", "2", "--multihost", "--out_dir", frames_dir],
        log_fn=lambda *a: None)
    out["frames_1"] = app_render.render_trajectory(
        config, scene, train_dir, f"{frames_dir}_{group.rank}", path="interp", n_views=2,
        log_fn=lambda *a: None, device="cpu")

    orig = entry.flagship_config
    entry.flagship_config = functools.partial(orig, tiny=True)
    try:
        out["bench"] = bench.run(bench.parse_args(
            ["--device", "cpu", "--batch_size", "64", "--steps", "2", "--warmup", "1"]))
    finally:
        entry.flagship_config = orig
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(the directory of the CLI's run, the results of rank_checks on both
    ranks)."""
    root = tmp_path_factory.mktemp("parallel")
    scene = str(root / "scene")
    generate_scene(scene, timesteps=3, width=80, height=64, focal=70.0, factors=(4,))
    results = parallel.spawn(rank_checks, RANKS, scene, str(root / "run"),
                             tiny_gin(str(root / "tiny.gin")), device="cpu", timeout=300)
    return root / "run", results


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned[1]


@functools.lru_cache(maxsize=None)
def one_process(case: str) -> dict:
    """run_case on this process, on one thread as each rank runs (tiny
    products gain nothing from more, and the test workers share the
    cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_case(case, parallel.Group())
    finally:
        torch.set_num_threads(threads)


def test_shard_batch_keeps_the_rank_rows_and_refuses_an_uneven_batch():
    from durf_tpu.parallel import mesh as jmesh

    host = example_ray_batch(batch_size=8)
    group = parallel.Group(rank=1, size=2, device=torch.device("cpu"))
    local = shard_batch(host, 8, group)
    np.testing.assert_array_equal(local["pixels"], host["pixels"][4:])
    np.testing.assert_array_equal(local["rays"].origins, host["rays"].origins[4:])
    assert local["init"] is host["init"] and local["ext"] is host["ext"]
    whole = shard_batch(host, 8, parallel.Group())
    assert whole.keys() == host.keys() and whole["init"] is host["init"]
    np.testing.assert_array_equal(whole["pixels"], host["pixels"])
    fake_mesh = types.SimpleNamespace(devices=np.empty(3))
    with pytest.raises(ValueError) as jax_err:
        jmesh.shard_batch(host, fake_mesh, 8)
    with pytest.raises(ValueError) as port_err:
        shard_batch(host, 8, parallel.Group(rank=0, size=3, device=torch.device("cpu")))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_one_process(ranks, case):
    """The loss, raw gradients and parameters after 2 steps, atol 1e-6."""
    one = one_process(case)
    for rank in ranks:
        two = rank["cases"][case]
        np.testing.assert_allclose(two["loss"], one["loss"], rtol=0, atol=ATOL)
        for name, g in one["grads"].items():
            np.testing.assert_allclose(two["grads"][name], g, rtol=0, atol=ATOL, err_msg=name)
        for name, p in one["params"].items():
            np.testing.assert_allclose(two["params"][name], p, rtol=0, atol=ATOL, err_msg=name)
            np.testing.assert_array_equal(two["params"][name],
                                          ranks[0]["cases"][case]["params"][name])
        for key, v in one["stats"].items():
            if key.startswith("viz/") and rank["rank"] != 0:
                continue  # the global batch's first ray is rank 0's
            np.testing.assert_allclose(two["stats"][key], v, rtol=1e-5, atol=ATOL, err_msg=key)


def test_the_cases_exercise_what_they_name(ranks):
    """LIDAR depth only on rank 0's rows; a nonzero centering gradient on
    the pose table; more hit rays than the capacity, rank 1's partly past
    the budget."""
    host = case_batch("lidar_on_rank0")
    assert (host["depth"][: B // 2] > 0).any() and not (host["depth"][B // 2:] > 0).any()
    for mode in ("midrange", "mean"):
        with_prior = one_process(f"centering_{mode}")["grads"]["box_centers"]
        assert np.abs(with_prior).max() > 0
    host, k = case_batch("overflow"), obj_capacity_k(B, 0.25)
    model = construct_model(case_config("overflow").model, host, "cpu")
    batch = ttrain.batch_to(host, "cpu")
    anyhit = model(batch["rays"], ext=batch["ext"], ts=batch["ts"])[-1]["dyn_mask"][:, 0] > 0
    rank0, rank1 = int(anyhit[: B // 2].sum()), int(anyhit[B // 2:].sum())
    assert rank0 < k < rank0 + rank1  # rank 1 keeps k - rank0 of its hit rays
    for stats in (one_process("overflow")["stats"], ranks[1]["cases"]["overflow"]["stats"]):
        assert float(stats["obj/overflow_rays"]) == rank0 + rank1 - k


def test_grid_update_is_bitwise_the_one_process_update(ranks):
    one = one_process("grid")["grid"]
    assert not (one == 1.0).all()  # the update has left the all-ones grid
    for rank in ranks:
        np.testing.assert_array_equal(rank["cases"]["grid"]["grid"], one)


def test_gathered_eval_chunk_is_bitwise_the_one_rank_render(ranks):
    for rank in ranks:
        for k in ("rgb", "depth", "acc"):
            np.testing.assert_array_equal(rank["render_n"][k], rank["render_1"][k], err_msg=k)
            np.testing.assert_array_equal(rank["render_n"][k], ranks[0]["render_1"][k])


def test_dryrun_multichip_descends_and_matches_one_rank(capsys):
    """dryrun_multichip(2) on the CPU: its ranks raise unless 20 steps
    descend and the group's eval chunk matches one rank's at 1e-5."""
    result = entry.dryrun_multichip(2, device="cpu")
    assert result["step"] == entry.DRYRUN_STEPS
    assert result["losses"][-1] < result["losses"][0]
    assert np.isfinite(result["checksum"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): 20 data-parallel train steps OK")
    assert f"checksum {result['checksum']:.6f} matches the single-rank render" in line


def test_multihost_cli_writes_on_rank0_and_resumes(ranks):
    r0, r1 = ranks
    assert r0["cli"]["step"] == r1["cli"]["step"] == 4
    for name, p in r0["cli"]["params"].items():
        np.testing.assert_array_equal(r1["cli"]["params"][name], p, err_msg=name)
    assert r1["cli"]["logs"] == [] and any("step 4/4" in line for line in r0["cli"]["logs"])
    assert r0["cli_resumed"]["step"] == r1["cli_resumed"]["step"] == 6
    assert any("resumed from the checkpoint of step 4" in line
               for line in r0["cli_resumed"]["logs"])


def test_multihost_cli_files_are_written_once(spawned):
    run = spawned[0]
    assert sorted(p.name for p in run.glob("checkpoint_*.pt")) == [
        "checkpoint_4.pt", "checkpoint_6.pt"]
    lines = [json.loads(line) for line in open(run / "metrics.jsonl")]
    # print_every 2 and render_every 4: steps 2 and 4 of the first run, 6 of
    # the resumed one, and the render of step 4, each logged once.
    train_steps = [line["step"] for line in lines if "train/loss" in line]
    assert train_steps == [2, 4, 6]
    assert [line["step"] for line in lines if "test/psnr" in line] == [4]
    assert (run / "images" / "test_pred_rgb_4.png").exists()


def test_multihost_apps_match_one_rank(spawned):
    """The eval and render apps over the group: the metrics and frames of
    this rank alone (bitwise), rank 0 alone writes."""
    run, ranks = spawned
    for rank in ranks:
        for key in ("psnr", "ssim", "depth_mse"):
            assert rank["eval_n"][key] == rank["eval_1"][key] == ranks[0]["eval_1"][key]
        for a, b in zip(rank["frames_n"], rank["frames_1"], strict=True):
            np.testing.assert_array_equal(a, b)
    assert json.load(open(f"{run}_eval/metrics.json"))["psnr"] == ranks[0]["eval_n"]["psnr"]
    assert sorted(p.name for p in run.parent.glob("run_frames/frame_*.png")) == [
        "frame_0000.png", "frame_0001.png"]


def test_bench_reports_the_rate_per_rank(ranks):
    for rank in ranks:
        result = rank["bench"]
        assert result["world"] == RANKS and result["value"] > 0
        assert result["value"] == pytest.approx(result["total"] / RANKS, abs=0.05)


def test_two_rank_step_matches_the_jax_step(ranks):
    """Without random draws, the 2-rank step against the JAX package's
    one-device step on the same weights and global batch: loss rtol 1e-3,
    stats rtol 1e-3 / atol 1e-5 (the gradient statistics rtol 2e-2), every
    parameter after the step within 2 lr(1) + 1e-6."""
    import jax

    from __graft_entry__ import _flagship_config
    from durf_tpu import train as jtrain
    from durf_tpu.data.synthetic import example_ray_batch as j_batch
    from durf_tpu.models.mipnerf import MipNerf as JMipNerf
    from durf_tpu_torch.params import params_from_flax, params_to_flax

    cfg = case_config("jax")
    jcfg = _flagship_config(tiny=True)
    jcfg.batch_size, jcfg.randomized = B, False
    model = construct_model(cfg.model, example_ray_batch(batch_size=B), "cpu")
    variables = {"params": params_to_flax(model.state_dict())}
    tx = jtrain.make_optimizer(jcfg)
    state = jtrain.create_train_state(jcfg, variables, tx)
    step = jax.jit(jtrain.make_train_step(JMipNerf(jcfg.model), jcfg, tx, jax.random.key(1)),
                   compiler_options={"xla_backend_optimization_level": 0})
    new_state, j_stats = step(state, j_batch(batch_size=B))
    j_params = params_from_flax(jax.tree.map(np.asarray, new_state.params))
    j_stats = {k: np.asarray(v) for k, v in j_stats.items()}
    lr1 = ttrain.make_lr_schedule(cfg)(1)
    for rank in ranks:
        two = rank["cases"]["jax"]
        np.testing.assert_allclose(two["stats"]["train/loss"], j_stats["train/loss"], rtol=1e-3)
        shared = sorted(set(j_stats) & set(two["stats"]))
        assert len(shared) >= 30
        for key in shared:
            if key.startswith("viz/") and rank["rank"] != 0:
                continue  # the global batch's first ray is rank 0's
            tol = dict(rtol=2e-2) if key.startswith("train/grad") else dict(rtol=1e-3, atol=1e-5)
            np.testing.assert_allclose(two["stats"][key], j_stats[key], err_msg=key, **tol)
        for name, p in two["params"].items():
            np.testing.assert_array_less(np.abs(p - j_params[name].numpy()), 2 * lr1 + 1e-6,
                                         err_msg=name)


def test_ranks_draw_disjoint_rows_of_the_one_process_draws():
    """RowShard draws, device-resident batches and host batches: rank r's
    rows are rows [r B/n, (r+1) B/n) of what one process draws."""
    full = torch.rand((8, 5), generator=torch.Generator().manual_seed(3))
    parts = [draw(torch.rand, (4, 5), RowShard(torch.Generator().manual_seed(3), r, 2))
             for r in range(2)]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), full.numpy())
    cm = torch.randn((1, 8, 3), generator=torch.Generator().manual_seed(4))
    parts = [draw(torch.randn, (1, 4, 3), RowShard(torch.Generator().manual_seed(4), r, 2), dim=1)
             for r in range(2)]
    np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(), cm.numpy())

    pools = {"pixels": torch.rand((2, 50, 3)), "depth": torch.rand((2, 50, 1)),
             "sky": torch.rand((2, 50, 1)), "counts": [50, 37]}
    from durf_tpu_torch.rays import Rays
    pools["rays"] = Rays(*(torch.rand((2, 50, c)) for c in (3, 3, 3, 1, 1, 1, 1)))
    one = device_data.sample_batch(pools, 5, 11, 8)
    groups = [parallel.Group(r, 2, torch.device("cpu")) for r in range(2)]
    ranks = [device_data.sample_batch(pools, 5, 11, 8, g.rows(8)) for g in groups]
    assert ranks[0]["ts"] == ranks[1]["ts"] == one["ts"]
    np.testing.assert_array_equal(torch.cat([r["pixels"] for r in ranks]).numpy(),
                                  one["pixels"].numpy())
    assert not np.array_equal(ranks[0]["pixels"].numpy(), ranks[1]["pixels"].numpy())

    host = example_ray_batch(batch_size=8)
    halves = [shard_batch(host, 8, g) for g in groups]
    np.testing.assert_array_equal(np.concatenate([h["pixels"] for h in halves]), host["pixels"])


def test_reference_pipeline_gives_every_host_the_same_rays(tmp_path, monkeypatch):
    """The fault recorded in ROADMAP queue 3: durf_tpu/data/pipeline.py:90-92
    seeds every host's train pipeline with 20201473 and draws batch_size /
    process_count rays from it, so under --multihost every host trains on
    the same rays (expected: each host its own part of a global batch)."""
    from durf_tpu.configs import Config as JConfig
    from durf_tpu.data import pipeline as jpipeline

    generate_scene(str(tmp_path), timesteps=3, width=48, height=32, focal=40.0, factors=(4,))
    cfg = JConfig(dataset_loader="carla_dyn", batching="timestep", batch_size=32, factor=4,
                  spherify=True, centering=True, near=0.0, far=30.0, timesteps=3)
    monkeypatch.setattr(jpipeline.jax, "process_count", lambda: 2)
    host0 = jpipeline.get_dataset("train", str(tmp_path), cfg)
    host1 = jpipeline.get_dataset("train", str(tmp_path), cfg)
    b0, b1 = next(host0), next(host1)
    assert b0["pixels"].shape[0] == 16
    np.testing.assert_array_equal(b0["pixels"], b1["pixels"])
    np.testing.assert_array_equal(b0["rays"].origins, b1["rays"].origins)
