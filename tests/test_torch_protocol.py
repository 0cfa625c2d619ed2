"""The protocol drivers (humanrf_torch/protocol/) against the JAX package's
(scripts/): the validation report, the scene cache, the supervisor, the
scenes they write, their CLI commands, and a tiny end-to-end run on the CPU.

Sizes: the multi-segment scene at 8² images with a 32³ grid (the driver's
100 frames and motion; its 128³ grid takes ~60 s on the CPU), and the end
to end at 24² over 8 frames ([6, 6] segments) with 256 rays per step."""
import csv
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import driver_common as j_common  # noqa: E402
import validation_report as j_report  # noqa: E402

from humanrf_torch.configs.args import parse_args as t_parse_args  # noqa: E402
from humanrf_torch.core import synthetic as t_synthetic  # noqa: E402
from humanrf_torch.protocol import common, supervisor  # noqa: E402
from humanrf_torch.protocol import validation_report as t_report  # noqa: E402
from humanrf_tpu.configs.args import parse_args as j_parse_args  # noqa: E402
from humanrf_tpu.core import synthetic as j_synthetic  # noqa: E402

torch.set_num_threads(2)
PY = sys.executable
VALIDATION_TXT = """Step: 2500
image_id: 0 --- psnr=21.5 ssim=0.81 lpips_randfeat=0.002
image_id: 1 --- psnr=22.5 ssim=0.83 lpips_randfeat=0.002
Step: 5000
image_id: 0 --- psnr=24.0 ssim=0.88 lpips_randfeat=0.001
image_id: 1 --- psnr=25.0 ssim=0.90 lpips_randfeat=0.001
"""


# ------------------------------------------------------------ validation report


@pytest.mark.parametrize("case", ["banked", "truncated", "metricless", "missing"])
def test_validation_report_matches_jax(case, tmp_path):
    text = {"banked": (common.R4_RUN / "validation.txt").read_text(), "truncated": VALIDATION_TXT + "Step: ",
            "metricless": "Step: 2500\n", "missing": None}[case]
    if text is not None:
        (tmp_path / "validation.txt").write_text(text)
    blocks = t_report.parse_validation_blocks(tmp_path)
    assert blocks == j_report.parse_validation_blocks(tmp_path)
    assert t_report.block_means(blocks) == j_report.block_means(blocks)
    assert t_report.best_block(blocks) == j_report.best_block(blocks)
    if case == "banked":
        # The banked run's result.json holds the same per-block means.
        banked = json.loads((common.R4_RUN / "result.json").read_text())["validation_blocks"]
        assert t_report.block_means(blocks) == banked
        assert t_report.best_block(blocks)["at_step"] == 17_500


# ------------------------------------------------------------------ scene cache


def test_generator_version_is_the_jax_packages():
    assert t_synthetic.GENERATOR_VERSION == j_synthetic.GENERATOR_VERSION


def test_ensure_scene_clears_stale_workspaces(tmp_path):
    """A new scene (other size or frames) also clears the run workspaces,
    whose `--training.checkpoint latest` state belongs to the old one; the
    stamp is the JAX driver's."""
    scene, runs = tmp_path / "scene", tmp_path / "runs"
    calls = []

    def gen(root):
        (root / "SynthActor").mkdir(parents=True)
        calls.append(root)

    assert common.ensure_scene(scene, {"size": 192, "frames": 2}, gen, (runs,))
    (runs / "cfg" / "checkpoints").mkdir(parents=True)
    assert not common.ensure_scene(scene, {"size": 192, "frames": 2}, gen, (runs,))
    assert (runs / "cfg" / "checkpoints").exists()
    # The JAX driver reads the port's stamp as its own.
    assert not j_common.ensure_scene(scene, {"size": 192, "frames": 2}, gen, (runs,))
    assert common.ensure_scene(scene, {"size": 384, "frames": 25}, gen, (runs,))
    assert not runs.exists()
    assert len(calls) == 2


# ------------------------------------------------------------------- supervisor


def _supervise(cmd, tmp_path, **kw):
    return supervisor.supervise(cmd, tmp_path / "log.txt", dict(os.environ), tmp_path, probe_first=False, poll_s=0.1,
                                **kw)


def test_supervisor_healthy_child_completes_without_restart(tmp_path):
    rc, restarts = _supervise([PY, "-c", "print('working'); print('done')"], tmp_path, stall_timeout=30.0,
                              max_restarts=2, probe=lambda: True)
    assert (rc, restarts) == (0, 0)
    assert "done" in (tmp_path / "log.txt").read_text()


def test_supervisor_kills_and_relaunches_a_wedged_child(tmp_path):
    """A child that logs once and hangs is killed after the stall timeout and
    relaunched after a probe; the relaunch sees its marker and exits (a
    resume from the checkpoint)."""
    marker = tmp_path / "attempt1.marker"
    child = (
        "import sys, time, pathlib\n"
        f"m = pathlib.Path({str(marker)!r})\n"
        "print('started', flush=True)\n"
        "if m.exists():\n"
        "    print('resumed ok', flush=True)\n"
        "    sys.exit(0)\n"
        "m.touch()\n"
        "time.sleep(3600)\n"
    )
    probes = []
    t0 = time.time()
    rc, restarts = _supervise([PY, "-c", child], tmp_path, stall_timeout=3.0, max_restarts=3,
                              probe=lambda: probes.append(1) or True)
    assert (rc, restarts) == (0, 1)
    assert probes, "the card must be probed before a relaunch"
    assert time.time() - t0 < 60.0
    log = (tmp_path / "log.txt").read_text()
    assert log.count("started") == 2 and "resumed ok" in log


def test_supervisor_deadline_stops_a_running_child_with_budget_rc(tmp_path):
    child = "import time\nprint('started', flush=True)\nfor i in range(600):\n    time.sleep(0.2)\n    print(i, flush=True)\n"
    t0 = time.time()
    rc, restarts = _supervise([PY, "-c", child], tmp_path, stall_timeout=300.0, max_restarts=2,
                              probe=lambda: True, deadline=time.time() + 2.0)
    assert (rc, restarts) == (supervisor.BUDGET_RC, 0)
    assert time.time() - t0 < 30.0
    assert "started" in (tmp_path / "log.txt").read_text()


def test_supervisor_respects_the_deadline_while_the_card_is_down(tmp_path):
    rc, _ = supervisor.supervise([PY, "-c", "print('never runs')"], tmp_path / "log.txt", dict(os.environ), tmp_path,
                                 probe_first=True, probe=lambda: False, probe_retry_s=0.1, poll_s=0.1,
                                 deadline=time.time() + 0.5)
    assert rc == supervisor.BUDGET_RC
    assert not (tmp_path / "log.txt").exists()


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    rc, restarts = _supervise([PY, "-c", "print('x'); raise SystemExit(7)"], tmp_path, stall_timeout=30.0,
                              max_restarts=2, probe=lambda: True)
    assert (rc, restarts) == (7, 3)


# ----------------------------------------------------------------------- scenes


def test_multiseg_scene_is_the_jax_drivers(tmp_path, monkeypatch):
    """Both drivers' 100-frame scene at 8² with a 32³ grid: calibration and
    AABBs equal to the byte, the occupancy grids equal, [25] × 4 segments."""
    import multiseg_fsdp_run as j_multiseg

    from humanrf_torch.core.dataset import VolumetricDataset as TDataset
    from humanrf_torch.protocol import multiseg
    from humanrf_torch.train.partitioning import compute_adaptive_segment_sizes as t_sizes
    from humanrf_tpu.core.dataset import VolumetricDataset as JDataset
    from humanrf_tpu.train.partitioning import compute_adaptive_segment_sizes as j_sizes

    small = lambda cfg: dataclasses.replace(cfg, grid_resolution=32)  # noqa: E731
    j_generate, t_write = j_synthetic.generate_synthetic_dataset, common.write_scene
    monkeypatch.setattr(j_synthetic, "generate_synthetic_dataset", lambda root, cfg: j_generate(root, small(cfg)))
    monkeypatch.setattr(common, "write_scene", lambda root, cfg, device: t_write(root, small(cfg), device))
    j_multiseg.make_scene(tmp_path / "jax", 100, 8)
    multiseg.make_scene(tmp_path / "torch", 100, 8, "cpu")

    j_seq, t_seq = (tmp_path / name / "SynthActor" / "Sequence1" for name in ("jax", "torch"))
    for rel in ("1x/calibration.csv", "aabbs.csv", "scene.json"):
        assert (t_seq / rel).read_bytes() == (j_seq / rel).read_bytes(), rel
    for frame in range(100):
        name = f"occupancy_grids/occupancy_grid{frame:06d}.npz"
        np.testing.assert_array_equal(np.load(t_seq / name)["occupancy_grid"], np.load(j_seq / name)["occupancy_grid"])
    frames = list(range(100))
    assert t_sizes(TDataset(t_seq / "1x"), frames) == j_sizes(JDataset(j_seq / "1x"), frames) == [25] * 4


def test_parallax_probe_mints_the_jax_drivers_cameras(tmp_path, monkeypatch):
    import parallax_probe as j_probe

    from humanrf_torch.protocol import parallax_probe

    captured = {}
    monkeypatch.setattr(j_synthetic, "generate_synthetic_dataset", lambda root, cfg: captured.update(cfg=cfg))
    j_probe.make_probe_scene(tmp_path, 50, 748)
    t_cfg = parallax_probe.probe_scene_config(50, 748)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(captured["cfg"])
    j_cams, t_cams = j_synthetic.make_cameras(captured["cfg"]), t_synthetic.make_cameras(t_cfg)
    assert len(t_cams) == len(j_cams) == 8
    for t, j in zip(t_cams, j_cams):
        assert (t.name, t.width, t.height) == (j.name, j.width, j.height)
        for field in ("rotation_axisangle", "translation", "focal_length", "principal_point"):
            np.testing.assert_allclose(getattr(t, field), getattr(j, field), rtol=0, atol=1e-6)
    assert parallax_probe.probe_angles_deg() == j_probe.probe_angles_deg()
    for deg in parallax_probe.probe_angles_deg():
        assert parallax_probe.nearest_training_angle_deg(deg) == j_probe.nearest_training_angle_deg(deg)


# --------------------------------------------------------------------- commands


def _config(cmd, module, parse, moot):
    """A driver's command → its parsed configuration without the moot flags."""
    assert cmd[1:3] == ["-m", module]
    cfg = dataclasses.asdict(parse(cmd[3:]))
    for flag in moot:
        *groups, key = flag[2:].split(".")
        node = cfg
        for g in groups:
            node = node[g]
        node.pop(key)
    return cfg


def _assert_same_command(t_cmd, j_cmd, moot=common.MOOT_FLAGS):
    assert _config(t_cmd, "humanrf_torch.run", t_parse_args, moot) == _config(j_cmd, "humanrf_tpu.run", j_parse_args,
                                                                               moot)


def test_full_schedule_command_is_the_jax_drivers(tmp_path, monkeypatch):
    import full_schedule_run as j_full

    from humanrf_torch.protocol import full_schedule

    commands = []
    monkeypatch.setattr(j_full, "ensure_scene", lambda *a, **k: False)
    monkeypatch.setattr(j_full, "check_segments", lambda *a: [25, 25])
    monkeypatch.setattr(j_full, "supervise", lambda cmd, *a, **k: commands.append(cmd) or (0, 0))
    for smoke in ([], ["--smoke"]):
        monkeypatch.setattr(sys, "argv", ["full_schedule_run.py", "--root", str(tmp_path), "--steps", "2500", *smoke])
        j_full.main()
        args = full_schedule.parser().parse_args(["--root", str(tmp_path), "--steps", "2500", *smoke])
        _assert_same_command(full_schedule.command(args, tmp_path / "scene", tmp_path / "workspace"), commands[-1])
    # --dense is the same command with the paper's field and sampler after it.
    args = full_schedule.parser().parse_args(["--root", str(tmp_path), "--dense"])
    dense = t_parse_args(full_schedule.command(args, tmp_path / "scene", tmp_path / "workspace")[3:])
    assert (dense.tpu.sampling, dense.model.n_levels, dense.model.log2_hashmap_size) == ("dense", 16, 19)


def test_finish_phases_drift_and_throughput_commands_are_the_jax_drivers(tmp_path, monkeypatch):
    import drift_ablation as j_drift
    import finish_phases as j_finish
    import throughput_probe as j_tput

    from humanrf_torch.protocol import drift_ablation, finish_phases, throughput_probe

    scene, ws = tmp_path / "scene", tmp_path / "ws"
    _assert_same_command(finish_phases.base_cmd(scene, ws, 50), j_finish.base_cmd(scene, ws, 50))
    for arm in j_drift.ARMS:
        _assert_same_command(drift_ablation.arm_cmd(arm, scene, ws, 50_000), j_drift.arm_cmd(arm, scene, ws, 50_000))
    assert drift_ablation.ARMS == j_drift.ARMS and drift_ablation.RESUME_STEP == j_drift.RESUME_STEP

    commands = []

    def fake_run(cmd, **kw):
        commands.append(cmd)
        return type("Done", (), {"returncode": 0})()

    (tmp_path / "ws" / "checkpoints").mkdir(parents=True)
    (tmp_path / "ws" / "checkpoints" / j_tput.CKPT.name).write_bytes(b"")
    monkeypatch.setattr(j_tput.subprocess, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["throughput_probe.py", "--root", str(tmp_path), "--steps", "200"])
    j_tput.main()
    _assert_same_command(throughput_probe.command(j_tput.SCENE, ws, 200), commands[-1])


@pytest.mark.parametrize("arm", ["wd0.03", "wd0"])
def test_drift_arm_resume_point_loads_in_both_packages(arm, tmp_path):
    """The banked step-17,500 checkpoint is AdamW's; each arm's resume point
    restores into the arm's optimizer, the port's and the JAX package's
    (which refuse AdamW's three chained states for Adam's two), with the
    moments and the step count of the banked state."""
    from flax import serialization

    from humanrf_torch.convert import load_opt_state
    from humanrf_torch.protocol import drift_ablation
    from humanrf_torch.r4 import r4_flags
    from humanrf_torch.run import build_model
    from humanrf_torch.train.checkpoint import load_checkpoint
    from humanrf_torch.train.trainer import make_optimizer
    from humanrf_tpu.train.trainer import make_optimizer as j_make_optimizer

    adam = drift_ablation.turns_decay_off(drift_ablation.ARMS[arm])
    assert adam == (arm == "wd0")
    drift_ablation.seed_workspace(tmp_path, adam=adam)
    seeded = tmp_path / "checkpoints" / f"step_{drift_ablation.RESUME_STEP:08d}.ckpt"
    params, opt_state, step, _, _ = load_checkpoint(seeded)
    _, banked, _, _, _ = load_checkpoint(drift_ablation.BEST_CKPT)
    assert step == drift_ablation.RESUME_STEP
    weight_decay = 0.0 if adam else 0.03
    config = t_parse_args(r4_flags(tmp_path, tmp_path, 1, 1, "cpu"))
    model = build_model(config, (25, 25), torch.device("cpu"))
    optimizer = make_optimizer(model.named_parameters(), 5e-3, 0.5, 50_000, weight_decay)
    load_opt_state(optimizer, opt_state)
    assert int(optimizer.count) == drift_ablation.RESUME_STEP
    j_template = j_make_optimizer(5e-3, 0.5, 50_000, weight_decay).init(params)
    j_state = serialization.from_state_dict(j_template, opt_state)
    adam_state = j_state.inner_state[0]
    assert int(adam_state.count) == drift_ablation.RESUME_STEP
    for moment in ("mu", "nu"):
        flat = jax.tree_util.tree_leaves(getattr(adam_state, moment))
        want = jax.tree_util.tree_leaves(banked["inner_state"]["0"][moment])
        assert len(flat) == len(want) and all(np.array_equal(a, b) for a, b in zip(flat, want))
    if not adam:
        assert seeded.read_bytes() == drift_ablation.BEST_CKPT.read_bytes()


@pytest.mark.parametrize("name", ["fused-flagship", "gather-ref-capacity", "onehot-2048-L8F4-Kf8-cascade"])
def test_quality_sweep_command_is_the_jax_drivers(name, tmp_path, monkeypatch):
    import quality_at_capacity as j_qac

    from humanrf_torch.protocol import quality_at_capacity

    assert quality_at_capacity.CONFIGS == j_qac.CONFIGS
    commands = []
    monkeypatch.setattr(j_qac, "supervise", lambda cmd, *a, **k: commands.append(cmd) or (0, 0))
    j_qac.run_config(name, tmp_path / "scene", tmp_path / "runs", 5000, ["--training.lr", "0.005"], frames=25,
                     chunk=10)
    t_cmd = quality_at_capacity.command(name, tmp_path / "scene", tmp_path / "runs" / name, 5000,
                                        ["--training.lr", "0.005"], frames=25, chunk=10)
    _assert_same_command(t_cmd, commands[-1])


def test_multiseg_command_is_the_jax_drivers(tmp_path, monkeypatch):
    import multiseg_fsdp_run as j_multiseg

    from humanrf_torch.protocol import multiseg

    commands = []

    def fake_run(cmd, **kw):
        commands.append(cmd)
        return type("Done", (), {"returncode": 0})()

    monkeypatch.setattr(j_multiseg, "ensure_scene", lambda *a, **k: False)
    monkeypatch.setattr(j_multiseg.subprocess, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["multiseg_fsdp_run.py", "--root", str(tmp_path), "--out", str(tmp_path / "r.json")])
    with pytest.raises(SystemExit) as done:
        j_multiseg.main()
    assert done.value.code == 0
    args = type("Args", (), dict(steps=400, size=192, frames=100, backend="gather", batch=1024, prop_samples=16,
                                 render_samples=8, validate_every=None, device="cpu"))
    t_cmd = multiseg.command(args, tmp_path / "scene", tmp_path / "ws")
    _assert_same_command(t_cmd, commands[-1], multiseg.MOOT_FLAGS)
    assert t_cmd[t_cmd.index("--tpu.num_devices") + 1] == "1"


def test_quality_sweep_keeps_the_best_block_partial_runs_and_log_tails(tmp_path, monkeypatch):
    from humanrf_torch.protocol import quality_at_capacity as qac

    ws = tmp_path / "runs" / "fused-flagship"
    ws.mkdir(parents=True)
    (ws / "validation.txt").write_text(VALIDATION_TXT)
    monkeypatch.setattr(supervisor, "supervise", lambda cmd, log, env, cwd, **kw: (qac.BUDGET_RC, 1))
    r = qac.run_config("fused-flagship", tmp_path / "scene", tmp_path / "runs", 5000, [], frames=25, chunk=10,
                       deadline=123.0)
    assert r["partial"] is True and r["restarts"] == 1
    assert (r["psnr"], r["at_step"], r["last_val_step"]) == (24.5, 5000, 5000)

    def failing(cmd, log, env, cwd, **kw):
        Path(log).write_text("boom traceback")
        return 1, 0

    monkeypatch.setattr(supervisor, "supervise", failing)
    r = qac.run_config("fused-flagship", tmp_path / "scene", tmp_path / "runs", 100, [])
    assert r["rc"] == 1 and "boom" in r["tail"] and "psnr" not in r


# ------------------------------------------------------------------- end to end


def test_full_schedule_then_finish_phases_on_the_cpu(tmp_path, monkeypatch):
    """full_schedule at 24² over 8 frames for 20 steps, validated every 10,
    then finish_phases' evaluate phase from its best.ckpt (its trajectory
    phase, a second CLI run of 12 views, takes ~30 s on the CPU and is left
    to the card's runs): result.json has the banked run's
    keys (less `partial`, which only a deadline writes; a budget cut, faked,
    adds it), and the evaluate phase's CSVs are what the JAX package's
    `evaluate` writes from the same renders."""
    from humanrf_torch.protocol import finish_phases, full_schedule
    from humanrf_torch.run import derive_synthetic_presets
    from humanrf_tpu.core.dataset import VolumetricDataset as JDataset
    from humanrf_tpu.evaluation.evaluate import evaluate as j_evaluate

    monkeypatch.setenv("HUMANRF_TPU_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    root = tmp_path / "run"
    flags = ["--root", str(root), "--frames", "8", "--size", "24", "--steps", "20", "--validate-every", "10",
             "--rays", "256", "--device", "cpu", "--smoke",
             "--extra", "--validation.rays_batch_size 1024 --test.rays_batch_size 1024 "
                        "--dataset.deterministic_loader true"]
    result = full_schedule.main(flags)
    banked = json.loads((common.R4_RUN / "result.json").read_text())
    assert result["rc"] == 0, result.get("tail")
    assert set(result) == set(banked) - {"partial"}
    assert result["segment_sizes"] == [6, 6]
    assert [b["step"] for b in result["validation_blocks"]] == [10, 20]
    for block in result["validation_blocks"]:
        assert set(block) == set(banked["validation_blocks"][0]) and np.isfinite(block["psnr"])
    assert json.loads((root / "result.json").read_text()) == result

    monkeypatch.setattr(supervisor, "supervise", lambda cmd, log, env, cwd, **kw: (supervisor.BUDGET_RC, 0))
    assert set(full_schedule.main(flags)) == set(banked)
    monkeypatch.undo()

    monkeypatch.setenv("HUMANRF_TPU_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    phases = finish_phases.main(["--root", str(root), "--frames", "8", "--device", "cpu", "--skip-trajectory"])
    assert phases["evaluate"]["rc"] == 0 and phases["partial"] is False and "trajectory" not in phases
    results = root / "workspace" / "results"
    data_dir = root / "scene" / "SynthActor" / "Sequence1" / "1x"
    j_out = tmp_path / "jax_evaluate"
    j_evaluate(results_directory=results, output_directory=j_out, coverage="siggraph_test",
               camera_preset="siggraph_test", frame_numbers=list(range(8)), data_folder=data_dir,
               camera_configs_override=derive_synthetic_presets(JDataset(data_dir)))
    for name in ("metrics.csv", "averages.csv"):
        t_rows, j_rows = (list(csv.DictReader(open(d / name))) for d in (results, j_out))
        assert t_rows and list(t_rows[0]) == list(j_rows[0])
        for t_row, j_row in zip(t_rows, j_rows):
            assert t_row.keys() == j_row.keys()
            for key in t_row:
                assert float(t_row[key]) == pytest.approx(float(j_row[key]), rel=1e-9)
    assert phases["averages_csv"][0] == ",".join(j_rows[0])


def test_bank_copies_the_reports_three_images_and_no_checkpoint(tmp_path):
    from humanrf_torch.protocol import bank

    root = tmp_path / "run"
    ws = root / "workspace"
    for rel in ("result.json", "scene/scene_meta.json", "workspace/validation.txt", "workspace/results/metrics.csv",
                "workspace/checkpoints/best.ckpt", "workspace/checkpoints/step_00000010.ckpt"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(rel)
    (ws / "driver.log").write_text("\n".join(f"line {i}" for i in range(200)))
    for i in range(4):
        (ws / "validation" / f"step_{i:04d}_0001_comparison.png").parent.mkdir(parents=True, exist_ok=True)
        (ws / "validation" / f"step_{i:04d}_0001_comparison.png").write_bytes(b"png")
        (ws / "results" / "test_frames" / f"Cam012_rgb{i:06d}.png").parent.mkdir(parents=True, exist_ok=True)
        (ws / "results" / "test_frames" / f"Cam012_rgb{i:06d}.png").write_bytes(b"png")
    written = {p.relative_to(tmp_path / "dest").as_posix() for p in bank.bank(root, tmp_path / "dest")}
    assert written == {
        "result.json", "workspace/validation.txt", "workspace/results/metrics.csv", "workspace/driver_log_tail.txt",
        "workspace/results/test_frames/Cam012_rgb000000.png", "workspace/results/test_frames/Cam012_rgb000001.png",
        "workspace/validation/step_0003_0001_comparison.png"}
    tail = (tmp_path / "dest" / "workspace" / "driver_log_tail.txt").read_text().splitlines()
    assert tail == [f"line {i}" for i in range(120, 200)]
