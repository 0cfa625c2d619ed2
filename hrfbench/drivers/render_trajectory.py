"""Novel views along a keycam trajectory, rendered back to back by one client.

The traffic: `keycams` of the scene's cameras drawn by the seed, a smooth
path of `trajectory_num_cameras` cameras through them (the intrinsics of the
second key camera), ping-ponged against the scene's frames from a start
drawn by the seed, each view in batches of `batch_rays` rays. The program
is the port's TEST `DataLoader` over that calibration and a render-only
`Trainer` restoring the configuration's checkpoint, whose graphed render
function (`Trainer._get_render_fn`) renders each batch; a view is done when
its colours sit on the host as numpy, as `Trainer.test` has them before it
writes its PNGs (the writes and ffmpeg are left out).

Once the window has closed, `compare_views` of its views drawn by the seed
are rendered again by the reference from the checkpoint and the files.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from scipy import interpolate
from scipy.spatial.transform import Rotation, Slerp

from hrfbench import harness
from hrfbench.counts import field_interp_fwd
from hrfbench.counts import render_batch as render_count
from hrfbench.counts.peaks import least_time
from hrfbench.scene.generate import Camera, read_calibration_csv, write_calibration_csv


def trajectory_cameras(keys, intrinsics: Camera, num: int):
    """`num` cameras through `keys`: world-to-camera rotations slerped and
    translations splined (degree min(2, K − 1)) at times spaced by the key
    cameras' distances, each with `intrinsics`' image and lens."""
    rot_w2c = np.stack([Rotation.from_rotvec(c.rotation_axisangle).as_matrix().T for c in keys])
    t_w2c = np.stack([-r @ c.translation for c, r in zip(keys, rot_w2c)])
    positions = np.stack([c.translation for c in keys])
    lengths = np.linalg.norm(positions[1:] - positions[:-1], axis=1)
    key_times = np.cumsum([0] + list(lengths / lengths.sum()))
    slerp = Slerp(key_times, Rotation.from_matrix(rot_w2c))
    spline = interpolate.make_interp_spline(key_times, t_w2c, k=min(2, len(keys) - 1))
    times = np.linspace(1e-5, 1 - 1e-5, num)
    rotations = slerp(times).as_matrix().astype(np.float32)
    translations = spline(times).astype(np.float32)
    digits = int(np.log10(num)) + 1
    return [Camera(f"Cam{i + 1}".zfill(digits), intrinsics.width, intrinsics.height,
                   Rotation.from_matrix(r.T).as_rotvec(), -r.T @ t, intrinsics.focal_length.copy(),
                   intrinsics.principal_point.copy()) for i, (r, t) in enumerate(zip(rotations, translations))]


def ping_pong(num_cameras: int, frames) -> list:
    """max(#cameras, #frames) (camera, frame) pairs, each index running
    forward, then backward, repeating the endpoint where it turns."""
    out = []
    for k in range(max(len(frames), num_cameras)):
        cam = k % num_cameras
        if (k // num_cameras) % 2:
            cam = num_cameras - 1 - cam
        f = k % len(frames)
        if (k // len(frames)) % 2:
            f = len(frames) - 1 - f
        out.append((cam, frames[f]))
    return out


def write_trajectory(ctx, frames) -> tuple:
    """The seed's trajectory, written as the test calibration beside the data
    → (test folder, render sequence)."""
    rng = np.random.default_rng(ctx.seed)
    seq_dir = ctx.scene / "SynthActor" / "Sequence1"
    cameras = read_calibration_csv(seq_dir / "1x" / "calibration.csv")
    keys = [cameras[int(i)] for i in rng.choice(len(cameras), ctx.traffic["keycams"], replace=False)]
    path = trajectory_cameras(keys, keys[1], ctx.traffic["trajectory_num_cameras"])
    test_dir = seq_dir / "test"
    shutil.rmtree(test_dir, ignore_errors=True)
    test_dir.mkdir()
    write_calibration_csv(path, test_dir / "calibration.csv")
    sequence = ping_pong(len(path), frames)
    start = int(rng.integers(len(sequence)))
    return test_dir, sequence[start:] + sequence[:start]


def build(ctx, workspace: Path):
    """The port's render program for the cell → (trainer, loader)."""
    from humanrf_torch import run as cli
    from humanrf_torch.configs.args import parse_args
    from humanrf_torch.core.dataset import VolumetricDataset
    from humanrf_torch.data.loader import DataLoader
    from humanrf_torch.train.trainer import Trainer

    ckpt = harness.ROOT / ctx.conf["checkpoint"]
    digest = hashlib.sha256(ckpt.read_bytes()).hexdigest()
    if digest != ctx.conf["checkpoint_sha256"]:
        raise harness.CheckFailed(f"{ckpt} has SHA-256 {digest}, not the configuration's {ctx.conf['checkpoint_sha256']}")
    config = parse_args([*ctx.conf["flags"], "--dataset.path", str(ctx.scene), "--workspace", str(workspace),
                         "--device", ctx.device.type, "--random_seed", str(ctx.seed),
                         "--test.rays_batch_size", str(ctx.traffic["batch_rays"])])
    data_folder = ctx.scene / config.dataset.actor / config.dataset.sequence / f"{config.dataset.scale}x"
    frames = tuple(config.dataset.frame_numbers)
    model = cli.build_model(config, cli.compute_segment_sizes(config, data_folder, frames), ctx.device)
    pcfg = cli.build_pipeline_config(config)
    harness.check_config(model.config, pcfg, ctx.conf)
    test_dir, sequence = write_trajectory(ctx, frames)
    loader = DataLoader(
        dataset=VolumetricDataset(test_dir, crop_center_square=False), mode=DataLoader.Mode.TEST,
        space_pruning_mode=DataLoader.SpacePruningMode.OCCUPANCY_GRID, batch_size=config.test.rays_batch_size,
        camera_numbers=tuple(range(ctx.traffic["trajectory_num_cameras"])), frame_numbers=frames, max_buffer_size=1,
        render_sequence=sequence, device=ctx.device,
    )
    trainer = Trainer(config=config, workspace=workspace, checkpoint=str(ckpt), model=model, pipeline_config=pcfg,
                      optimizer=None, resolution=loader.resolution, seed=ctx.seed)
    return trainer, loader, test_dir


def views(trainer, loader, acc, spans: bool):
    """The loader's views, rendered batch by batch as `Trainer.test` renders
    them → yields (colors (H·W, 3) float32 numpy); `acc` sums the valid rays
    and the rays of the batches on the device; `spans` names the host's
    work for the profiler."""
    span = lambda name: torch.profiler.record_function(f"hrfbench.{name}") if spans else contextlib.nullcontext()  # noqa: E731
    render_fn = trainer._get_render_fn(loader.batch_size)
    aabb = loader.device_aabb
    partial = []
    for i, (batch, pool, grids, info) in enumerate(loader):
        with span("render"):
            out, valid = render_fn(batch, pool, grids, aabb, 0.0)
            partial.append(out.color[: info.num_real].clone())  # the next batch overwrites `out`
        if acc is not None:
            acc[0] += valid.sum()
            acc[1] += valid.shape[0]
        if (i + 1) % loader.num_batches_per_full_image:
            continue
        with span("to_host"):
            colors = torch.cat(partial).cpu().numpy()
        partial = []
        yield colors


def view_numbers(program, reference) -> dict:
    """The numbers the render cell compares: over the compared views, the
    widest gap of a colour channel and the largest root-mean-square gap of a
    view, against the reference's render of the same view."""
    gaps = [np.abs(p.astype(np.float64) - r.astype(np.float64)) for p, r in zip(program, reference)]
    return {"view_max_gap": max(float(g.max()) for g in gaps),
            "view_rms_gap": max(float(np.sqrt((g**2).mean())) for g in gaps)}


def run(ctx) -> dict:
    traffic, trace = ctx.traffic, ctx.trace
    workspace = Path(tempfile.mkdtemp(prefix="hrfbench-"))
    trainer, loader, test_dir = build(ctx, workspace)
    acc = [torch.zeros((), dtype=torch.int64, device=ctx.device) for _ in range(2)] if trace else None
    stream = views(trainer, loader, acc, trace)
    served = 0  # views taken from the stream
    for _ in range(traffic["warmup_views"]):
        next(stream)
        served += 1
    harness.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    record = {"setup_s": setup_s}

    kept = {}  # view index → (camera, frame, colors)
    sequence = loader.render_sequence
    profiled = None
    if trace:
        prof, ev = harness.open_profile()
        kept[served] = (*sequence[served % len(sequence)], next(stream))
        profiled = served
        served += 1
        record["profile"] = harness.close_profile(prof, ev, 1)
        for t in acc:
            t.zero_()
    harness.sync(ctx.device)
    t0 = t_prev = time.perf_counter()
    view_ms, window_views = [], []
    while True:
        colors = next(stream)
        t = time.perf_counter()
        view_ms.append(1e3 * (t - t_prev))
        t_prev = t
        kept[served] = (*sequence[served % len(sequence)], colors)
        window_views.append(served)
        served += 1
        if t - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    stream.close()
    record.update(memory_peak_bytes=harness.peak_bytes(ctx.device), window_s=window_s, views=len(view_ms),
                  attempted=len(view_ms),
                  failed=sum(not np.isfinite(kept[v][2]).all() for v in window_views))
    width, height = loader.resolution
    pixels = width * height
    record["end_to_end"] = {"setup_s": setup_s, "render_mpix_per_s": len(view_ms) * pixels / window_s / 1e6,
                            "view_ms_p90": float(np.percentile(view_ms, 90))}
    record["view_ms"] = view_ms
    if trace:
        record.update(slot_fill=float(acc[0]) / float(acc[1]), view_s=window_s / len(view_ms))
    loader.shutdown()
    batch_rays = loader.batch_size
    del trainer, loader, stream
    harness.free_device()
    shutil.rmtree(workspace, ignore_errors=True)

    # The reference, once the program's state is gone.
    from hrfbench.reference.check import Scene, build_model, load_checkpoint_state, model_config, render_view

    rng = np.random.default_rng(ctx.seed + 1)
    compared = sorted(int(i) for i in rng.choice(window_views, min(traffic["compare_views"], len(window_views)),
                                                 replace=False))
    if profiled is not None:
        compared.insert(0, profiled)
    scene = Scene(ctx.scene, calibration=test_dir / "calibration.csv")
    model = build_model(ctx.conf, load_checkpoint_state(harness.ROOT / ctx.conf["checkpoint"]), ctx.device)
    refs = []
    for v in compared:
        camera, frame, _ = kept[v]
        log = [] if v == profiled else None
        ref = render_view(ctx.conf, model, scene, camera, frame, batch_rays, width, height, ctx.device,
                          block_rays=batch_rays, work_log=log)
        refs.append(ref)
        if log is not None:
            model_dict = dataclasses.asdict(model_config(ctx.conf))
            record["view_work"] = render_count.count(log, model_dict)
            record["field_interp_fwd_least"] = least_time(*field_interp_fwd.count(log), field_interp_fwd.PRECISION)
    record["compared_views"] = compared
    record["numbers"] = view_numbers([kept[v][2] for v in compared], refs)
    if ctx.keep_inputs:  # for `hrfbench/control.py`
        record["inputs"] = {"views": [kept[v][:2] for v in compared], "reference": refs, "scene": scene,
                            "batch_rays": batch_rays, "width": width, "height": height}
    return record
