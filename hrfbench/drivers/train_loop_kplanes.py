"""The closed training loop of `train_loop` for a K-Planes configuration
(`--model.representation kplanes`): the port's `Trainer` step fed by its
`DataLoader`, step after step, checked against the K-Planes reference
(`hrfbench/reference/kplanes.py`).

Set-up builds the program through the port's normal path, checks that it
built the field and sampler the configuration states, loads weights drawn
on the device from the seed (`reference.kplanes.draw_weights`: spatial
planes U[0.1, 0.5], time planes 1 + U[−0.1, 0.1], He-normal MLPs), and runs
the first `check_steps` steps on the loop's own call and feed, keeping their
requests, losses, step 1's gradient and the parameters after the last for
the reference. The window, its trace and the numbers are `train_loop`'s;
the record's `step_work` counts the step's planes, MLPs and Adam
(`counts/kplanes_step.py`), and `kplanes_{fwd,bwd}_least` the least time of
the profiled check step's plane queries (`counts/kplanes_{fwd,bwd}.py`).

A program without the K-Planes model fails at once: this module imports it.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
from pathlib import Path

import torch

from humanrf_torch.models.kplanes import KPlanesModel  # noqa: F401  (the program this cell runs)

from hrfbench import harness
from hrfbench.counts import kplanes_bwd, kplanes_fwd, kplanes_step
from hrfbench.counts.peaks import least_time
from hrfbench.drivers.train_loop import _cpu, _span


def build(ctx, workspace: Path):
    """The port's training program for the cell → (trainer, loader)."""
    from humanrf_torch import run as cli
    from humanrf_torch.configs.args import parse_args
    from humanrf_torch.core.dataset import VolumetricDataset
    from humanrf_torch.data.loader import DataLoader
    from humanrf_torch.train.trainer import Trainer

    config = parse_args([*ctx.conf["flags"], "--dataset.path", str(ctx.scene), "--workspace", str(workspace),
                         "--device", ctx.device.type, "--random_seed", str(ctx.seed)])
    data_folder = ctx.scene / config.dataset.actor / config.dataset.sequence / f"{config.dataset.scale}x"
    frames = tuple(config.dataset.frame_numbers)
    segment_sizes = cli.compute_segment_sizes(config, data_folder, frames)
    model = cli.build_model(config, segment_sizes, ctx.device)
    pcfg = cli.build_pipeline_config(config)
    check_config(model.config, pcfg, ctx.conf)
    cameras = cli.derive_synthetic_presets(VolumetricDataset(data_folder))[config.training.camera_preset]
    loader = DataLoader(
        dataset=VolumetricDataset(data_folder, config.dataset.crop_center_square), mode=DataLoader.Mode.TRAINING,
        space_pruning_mode=DataLoader.SpacePruningMode.OCCUPANCY_GRID, frame_numbers=frames,
        batch_size=config.training.rays_initial_batch_size * config.tpu.candidate_rays_factor,
        camera_numbers=cameras, max_buffer_size=config.dataset.max_buffer_size,
        max_num_frames_per_batch=config.dataset.max_num_frames_per_batch, use_mask=True,
        filter_light_bloom=config.dataset.filter_light_bloom, deterministic=config.dataset.deterministic_loader,
        seed=ctx.seed, device=ctx.device,
    )
    trainer = Trainer(config=config, workspace=workspace, checkpoint=None, model=model, pipeline_config=pcfg,
                      optimizer=cli.optimizer_factory(config), resolution=loader.resolution, seed=ctx.seed)
    return trainer, loader


def check_config(program_model_cfg, program_pcfg, conf: dict) -> None:
    """Raise unless the port built the K-Planes field, the sampler and the
    loss that the configuration file states, as the reference reads them."""
    from hrfbench.reference import kplanes
    from hrfbench.reference.check import flag, pipeline_config

    pairs = ((dataclasses.asdict(program_model_cfg), dataclasses.asdict(kplanes.model_config(conf))),
             (dataclasses.asdict(program_pcfg), {**dataclasses.asdict(pipeline_config(conf)),
                                                 "photometric": flag(conf["flags"], "training.photometric")}))
    for program, reference in pairs:
        diff = {k: (program.get(k), v) for k, v in reference.items() if program.get(k) != v}
        if diff:
            raise harness.CheckFailed(f"the port runs another configuration than the file states (port, file): {diff}")


def run(ctx) -> dict:
    """→ the run's record (see `hrfbench/run.py`)."""
    from humanrf_torch.utils.rngs import split

    from hrfbench.reference import kplanes

    traffic, trace = ctx.traffic, ctx.trace
    torch.set_num_threads(traffic["cpu_threads"])
    workspace = Path(tempfile.mkdtemp(prefix="hrfbench-"))
    trainer, loader = build(ctx, workspace)
    model, step_fn = trainer.model, trainer.train_step_fn
    named = dict(model.named_parameters())
    initial = kplanes.draw_weights({n: tuple(p.shape) for n, p in named.items()}, ctx.seed, ctx.device)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(initial[n])
    initial = {n: t.cpu() for n, t in initial.items()}
    aabb = loader.device_aabb
    it = iter(loader)

    def one_step(spans: bool = False):
        with _span("key", spans):
            trainer.rng, key = split(trainer.rng)
        with _span("fetch", spans):
            batch, pool, grids, _ = next(it)
        with _span("step", spans):
            loss, aux = step_fn(batch, pool, grids, aabb, key)
        return batch, pool, grids, key, loss, aux

    # The check steps: the loop's own call and feed, kept for the reference;
    # a traced run profiles the second (the first graph replay).
    requests, losses, grads, check_profile = [], [], None, None
    for i in range(traffic["check_steps"]):
        profiled = trace and i == 1
        if profiled:
            prof, ev = harness.open_profile()
        batch, pool, grids, key, loss, aux = one_step(profiled)
        if profiled:
            check_profile = harness.close_profile(prof, ev, 1)
        requests.append((_cpu(batch), _cpu(pool), grids.cpu().clone(), aabb.cpu().clone(), key.cpu().clone()))
        losses.append(float(loss))
        if i == 0:
            b1 = trainer.optimizer.b1
            grads = {n: (m / (1.0 - b1)).cpu() for n, m in zip(trainer.optimizer.names, trainer.optimizer.mu)}
    params = {n: p.detach().cpu().clone() for n, p in named.items()}
    for _ in range(traffic["warmup_steps"]):
        one_step()
    harness.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    # The window.
    record = {"setup_s": setup_s}
    profile = None
    if trace:
        prof, ev = harness.open_profile()
        for _ in range(traffic["profile_steps"]):
            one_step(True)
        profile = harness.close_profile(prof, ev, traffic["profile_steps"])
    skipped_before = int(trainer.optimizer.skipped)
    fetch_s, steps, samples = 0.0, 0, None
    events = []
    harness.sync(ctx.device)
    t0 = time.perf_counter()
    while True:
        if trace:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        trainer.rng, key = split(trainer.rng)
        tf = time.perf_counter()
        batch, pool, grids, _ = next(it)
        fetch_s += time.perf_counter() - tf
        loss, aux = step_fn(batch, pool, grids, aabb, key)
        if trace:
            samples = aux["num_samples"].clone() if samples is None else samples + aux["num_samples"]
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if trace:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    harness.sync(ctx.device)
    window_s = time.perf_counter() - t0
    record.update(memory_peak_bytes=harness.peak_bytes(ctx.device), window_s=window_s, steps=steps, attempted=steps,
                  failed=int(trainer.optimizer.skipped) - skipped_before)
    pcfg = trainer.pcfg
    record["end_to_end"] = {"setup_s": setup_s, "train_rays_per_s": pcfg.num_rays * steps / window_s}
    if trace:
        intervals = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        slots = pcfg.num_rays * pcfg.render_samples_per_ray
        record.update(fetch_share=fetch_s / window_s, step_ms=intervals, step_s=window_s / steps,
                      slot_fill=float(samples) / (slots * steps), profile=profile, check_profile=check_profile)
    num_params = sum(p.numel() for p in named.values())
    width, height = trainer.resolution
    loader.shutdown()
    del trainer, model, step_fn, named, it, loader
    harness.free_device()
    shutil.rmtree(workspace, ignore_errors=True)

    # The reference, on the chip, once the program's state is gone.
    from hrfbench.reference.check import Scene, StepInputs, derive_step, train_numbers

    scene = Scene(ctx.scene)
    derived, mismatches = [], 0
    for req in requests:
        inputs, bad = derive_step(scene, StepInputs(*req))
        derived.append(inputs)
        mismatches += bad
    logs = [[] for _ in derived] if trace else None
    ref = kplanes.train_steps(ctx.conf, initial, derived, width, height, ctx.device, work_logs=logs)
    program = {"losses": losses, "grads": grads, "params": params}
    numbers, worst = train_numbers(program, ref, initial)
    numbers["feed_mismatches"] = mismatches
    record.update(numbers=numbers, worst_leaves=worst)
    if ctx.keep_inputs:  # for `hrfbench/control_kplanes.py`
        record["inputs"] = {"initial": initial, "steps": derived, "width": width, "height": height,
                            "reference": ref}
    record["losses"] = {"program": losses, "reference": ref["losses"]}
    if trace:
        model_dict = dataclasses.asdict(kplanes.model_config(ctx.conf))
        record["step_work"] = kplanes_step.count(logs[1], model_dict, num_params)
        for name, mod in (("fwd", kplanes_fwd), ("bwd", kplanes_bwd)):
            record[f"kplanes_{name}_least"] = least_time(*mod.count(logs[1]), mod.PRECISION)
    return record
