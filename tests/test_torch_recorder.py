"""The recorder of `humanrf_torch/utils/profiling.py` and the spans and
counters of the paths it instruments.

- spans nest on their thread, share their request's id, keep their self
  time; the ring drops its oldest spans and counts them; two threads record
  at once without a lost span or count; a disabled recorder records nothing;
  a span is a CPU event of a `torch.profiler` trace only while a profiler is
  active; `idle_gaps` labels each device gap with the innermost span;
- the loader (threaded and deterministic) records every fetch with its
  parts and every image load under its pair index, and its counters agree
  with what it did; `GraphedStep` on the CPU records its calls and captures
  nothing; a dense step whose budget overflows counts exactly the valid rays
  its loss leaves out;
- a model counts its segments and hash-table entries, AdamW the
  parameters it updates, and a step the segments its rays reach;
  `graphs.timed` outside a capture times nothing;
- on the card (`-m cuda`): 50 graphed steps fed by the loader make no
  synchronizing call, and every replay has its device time and its
  optimizer's, inside it.

No JAX here: the file runs on the card too.
"""
import itertools
import sys
import threading
import time
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from humanrf_torch import run as cli
from humanrf_torch.configs.args import parse_args
from humanrf_torch.core.dataset import VolumetricDataset
from humanrf_torch.core.synthetic import SyntheticSceneConfig, generate_synthetic_dataset
from humanrf_torch.data.loader import DataLoader
from humanrf_torch.models.humanrf import HumanRFConfig, HumanRFModel
from humanrf_torch.ops import adamw as adamw_kernels
from humanrf_torch.train import pipeline
from humanrf_torch.train.graphs import GraphedStep, timed
from humanrf_torch.train.trainer import make_optimizer
from humanrf_torch.utils import profiling
from humanrf_torch.utils.rngs import make_key, split
from humanrf_torch.view_inputs import load_train_inputs

torch.set_num_threads(2)

RUN_DIR = Path(__file__).resolve().parent.parent / "runs_evidence" / "r4_full_schedule_748"


class Clock:
    """A span clock the test moves by hand, in ns."""

    def __init__(self):
        self.now = 1_000

    def __call__(self):
        return self.now


@pytest.fixture
def recorder(monkeypatch):
    """A fresh process recorder with a hand-moved clock."""
    rec = profiling.Recorder(clock=Clock())
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def test_spans_nest_share_their_request_id_and_keep_self_time(recorder):
    clock = recorder.clock
    with profiling.span("fetch", 7):
        clock.now += 10
        with profiling.span("draw"):
            clock.now += 30
        with profiling.span("stage") as stage:
            clock.now += 20
            with profiling.span("load", 99):
                clock.now += 5
        clock.now += 1
    with profiling.span("alone"):
        pass
    snap = profiling.snapshot()
    (fetch,), (draw,), (stage_span,), (load,), (alone,) = (snap["spans"][n] for n in
                                                            ("fetch", "draw", "stage", "load", "alone"))
    assert (fetch.id, draw.id, stage_span.id, load.id, alone.id) == (7, 7, 7, 99, None)
    assert (fetch.parent, alone.parent) == (-1, -1)
    assert draw.parent == stage_span.parent == fetch.seq and load.parent == stage_span.seq
    assert fetch.end_ns - fetch.start_ns == 66 and fetch.self_ns == 66 - 30 - 25
    assert (stage_span.self_ns, stage.duration_ns, load.self_ns) == (20, 25, 5)
    assert {s.thread for s in (fetch, draw, stage_span, load)} == {threading.get_ident()}
    assert snap["dropped"] == 0 and not any(s.annotated for s in (fetch, draw, load))


def test_the_ring_drops_its_oldest_spans_and_counts_them(monkeypatch):
    rec = profiling.Recorder(ring_size=4, clock=Clock())
    monkeypatch.setattr(profiling, "RECORDER", rec)
    for i in range(10):
        with profiling.span("s", i):
            rec.clock.now += 100
    snap = profiling.snapshot()
    assert [s.id for s in snap["spans"]["s"]] == [6, 7, 8, 9]
    assert snap["dropped"] == 6 and snap["since_ns"] == snap["spans"]["s"][0].end_ns


def test_two_threads_record_at_once_without_losing_a_span_or_a_count(monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    n = 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(tag):
            for i in range(n):
                with profiling.span(f"{tag}.outer", i):
                    with profiling.span("inner"):
                        profiling.count("both")

        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b", "c", "d")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = profiling.snapshot()
    assert snap["counters"] == {"both": 4 * n} and snap["dropped"] == 0
    outer = {s.seq: s for tag in "abcd" for s in snap["spans"][f"{tag}.outer"]}
    assert len(outer) == 4 * n and len(snap["spans"]["inner"]) == 4 * n
    for s in snap["spans"]["inner"]:
        parent = outer[s.parent]
        assert parent.thread == s.thread and parent.id == s.id
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_a_disabled_recorder_records_nothing(recorder):
    profiling.enable(False)
    with profiling.span("fetch", 1) as fetch:
        recorder.clock.now += 50
    profiling.count("n", 3)
    with profiling.device_time("t", 1, "cpu"):
        pass
    assert fetch.duration_ns == 0
    snap = profiling.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {} and snap["device_ms"] == {}
    profiling.enable(True)
    with profiling.span("fetch", 2):
        pass
    assert [s.id for s in profiling.snapshot()["spans"]["fetch"]] == [2]


def test_spans_are_trace_events_only_while_a_profiler_is_active(recorder):
    from torch.profiler import ProfilerActivity, profile

    with profiling.span("before"):
        torch.ones(8).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("loader.fetch", 3):
            with profiling.span("loader.stage"):
                torch.ones(8).sum()
    with profiling.span("after"):
        torch.ones(8).sum()
    names = {e.name: e for e in prof.events()}
    assert {"loader.fetch", "loader.stage"} <= set(names) and not {"before", "after"} & set(names)
    fetch, stage = names["loader.fetch"], names["loader.stage"]
    assert fetch.device_type == torch.autograd.DeviceType.CPU and not fetch.is_user_annotation
    assert fetch.time_range.start <= stage.time_range.start <= stage.time_range.end <= fetch.time_range.end
    snap = profiling.snapshot()
    assert {n: snap["spans"][n][0].annotated for n in ("before", "loader.fetch", "loader.stage", "after")} == {
        "before": False, "loader.fetch": True, "loader.stage": True, "after": False}


def _event(name, start, end, device, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=kind, is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_idle_gaps_are_labelled_with_the_innermost_span(recorder):
    for name in ("graph.call", "graph.replay", "loader.fetch", "loader.stage"):
        with profiling.span(name):
            pass
    events = [
        _event("kernel_a", 0, 100, True), _event("kernel_b", 50, 150, True),  # one busy run
        _event("kernel_c", 400, 500, True), _event("kernel_d", 1500, 1600, True), _event("kernel_e", 1610, 1700, True),
        _event("graph.call", 0, 300, False), _event("graph.replay", 10, 250, False),
        _event("loader.fetch", 260, 1400, False), _event("loader.stage", 900, 1200, False),
        _event("aten::copy_", 1000, 1100, False),  # not a span of the program
        _event("outer", 250, 1450, False, annotation=True),  # a record_function range: no span of the program
        _event("outer", 1600, 1610, True),  # and its range on the device's rows: no device work
        _event("graph.call", 1605, 1606, True),  # a span's name on the device's rows: no device work
    ]
    gaps = recorder.idle_gaps(events)
    assert gaps == [["loader.stage", 1000 / 1e6], ["loader.fetch", 250 / 1e6], ["other", 10 / 1e6]]


def test_device_counters_accumulate_and_the_snapshot_reads_them(recorder):
    c = profiling.device_counter("sampler.steps", "cpu")
    assert profiling.device_counter("sampler.steps", torch.device("cpu")) is c
    c += 2
    c += torch.tensor(5)
    profiling.count("sampler.steps", 1)
    recorder.add_device_ms("graph.device_ms", ("f", 1), 1.5)
    snap = profiling.snapshot()
    assert snap["counters"] == {"sampler.steps": 8} and snap["device_ms"] == {"graph.device_ms": {("f", 1): 1.5}}


# ------------------------------------------------------ instrumented paths


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    generate_synthetic_dataset(root, SyntheticSceneConfig(num_cameras=6, width=40, height=40, num_frames=4,
                                                          grid_resolution=32))
    return root


def _config(root, device):
    return parse_args([
        "--config", "example_synthetic", "--dataset.path", str(root), "--workspace", str(root / "ws"),
        "--device", device.type, "--dataset.frame_numbers", "0", "1", "2", "3", "--dataset.max_buffer_size", "3",
        "--training.rays_initial_batch_size", "128", "--tpu.sampling", "proposal", "--tpu.proposal_rank", "8",
        "--tpu.proposal_resolution", "64", "--tpu.proposal_samples_per_ray", "16", "--tpu.render_samples_per_ray",
        "8", "--tpu.candidate_rays_factor", "2", "--model.log2_hashmap_size", "12", "--model.n_levels", "4",
        "--model.finest_resolution", "128",
    ])


def _loader(root, config, device, deterministic):
    folder = root / "SynthActor" / "Sequence1" / "1x"
    cameras = cli.derive_synthetic_presets(VolumetricDataset(folder))["siggraph_train"]
    return DataLoader(
        dataset=VolumetricDataset(folder), mode=DataLoader.Mode.TRAINING,
        space_pruning_mode=DataLoader.SpacePruningMode.OCCUPANCY_GRID, frame_numbers=(0, 1, 2, 3),
        batch_size=config.training.rays_initial_batch_size * config.tpu.candidate_rays_factor, camera_numbers=cameras,
        max_buffer_size=config.dataset.max_buffer_size, max_num_frames_per_batch=2, use_mask=True,
        filter_light_bloom=False, deterministic=deterministic, seed=3, device=device,
    )


FETCH_PARTS = {"loader.draw", "loader.lock_wait", "loader.gather", "loader.stage"}


@pytest.mark.parametrize("deterministic", [True, False])
def test_the_loader_records_each_fetch_and_image_load(scene, recorder, deterministic):
    recorder.clock = time.perf_counter_ns
    loader = _loader(scene, _config(scene, torch.device("cpu")), "cpu", deterministic)
    try:
        it = iter(loader)
        fetches = 12
        for _ in range(fetches):
            next(it)
        if not deterministic:  # let the replacer commit a few images, then fetch again
            deadline = time.monotonic() + 60
            while loader.pair_load_index < loader.buffer_size + 3 and time.monotonic() < deadline:
                time.sleep(0.01)
            for _ in range(3):
                next(it)
            fetches += 3
    finally:
        loader.shutdown()
    snap = profiling.snapshot()
    spans = snap["spans"]
    by_seq = {s.seq: s for ss in spans.values() for s in ss}
    fetch = spans["loader.fetch"]
    assert [s.id for s in fetch] == list(range(1, fetches + 1)) and loader.batch_number == fetches
    for f in fetch:
        children = {s.name for s in by_seq.values() if s.parent == f.seq}
        assert FETCH_PARTS <= children, children
        assert all(s.id == f.id for s in by_seq.values() if s.parent == f.seq)
    # Every image load is recorded under its pair index, with its parts (but
    # a load that the shutdown cut, which has none).
    loads = spans["loader.load"]
    assert sorted(s.id for s in loads) == list(range(loader.pair_load_index))
    for load in loads if deterministic else [s for s in loads if s.id != loader.pair_load_index - 1]:
        parts = [s for s in by_seq.values() if s.parent == load.seq]
        assert {s.name for s in parts} >= {"loader.decode", "loader.prepare", "loader.commit"}
        assert all(s.id == load.id for s in parts)
        assert ("loader.commit_wait" in {s.name for s in parts}) == (load.id >= loader.buffer_size
                                                                     and not deterministic)
    replaced = [s for s in loads if s.id >= loader.buffer_size]
    assert replaced and all(by_seq.get(s.parent, types.SimpleNamespace(name=None)).name
                            == ("loader.replace" if deterministic else None) for s in replaced)
    # The counters agree with the spans and with the loader's own state.
    counters = snap["counters"]
    assert counters["loader.images_replaced"] == loader.pair_load_index - loader.buffer_size == len(replaced)
    assert counters["loader.pool_snapshots"] == len(spans["loader.pool_snapshot"]) >= 1
    assert counters["loader.grid_uploads"] == len(spans["loader.grid_upload"]) >= 1
    batch_bytes = loader.batch_size * (4 + 4 + 16 + 1)
    pool_bytes = sum(a.nbytes for a in (loader.entry_inverse_krs, loader.entry_camera_origins, loader.entry_landscape,
                                        loader.entry_frame_numbers, loader.entry_camera_numbers,
                                        loader.entry_grid_slots))
    grid_bytes = loader.occupancy_grid_resolution ** 3
    assert counters["loader.staged_bytes"] == (fetches * batch_bytes + counters["loader.pool_snapshots"] * pool_bytes
                                               + counters["loader.grid_uploads"] * grid_bytes)


def test_graphed_step_on_the_cpu_records_its_calls_and_captures_nothing(recorder):
    step = GraphedStep("a cpu step", lambda x, y: x * y + 1)
    for i in range(3):
        assert torch.equal(step(torch.full((4,), float(i)), torch.ones(4)), torch.full((4,), i + 1.0))
    snap = profiling.snapshot()
    assert [s.id for s in snap["spans"]["graph.call"]] == [("a cpu step", i) for i in (1, 2, 3)]
    assert set(snap["spans"]) == {"graph.call"} and snap["counters"] == {} and snap["device_ms"] == {}


def test_timed_outside_a_capture_times_nothing(recorder):
    def body(x):
        with timed("test.part"):
            return x + 1

    step = GraphedStep("a cpu step", body)
    assert torch.equal(step(torch.zeros(3)), torch.ones(3))
    assert profiling.snapshot()["device_ms"] == {}


_SMALL = dict(
    sorted_frame_numbers=tuple(range(50)), segment_sizes=(25, 25), density_scale=10.0, n_levels=2, n_features_per_level=2,
    log2_hashmap_size=11, coarsest_resolution=4, finest_resolution=32, geometry_feature_dim=3,
    n_neurons=16, n_hidden_layers_density=1, n_hidden_layers_color=1, sh_degree=2, camera_embedding_dim=2,
)


def test_a_dense_step_counts_the_valid_rays_its_budget_leaves_out(recorder, monkeypatch):
    inputs = load_train_inputs(RUN_DIR / "torch_train_inputs.npz", "cpu")
    model = HumanRFModel(HumanRFConfig(**_SMALL))
    model.init_parameters(torch.Generator().manual_seed(0))
    # ~110 of 128 rays hit the actor with ~450 lattice points each: a
    # 16,384-slot render budget leaves out more than half of them.
    cfg = pipeline.PipelineConfig(sampling="dense", num_rays=128, candidate_rays_factor=2, samples_per_ray=512,
                                  candidate_budget=40_960, sample_budget=16_384, march_grid_factor=2,
                                  bce_loss_weight=1e-3, huber_delta=0.01)
    seen = []
    prune_and_render = pipeline.prune_and_render

    def watched(cfg_, model_, rays, *args, **kwargs):
        out, pruned = prune_and_render(cfg_, model_, rays, *args, **kwargs)
        seen.append((int(rays.valid.sum()), int((rays.valid & ~pruned.ray_included).sum())))
        return out, pruned

    monkeypatch.setattr(pipeline, "prune_and_render", watched)
    step = pipeline.make_train_step(cfg, model, make_optimizer(model.named_parameters(), 1e-2, 0.5, 50_001, 0.03),
                                    inputs.width, inputs.height)
    rng = np.random.default_rng(4)
    rgba = inputs.pixel_rgba.numpy()
    key = make_key(2)
    for _ in range(2):
        b = rng.integers(0, rgba.shape[0], 256)
        p = np.array([rng.choice(np.nonzero(rgba[i, :, 3])[0]) for i in b])
        batch = pipeline.HostBatch(torch.tensor(b, dtype=torch.int32), torch.tensor(p, dtype=torch.int32),
                                   torch.tensor(rgba[b, p].astype(np.float32) / 255.0), torch.ones(256, dtype=torch.bool))
        key, sub = split(key)
        step(batch, inputs.pool, inputs.grids, inputs.aabb, sub)
    counters = profiling.snapshot()["counters"]
    valid, overflowed = (sum(v) for v in zip(*seen))
    assert 0 < overflowed < valid and counters["sampler.rays_overflowed"] == overflowed
    assert counters["sampler.rays_valid"] == valid and counters["sampler.steps"] == 2
    assert counters["sampler.candidate_rays_valid"] >= valid and counters["sampler.samples"] <= 2 * 16_384


def test_a_model_counts_its_segments_and_tables_and_an_optimizer_its_parameters(recorder):
    """`field.segments` and `field.table_params` (the four hash tables of
    each segment, sized by its frames: 2^8, 2^9 and 2^10 entries at log2 T
    12 for 6, 12 and 25 frames) counted at build, and what AdamW updates:
    sizes of the latest build, which a second build sets again and does not
    add to."""
    for _ in range(2):
        model = HumanRFModel(HumanRFConfig(**dict(_SMALL, sorted_frame_numbers=tuple(range(43)),
                                                  segment_sizes=(6, 12, 25), log2_hashmap_size=12)))
        counters = profiling.snapshot()["counters"]
        assert {k: counters[k] for k in ("field.segments", "field.table_params")} == {
            "field.segments": 3, "field.table_params": 4 * 2 * 2 * (256 + 512 + 1024)}
        make_optimizer(model.named_parameters(), 1e-2, 0.5, 50_001, 0.03)
        total = sum(p.numel() for p in model.parameters())
        assert profiling.snapshot()["counters"]["train.optimizer_params"] == total > 4 * 2 * 2 * 1792
    model = HumanRFModel(HumanRFConfig(**dict(_SMALL, sorted_frame_numbers=tuple(range(6)), segment_sizes=(6,),
                                              log2_hashmap_size=12)))
    make_optimizer(model.named_parameters(), 1e-2, 0.5, 50_001, 0.03)
    assert profiling.snapshot()["counters"] == {"field.segments": 1, "field.table_params": 4 * 2 * 2 * 256,
                                                "train.optimizer_params": sum(p.numel() for p in model.parameters())}


def test_a_step_counts_the_segments_its_rays_reach(recorder, monkeypatch):
    """`train.segments_reached`: per step the distinct segments of the frames
    of the valid rays, over eight 6-frame segments and frames of no segment
    (48, 49), summed over the steps."""
    inputs = load_train_inputs(RUN_DIR / "torch_train_inputs.npz", "cpu")
    frames = torch.tensor([0, 7, 13, 19, 20, 31, 49, 48] * 2, dtype=torch.int32)
    pool = inputs.pool._replace(frame_numbers=frames)
    model = HumanRFModel(HumanRFConfig(**dict(_SMALL, segment_sizes=(6,) * 8)))
    model.init_parameters(torch.Generator().manual_seed(0))
    cfg = pipeline.PipelineConfig(sampling="dense", num_rays=128, candidate_rays_factor=1, samples_per_ray=256,
                                  candidate_budget=8192, sample_budget=4096, march_grid_factor=2, huber_delta=0.01)
    seen = []
    build_rays = pipeline.build_rays

    def watched(*args, **kwargs):
        rays = build_rays(*args, **kwargs)
        seen.append({int(f) // 6 for f, v in zip(rays.frame_numbers, rays.valid) if v and f < 48})
        return rays

    monkeypatch.setattr(pipeline, "build_rays", watched)
    step = pipeline.make_train_step(cfg, model, make_optimizer(model.named_parameters(), 1e-2, 0.5, 50_001, 0.03),
                                    inputs.width, inputs.height)
    rng = np.random.default_rng(3)
    rgba = inputs.pixel_rgba.numpy()
    key = make_key(1)
    for entries in ([0, 1, 2, 6, 7], [3, 4, 5, 8, 9, 10]):
        b = rng.choice(entries, 128)
        p = np.array([rng.choice(np.nonzero(rgba[i, :, 3])[0]) for i in b])
        batch = pipeline.HostBatch(torch.tensor(b, dtype=torch.int32), torch.tensor(p, dtype=torch.int32),
                                   torch.tensor(rgba[b, p].astype(np.float32) / 255.0), torch.ones(128, dtype=torch.bool))
        key, sub = split(key)
        step(batch, pool, inputs.grids, inputs.aabb, sub)
    assert len(seen) == 2 and len(seen[0]) >= 3 and len(seen[1]) >= 3 and seen[0] != seen[1]
    assert profiling.snapshot()["counters"]["train.segments_reached"] == len(seen[0]) + len(seen[1])


@pytest.mark.cuda
def test_fifty_graphed_steps_make_no_synchronizing_call(scene, recorder):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    recorder.clock = time.perf_counter_ns
    device = torch.device("cuda", 0)
    config = _config(scene, device)
    model = cli.build_model(config, [4], device)
    model.init_parameters(torch.Generator(device=device).manual_seed(0))
    loader = _loader(scene, config, device, deterministic=False)
    step = pipeline.make_train_step(cli.build_pipeline_config(config), model,
                                    cli.optimizer_factory(config)(model.named_parameters()), *loader.resolution)
    keys = itertools.count()
    it = iter(loader)
    adamw_kernels.reset_launches()
    try:
        for _ in range(3):  # the eager body and capture, then a replay
            step(*next(it)[:3], loader.device_aabb, make_key(next(keys)))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")  # (it warns once that it is a prototype)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                for _ in range(50):
                    with profiling.span("test.step"):
                        batch, pool, grids, _ = next(it)
                        step(batch, pool, grids, loader.device_aabb, make_key(next(keys)))
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        loader.shutdown()
    synced = [str(w.message) for w in caught if "synchroniz" in str(w.message).lower()]
    assert not [m for m in synced if "prototype" not in m], synced
    snap = profiling.snapshot()
    calls = [s.id for s in snap["spans"]["graph.call"]]
    assert len(calls) == 53 and snap["counters"]["graph.captures"] == 1
    assert set(snap["device_ms"]["graph.device_ms"]) == {("the train step", i) for i in range(2, 54)}
    assert all(0 < ms < 1e3 for ms in snap["device_ms"]["graph.device_ms"].values())
    optimizer_ms = snap["device_ms"]["train.optimizer_ms"]
    assert set(optimizer_ms) == set(snap["device_ms"]["graph.device_ms"])
    assert all(0 < ms < snap["device_ms"]["graph.device_ms"][call] for call, ms in optimizer_ms.items())
    assert snap["counters"]["sampler.steps"] == 53
    # AdamW's two kernels once a step, the replays' counted as the eager step's
    assert adamw_kernels.launches == {"finite": 53, "update": 53}
    assert snap["counters"]["train.optimizer_launches"] == 2
