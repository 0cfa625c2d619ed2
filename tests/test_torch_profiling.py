"""The port's profiler (humanrf_torch/utils/profiling.py) and the trainer's
`--tpu.profile_dir` window.

- `trace` writes one Chrome-trace JSON holding what ran inside it;
- `RateMeter` counts items over its window;
- a 26-step CLI run with `--tpu.profile_dir` writes exactly one trace, and
  its `train_step` spans are those of steps 20–24: the JAX trainer's window
  (start at the first step >= 20, stop five steps later) at one step per
  dispatch.
"""
import json
import time

import torch

from humanrf_torch.core.synthetic import SyntheticSceneConfig, generate_synthetic_dataset
from humanrf_torch.run import main as t_main
from humanrf_torch.utils.profiling import RateMeter, trace

torch.set_num_threads(2)


def _events(path):
    return json.loads(path.read_text())["traceEvents"]


def test_trace_writes_one_chrome_trace_of_its_body(tmp_path):
    with trace(tmp_path / "prof"):
        with torch.profiler.record_function("inside"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with trace(tmp_path / "off", enabled=False):
        torch.ones(3).sum()
    (path,) = (tmp_path / "prof").iterdir()
    assert path.name.endswith(".pt.trace.json") and not (tmp_path / "off").exists()
    names = {e.get("name") for e in _events(path)}
    assert "inside" in names and any("mm" in str(n) for n in names)


def test_rate_meter_counts_items_over_its_window():
    meter = RateMeter()
    meter.tick(500)
    meter.tick(500)
    time.sleep(0.05)
    rate = meter.window()
    assert 0 < rate <= 1000 / 0.05
    assert meter._items == 0


def test_cli_traces_steps_20_to_24_once(tmp_path, capsys):
    generate_synthetic_dataset(tmp_path, SyntheticSceneConfig(num_cameras=6, width=40, height=40, num_frames=2,
                                                              grid_resolution=32))
    profile_dir = tmp_path / "profile"
    result = t_main([
        "--config", "example_synthetic", "--dataset.path", str(tmp_path), "--workspace", str(tmp_path / "ws"),
        "--device", "cpu", "--dataset.deterministic_loader", "true", "--training.max_steps", "26",
        "--training.rays_initial_batch_size", "128", "--validation.every_n_steps", "1000",
        "--training.save_checkpoint_every_n_steps", "1000",
        "--tpu.sampling", "proposal", "--tpu.proposal_rank", "8", "--tpu.proposal_resolution", "64",
        "--tpu.proposal_samples_per_ray", "16", "--tpu.render_samples_per_ray", "8",
        "--model.log2_hashmap_size", "12", "--model.n_levels", "4", "--model.finest_resolution", "128",
        "--tpu.profile_dir", str(profile_dir),
    ])
    assert result["train"]["end_step"] == 27
    (path,) = profile_dir.iterdir()
    steps = sorted(int(e["name"].split()[1]) for e in _events(path) if str(e.get("name")).startswith("train_step "))
    assert steps == [20, 21, 22, 23, 24]
    assert capsys.readouterr().out.count("profiler trace written to") == 1
