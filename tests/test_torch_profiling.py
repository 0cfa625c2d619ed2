"""The port's profiler (humanrf_torch/utils/profiling.py) and the trainer's
`--tpu.profile_dir` window.

- `Trace` writes one Chrome-trace JSON holding what ran inside it, and its
  idle gaps beside it;
- a 26-step CLI run with `--tpu.profile_dir` writes exactly one trace, and
  its `train.step` spans are those of steps 20–24: the JAX trainer's window
  (start at the first step >= 20, stop five steps later) at one step per
  dispatch. The recorder's spans of the run say which steps the trace holds.
"""
import json

import torch

from humanrf_torch.core.synthetic import SyntheticSceneConfig, generate_synthetic_dataset
from humanrf_torch.run import main as t_main
from humanrf_torch.utils import profiling
from humanrf_torch.utils.profiling import Trace

torch.set_num_threads(2)


def _events(path):
    return json.loads(path.read_text())["traceEvents"]


def test_trace_writes_one_chrome_trace_of_its_body(tmp_path):
    tracer = Trace(tmp_path / "prof", cuda=False)
    tracer.start()
    with profiling.span("inside"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tracer.stop()
    gaps = path.with_name(path.name.replace(".pt.trace.json", ".gaps.json"))
    assert sorted((tmp_path / "prof").iterdir()) == sorted([path, gaps])
    assert path.name.endswith(".pt.trace.json") and json.loads(gaps.read_text()) == {"idle_gaps": []}  # no device
    names = {e.get("name") for e in _events(path)}
    assert "inside" in names and any("mm" in str(n) for n in names)


def test_cli_traces_steps_20_to_24_once(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
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
    (path,) = profile_dir.glob("*.pt.trace.json")
    assert sum(e.get("name") == "train.step" for e in _events(path)) == 5
    steps = profiling.snapshot()["spans"]["train.step"]
    assert [s.id for s in steps] == list(range(1, 28))
    assert [s.id for s in steps if s.annotated] == [20, 21, 22, 23, 24]
    assert capsys.readouterr().out.count("profiler trace written to") == 1
