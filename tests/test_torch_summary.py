"""The port's TensorBoard event writer (humanrf_torch/utils/summary.py) and
the trainer's events.

- CRC-32C on its check values; the masked CRC equals TensorBoard's own;
- a written file reads back through a record reader and a protocol-buffer
  decoder written here (every CRC checked), through TensorBoard's `Event`
  message and through its `EventAccumulator`: the file version first, the
  scalars at their steps as float32, the image as the PNG of its pixels;
- after a short CLI run, `run/` holds one events file whose scalar tags are
  the JAX trainer's `add_scalar` tags, read from its source
  (`humanrf_tpu/train/trainer.py`), with `{k}/validation` expanded to the
  validation metrics; `stability/skipped_nonfinite_updates`, written at a
  multiple of 500 steps after a skipped update, is the one tag a short run
  without a skip does not write. The validation images are there as
  `comp_0001`, the validation folder's comparison image.
"""
import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from humanrf_torch.core import image_io
from humanrf_torch.core.synthetic import SyntheticSceneConfig, generate_synthetic_dataset
from humanrf_torch.run import main as t_main
from humanrf_torch.utils import summary

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SKIP_TAG = "stability/skipped_nonfinite_updates"


def _crc32c_bitwise(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 * (crc & 1))
    return crc ^ 0xFFFFFFFF


def _masked(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_records(path: Path):
    data, pos, out = path.read_bytes(), 0, []
    while pos < len(data):
        header = data[pos : pos + 8]
        (length,) = struct.unpack("<Q", header)
        (header_crc,) = struct.unpack("<I", data[pos + 8 : pos + 12])
        body = data[pos + 12 : pos + 12 + length]
        (body_crc,) = struct.unpack("<I", data[pos + 12 + length : pos + 16 + length])
        assert header_crc == _masked(_crc32c_bitwise(header)) and body_crc == _masked(_crc32c_bitwise(body))
        out.append(body)
        pos += 16 + length
    assert pos == len(data)
    return out


def _fields(buf: bytes):
    """Protocol-buffer wire fields → [(number, value)]: ints for varints,
    bytes for length-delimited and fixed-width fields."""
    pos, out = 0, []
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 2:
            size, pos = _varint(buf, pos)
            value, pos = buf[pos : pos + size], pos + size
        else:
            width = {1: 8, 5: 4}[wire]
            value, pos = buf[pos : pos + width], pos + width
        out.append((number, value))
    return out


def _varint(buf: bytes, pos: int):
    shift = value = 0
    while True:
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, pos


def decode_event(body: bytes) -> dict:
    """→ {"wall_time", "step", "file_version"?, "tag"?, "value"?, "image"?}."""
    event = {"step": 0}
    for number, value in _fields(body):
        if number == 1:
            event["wall_time"] = struct.unpack("<d", value)[0]
        elif number == 2:
            event["step"] = value
        elif number == 3:
            event["file_version"] = value.decode()
        elif number == 5:
            ((_, summary_value),) = _fields(value)
            for n, v in _fields(summary_value):
                if n == 1:
                    event["tag"] = v.decode()
                elif n == 2:
                    event["value"] = struct.unpack("<f", v)[0]
                elif n == 4:
                    event["image"] = dict(_fields(v))
    return event


def test_crc32c_check_values_and_tensorboards_masked_crc():
    assert summary.crc32c(b"") == 0
    assert summary.crc32c(b"123456789") == 0xE3069283
    assert summary.crc32c(bytes(32)) == 0x8A9136AA
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c

    data = np.random.default_rng(0).integers(0, 256, 4099, dtype=np.uint8).tobytes()
    assert summary.masked_crc32c(data) == masked_crc32c(data) == _masked(_crc32c_bitwise(data))


def test_written_events_read_back(tmp_path):
    writer = summary.SummaryWriter(tmp_path / "run")
    rng = np.random.default_rng(1)
    scalars = [("loss/training", 0.25, 1), ("psnr/validation", 31.4159, 20), ("big", -1e30, 2**40)]
    for tag, value, step in scalars:
        writer.add_scalar(tag, value, step)
    image = rng.integers(0, 256, (7, 12, 3), dtype=np.uint8)
    writer.add_image("comp_0001", image, 20)
    writer.close()
    (path,) = (tmp_path / "run").iterdir()
    assert path.name.startswith("events.out.tfevents.")

    events = [decode_event(body) for body in read_records(path)]
    assert events[0]["file_version"] == "brain.Event:2"
    for event, (tag, value, step) in zip(events[1:], scalars):
        assert (event["tag"], event["step"]) == (tag, step)
        assert event["value"] == np.float32(value)
    png = events[-1]["image"]
    assert (png[1], png[2], png[3]) == (7, 12, 3)
    np.testing.assert_array_equal(image_io.decode_png(png[4]), image)

    from tensorboard.compat.proto import event_pb2

    parsed = [event_pb2.Event.FromString(body) for body in read_records(path)]
    assert parsed[1].summary.value[0].simple_value == np.float32(0.25) and parsed[3].step == 2**40
    assert parsed[4].summary.value[0].image.width == 12

    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tmp_path / "run"))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == sorted(tag for tag, _, _ in scalars)
    assert acc.Tags()["images"] == ["comp_0001"]
    assert [(e.step, e.value) for e in acc.Scalars("psnr/validation")] == [(20, np.float32(31.4159))]


def _jax_scalar_tags(metrics):
    source = (REPO / "humanrf_tpu" / "train" / "trainer.py").read_text()
    tags = set(re.findall(r'add_scalar\(\s*f?"([^"]+)"', source))
    assert "{k}/validation" in tags and SKIP_TAG in tags
    return (tags - {"{k}/validation"}) | {f"{k}/validation" for k in metrics}


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("summary")
    generate_synthetic_dataset(root, SyntheticSceneConfig(num_cameras=6, width=40, height=40, num_frames=2,
                                                          grid_resolution=32))
    ws = root / "ws"
    t_main([
        "--config", "example_synthetic", "--dataset.path", str(root), "--workspace", str(ws), "--device", "cpu",
        "--dataset.deterministic_loader", "true", "--training.max_steps", "21",
        "--training.rays_initial_batch_size", "256", "--validation.every_n_steps", "21",
        "--training.save_checkpoint_every_n_steps", "21", "--validation.rays_batch_size", "800",
        "--tpu.sampling", "proposal", "--tpu.proposal_rank", "8", "--tpu.proposal_resolution", "64",
        "--tpu.proposal_samples_per_ray", "16", "--tpu.render_samples_per_ray", "8",
        "--model.log2_hashmap_size", "12", "--model.n_levels", "4", "--model.finest_resolution", "128",
    ])
    return ws


def test_cli_run_writes_the_jax_trainers_tags(cli_run):
    (path,) = (cli_run / "run").iterdir()
    events = [decode_event(body) for body in read_records(path)]
    scalar_steps = {}
    for event in events[1:]:
        if "value" in event:
            scalar_steps.setdefault(event["tag"], []).append(event["step"])
    metrics = {part.split("=")[0] for line in (cli_run / "validation.txt").read_text().splitlines()
               if line.startswith("image_id") for part in line.split("--- ")[1].split()}
    assert metrics == {"psnr", "ssim"}
    assert set(scalar_steps) == _jax_scalar_tags(metrics) - {SKIP_TAG}
    assert scalar_steps["photometric/training"] == [1, 20] and scalar_steps["psnr/validation"] == [21]
    assert scalar_steps["throughput/rays_per_sec"] == [1, 20]
    assert all(np.isfinite(e["value"]) for e in events[1:] if "value" in e)

    (image,) = [e for e in events if "image" in e]
    assert (image["tag"], image["step"]) == ("comp_0001", 21)
    comparison = image_io.imread(cli_run / "validation" / "step_0021_0001_comparison.png")[..., ::-1]
    np.testing.assert_array_equal(image_io.decode_png(image["image"][4]), comparison)
