"""The port's quality metrics (humanrf_torch/evaluation/metrics.py) and
offline evaluation against the JAX package's.

PSNR and SSIM run the same float64 numpy/scipy arithmetic: 1e-12. The
random-feature LPIPS proxy runs AlexNet in fp32 in both frameworks (XLA's
and PyTorch's CPU convolutions sum in other orders): 1e-5 relative.
`bounding_rect` equals `cv2.boundingRect`."""
import contextlib
import sys

import cv2
import numpy as np
import pytest
import torch

from humanrf_torch.evaluation import metrics as t_metrics
from humanrf_tpu.evaluation import metrics as j_metrics

torch.set_num_threads(2)


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    gt = rng.random((h, w, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(scale=0.05, size=gt.shape), 0, 1).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("shape", [(37, 51), (5, 4), (2, 9)])
def test_psnr_and_ssim_equal_jax(shape):
    pred, gt = _pair(*shape, seed=1)
    mask = np.random.default_rng(2).random(shape) > 0.4
    for m in (None, mask):
        assert t_metrics.compute_psnr(pred, gt, m) == pytest.approx(j_metrics.compute_psnr(pred, gt, m), rel=1e-12)
    # ROIs under the 7-pixel window shrink it, with a warning.
    shrinks = (lambda: pytest.warns(UserWarning)) if min(shape) < 7 else contextlib.nullcontext
    with shrinks():
        t_ssim = t_metrics.compute_ssim(pred, gt, data_range=1.0)
    with shrinks():
        j_ssim = j_metrics.compute_ssim(pred, gt, data_range=1.0)
    assert t_ssim == pytest.approx(j_ssim, rel=1e-12)


@pytest.mark.parametrize("shape", [(80, 96), (40, 30)])
def test_lpips_randfeat_matches_jax(shape, tmp_path, monkeypatch):
    monkeypatch.setenv("HUMANRF_TPU_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    pred, gt = _pair(*shape, seed=3)
    tm, jm = t_metrics.LpipsModel.load_or_init(), j_metrics.LpipsModel.load_or_init()
    assert not tm.is_pretrained and tm.metric_name == jm.metric_name == "lpips_randfeat"
    t_val, j_val = tm(pred, gt), jm(pred, gt, normalize=True)
    assert t_val > 0 and t_val == pytest.approx(j_val, rel=1e-5)
    assert tm(gt, gt) == 0.0


def test_lpips_reads_pretrained_weights_from_the_jax_path(tmp_path, monkeypatch):
    """A weights file at HUMANRF_TPU_LPIPS_WEIGHTS makes the metric 'lpips'
    in both packages, with the same value."""
    rng = np.random.default_rng(4)
    weights = {}
    in_ch = 3
    for i, (out_ch, k, _, _, _) in enumerate(t_metrics._ALEX_LAYERS):
        weights[f"conv{i}_w"] = (0.1 * rng.standard_normal((out_ch, in_ch, k, k))).astype(np.float32)
        weights[f"conv{i}_b"] = (0.01 * rng.standard_normal(out_ch)).astype(np.float32)
        weights[f"lin{i}_w"] = np.abs(rng.standard_normal(out_ch)).astype(np.float32) / out_ch
        in_ch = out_ch
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **weights)
    monkeypatch.setenv("HUMANRF_TPU_LPIPS_WEIGHTS", str(path))
    tm, jm = t_metrics.LpipsModel.load_or_init(), j_metrics.LpipsModel.load_or_init()
    assert tm.is_pretrained and tm.metric_name == "lpips"
    pred, gt = _pair(70, 64, seed=5)
    assert tm(pred, gt) == pytest.approx(jm(pred, gt), rel=1e-5)


def _stub_lpips_module():
    """A stand-in for the pip `lpips` package: `LPIPS(net="alex")` with
    AlexNet's `net.slice1..5` (the layers of torchvision's AlexNet features,
    split as lpips splits them) and five `lins` whose `model[-1]` is the 1×1
    head, all with seeded random weights."""
    import types

    from torch import nn

    class NetLin(nn.Module):
        def __init__(self, channels):
            super().__init__()
            self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))
            self.model[-1].weight.data.abs_()  # trained LPIPS heads are non-negative

    class Alex(nn.Module):
        def __init__(self):
            super().__init__()
            self.slice1 = nn.Sequential(nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU())
            self.slice2 = nn.Sequential(nn.MaxPool2d(3, 2), nn.Conv2d(64, 192, 5, padding=2), nn.ReLU())
            self.slice3 = nn.Sequential(nn.MaxPool2d(3, 2), nn.Conv2d(192, 384, 3, padding=1), nn.ReLU())
            self.slice4 = nn.Sequential(nn.Conv2d(384, 256, 3, padding=1), nn.ReLU())
            self.slice5 = nn.Sequential(nn.Conv2d(256, 256, 3, padding=1), nn.ReLU())

    class LPIPS(nn.Module):
        def __init__(self, net="alex", version="0.1"):
            super().__init__()
            assert (net, version) == ("alex", "0.1")
            self.net = Alex()
            self.lins = nn.ModuleList(NetLin(c) for c in (64, 192, 384, 256, 256))

    module = types.ModuleType("lpips")
    module.LPIPS = LPIPS
    return module


def test_lpips_converter_writes_the_jax_converters_npz(tmp_path, monkeypatch):
    """Both converters on the same (stub) pretrained model write the same
    arrays under the same keys, and the port's metric loads the file as
    pretrained LPIPS."""
    stub = _stub_lpips_module()
    monkeypatch.setitem(sys.modules, "lpips", stub)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = stub.LPIPS()
    monkeypatch.setattr(stub, "LPIPS", lambda **kw: model)  # one set of weights for both converters
    j_path = j_metrics.lpips_convert_weights(tmp_path / "jax" / "lpips_alex.npz")
    t_path = t_metrics.lpips_convert_weights(tmp_path / "torch" / "lpips_alex.npz")
    j_npz, t_npz = dict(np.load(j_path)), dict(np.load(t_path))
    expected = {f"{name}{i}_{part}" for i in range(5) for name, part in (("conv", "w"), ("conv", "b"), ("lin", "w"))}
    assert t_npz.keys() == j_npz.keys() == expected
    for key, value in j_npz.items():
        assert t_npz[key].dtype == value.dtype and np.array_equal(t_npz[key], value), key
    monkeypatch.setenv("HUMANRF_TPU_LPIPS_WEIGHTS", str(t_path))
    tm, jm = t_metrics.LpipsModel.load_or_init(), j_metrics.LpipsModel.load_or_init()
    assert tm.is_pretrained and tm.metric_name == "lpips"
    pred, gt = _pair(70, 64, seed=6)
    assert tm(pred, gt) > 0 and tm(pred, gt) == pytest.approx(jm(pred, gt), rel=1e-5)


@pytest.mark.parametrize("case", ["blob", "corner", "empty", "full"])
def test_bounding_rect_equals_cv2(case):
    mask = np.zeros((23, 31), np.uint8)
    if case == "blob":
        mask[4:9, 7:20] = 255
        mask[15, 3] = 1
    elif case == "corner":
        mask[-1, -1] = 255
    elif case == "full":
        mask[:] = 255
    assert t_metrics.bounding_rect(mask) == tuple(cv2.boundingRect(mask))
    assert t_metrics.bounding_rect(mask[..., None]) == tuple(cv2.boundingRect(mask[..., None]))


def test_evaluate_writes_the_jax_csvs(synthetic_dataset, tmp_path, monkeypatch):
    """Both `evaluate`s on the same predictions (ground truth blurred): the
    same metrics.csv and averages.csv up to float64 rounding."""
    import csv

    from humanrf_torch.evaluation.evaluate import evaluate as t_evaluate
    from humanrf_tpu.evaluation.evaluate import evaluate as j_evaluate

    monkeypatch.setenv("HUMANRF_TPU_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    data_dir, _ = synthetic_dataset
    configs = {"siggraph_train": (0, 1, 2, 3, 4, 5), "siggraph_train_validation": (6,), "siggraph_test": (7,),
               "siggraph_vmaf": (7,)}
    results = tmp_path / "results"
    (results / "test_frames").mkdir(parents=True)
    for frame in (0, 1, 2):
        gt = cv2.imread(str(data_dir / "rgbs" / "Cam008" / f"Cam008_rgb{frame:06d}.jpg"))
        cv2.imwrite(str(results / "test_frames" / f"Cam008_rgb{frame:06d}.png"), cv2.GaussianBlur(gt, (5, 5), 1.0))
    out = {}
    for name, fn in (("jax", j_evaluate), ("torch", t_evaluate)):
        out[name] = fn(results_directory=results, output_directory=tmp_path / name, coverage="siggraph_test",
                       camera_preset="siggraph_test", frame_numbers=[0, 1, 2], data_folder=data_dir,
                       camera_configs_override=configs)
    assert out["torch"].keys() == out["jax"].keys() == {"PSNR", "PSNR_ROI", "SSIM"}
    for k in out["jax"]:
        assert out["torch"][k] == pytest.approx(out["jax"][k], rel=1e-12)
    for csv_name in ("metrics.csv", "averages.csv"):
        rows = {name: list(csv.DictReader(open(tmp_path / name / csv_name))) for name in out}
        assert [r.keys() for r in rows["torch"]] == [r.keys() for r in rows["jax"]]
        for tr, jr in zip(rows["torch"], rows["jax"]):
            assert {k: float(v) for k, v in tr.items()} == pytest.approx({k: float(v) for k, v in jr.items()}, rel=1e-12)
