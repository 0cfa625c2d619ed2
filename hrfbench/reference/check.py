"""The reference side of the correctness check: the feed worked out again
from the scene's files, the first training steps, and novel views.

Everything here is computed in float32 with TF32 off (the MLPs round their
operands to bfloat16 with float32 accumulation, as the configuration
states). What the port handed over is read only to judge it: the pool
entries' camera and frame, the drawn pixels and the step keys are the
request; every camera matrix, image value and occupancy grid is derived again
from the files.
"""
from __future__ import annotations

import statistics
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from hrfbench.reference.adamw import AdamW
from hrfbench.reference.checkpoint import convert_params, load_checkpoint
from hrfbench.reference.humanrf import HumanRFConfig, HumanRFModel
from hrfbench.reference.occupancy import dilate_grid
from hrfbench.reference.pipeline import HostBatch, PipelineConfig, PoolArrays, make_render_fn, make_train_step
from hrfbench.scene.generate import decode_png, grid_path, mask_path, read_aabbs_csv, read_calibration_csv, rgb_path

_INV_255 = np.float32(1.0) / np.float32(255.0)


def flag(flags: List[str], name: str, kind=str):
    """The value of `--name` in a flag list (the last one given); raises when absent."""
    key = f"--{name}"
    if key not in flags:
        raise KeyError(f"the configuration's flags do not state {key}")
    i = len(flags) - 1 - flags[::-1].index(key)
    if kind is bool:
        return flags[i + 1].lower() in ("true", "1", "yes")
    return kind(flags[i + 1].replace("_", "")) if kind in (int, float) else kind(flags[i + 1])


def frame_numbers(flags: List[str]) -> List[int]:
    i = flags.index("--dataset.frame_numbers") + 1
    out = []
    while i < len(flags) and not flags[i].startswith("--"):
        out.append(int(flags[i]))
        i += 1
    return out


def model_config(conf: dict) -> HumanRFConfig:
    """The field the configuration file states."""
    f = conf["flags"]
    sampling = flag(f, "tpu.sampling")
    return HumanRFConfig(
        sorted_frame_numbers=tuple(sorted(frame_numbers(f))),
        segment_sizes=tuple(conf["segment_sizes"]),
        density_scale=flag(f, "model.density_scale", float),
        n_features_per_level=flag(f, "model.n_features_per_level", int),
        log2_hashmap_size=flag(f, "model.log2_hashmap_size", int),
        n_levels=flag(f, "model.n_levels", int),
        coarsest_resolution=flag(f, "model.coarsest_resolution", int),
        finest_resolution=flag(f, "model.finest_resolution", int),
        geometry_feature_dim=flag(f, "model.geometry_feature_dim", int),
        n_neurons=flag(f, "model.n_neurons", int),
        n_hidden_layers_density=flag(f, "model.n_hidden_layers_density", int),
        n_hidden_layers_color=flag(f, "model.n_hidden_layers_color", int),
        sh_degree=flag(f, "model.sh_degree", int),
        camera_embedding_dim=flag(f, "model.camera_embedding_dim", int),
        proposal_rank=flag(f, "tpu.proposal_rank", int) if sampling == "proposal" else 0,
        proposal_resolution=flag(f, "tpu.proposal_resolution", int),
    )


def pipeline_config(conf: dict, num_rays: Optional[int] = None) -> PipelineConfig:
    """The sampler and loss the configuration file states; `num_rays` for a render batch."""
    f = conf["flags"]
    return PipelineConfig(
        num_rays=num_rays or flag(f, "training.rays_initial_batch_size", int),
        samples_per_ray=flag(f, "tpu.samples_per_ray", int),
        candidate_budget=flag(f, "tpu.candidate_budget", int),
        sample_budget=flag(f, "training.samples_max_batch_size", int),
        use_visibility_prune=flag(f, "tpu.use_visibility_prune", bool),
        sampling=flag(f, "tpu.sampling"),
        bce_loss_weight=flag(f, "training.bce_loss_weight", float),
        march_grid_factor=flag(f, "tpu.march_grid_factor", int),
        proposal_samples_per_ray=flag(f, "tpu.proposal_samples_per_ray", int),
        render_samples_per_ray=flag(f, "tpu.render_samples_per_ray", int),
        proposal_mid_samples_per_ray=flag(f, "tpu.proposal_mid_samples_per_ray", int),
        proposal_loss_weight=flag(f, "tpu.proposal_loss_weight", float),
        proposal_uniform_bonus=flag(f, "tpu.proposal_uniform_bonus", float),
        candidate_rays_factor=flag(f, "tpu.candidate_rays_factor", int) if num_rays is None else 1,
        **conf["pipeline"],
    )


# ------------------------------------------------------------------ the feed


class Scene:
    """The scene's files as the loader normalises them: cameras, AABB, grids, images."""

    def __init__(self, root: Path, calibration: Optional[Path] = None):
        self.seq_dir = Path(root) / "SynthActor" / "Sequence1"
        self.data_dir = self.seq_dir / "1x"
        aabbs = read_aabbs_csv(self.seq_dir / "aabbs.csv")
        union = np.stack((aabbs[:, 0].min(0), aabbs[:, 1].max(0)), axis=0)
        offset = -union.mean(0)
        scale = 1.0 / np.max(union[1] - union[0])
        self.aabb = ((union + offset) * scale).astype(np.float32)
        self.cameras = read_calibration_csv(calibration or self.data_dir / "calibration.csv")
        for cam in self.cameras:
            cam.translation = (cam.translation + offset) * scale
        self.inverse_krs = np.stack([c.inverse_kr() for c in self.cameras]).astype(np.float32)
        self.origins = np.stack([c.translation for c in self.cameras]).astype(np.float32)
        self._grids: Dict[int, torch.Tensor] = {}
        self._images: Dict[tuple, np.ndarray] = {}

    def grid(self, frame: int) -> torch.Tensor:
        if frame not in self._grids:
            raw = np.load(grid_path(self.seq_dir, frame))["occupancy_grid"]
            self._grids[frame] = dilate_grid(torch.from_numpy(np.ascontiguousarray(raw)))
        return self._grids[frame]

    def rgba_u8(self, camera: int, frame: int) -> np.ndarray:
        """(H·W, 4) uint8 rgb·mask and mask, as the loader keeps an image."""
        key = (camera, frame)
        if key not in self._images:
            name = self.cameras[camera].name
            rgb = decode_png(rgb_path(self.data_dir, name, frame).read_bytes()) / np.float32(255)
            mask = decode_png(mask_path(self.data_dir, name, frame).read_bytes())[..., None] / np.float32(255)
            rgba = np.concatenate((rgb * mask, mask), axis=-1) * np.float32(255)
            self._images[key] = rgba.astype(np.uint8).reshape(-1, 4)
        return self._images[key]

    def pool(self, cameras: np.ndarray, frames: np.ndarray, slots: np.ndarray) -> PoolArrays:
        cams = np.asarray(cameras, dtype=np.int64)
        return PoolArrays(
            torch.from_numpy(self.inverse_krs[cams]), torch.from_numpy(self.origins[cams]),
            torch.tensor([self.cameras[c].width > self.cameras[c].height for c in cams]),
            torch.as_tensor(np.asarray(frames, dtype=np.int32)), torch.as_tensor(np.asarray(cameras, dtype=np.int32)),
            torch.as_tensor(np.asarray(slots, dtype=np.int32)),
        )

    def grids(self, frames: np.ndarray, slots: np.ndarray, num_slots: int) -> torch.Tensor:
        """The grid stack the entries point into; slots no entry holds stay empty."""
        res = self.grid(int(frames[0])).shape[0]
        out = torch.zeros((num_slots, res, res, res), dtype=torch.bool)
        for frame, slot in set(zip(np.asarray(frames).tolist(), np.asarray(slots).tolist())):
            out[slot] = self.grid(frame)
        return out


class StepInputs(NamedTuple):
    """One training step's request as the port's loop took it (CPU tensors)."""

    batch: HostBatch
    pool: PoolArrays
    grids: torch.Tensor
    aabb: torch.Tensor
    key: torch.Tensor


def derive_step(scene: Scene, seen: StepInputs) -> tuple:
    """→ (the reference's StepInputs, entries that differ from the port's feed).

    The pool entries' (camera, frame, grid slot) and the drawn (entry, pixel)
    pairs are taken from the port; the rest is derived from the files."""
    cams, frames = seen.pool.camera_numbers.numpy(), seen.pool.frame_numbers.numpy()
    slots = seen.pool.grid_slots.numpy()
    pool = scene.pool(cams, frames, slots)
    used = np.unique(seen.batch.buffer_idx.numpy())
    grids = scene.grids(frames[used], slots[used], seen.grids.shape[0])
    entries = seen.batch.buffer_idx.long().numpy()
    pixels = seen.batch.pixel_idx.long().numpy()
    rgba_u8 = np.stack([scene.rgba_u8(int(cams[e]), int(frames[e]))[p] for e, p in zip(entries, pixels)])
    rgba = torch.from_numpy(rgba_u8.astype(np.float32) * _INV_255)
    batch = seen.batch._replace(rgba=rgba)
    aabb = torch.from_numpy(scene.aabb)
    mismatches = (
        int((pool.inverse_krs != seen.pool.inverse_krs).any(-1).any(-1)[used].sum())
        + int((pool.camera_origins != seen.pool.camera_origins).any(-1)[used].sum())
        + int((pool.landscape != seen.pool.landscape)[used].sum())
        + int((rgba != seen.batch.rgba).any(-1).sum())
        + int((aabb != seen.aabb).any())
        + sum(int((grids[s] != seen.grids[s]).any()) for s in np.unique(slots[used]).tolist())
    )
    return StepInputs(batch, pool, grids, aabb, seen.key), mismatches


def _to(x, device):
    return type(x)(*(t.to(device) for t in x)) if isinstance(x, tuple) else x.to(device)


def build_model(conf: dict, state: Dict[str, torch.Tensor], device, round_tables: bool = False) -> HumanRFModel:
    model = HumanRFModel(model_config(conf), device=device)
    model.load_state_dict({k: v.to(device) for k, v in state.items()})
    for segment in model.segments:
        segment.round_tables = round_tables
    return model


def train_steps(conf: dict, state: Dict[str, torch.Tensor], steps: List[StepInputs], width: int, height: int,
                device, round_tables: bool = False, work_logs: Optional[List[list]] = None) -> dict:
    """Run the reference's train step over `steps` from the parameters
    `state` → {"losses": [...], "grads": {leaf: step 1's gradient},
    "params": {leaf: the parameters after the last step}} (CPU tensors).
    `work_logs`, one list per step, receives what each step's queries serve."""
    f = conf["flags"]
    model = build_model(conf, state, device, round_tables)
    opt = AdamW([p for _, p in model.named_parameters()], flag(f, "training.lr", float),
                flag(f, "training.lr_decay", float), flag(f, "training.max_steps", int),
                flag(f, "training.weight_decay", float))
    step = make_train_step(pipeline_config(conf), model, opt, width, height)
    out = {"losses": [], "grads": None}
    for i, inp in enumerate(steps):
        model.set_work_log(work_logs[i] if work_logs is not None else None)
        loss, _ = step(*(_to(x, device) for x in inp))
        out["losses"].append(float(loss))
        if i == 0:
            out["grads"] = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
    model.set_work_log(None)
    out["params"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    return out


def load_checkpoint_state(path: Path) -> Dict[str, torch.Tensor]:
    return convert_params(load_checkpoint(path)[0])


def render_view(conf: dict, model: HumanRFModel, scene: Scene, camera: int, frame: int, batch_size: int,
                width: int, height: int, device, block_rays: int = 1 << 16,
                work_log: Optional[list] = None) -> np.ndarray:
    """One view of trajectory camera `camera` at `frame` → (H·W, 3) float32
    colors on a black background, rendered in blocks of `block_rays` rays,
    the last padded with pixel 0 (its padding dropped)."""
    cam = scene.cameras[camera]
    num_pixels = cam.width * cam.height
    pool = _to(scene.pool(np.array([camera]), np.array([frame]), np.array([0])), device)
    grids = scene.grids(np.array([frame]), np.array([0]), 1).to(device)
    aabb = torch.from_numpy(scene.aabb).to(device)
    fn = make_render_fn(pipeline_config(conf, batch_size), model, width, height)
    model.set_work_log(work_log)
    colors = []
    for start in range(0, num_pixels, block_rays):
        n = min(block_rays, num_pixels - start)
        pixels = torch.zeros(block_rays, dtype=torch.int32, device=device)
        pixels[:n] = torch.arange(start, start + n, dtype=torch.int32, device=device)
        batch = HostBatch(torch.zeros(block_rays, dtype=torch.int32, device=device), pixels,
                          torch.zeros((block_rays, 4), device=device),
                          torch.ones(block_rays, dtype=torch.bool, device=device))
        out, _ = fn(batch, pool, grids, aabb, 0.0)
        colors.append(out.color[:n].cpu())
    model.set_work_log(None)
    return torch.cat(colors).numpy()


# ----------------------------------------------------------- the comparison


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor], leaves: List[str]) -> Dict[str, float]:
    """Per leaf |‖program‖ − ‖reference‖| over max(‖reference‖, the median
    leaf's ‖reference‖), norms in float64."""
    norms = {n: float(reference[n].double().norm()) for n in leaves}
    median = statistics.median(norms.values())
    return {n: abs(float(program[n].double().norm()) - norms[n]) / max(norms[n], median) for n in leaves}


def counted_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: a
    norm at least a thousandth of the median leaf's."""
    norms = {n: float(g.double().norm()) for n, g in grads.items()}
    median = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= 1e-3 * median]


def train_numbers(program: dict, reference: dict, initial: Dict[str, torch.Tensor]) -> tuple:
    """The numbers a training cell compares (see PERF.md): the worst step's
    relative loss gap, the worst leaf's gap of step 1's gradient norms, and
    the median leaf's gap of the norms of the parameters' change over the
    steps (the worst leaf's swings over orders of magnitude from seed to
    seed: Adam's normalised update magnifies the summation order's noise in
    a leaf's near-zero gradients) → (numbers, the worst leaf of each gap,
    with the worst leaf's change gap beside them)."""
    leaves = counted_leaves(reference["grads"])
    change = lambda params: {n: params[n] - initial[n] for n in leaves}  # noqa: E731
    grad = leaf_gaps(program["grads"], reference["grads"], leaves)
    update = leaf_gaps(change(program["params"]), change(reference["params"]), leaves)
    numbers = {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])),
        "grad_gap": max(grad.values()),
        "median_update_gap": statistics.median(update.values()),
    }
    worst = {"grad_leaf": max(grad, key=grad.get), "update_leaf": max(update, key=update.get),
             "worst_update_gap": max(update.values())}
    return numbers, worst
