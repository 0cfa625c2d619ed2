"""Load baked inputs of the r4 scene: a test view (the model/pipeline
settings and the loader state of one image, as
`scripts/make_torch_view_inputs.py` writes them) and a training pool (the
loader state and pooled images of the train cameras at two frames, as
`scripts/make_torch_train_inputs.py` writes them).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from humanrf_torch.models.humanrf import HumanRFConfig
from humanrf_torch.train.pipeline import PipelineConfig, PoolArrays
from humanrf_torch.train.trainer import ViewInputs


class BakedView(NamedTuple):
    model_config: HumanRFConfig
    pipeline_config: PipelineConfig
    inputs: ViewInputs
    rays_batch_size: int
    images: Dict[str, np.ndarray]  # gt_rgb, gt_mask, jax_render (uint8)
    camera_name: str
    frame_number: int


class TrainInputs(NamedTuple):
    pool: PoolArrays
    grids: torch.Tensor        # (G, res, res, res) bool
    aabb: torch.Tensor         # (2, 3) float32
    width: int
    height: int
    pixel_rgba: torch.Tensor   # (B, H·W, 4) uint8: (rgb·mask, mask) per pool entry
    camera_names: List[str]    # per pool entry


def _grids(data) -> np.ndarray:
    shape = tuple(int(s) for s in data["grids_shape"])
    return np.unpackbits(data["grids_packed"], count=int(np.prod(shape))).astype(bool).reshape(shape)


def _pool(data, device) -> PoolArrays:
    return PoolArrays(*(torch.as_tensor(data[name], device=device) for name in PoolArrays._fields))


def load_train_inputs(path, device) -> TrainInputs:
    data = np.load(Path(path))
    return TrainInputs(
        pool=_pool(data, device),
        grids=torch.as_tensor(_grids(data), device=device),
        aabb=torch.as_tensor(data["aabb"], device=device),
        width=int(data["width"]),
        height=int(data["height"]),
        pixel_rgba=torch.as_tensor(data["pixel_rgba"], device=device),
        camera_names=[str(n) for n in data["camera_names"]],
    )


def load_view_inputs(path, device) -> BakedView:
    data = np.load(Path(path))
    cfg = json.loads(str(data["config_json"]))
    model, tpu = cfg["model"], cfg["tpu"]
    model_config = HumanRFConfig(
        sorted_frame_numbers=tuple(cfg["sorted_frame_numbers"]),
        segment_sizes=tuple(cfg["segment_sizes"]),
        density_scale=float(model["density_scale"]),
        n_features_per_level=model["n_features_per_level"],
        log2_hashmap_size=model["log2_hashmap_size"],
        n_levels=model["n_levels"],
        coarsest_resolution=model["coarsest_resolution"],
        finest_resolution=model["finest_resolution"],
        geometry_feature_dim=model["geometry_feature_dim"],
        n_neurons=model["n_neurons"],
        n_hidden_layers_density=model["n_hidden_layers_density"],
        n_hidden_layers_color=model["n_hidden_layers_color"],
        sh_degree=model["sh_degree"],
        camera_embedding_dim=model["camera_embedding_dim"],
        proposal_rank=tpu["proposal_rank"],
        proposal_resolution=tpu["proposal_resolution"],
    )
    pipeline_config = PipelineConfig(
        march_grid_factor=tpu["march_grid_factor"],
        proposal_samples_per_ray=tpu["proposal_samples_per_ray"],
        render_samples_per_ray=tpu["render_samples_per_ray"],
        proposal_mid_samples_per_ray=tpu["proposal_mid_samples_per_ray"],
        proposal_uniform_bonus=tpu["proposal_uniform_bonus"],
    )

    inputs = ViewInputs(
        pool=_pool(data, device),
        grids=torch.as_tensor(_grids(data), device=device),
        aabb=torch.as_tensor(data["aabb"], device=device),
        width=int(data["width"]),
        height=int(data["height"]),
        buffer_index=int(data["buffer_index"]),
    )
    images = {k: data[k] for k in ("gt_rgb", "gt_mask", "jax_render")}
    return BakedView(
        model_config, pipeline_config, inputs, cfg["rays_batch_size"], images, cfg["camera_name"], cfg["frame_number"]
    )
