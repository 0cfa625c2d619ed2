"""The HumanRF scene representation as an `nn.Module`.

Counterpart of `humanrf_tpu/models/humanrf.py`. The module owns the
parameters, in the JAX package's layouts so that `convert.py` maps a JAX
params pytree leaf for leaf:

    segments.<s>.{xyz,xyt,yzt,xzt}  (L, F, T)      segments.<s>.vectors  (4, D, R)
    sigma_net.w<i>, color_net.w<i>  (din, dout)    proposal.<s>.factors  (4, res, rank)
    camera_embeddings               (160, E)

Samples are routed to their segment on the device, with static shapes and
no host read, as the JAX package routes them (`humanrf_tpu/models/
humanrf.py:243-276`, its where-masking without the `lax.cond`): one field
query over all N samples reads each sample's own segment's tables inside
its kernels (`seg` of `ops/field_interp.py::field_query`). The
proposal field, plain PyTorch ops, reads each sample's own segment's
factors in one gather over the segments' stacked factors (evaluating every
segment on all N and selecting with `torch.where` would repeat its gathers
and their sorting backward once per segment). Each sample's features and
gradients are those of the reference's index selection (`humanrf.py:
172-177`).

Building a model sets, in the recorder (`utils/profiling.py`), its
segments (`field.segments`) and its segments' hash-table entries, the four
(L, F, T) tables without the vectors (`field.table_params`): gauges of the
latest build.

A model is built with zero parameters; `init_parameters` draws a fresh one
from an explicit `torch.Generator` with the JAX package's distributions
(its numbers differ from JAX's), and `load_state_dict(convert_params(...))`
loads a JAX one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from humanrf_torch.models.activation import truncated_exp
from humanrf_torch.models.decomposition4d import GRID_NAMES, Decomposition4D, Decomposition4DConfig
from humanrf_torch.models import fused_field
from humanrf_torch.models.hash_encoding import HashGridConfig
from humanrf_torch.models.mlp import MLP, normal
from humanrf_torch.models.proposal import ProposalField, ProposalFieldConfig, apply_proposal_field
from humanrf_torch.models.sh import sh_encode
from humanrf_torch.utils import profiling

# Matches humanrf/adaptive_temporal_partitioning.py:8.
PREDEFINED_SEGMENT_SIZES = [6, 12, 25, 50, 100]

NUM_CAMERAS = 160  # actorshq/dataset/volumetric_dataset.py:78


@dataclass(frozen=True)
class HumanRFConfig:
    sorted_frame_numbers: Tuple[int, ...]
    segment_sizes: Tuple[int, ...]
    density_scale: float = 100.0
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    n_levels: int = 16
    coarsest_resolution: int = 32
    finest_resolution: int = 2048
    geometry_feature_dim: int = 15
    n_neurons: int = 64
    n_hidden_layers_density: int = 1
    n_hidden_layers_color: int = 2
    sh_degree: int = 4
    camera_embedding_dim: int = 0
    # Proposal density field for importance sampling; 0 disables it.
    proposal_rank: int = 0
    proposal_resolution: int = 128

    @property
    def total_feature_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def num_segments(self) -> int:
        return len(self.segment_sizes)


def segment_grid_config(cfg: HumanRFConfig, segment_size: int) -> Decomposition4DConfig:
    """Per-segment hash-map size scaling (humanrf.py:106-120)."""
    seg_log2 = int(np.round(np.log2(segment_size / max(PREDEFINED_SEGMENT_SIZES) * (2**cfg.log2_hashmap_size))))
    return Decomposition4DConfig(
        grid=HashGridConfig(
            n_levels=cfg.n_levels,
            n_features_per_level=cfg.n_features_per_level,
            log2_hashmap_size=seg_log2,
            base_resolution=cfg.coarsest_resolution,
            finest_resolution=cfg.finest_resolution,
        ),
        vectors_finest_resolution=cfg.finest_resolution,
    )


class HumanRFModel(nn.Module):
    def __init__(self, config: HumanRFConfig, device=None):
        super().__init__()
        self.config = cfg = config
        self.segment_grid_configs: List[Decomposition4DConfig] = [
            segment_grid_config(cfg, size) for size in cfg.segment_sizes
        ]
        self.segments = nn.ModuleList(Decomposition4D(c, device) for c in self.segment_grid_configs)
        profiling.gauge("field.segments", cfg.num_segments)
        profiling.gauge("field.table_params", sum(getattr(segment, name).numel() for segment in self.segments
                                                  for name in GRID_NAMES))
        self.sigma_net = MLP(
            cfg.total_feature_dim, 1 + cfg.geometry_feature_dim, cfg.n_neurons, cfg.n_hidden_layers_density, device
        )
        self.color_net = MLP(
            cfg.sh_degree**2 + cfg.geometry_feature_dim + cfg.camera_embedding_dim,
            3,
            cfg.n_neurons,
            cfg.n_hidden_layers_color,
            device,
        )
        if cfg.camera_embedding_dim > 0:
            self.camera_embeddings = nn.Parameter(
                torch.zeros((NUM_CAMERAS, cfg.camera_embedding_dim), device=device)
            )
        self.proposal_config: Optional[ProposalFieldConfig] = None
        if cfg.proposal_rank > 0:
            self.proposal_config = ProposalFieldConfig(resolution=cfg.proposal_resolution, rank=cfg.proposal_rank)
            self.proposal = nn.ModuleList(
                ProposalField(self.proposal_config, device) for _ in range(cfg.num_segments)
            )

        # Frame → segment / normalized-local-time lookup tables (humanrf.py:79-103).
        sorted_frames = cfg.sorted_frame_numbers
        seg_end = np.cumsum(cfg.segment_sizes, dtype=np.int64)
        seg_end[-1] = min(seg_end[-1], len(sorted_frames))
        seg_start = np.concatenate((np.zeros(1, dtype=np.int64), seg_end[:-1]))
        frame_to_segment = np.full(sorted_frames[-1] + 1, -1, dtype=np.int64)
        frame_to_local_time = np.full(sorted_frames[-1] + 1, -1.0, dtype=np.float32)
        for s in range(cfg.num_segments):
            seg_frames = [sorted_frames[j] for j in range(seg_start[s], seg_end[s])]
            for local_idx, fn in enumerate(seg_frames):
                frame_to_segment[fn] = s
                frame_to_local_time[fn] = local_idx / len(seg_frames)
        self.register_buffer("frame_to_segment", torch.as_tensor(frame_to_segment, device=device), persistent=False)
        self.register_buffer(
            "frame_to_local_time", torch.as_tensor(frame_to_local_time, device=device), persistent=False
        )

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """A fresh model, as `humanrf_tpu/models/humanrf.py::init_params`
        draws it: per segment the hash tables U[-1e-4, 1e-4] and the vectors
        0.1·N(0, 1); He-normal MLPs; camera embeddings N(0, 1); proposal
        factors 0.3·N(0, 1). Draws on the generator's device, then copies."""
        for segment in self.segments:
            segment.init_parameters(generator)
        self.sigma_net.init_parameters(generator)
        self.color_net.init_parameters(generator)
        if self.config.camera_embedding_dim > 0:
            self.camera_embeddings.copy_(normal(self.camera_embeddings.shape, generator))
        if self.proposal_config is not None:
            for field in self.proposal:
                field.init_parameters(generator)

    # ----------------------------------------------------------------- routing

    def _segment_ids(self, frame_numbers: torch.Tensor) -> Optional[torch.Tensor]:
        """(N,) int32 segment of each sample (-1 for a frame of no segment),
        or None for a one-segment model, whose query serves every sample."""
        if self.config.num_segments == 1:
            return None
        return self.frame_to_segment[frame_numbers].int()

    # ----------------------------------------------------------------- queries

    def features(self, positions: torch.Tensor, frame_numbers: torch.Tensor,
                 tables: Optional[Mapping[int, torch.Tensor]] = None,
                 n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """positions (N,3) in [-0.5,0.5]; frame_numbers (N,) → (N, L*F).
        `tables` maps a segment to its (4L, F, T) table stack where the
        caller holds it (the FSDP step's gathered tables); the other segments
        read their own parameters. Samples at or past `n_valid` (one int32 on
        the device: a static budget's empty tail) get zero features."""
        tables = tables or {}
        frame_numbers = frame_numbers.long()
        times = self.frame_to_local_time[frame_numbers][:, None]
        xyzt = torch.cat([positions + 0.5, times], dim=-1).detach()  # positions get no gradient, as in JAX
        fields = [segment.field(tables.get(s)) for s, segment in enumerate(self.segments)]
        return fused_field.field_query(fields, xyzt, n_valid, self._segment_ids(frame_numbers))

    def proposal_density(self, positions: torch.Tensor, frame_numbers: torch.Tensor, level: int = 0) -> torch.Tensor:
        """positions (N, 3) in [-0.5, 0.5]; frame_numbers (N,) → sigma (N,)
        fp32. One CP field serves every proposal level: `level` is ignored."""
        if self.proposal_config is None:
            raise ValueError("model built with proposal_rank=0")
        frame_numbers = frame_numbers.long()
        times = self.frame_to_local_time[frame_numbers][:, None]
        coords = torch.cat([positions + 0.5, times], dim=-1)
        seg = self._segment_ids(frame_numbers)
        if seg is None:
            return self.proposal[0](coords)
        factors = torch.stack([field.factors for field in self.proposal])
        return apply_proposal_field({"factors": factors}, coords, self.proposal_config, seg)

    def density(self, positions: torch.Tensor, frame_numbers: torch.Tensor,
                tables: Optional[Mapping[int, torch.Tensor]] = None, n_valid: Optional[torch.Tensor] = None):
        """→ (density (N,), geometry_features (N, G)). humanrf.py:158-186.
        `n_valid` as in `features`."""
        h = self.sigma_net(self.features(positions, frame_numbers, tables, n_valid))
        density = truncated_exp(h[..., 0]) * self.config.density_scale
        return density, h[..., 1:]

    def forward(
        self,
        positions: torch.Tensor,
        directions: torch.Tensor,
        frame_numbers: torch.Tensor,
        camera_numbers: Optional[torch.Tensor] = None,
        is_training: bool = False,
        tables: Optional[Mapping[int, torch.Tensor]] = None,
        n_valid: Optional[torch.Tensor] = None,
    ):
        """→ (density (N,), radiance (N, 3)). humanrf.py:188-208. `tables`
        and `n_valid` as in `features`."""
        cfg = self.config
        density, geo = self.density(positions, frame_numbers, tables, n_valid)
        color_in = [sh_encode((directions + 1.0) * 0.5, cfg.sh_degree), geo]
        if cfg.camera_embedding_dim > 0:
            if is_training:
                # A row gather whose backward sums duplicate rows by sorting (see proposal.py).
                emb = F.embedding(camera_numbers.long(), self.camera_embeddings)
            else:
                # Zeros at validation/test time (humanrf.py:196-204).
                emb = torch.zeros(
                    (positions.shape[0], cfg.camera_embedding_dim), dtype=torch.float32, device=positions.device
                )
            color_in.append(emb)
        radiance = self.color_net(torch.cat(color_in, dim=-1), output_activation="sigmoid")
        return density, radiance
