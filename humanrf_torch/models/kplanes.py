"""K-Planes, hybrid variant: a plane-product 4D field with a small MLP
decoder and two proposal plane fields (Fridovich-Keil et al., "K-Planes:
Explicit Radiance Fields in Space, Time, and Appearance", CVPR 2023).

A sample at `positions` (N, 3) in the unit cube [-0.5, 0.5]^3 of frame f
reads the field at q = (2·x, 2·y, 2·z, t) in [-1, 1]^4, with
t = 2·(f − first) / (last − first) − 1 over the sequence's frames. The field
holds, per scale s of `multiscales`, six planes (xy, xz, xt, yz, yt, zt;
`ops/kplanes.py::PLANES`) of `feature_dim` channels, `resolution`·s texels
along each spatial axis and `time_resolution` along t; a scale's features
are the product of its six bilinear lookups, and the field's the scales'
concatenated (`ops/kplanes.py::plane_query`: one kernel launch each way on
the card). The hybrid decoder is HumanRF's: a density MLP to 1 + G values,
density `trunc_exp(h[0])` and geometry features h[1:], then a colour MLP
over the direction's SH-4 and those features, with a sigmoid.

Two proposal fields shape the samples (`train/pipeline.py::proposal_render`
asks each level's): each is one scale of `proposal_feature_dim`-channel
planes at `proposal_resolutions[level]` spatial and `time_resolution` time
texels, decoded by an MLP of one hidden layer to a `trunc_exp` density.

`regularization()` is the plane regularisers, weighted, as one scalar
tensor computed in the graph: plane TV over each field's spatial planes,
time smoothness (the mean square of the second difference along t) and the
L1 distance of the time planes from 1, each a mean over a plane's entries
summed over the planes and over both proposal fields. On the card it is one
pass of hand-written kernels each way over every plane
(`ops/kplanes.py::plane_regularization`); elsewhere the plain formulas
(`plane_regularizers`), differentiated by autograd.

The parameters, by name:

    field.scales.<s>.<plane>                (res_j, res_i, M)  channels last
    sigma_net.w<i>, color_net.w<i>          (din, dout)
    proposals.<l>.field.scales.0.<plane>    (res_j, res_i, M_p)
    proposals.<l>.sigma_net.w<i>            (din, dout)

A model is built with zero parameters; `init_parameters` draws the source's
initialisation (spatial planes U[0.1, 0.5], time planes 1, He-normal MLPs).
Building one sets the recorder's gauge `field.plane_params` to the plane
entries of the field and both proposals; each differentiated query (the
train step's) adds the samples it serves to the device counters
`kplanes.field_samples` and `kplanes.proposal_samples`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from humanrf_torch.models.activation import truncated_exp
from humanrf_torch.models.mlp import MLP
from humanrf_torch.models.sh import sh_encode
from humanrf_torch.ops.kplanes import (PLANE_NAMES, PLANES, SPATIAL_PLANES, TIME_PLANES, plane_query,
                                       plane_regularization, plane_shape)
from humanrf_torch.utils import profiling


@dataclass(frozen=True)
class KPlanesConfig:
    sorted_frame_numbers: Tuple[int, ...]
    feature_dim: int = 32
    resolution: int = 64
    time_resolution: int = 25
    multiscales: Tuple[int, ...] = (1, 2, 4, 8)
    proposal_feature_dim: int = 8
    proposal_resolutions: Tuple[int, ...] = (128, 256)
    geometry_feature_dim: int = 15
    n_neurons: int = 64
    n_hidden_layers_density: int = 1
    n_hidden_layers_color: int = 2
    sh_degree: int = 4
    proposal_n_neurons: int = 64
    plane_tv_weight: float = 1e-4
    time_smoothness_weight: float = 0.1
    l1_time_planes_weight: float = 1e-4
    proposal_plane_tv_weight: float = 1e-4
    proposal_time_smoothness_weight: float = 1e-3
    proposal_l1_time_planes_weight: float = 1e-4

    @property
    def total_feature_dim(self) -> int:
        return len(self.multiscales) * self.feature_dim

    @property
    def num_segments(self) -> int:
        return 1  # one field over the whole sequence


class PlaneField(nn.Module):
    """The planes of one plane field: per scale, a `ParameterDict` of its six
    planes by name, each (res_j, res_i, M) at per-axis sizes
    (r, r, r, time_resolution) for r in `spatial`."""

    def __init__(self, spatial: Sequence[int], time_resolution: int, channels: int, device=None):
        super().__init__()
        self.scales = nn.ModuleList()
        for r in spatial:
            res = (r, r, r, time_resolution)
            self.scales.append(nn.ParameterDict({
                name: nn.Parameter(torch.zeros(plane_shape(res, p, channels), device=device))
                for p, name in enumerate(PLANE_NAMES)
            }))

    def planes(self) -> list:
        """Scale-major, six a scale in `PLANES`' order (`plane_query`'s input)."""
        return [scale[name] for scale in self.scales for name in PLANE_NAMES]

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The source's: spatial planes U[0.1, 0.5], time planes 1."""
        for scale in self.scales:
            for p, name in enumerate(PLANE_NAMES):
                plane = scale[name]
                if p in TIME_PLANES:
                    plane.fill_(1.0)
                else:
                    u = torch.rand(plane.shape, generator=generator, device=generator.device)
                    plane.copy_(0.1 + 0.4 * u)

    def regularizers(self) -> tuple:
        """→ (plane TV, time smoothness, L1 of the time planes) of these
        planes (`plane_regularizers`)."""
        return plane_regularizers(self.planes())


def plane_regularizers(planes: Sequence[torch.Tensor]) -> tuple:
    """A plane field's planes (scale-major, six a scale in `PLANES`' order)
    → (plane TV, time smoothness, L1 of the time planes), each summed over
    every scale's planes of its kind: TV over the spatial planes, the other
    two over the time planes, each plane's term a mean over its entries (the
    reductions the configuration lists as assumed). The plain formulas, in
    the planes' type, differentiated by autograd."""
    tv = smooth = l1 = None
    for s in range(len(planes) // 6):
        scale = planes[6 * s:6 * s + 6]
        for p in SPATIAL_PLANES:
            t = plane_tv(scale[p])
            tv = t if tv is None else tv + t
        for p in TIME_PLANES:
            plane = scale[p]
            a = time_smoothness(plane)
            smooth = a if smooth is None else smooth + a
            a = (1.0 - plane).abs().mean()
            l1 = a if l1 is None else l1 + a
    return tv, smooth, l1


def plane_tv(plane: torch.Tensor) -> torch.Tensor:
    """2·(mean square of the differences along rows + along columns): the
    source's `compute_plane_tv` of a (1, M, h, w) grid, here (h, w, M)."""
    rows = torch.square(plane[1:] - plane[:-1]).mean()
    cols = torch.square(plane[:, 1:] - plane[:, :-1]).mean()
    return 2.0 * (rows + cols)


def time_smoothness(plane: torch.Tensor) -> torch.Tensor:
    """The mean square of the second difference along t (a time plane's
    rows): the source's `compute_plane_smoothness`."""
    first = plane[1:] - plane[:-1]
    return torch.square(first[1:] - first[:-1]).mean()


class ProposalPlaneField(nn.Module):
    """One proposal level: a single-scale plane field and its density MLP."""

    def __init__(self, resolution: int, time_resolution: int, channels: int, n_neurons: int, device=None):
        super().__init__()
        self.field = PlaneField((resolution,), time_resolution, channels, device)
        self.sigma_net = MLP(channels, 1, n_neurons, 1, device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        self.field.init_parameters(generator)
        self.sigma_net.init_parameters(generator)

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        h = self.sigma_net(plane_query(self.field.planes(), coords))
        return truncated_exp(h[..., 0])


class KPlanesModel(nn.Module):
    def __init__(self, config: KPlanesConfig, device=None):
        super().__init__()
        self.config = cfg = config
        self.field = PlaneField([cfg.resolution * s for s in cfg.multiscales], cfg.time_resolution, cfg.feature_dim,
                                device)
        self.sigma_net = MLP(cfg.total_feature_dim, 1 + cfg.geometry_feature_dim, cfg.n_neurons,
                             cfg.n_hidden_layers_density, device)
        self.color_net = MLP(cfg.sh_degree**2 + cfg.geometry_feature_dim, 3, cfg.n_neurons, cfg.n_hidden_layers_color,
                             device)
        self.proposals = nn.ModuleList(
            ProposalPlaneField(r, cfg.time_resolution, cfg.proposal_feature_dim, cfg.proposal_n_neurons, device)
            for r in cfg.proposal_resolutions
        )
        profiling.gauge("field.plane_params", sum(
            t.numel() for f in (self.field, *(p.field for p in self.proposals)) for t in f.planes()))

        # Frame → segment (0: the one field) and → t in [-1, 1].
        frames = cfg.sorted_frame_numbers
        first, last = frames[0], frames[-1]
        frame_to_segment = np.full(last + 1, -1, dtype=np.int64)
        frame_to_time = np.zeros(last + 1, dtype=np.float32)
        for f in frames:
            frame_to_segment[f] = 0
            frame_to_time[f] = np.float32(2.0 * (f - first) / (last - first) - 1.0) if last > first else 0.0
        self.register_buffer("frame_to_segment", torch.as_tensor(frame_to_segment, device=device), persistent=False)
        self.register_buffer("frame_to_time", torch.as_tensor(frame_to_time, device=device), persistent=False)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The source's initialisation (see the module docstring), drawn on
        the generator's device, then copied."""
        self.field.init_parameters(generator)
        self.sigma_net.init_parameters(generator)
        self.color_net.init_parameters(generator)
        for p in self.proposals:
            p.init_parameters(generator)

    def coords(self, positions: torch.Tensor, frame_numbers: torch.Tensor) -> torch.Tensor:
        """positions (N, 3) in [-0.5, 0.5]; frame_numbers (N,) → q (N, 4) in [-1, 1]."""
        t = self.frame_to_time[frame_numbers.long()][:, None]
        return torch.cat([positions * 2.0, t], dim=-1).detach()

    def features(self, positions: torch.Tensor, frame_numbers: torch.Tensor, tables=None,
                 n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """→ (N, S·M) features; samples at or past `n_valid` get zeros.
        `tables` is HumanRF's FSDP hook and must be None here."""
        if tables:
            raise ValueError("a K-Planes model takes no gathered tables")
        self._count("kplanes.field_samples", positions.shape[0], n_valid)
        return plane_query(self.field.planes(), self.coords(positions, frame_numbers), n_valid)

    def density(self, positions: torch.Tensor, frame_numbers: torch.Tensor, tables=None,
                n_valid: Optional[torch.Tensor] = None):
        """→ (density (N,), geometry features (N, G))."""
        h = self.sigma_net(self.features(positions, frame_numbers, tables, n_valid))
        return truncated_exp(h[..., 0]), h[..., 1:]

    def forward(self, positions: torch.Tensor, directions: torch.Tensor, frame_numbers: torch.Tensor,
                camera_numbers: Optional[torch.Tensor] = None, is_training: bool = False, tables=None,
                n_valid: Optional[torch.Tensor] = None):
        """→ (density (N,), radiance (N, 3)). No appearance embedding:
        `camera_numbers` and `is_training` change nothing."""
        density, geo = self.density(positions, frame_numbers, tables, n_valid)
        color_in = torch.cat([sh_encode((directions + 1.0) * 0.5, self.config.sh_degree), geo], dim=-1)
        return density, self.color_net(color_in, output_activation="sigmoid")

    def proposal_density(self, positions: torch.Tensor, frame_numbers: torch.Tensor, level: int = 0) -> torch.Tensor:
        """Proposal level `level`'s density (N,) fp32."""
        self._count("kplanes.proposal_samples", positions.shape[0])
        return self.proposals[level](self.coords(positions, frame_numbers))

    def _count(self, name: str, n: int, n_valid: Optional[torch.Tensor] = None) -> None:
        """Add the samples a differentiated query serves (the train step's:
        renders take no gradient) to the recorder's device counter `name`."""
        if torch.is_grad_enabled():
            served = n if n_valid is None else n_valid.reshape(()).clamp(0, n).long()
            profiling.device_counter(name, self.frame_to_time.device).add_(served)

    def regularizer_inputs(self) -> tuple:
        """→ (the planes of the field and of each proposal, one list a
        field; their (tv, smoothness, l1) weights, one triple a field)."""
        cfg = self.config
        fields = [self.field.planes()] + [p.field.planes() for p in self.proposals]
        weights = [(cfg.plane_tv_weight, cfg.time_smoothness_weight, cfg.l1_time_planes_weight)]
        weights += [(cfg.proposal_plane_tv_weight, cfg.proposal_time_smoothness_weight,
                     cfg.proposal_l1_time_planes_weight)] * len(self.proposals)
        return fields, weights

    def regularization(self) -> torch.Tensor:
        """The weighted plane regularisers of the field and the proposals,
        one scalar tensor (see the module docstring): on the card through
        the kernels, elsewhere `plain_regularization()`."""
        fields, weights = self.regularizer_inputs()
        if fields[0][0].is_cuda:
            return plane_regularization(fields, weights)
        return self.plain_regularization()

    def plain_regularization(self) -> torch.Tensor:
        """`regularization()` by the plain formulas, on any device."""
        cfg = self.config
        tv, smooth, l1 = self.field.regularizers()
        total = cfg.plane_tv_weight * tv + cfg.time_smoothness_weight * smooth + cfg.l1_time_planes_weight * l1
        parts = [p.field.regularizers() for p in self.proposals]
        if parts:
            total = total + cfg.proposal_plane_tv_weight * sum(p[0] for p in parts)
            total = total + cfg.proposal_time_smoothness_weight * sum(p[1] for p in parts)
            total = total + cfg.proposal_l1_time_planes_weight * sum(p[2] for p in parts)
        return total
