"""The plain reference of K-Planes (hybrid): the field, its two proposal
fields, the regularisers, the MSE loss and the training step, in float32
with TF32 off, on any device. It imports nothing of the port.

Source: Fridovich-Keil, Meanti, Warburg, Recht, Kanazawa, "K-Planes:
Explicit Radiance Fields in Space, Time, and Appearance", CVPR 2023
(arXiv:2301.10241), and its code's `plenoxels/configs/final/D-NeRF/
dnerf_hybrid.py` with `plenoxels/models/kplane_field.py`,
`density_fields.py` and `regularization.py`:

- a sample's q = (x, y, z, t) ∈ [−1, 1]⁴: the position scaled from the
  scene's unit cube [−0.5, 0.5]³ (×2), t = 2·(frame − first)/(last −
  first) − 1;
- per scale s of `multiscales`, f_s(q) = Π over the six planes (xy, xz, xt,
  yz, yt, zt: `itertools.combinations(range(4), 2)`) of the plane sampled
  bilinearly at (q_i, q_j), `grid_sample`'s align_corners=True with border
  clamping; the features are the scales' concatenated;
- the hybrid decoder: sigma MLP (features → hidden → 1 + G), density
  trunc_exp(h[0]), colour MLP ([SH-4 of (d + 1)/2, h[1:]] → hidden → hidden
  → 3, sigmoid); no appearance embedding;
- two proposal fields, single-scale planes of M_p channels at their own
  spatial resolutions, each an M_p → hidden → 1 MLP with trunc_exp; the
  samples go uniform-stratified → proposal 1 → resampled → proposal 2 →
  resampled → field; the interlevel (histogram) loss summed over both;
- losses: MSE + the interlevel loss + plane TV over each field's spatial
  planes + time smoothness (mean square of the second difference along t)
  + L1 of |1 − P| over the time planes, each with the configuration's
  weights; no distortion loss (weight 0 in the source). Each regulariser
  is a mean over a plane's entries, summed over the planes of its kind,
  every scale and both proposal fields (the reductions the configuration
  lists as assumed).

Here the planes are (res_j, res_i, M) tensors, channels last (the source's
are (1, M, res_j, res_i)); the lookups are explicit gathers of the four
taps, their weighted sum, the product over planes, the concatenation.

Departures from the source, stated in the configuration too:
- the samples' [tmin, tmax] is the scene's AABB narrowed by the occupancy
  hull's march (the system's sampler), not the AABB alone;
- the proposals take gradients on every step: the source's update-every-5
  schedule and its proposal weight anneal are left out (a graphed step is
  one program);
- the resampling CDF carries the system's 0.05 uniform bonus;
- MLPs take bf16 operands with fp32 sums (the source: tcnn in fp16), He-normal
  initialisation;
- the learning rate follows the system's exponential schedule, not the
  source's warm-up cosine; Adam with the system's b2 0.99 and eps 1e-15;
- the background is the system's random colour per ray.

`round_planes` reads every plane in bfloat16 (the control: the precision
below the configuration's float32 planes).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from hrfbench.reference import losses
from hrfbench.reference.activation import truncated_exp
from hrfbench.reference.adamw import AdamW
from hrfbench.reference.check import flag, frame_numbers, pipeline_config
from hrfbench.reference.mlp import MLP, normal
from hrfbench.reference.occupancy import sample_occupancy
from hrfbench.reference.pipeline import HostBatch, PoolArrays, _per_sample, _slot_ids, build_rays, compact_rays
from hrfbench.reference.render import composite_grid, render_weights_grid
from hrfbench.reference.resample import proposal_distillation_per_ray, sample_intervals, stratified_bins, weights_to_cdf
from hrfbench.reference.rngs import split, uniform_per_id
from hrfbench.reference.sh import sh_encode

PLANES = tuple(itertools.combinations(range(4), 2))
NAMES = tuple("".join("xyzt"[a] for a in pair) for pair in PLANES)
SPATIAL = tuple(p for p, pair in enumerate(PLANES) if 3 not in pair)
TIME = tuple(p for p, pair in enumerate(PLANES) if 3 in pair)

# The reference's loss mean: `control_kplanes.py`'s half-batch fault replaces it.
masked_mean = losses.masked_mean


@dataclass(frozen=True)
class KPlanesConfig:
    sorted_frame_numbers: Tuple[int, ...]
    feature_dim: int
    resolution: int
    time_resolution: int
    multiscales: Tuple[int, ...]
    proposal_feature_dim: int
    proposal_resolutions: Tuple[int, ...]
    geometry_feature_dim: int
    n_neurons: int
    n_hidden_layers_density: int
    n_hidden_layers_color: int
    sh_degree: int
    proposal_n_neurons: int
    plane_tv_weight: float
    time_smoothness_weight: float
    l1_time_planes_weight: float
    proposal_plane_tv_weight: float
    proposal_time_smoothness_weight: float
    proposal_l1_time_planes_weight: float


def _ints(flags: List[str], name: str) -> Tuple[int, ...]:
    i = flags.index(f"--{name}") + 1
    out = []
    while i < len(flags) and not flags[i].startswith("--"):
        out.append(int(flags[i]))
        i += 1
    return tuple(out)


def model_config(conf: dict) -> KPlanesConfig:
    """The field the configuration file states."""
    f = conf["flags"]
    if flag(f, "model.representation") != "kplanes":
        raise ValueError("the configuration does not state --model.representation kplanes")
    k = lambda name, kind=int: flag(f, f"model.kplanes_{name}", kind)  # noqa: E731
    return KPlanesConfig(
        sorted_frame_numbers=tuple(sorted(frame_numbers(f))),
        feature_dim=k("feature_dim"),
        resolution=k("resolution"),
        time_resolution=k("time_resolution"),
        multiscales=_ints(f, "model.kplanes_multiscales"),
        proposal_feature_dim=k("proposal_feature_dim"),
        proposal_resolutions=_ints(f, "model.kplanes_proposal_resolutions"),
        geometry_feature_dim=flag(f, "model.geometry_feature_dim", int),
        n_neurons=flag(f, "model.n_neurons", int),
        n_hidden_layers_density=flag(f, "model.n_hidden_layers_density", int),
        n_hidden_layers_color=flag(f, "model.n_hidden_layers_color", int),
        sh_degree=flag(f, "model.sh_degree", int),
        proposal_n_neurons=k("proposal_n_neurons"),
        plane_tv_weight=k("plane_tv_weight", float),
        time_smoothness_weight=k("time_smoothness_weight", float),
        l1_time_planes_weight=k("l1_time_planes_weight", float),
        proposal_plane_tv_weight=k("proposal_plane_tv_weight", float),
        proposal_time_smoothness_weight=k("proposal_time_smoothness_weight", float),
        proposal_l1_time_planes_weight=k("proposal_l1_time_planes_weight", float),
    )


# ---------------------------------------------------------------- the planes


def _axis(c: torch.Tensor, size: int):
    """grid_sample's align_corners=True, border: the two taps and the weight of the second."""
    pix = torch.clamp((c + 1.0) / 2.0 * (size - 1), 0.0, size - 1.0)
    lo = torch.floor(pix)
    hi = torch.clamp(lo + 1.0, max=size - 1.0)
    return lo.long(), hi.long(), pix - lo


def bilinear(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """plane (H, W, M); u along W, v along H, in [-1, 1] → (N, M)."""
    h, w, _ = plane.shape
    u0, u1, fu = _axis(u, w)
    v0, v1, fv = _axis(v, h)
    fu, fv = fu[:, None], fv[:, None]
    top = plane[v0, u0] * (1.0 - fu) + plane[v0, u1] * fu
    bottom = plane[v1, u0] * (1.0 - fu) + plane[v1, u1] * fu
    return top * (1.0 - fv) + bottom * fv


class Planes(nn.Module):
    """A plane field's planes, per scale the six by name (the port's names)."""

    def __init__(self, spatial, time_resolution: int, channels: int, device=None):
        super().__init__()
        self.scales = nn.ModuleList()
        for r in spatial:
            res = (r, r, r, time_resolution)
            self.scales.append(nn.ParameterDict({
                name: nn.Parameter(torch.zeros((res[j], res[i], channels), device=device))
                for name, (i, j) in zip(NAMES, PLANES)
            }))
        self.round_planes = False
        self.work_log: Optional[list] = None

    def features(self, q: torch.Tensor) -> torch.Tensor:
        """q (N, 4) → (N, S·M): per scale the product of its planes' lookups."""
        feats = []
        for scale in self.scales:
            f = None
            for name, (i, j) in zip(NAMES, PLANES):
                plane = scale[name]
                if self.round_planes:
                    plane = plane.to(torch.bfloat16).float()
                v = bilinear(plane, q[:, i], q[:, j])
                f = v if f is None else f * v
            feats.append(f)
        if self.work_log is not None:
            self._log(q, torch.is_grad_enabled())
        return torch.cat(feats, dim=1)

    @torch.no_grad()
    def _log(self, q: torch.Tensor, grad: bool) -> None:
        """What one query serves: its samples, scales, channels, and the
        distinct texels each plane's taps touch (the inputs of `counts/kplanes_*`);
        `grad`: whether the query is differentiated."""
        texels = 0
        for scale in self.scales:
            for name, (i, j) in zip(NAMES, PLANES):
                h, w, _ = scale[name].shape
                u0, u1, _ = _axis(q[:, i], w)
                v0, v1, _ = _axis(q[:, j], h)
                flat = torch.cat([v0 * w + u0, v0 * w + u1, v1 * w + u0, v1 * w + u1])
                texels += flat.unique().numel()
        m = next(iter(self.scales[0].values())).shape[-1]
        self.work_log.append({"kind": "planes", "n": q.shape[0], "S": len(self.scales), "M": m, "texels": texels,
                              "grad": grad})

    def regularizers(self):
        """(Σ plane TV over spatial planes, Σ time smoothness over time planes,
        Σ over time planes of mean |1 − P|), every scale's planes."""
        tv, smooth, l1 = 0.0, 0.0, 0.0
        for scale in self.scales:
            for p in SPATIAL:
                t = scale[NAMES[p]]
                h, w, m = t.shape
                dh = ((t[1:] - t[:-1]) ** 2).sum() / (m * (h - 1) * w)
                dw = ((t[:, 1:] - t[:, :-1]) ** 2).sum() / (m * h * (w - 1))
                tv = tv + 2.0 * (dh + dw)
            for p in TIME:
                t = scale[NAMES[p]]
                second = (t[2:] - t[1:-1]) - (t[1:-1] - t[:-2])
                smooth = smooth + (second ** 2).mean()
                l1 = l1 + (1.0 - t).abs().mean()
        return tv, smooth, l1


class ProposalNet(nn.Module):
    def __init__(self, resolution: int, time_resolution: int, channels: int, n_neurons: int, device=None):
        super().__init__()
        self.field = Planes((resolution,), time_resolution, channels, device)
        self.sigma_net = MLP(channels, 1, n_neurons, 1, device)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return truncated_exp(self.sigma_net(self.field.features(q))[..., 0])


class KPlanesModel(nn.Module):
    def __init__(self, config: KPlanesConfig, device=None):
        super().__init__()
        self.config = cfg = config
        self.field = Planes([cfg.resolution * s for s in cfg.multiscales], cfg.time_resolution, cfg.feature_dim,
                            device)
        self.sigma_net = MLP(len(cfg.multiscales) * cfg.feature_dim, 1 + cfg.geometry_feature_dim, cfg.n_neurons,
                             cfg.n_hidden_layers_density, device)
        self.color_net = MLP(cfg.sh_degree ** 2 + cfg.geometry_feature_dim, 3, cfg.n_neurons,
                             cfg.n_hidden_layers_color, device)
        self.proposals = nn.ModuleList(
            ProposalNet(r, cfg.time_resolution, cfg.proposal_feature_dim, cfg.proposal_n_neurons, device)
            for r in cfg.proposal_resolutions)
        frames = cfg.sorted_frame_numbers
        first, last = frames[0], frames[-1]
        times = torch.zeros(last + 1, dtype=torch.float64)
        for f in frames:
            times[f] = 2.0 * (f - first) / (last - first) - 1.0 if last > first else 0.0
        self.register_buffer("frame_time", times.float().to(device), persistent=False)
        self.work_log: Optional[list] = None

    def set_round_planes(self, on: bool) -> None:
        for f in (self.field, *(p.field for p in self.proposals)):
            f.round_planes = on

    def set_work_log(self, log: Optional[list]) -> None:
        self.work_log = log
        for f in (self.field, *(p.field for p in self.proposals)):
            f.work_log = log

    def _q(self, positions: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        return torch.cat([positions * 2.0, self.frame_time[frames.long()][:, None]], dim=-1).detach()

    def forward(self, positions, directions, frames):
        h = self.sigma_net(self.field.features(self._q(positions, frames)))
        if self.work_log is not None:
            self.work_log.append({"kind": "sigma", "grad": torch.is_grad_enabled()})
        density = truncated_exp(h[..., 0])
        rgb = self.color_net(torch.cat([sh_encode((directions + 1.0) * 0.5, self.config.sh_degree), h[..., 1:]], -1),
                             output_activation="sigmoid")
        if self.work_log is not None:
            self.work_log.append({"kind": "color", "grad": torch.is_grad_enabled()})
        return density, rgb

    def proposal_density(self, positions, frames, level: int) -> torch.Tensor:
        sigma = self.proposals[level](self._q(positions, frames))
        if self.work_log is not None:
            self.work_log.append({"kind": "proposal", "level": level, "grad": torch.is_grad_enabled()})
        return sigma

    def regularization(self) -> torch.Tensor:
        cfg = self.config
        tv, smooth, l1 = self.field.regularizers()
        total = cfg.plane_tv_weight * tv + cfg.time_smoothness_weight * smooth + cfg.l1_time_planes_weight * l1
        parts = [p.field.regularizers() for p in self.proposals]
        total = total + cfg.proposal_plane_tv_weight * sum(p[0] for p in parts)
        total = total + cfg.proposal_time_smoothness_weight * sum(p[1] for p in parts)
        return total + cfg.proposal_l1_time_planes_weight * sum(p[2] for p in parts)


# ------------------------------------------------------------ the training step


def render(cfg, model: KPlanesModel, rays, pool: PoolArrays, grids, buffer_idx, background, rng=None, ray_ids=None):
    """The two-level proposal render over static (R, K) lattices → (rgb,
    weights sum, per-ray interlevel loss summed over both levels or None)."""
    num_rays = rays.origins.shape[0]
    k_c, k_m, k_f = cfg.proposal_samples_per_ray, cfg.proposal_mid_samples_per_ray, cfg.render_samples_per_ray
    u_c = u_m = u_f = None
    if rng is not None:
        rng_c, rng_m, rng_f = split(rng, 3)
        u_c = uniform_per_id(rng_c, _slot_ids(ray_ids, k_c)).reshape(num_rays, k_c)
        u_m = uniform_per_id(rng_m, _slot_ids(ray_ids, k_m + 1)).reshape(num_rays, k_m + 1)
        u_f = uniform_per_id(rng_f, _slot_ids(ray_ids, k_f + 1)).reshape(num_rays, k_f + 1)
    grid_ids = pool.grid_slots[buffer_idx.long()]

    def level_weights(t, dt, level):
        k = t.shape[1]
        pts = rays.origins[:, None, :] + rays.directions[:, None, :] * t[..., None]
        sigma = model.proposal_density(pts.reshape(-1, 3), _per_sample(rays.frame_numbers, k), level)
        mask = rays.valid[:, None] & sample_occupancy(grids, grid_ids[:, None], pts + 0.5)
        return render_weights_grid(sigma.reshape(num_rays, k), dt, mask)

    t_c, dt_c, edges = stratified_bins(rays.tmin, rays.tmax, k_c, u_c)
    w_c = level_weights(t_c, dt_c, 0)
    levels = [(edges, w_c)]
    t_m, dt_m, edges = sample_intervals(edges, weights_to_cdf(w_c.detach(), cfg.proposal_uniform_bonus), k_m, u_m,
                                        return_edges=True)
    w_m = level_weights(t_m, dt_m, 1)
    levels.append((edges, w_m))
    t_f, dt_f = sample_intervals(edges, weights_to_cdf(w_m.detach(), cfg.proposal_uniform_bonus), k_f, u_f)
    pts = rays.origins[:, None, :] + rays.directions[:, None, :] * t_f[..., None]
    density, rgb = model(pts.reshape(-1, 3), _per_sample(rays.directions, k_f), _per_sample(rays.frame_numbers, k_f))
    w_f = render_weights_grid(density.reshape(num_rays, k_f), dt_f, rays.valid[:, None].expand(num_rays, k_f))
    out = composite_grid(w_f, rgb.reshape(num_rays, k_f, 3), background)
    if model.work_log is not None:
        model.work_log.append({"kind": "valid_samples", "n": int(rays.valid.sum()) * k_f})
    interlevel = None
    if rng is not None:
        interlevel = sum(proposal_distillation_per_ray(e, w, t_f - 0.5 * dt_f, t_f + 0.5 * dt_f, w_f)
                         for e, w in levels)
    return out, interlevel


def make_train_step(conf: dict, model: KPlanesModel, optimizer, width: int, height: int):
    """train_step(batch, pool, grids, aabb, rng) → loss: the loss (MSE,
    interlevel, the plane regularisers, BCE at the configuration's weight
    where it is not 0), its backward and the optimizer's step, in place."""
    cfg = pipeline_config(conf)
    f = conf["flags"]
    if flag(f, "training.photometric") != "mse":
        raise ValueError("the K-Planes reference takes --training.photometric mse")
    bce_weight = flag(f, "training.bce_loss_weight", float)

    def step(batch: HostBatch, pool: PoolArrays, grids, aabb, rng):
        rays = build_rays(cfg, batch, pool, grids, aabb, width, height)
        ray_ids = torch.arange(cfg.num_rays * cfg.candidate_rays_factor, device=rays.origins.device)
        if cfg.candidate_rays_factor > 1:
            rays, batch, ray_ids = compact_rays(rays, batch, ray_ids, cfg.num_rays)
        for p in model.parameters():
            p.grad = None
        rng_bg, rng_jitter = split(rng)
        gt_mask = batch.rgba[:, 3:4]
        background = uniform_per_id(rng_bg, ray_ids, num=3)
        gt = batch.rgba[:, 0:3] * gt_mask + background * (1.0 - gt_mask)
        out, interlevel = render(cfg, model, rays, pool, grids, batch.buffer_idx, background, rng_jitter, ray_ids)
        loss = masked_mean((out.color - gt) ** 2, rays.valid)
        if bce_weight:
            loss = loss + masked_mean(losses.bce_loss(out.weights_sum, gt_mask), rays.valid) * bce_weight
        loss = loss + cfg.proposal_loss_weight * masked_mean(interlevel[:, None], rays.valid)
        loss = loss + model.regularization()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def build_model(conf: dict, state: Dict[str, torch.Tensor], device, round_planes: bool = False) -> KPlanesModel:
    model = KPlanesModel(model_config(conf), device=device)
    model.load_state_dict({k: v.to(device) for k, v in state.items()})
    model.set_round_planes(round_planes)
    return model


def train_steps(conf: dict, state: Dict[str, torch.Tensor], steps, width: int, height: int, device,
                round_planes: bool = False, work_logs: Optional[List[list]] = None) -> dict:
    """The reference's train step over `steps` (`check.StepInputs`) from the
    parameters `state` → {"losses", "grads": step 1's, "params": after the
    last} (CPU tensors), as `check.train_steps` for HumanRF. `work_logs`,
    one list per step, receives what each step's queries serve."""
    f = conf["flags"]
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = build_model(conf, state, device, round_planes)
        opt = AdamW([p for _, p in model.named_parameters()], flag(f, "training.lr", float),
                    flag(f, "training.lr_decay", float), flag(f, "training.max_steps", int),
                    flag(f, "training.weight_decay", float))
        step = make_train_step(conf, model, opt, width, height)
        out = {"losses": [], "grads": None}
        for i, inp in enumerate(steps):
            model.set_work_log(work_logs[i] if work_logs is not None else None)
            loss = step(*(x.to(device) if isinstance(x, torch.Tensor) else type(x)(*(t.to(device) for t in x))
                          for x in inp))
            out["losses"].append(float(loss))
            if i == 0:
                out["grads"] = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        model.set_work_log(None)
        out["params"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return out


def draw_weights(named_shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Fresh weights from `seed`, drawn on `device`: spatial planes U[0.1,
    0.5] (the source's), time planes 1 + U[−0.1, 0.1] (the source starts
    them at 1; the perturbation makes a fault along t show in every value),
    MLP weights He-normal, √(2/din)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, shape in named_shapes.items():
        leaf = name.split(".")[-1]
        if leaf in NAMES:
            u = torch.rand(shape, generator=gen, device=device)
            out[name] = 1.0 + 0.2 * (u - 0.5) if NAMES.index(leaf) in TIME else 0.1 + 0.4 * u
        elif ".w" in name and "_net" in name:
            out[name] = normal(shape, gen) * (2.0 / shape[0]) ** 0.5
        else:
            raise ValueError(f"no distribution for parameter {name}")
    return out
