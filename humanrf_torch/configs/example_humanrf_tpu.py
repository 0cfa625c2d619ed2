"""The paper's reference run on the JAX package's flagship field and sampler.

Same data, schedule and evaluation protocol as `example_humanrf`, with the
scene field and sampler of the JAX package's flagship: L8/F4 grids with small
per-level tables, and CP-proposal importance sampling (Kc = 32 → Kf = 16) with
2× candidate rays. The port runs it with proposal sampling through its CUDA
field query kernels (`csrc/field_interp.cu`).
"""
from humanrf_torch.configs.example_humanrf import config as _reference_config

config = _reference_config + [
    # fmt: off
    # Field: small per-level tables; 2^12 scales to 2^11 = 2048 per
    # 50-frame segment (models/humanrf.py scaling).
    "--model.log2_hashmap_size", "12",
    "--model.n_levels", "8",
    "--model.n_features_per_level", "4",
    "--tpu.field_backend", "fused",

    # Sampler: proposal importance sampling, flagship shapes.
    "--tpu.sampling", "proposal",
    "--tpu.proposal_samples_per_ray", "32",
    "--tpu.render_samples_per_ray", "16",
    "--tpu.candidate_rays_factor", "2",
    "--training.rays_initial_batch_size", "16_384",
    # fmt: on
]
