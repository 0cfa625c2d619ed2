#!/usr/bin/env python3
"""Write the JAX package's dense render of a patch of the r4 test view.

The PyTorch port renders `runs_evidence/r4_full_schedule_748/best.ckpt`
through its dense sampler (lattice, occupancy filter, visibility prune,
flat-buffer render) on a GPU machine without JAX. This script bakes what it
checks against into `torch_dense_inputs.npz` beside the checkpoint, using the
JAX package's own `make_render_fn` with `sampling="dense"` on the CPU (fp32
`gather` field backend):

- the patch: 128×128 pixels of the Cam012 frame-0 view, centred on the
  subject's bounding box, as 16 batches of 32×32 pixels (flat pixel ids);
- the dense settings: the r4 run's (`config.yaml`: 512 lattice points per
  ray, the visibility prune on, march grid factor 2), with budgets that hold
  every sample of a 1,024-ray batch (candidate_budget 512 × 1,024, so no
  lattice point is dropped; sample_budget 131,072, 128 per ray, which the
  trained model's pruned rays stay under). The run's own budgets (131,072
  and 65,536 per 1,024 rays) drop the samples of ~3 rays in 4 of a batch
  on the subject, and two renders that leave the same rays black agree on
  them whatever the field computes;
- the JAX render of each batch: colors on a black background and the
  accumulated alpha.

The view's camera, grid and AABB come from `torch_view_inputs.npz`, which
`tests/test_torch_view_inputs.py` holds to a fresh build.

Usage: python scripts/make_torch_dense_inputs.py [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

RUN_DIR = REPO / "runs_evidence" / "r4_full_schedule_748"
VIEW_PATH = RUN_DIR / "torch_view_inputs.npz"
OUT_PATH = RUN_DIR / "torch_dense_inputs.npz"
PATCH, BLOCK = 128, 32


def dense_settings() -> dict:
    """The r4 run's dense sampling settings (config.yaml) for BLOCK² rays,
    with budgets that hold every sample (see the module docstring)."""
    import yaml

    tpu = yaml.safe_load((RUN_DIR / "config.yaml").read_text())["tpu"]
    num_rays = BLOCK * BLOCK
    return {
        "num_rays": num_rays,
        "samples_per_ray": tpu["samples_per_ray"],
        "candidate_budget": tpu["samples_per_ray"] * num_rays,
        "sample_budget": 128 * num_rays,
        "use_visibility_prune": tpu["use_visibility_prune"],
        "march_grid_factor": tpu["march_grid_factor"],
    }


def patch_blocks(mask: np.ndarray) -> np.ndarray:
    """(16, 1024) flat pixel ids: the PATCH² square centred on the mask's
    bounding box, as BLOCK×BLOCK batches in row-major block order."""
    ys, xs = np.nonzero(mask)
    y0 = (int(ys.min()) + int(ys.max()) + 1) // 2 - PATCH // 2
    x0 = (int(xs.min()) + int(xs.max()) + 1) // 2 - PATCH // 2
    blocks = []
    for by in range(0, PATCH, BLOCK):
        for bx in range(0, PATCH, BLOCK):
            yy, xx = np.meshgrid(np.arange(y0 + by, y0 + by + BLOCK), np.arange(x0 + bx, x0 + bx + BLOCK), indexing="ij")
            blocks.append((yy * mask.shape[1] + xx).reshape(-1))
    return np.stack(blocks).astype(np.int32)


def jax_render(pixel_idx: np.ndarray, settings: dict, blocks=None) -> dict:
    """The JAX package's dense render of the given batches (all by default)
    → {"jax_color" (B, 1024, 3), "jax_weights_sum" (B, 1024)} float32."""
    import jax
    import jax.numpy as jnp

    from humanrf_tpu.models.humanrf import HumanRFConfig, HumanRFModel
    from humanrf_tpu.train.checkpoint import load_checkpoint
    from humanrf_tpu.train.pipeline import HostBatch, PipelineConfig, PoolArrays, make_render_fn

    view = np.load(VIEW_PATH)
    cfg = json.loads(str(view["config_json"]))
    model_cfg = HumanRFConfig(
        sorted_frame_numbers=tuple(cfg["sorted_frame_numbers"]), segment_sizes=tuple(cfg["segment_sizes"]),
        proposal_rank=cfg["tpu"]["proposal_rank"], proposal_resolution=cfg["tpu"]["proposal_resolution"],
        field_backend="gather", **cfg["model"],
    )
    model = HumanRFModel(model_cfg)
    params, _, _, _, _ = load_checkpoint(RUN_DIR / "best.ckpt", model.init_params(jax.random.PRNGKey(0)), None)
    pcfg = PipelineConfig(sampling="dense", **settings)
    render = make_render_fn(pcfg, model, int(view["width"]), int(view["height"]))
    pool = PoolArrays(*(jnp.asarray(view[name]) for name in PoolArrays._fields))
    shape = tuple(int(s) for s in view["grids_shape"])
    grids = jnp.asarray(np.unpackbits(view["grids_packed"], count=int(np.prod(shape))).astype(bool).reshape(shape))
    aabb = jnp.asarray(view["aabb"])
    n = pixel_idx.shape[1]
    colors, wsums = [], []
    for b in range(len(pixel_idx)) if blocks is None else blocks:
        batch = HostBatch(jnp.full(n, int(view["buffer_index"]), jnp.int32), jnp.asarray(pixel_idx[b]),
                          jnp.zeros((n, 4), jnp.float32), jnp.ones(n, bool))
        out, _ = render(params, batch, pool, grids, aabb, 0.0)
        colors.append(np.asarray(out.color, dtype=np.float32))
        wsums.append(np.asarray(out.weights_sum[:, 0], dtype=np.float32))
    return {"jax_color": np.stack(colors), "jax_weights_sum": np.stack(wsums)}


def build() -> dict:
    settings = dense_settings()
    pixel_idx = patch_blocks(np.load(VIEW_PATH)["gt_mask"])
    return {
        "config_json": np.array(json.dumps({**settings, "patch": PATCH, "block": BLOCK, "field_backend": "gather"})),
        "pixel_idx": pixel_idx,
        **jax_render(pixel_idx, settings),
    }


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=OUT_PATH)
    args = ap.parse_args()
    np.savez_compressed(args.out, **build())
    print(f"wrote {args.out} ({args.out.stat().st_size / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
