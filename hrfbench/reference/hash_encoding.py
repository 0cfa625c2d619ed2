"""Multi-resolution hash-grid configuration (Instant-NGP conventions).

Counterpart of `humanrf_tpu/models/hash_encoding.py`: only the configuration
and the corner/hash constants; the lookups themselves live in
`models/fused_field.py` on top of `ops/field_interp.py`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_HASH_PRIMES = (1, 2654435761, 805459861)


@dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 32
    finest_resolution: int = 2048

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def feature_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def per_level_scale(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return float(np.exp(np.log(self.finest_resolution / self.base_resolution) / (self.n_levels - 1)))

    def level_scales(self) -> np.ndarray:
        """Grid scale per level (fp32): pos_grid = x * scale + 0.5."""
        ls = np.arange(self.n_levels)
        return (self.base_resolution * self.per_level_scale**ls - 1.0).astype(np.float32)

    def level_resolutions(self) -> np.ndarray:
        return (np.ceil(self.level_scales()) + 1).astype(np.int64)


# Corner c has offset bit d = (c >> d) & 1 along axis d.
_CORNER_BITS = [tuple(((c >> d) & 1) for d in range(3)) for c in range(8)]
