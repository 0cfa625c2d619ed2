"""Random draws keyed by integer identity, bit for bit those of the JAX package.

Counterpart of `humanrf_tpu/utils/rngs.py`. Every draw of a training step
(background colour, sample jitter) is keyed by a stable global id (ray id, or
ray id × lattice slot), so a ray draws the same noise wherever compaction or
sharding puts it. The JAX package derives the per-id key with
`jax.random.fold_in` on a threefry-2x32 key; this module computes the same
counter-based threefry-2x32 in int64 torch arithmetic, with every word masked
to 32 bits, on whatever device the ids live on. There is no global RNG: a key
is an explicit (2,) tensor of uint32 values (held as int64).

The installed JAX sets `jax_threefry_partitionable=True`, under which
`split(key, n)[i]` and the bits of `uniform(key, (m,))` come from hashing the
64-bit counter i as the word pair (0, i):

    fold_in(key, d)   = threefry(key, (0, d))          (both output words)
    split(key, n)[i]  = threefry(key, (0, i))          (both output words)
    bits(key, m)[j]   = y0 ^ y1,  (y0, y1) = threefry(key, (0, j))
    uniform           = (bits >> 9) · 2^-23            (the mantissa trick)

`tests/test_torch_train.py` holds each function to the installed JAX.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def make_key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a seed in [0, 2^63): the words (hi, lo)."""
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry-2x32 hash (20 rounds) of counter words (x0, x1) under the
    key words; all int64 tensors holding uint32 values → (y0, y1)."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """`jax.random.fold_in` for each element of `data` (ids, wrapped to
    uint32) → keys (*data.shape, 2)."""
    d = data.long() & _MASK
    y0, y1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` → (num, 2) keys."""
    return fold_in(key, torch.arange(num, dtype=torch.int64, device=key.device))


def _uniform_keys(keys: torch.Tensor, num: int) -> torch.Tensor:
    """`jax.random.uniform(k, (num,))` for each key of (N, 2) keys → (N, num)."""
    j = torch.arange(num, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys.T[:, :, None], torch.zeros_like(j), j)
    return ((y0 ^ y1) >> 9).float() * 2.0**-23


def uniform_per_id(key: torch.Tensor, ids: torch.Tensor, num: int = 1) -> torch.Tensor:
    """Uniform [0, 1) float32 draws keyed by integer identity: (N,) when
    num == 1, else (N, num). The draw of an id does not depend on the shape
    or order of `ids`.

    num ≤ 2 reads the per-id key's words directly, top 24 bits each (the
    JAX package's `_bits_to_unit`); num = 3 draws `uniform(key_id, (3,))`.
    """
    keys = fold_in(key, ids)
    if num <= 2:
        u = (keys[..., :num] >> 8).float() * 2.0**-24
        return u[..., 0] if num == 1 else u
    return _uniform_keys(keys, num)
