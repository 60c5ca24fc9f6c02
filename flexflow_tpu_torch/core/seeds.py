"""Host-side seed material for the ops that draw random numbers.

The JAX package threads a PRNG key: one split of the model's key per
training step (flexflow_tpu/core/model.py) and, per compute op,
`jax.random.fold_in(step_key, compute_idx)` (parallel/executor.py), so an
op's randomness does not depend on the order in which other ops draw.
The port keeps that structure with host integers: per step one 63-bit
draw from the model's CPU generator (`step_seed`), per op
`fold_in(step_seed, compute_idx)`. An op turns its seed into what it
needs (the two uint32 attention seeds, a device generator's seed) with no
device-to-host sync and no mask built on the host. These numbers are not
the JAX package's; parity tests inject the same seeds into both packages.
"""
from __future__ import annotations

from typing import Optional

import torch

_M64 = (1 << 64) - 1


def mix64(x: int) -> int:
    """splitmix64 (Steele, Lea and Flood, 2014): a bijective 64-bit mix."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 64-bit seed from `seed` and the integer `data` (the
    counterpart of jax.random.fold_in)."""
    return mix64((seed & _M64) ^ mix64(data & _M64))


def step_seed(rng) -> Optional[int]:
    """The seed of one training step: `rng` itself when it is an int (or
    None), else one draw from `rng`, a torch.Generator on the CPU."""
    if rng is None or isinstance(rng, int):
        return rng
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=rng))
