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

A training step hands its ops their seeds as a table (`seed_table`): for
N steps and every compute op that draws, the two uint32 dropout seeds of
`fold_in(step_seed, compute_idx)`, laid out (N, n_ops, 2) and copied to
the device with the steps' batches, as the JAX package stages one key per
step. All seed arithmetic stays on the host; a kernel reads its op's two
seeds from the table by pointer, so a captured CUDA graph replays each
step with that step's seeds.
"""
from __future__ import annotations

from typing import Optional, Sequence

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


def as_int32(u: int) -> int:
    """A uint32 as the int32 with the same bits."""
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u >= 1 << 31 else u


def seed_table(step_seeds: Sequence[Optional[int]], drawing: Sequence[int],
               n_ops: int) -> torch.Tensor:
    """The (N, n_ops, 2) int32 CPU table of N steps' op seeds: entry
    [j, i] holds the bits of `dropout_seeds(fold_in(step_seeds[j], i))`
    for each compute index i in `drawing`, zeros elsewhere. The kernels
    read the two words as uint32. `dropout_seeds` is looked up at call
    time, so a test that patches it in kernels.attention reaches here."""
    from ..kernels import attention as katt

    table = [[[0, 0] for _ in range(n_ops)] for _ in step_seeds]
    for row, s in zip(table, step_seeds):
        if s is None:
            continue
        for i in drawing:
            s0, s1 = katt.dropout_seeds(fold_in(s, i))
            row[i] = [as_int32(int(s0)), as_int32(int(s1))]
    return torch.tensor(table, dtype=torch.int32).reshape(
        len(step_seeds), n_ops, 2)

