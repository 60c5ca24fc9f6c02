"""SingleDataLoader: batched feeding of a whole in-memory dataset.

The PyTorch counterpart of flexflow_tpu/core/dataloader.py (reference:
python/flexflow/core/flexflow_cffi.py:2447 SingleDataLoader): the whole
array stays in host memory; `next_batch` hands out the next batch of the
batch tensor's size and wraps to the start when the next one would run
past the end, and `num_batches` counts whole batches only (the tail is
dropped). `FFModel.fit` and `eval` take loaders for x and y and read
their arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class SingleDataLoader:
    def __init__(self, ffmodel, batch_tensor, full_array: np.ndarray,
                 num_samples: Optional[int] = None):
        self.model = ffmodel
        self.batch_tensor = batch_tensor
        self.full_array = np.asarray(full_array)
        self.num_samples = num_samples or self.full_array.shape[0]
        self.batch_size = batch_tensor.dims[0]
        self.next_index = 0

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    def reset(self):
        self.next_index = 0

    def next_batch(self, ffmodel=None) -> np.ndarray:
        i = self.next_index
        b = self.batch_size
        if i + b > self.num_samples:
            i = 0
        batch = self.full_array[i:i + b]
        self.next_index = i + b
        return batch
