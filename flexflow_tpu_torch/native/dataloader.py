"""Python wrapper over the native prefetching data loader (the PyTorch
counterpart of the JAX package's native/dataloader.py: batches come out
as numpy arrays on the host, for the caller to move to the device)."""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import get_lib


class NativeDataLoader:
    """Shuffled, prefetched batch iterator over an in-memory dataset
    (native equivalent of SingleDataLoader's sequential slicing; reference
    python/flexflow_dataloader.cc)."""

    def __init__(self, array: np.ndarray, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, queue_depth: int = 4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable (g++ missing or "
                               "the build failed)")
        self._lib = lib
        self.array = np.ascontiguousarray(array)
        self.batch_size = batch_size
        self.sample_shape = self.array.shape[1:]
        sample_bytes = int(self.array.dtype.itemsize * np.prod(self.sample_shape or (1,)))
        self._out = np.empty((batch_size,) + self.sample_shape, self.array.dtype)
        self._handle = lib.ffdl_create(
            self.array.ctypes.data_as(ctypes.c_void_p),
            self.array.shape[0],
            sample_bytes,
            batch_size,
            1 if shuffle else 0,
            seed,
            queue_depth,
        )
        if not self._handle:
            raise RuntimeError("ffdl_create failed")

    @property
    def num_batches(self) -> int:
        return self._lib.ffdl_batches_per_epoch(self._handle)

    def next_batch(self) -> Optional[np.ndarray]:
        idx = self._lib.ffdl_next(
            self._handle, self._out.ctypes.data_as(ctypes.c_void_p)
        )
        if idx < 0:
            return None
        return self._out.copy()

    def reset(self):
        self._lib.ffdl_reset(self._handle)

    def __iter__(self):
        self.reset()
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.ffdl_destroy(self._handle)
                self._handle = None
        except Exception:  # best-effort destructor at interpreter exit
            pass
