"""The elastic runtime's topology fingerprint.

The PyTorch counterpart of one function of flexflow_tpu/runtime/
elastic.py: `topology_fingerprint`, which the checkpoint sidecar records.
The rest of that module (topology_matches, restore_elastic, the health
monitor, shrunk_devices) waits for multi-GPU execution (ROADMAP queue 1
item 6).
"""
from __future__ import annotations

from typing import Optional

import torch


def topology_fingerprint(device: Optional[torch.device] = None) -> dict:
    """A JSON-serializable description of the device a model is compiled
    against (the checkpoint sidecar's ``topology`` entry), with the JAX
    package's keys: ``num_devices``, ``num_processes``, ``platform``
    ("gpu" or "cpu"), ``device_kinds``, ``mesh_axes`` (none: the port
    runs on one device, without a mesh) and ``per_process_devices``
    (device ids by owning process). Without a device, the first CUDA
    device when there is one, else the CPU."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        platform, kind = "gpu", torch.cuda.get_device_name(index)
    else:
        index, platform, kind = 0, device.type, device.type
    return {
        "num_devices": 1,
        "num_processes": 1,
        "platform": platform,
        "device_kinds": [kind],
        "mesh_axes": {},
        "per_process_devices": {"0": [index]},
    }
