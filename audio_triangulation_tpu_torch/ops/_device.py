"""Numpy constants on a device, copied there once.

The matrices of the matmul engines (DFT, lag synthesis, smoothing) are numpy
arrays built once per configuration by cached functions.  Copying one from
host memory at every call costs its bytes over the bus and makes the host
wait for the stream (a copy from pageable memory synchronises), so the
device copies are kept, keyed by the array object itself.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_ENTRIES = 32
_cache: dict = {}


def device_constant(arr: np.ndarray, device, dtype=torch.float32):
    """``arr`` as a ``dtype`` tensor on ``device``.  For a device other than
    the CPU the tensor is kept for as long as ``arr`` is one of the last
    ``MAX_ENTRIES`` arrays asked for; ``arr`` must not be changed
    afterwards (the arrays of the cached matrix functions never are)."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.as_tensor(arr, dtype=dtype)
    key = (id(arr), str(device), dtype)
    hit = _cache.get(key)
    if hit is None or hit[0] is not arr:  # the id of a freed array can recur
        while len(_cache) >= MAX_ENTRIES:
            _cache.pop(next(iter(_cache)))
        hit = (arr, torch.as_tensor(arr, dtype=dtype, device=device))
        _cache[key] = hit
    return hit[1]
