"""Interleaved int8 I/Q: rounded half to even, clipped to +-127."""

import numpy as np
import torch

DTYPE = np.int8


def quantize(i, q):
    return torch.stack([x.round().clamp(-127, 127) for x in (i, q)],
                       dim=1).to(torch.int8).reshape(-1)
