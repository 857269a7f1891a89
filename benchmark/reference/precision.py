"""Precisions of the reference: as the configuration states them, or one
step below for the control."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Precision:
    """``sums``: the correlations (float32 in the configuration, bfloat16
    in the control); ``state``: loop state, phases and the navigation
    solution (float64, float32 in the control)."""
    control: bool = False

    def sums(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to the correlations' precision (f64 otherwise:
        the reference computes them more finely than float32)."""
        if self.control:
            return x.to(torch.bfloat16).to(torch.float64)
        return x

    def state(self, x):
        """A state value rounded to the state's precision."""
        if self.control:
            if isinstance(x, torch.Tensor):
                return x.to(torch.float32).to(torch.float64)
            import numpy as np
            return np.asarray(x, np.float32).astype(np.float64)
        return x


REFERENCE = Precision(False)
CONTROL = Precision(True)
