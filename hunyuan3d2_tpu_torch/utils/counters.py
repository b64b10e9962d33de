"""RunningStats — min/max/mean accumulator (observability helper).

Port of hunyuan3d2_tpu/utils/counters.py (reference
hy3dgen/texgen/utils/counter_utils.py:16-48), copied so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations


class RunningStats:
    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def append(self, value: float):
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def as_dict(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "min": self.min, "max": self.max}

    def __repr__(self):
        return (f"RunningStats(count={self.count}, mean={self.mean:.6g}, "
                f"min={self.min}, max={self.max})")
