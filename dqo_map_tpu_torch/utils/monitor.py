"""Run-time performance recorder and training-curve logger (counterpart of
`dqo_map_tpu/utils/monitor.py`)."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict

import torch


class Recorder:
    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.means = defaultdict(float)
        self.counts = defaultdict(int)
        self.max_mem_gb = 0.0
        self.fps = 0.0

    def update_mean(self, name: str, value: float, weight: int = 1):
        """Running mean of `name`."""
        c = self.counts[name]
        self.means[name] = (self.means[name] * c + value * weight) / (c + weight)
        self.counts[name] += weight

    def watch_gpu(self):
        """Peak device memory of the device so far, in GiB (0 on the CPU)."""
        if self.device.type == "cuda":
            self.max_mem_gb = max(
                self.max_mem_gb,
                torch.cuda.max_memory_allocated(self.device) / (1 << 30))

    def cal_fps(self) -> float:
        """fps = 1 / the mean mapping time."""
        if self.means.get("mapping", 0) > 0:
            self.fps = 1.0 / self.means["mapping"]
        return self.fps

    def save(self, save_path: str) -> dict:
        os.makedirs(save_path, exist_ok=True)
        data = {"fps": self.fps, "max_mem_GB": self.max_mem_gb}
        data.update({f"mean_{k}_s": v for k, v in self.means.items()})
        with open(os.path.join(save_path, "performance.json"), "w") as f:
            json.dump(data, f, indent=2)
        return data


class ScalarLogger:
    """Training-curve logger: append-only JSONL, one `{"step", "tag",
    "value", "t"}` object a line, mirrored to TensorBoard where its package
    is installed."""

    def __init__(self, save_path: str, enabled: bool = True):
        self.enabled = enabled
        self._f = None
        self._tb = None
        if not enabled:
            return
        os.makedirs(save_path, exist_ok=True)
        self._f = open(os.path.join(save_path, "scalars.jsonl"), "a")
        try:  # the optional mirror
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(os.path.join(save_path, "tb"))

    def log(self, step: int, tag: str, value: float):
        if not self.enabled or self._f is None:
            return
        self._f.write(json.dumps({"step": int(step), "tag": tag,
                                  "value": float(value), "t": time.time()})
                      + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def log_dict(self, step: int, values: dict, prefix: str = ""):
        for k, v in values.items():
            self.log(step, prefix + k, v)
        self.flush()

    def flush(self):
        if self._f is not None:
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
