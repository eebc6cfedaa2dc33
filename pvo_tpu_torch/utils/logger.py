"""Training logger: running-mean console prints + TensorBoard (port of
:mod:`pvo_tpu.utils.logger`, the same code).

Rebuild of the reference Logger (VO_Module/droid_slam/logger.py:8-53):
accumulates metrics and emits averaged values every ``log_every`` steps
to stdout and (when available) a TensorBoard SummaryWriter.
"""

from __future__ import annotations

from collections import defaultdict


class Logger:
    def __init__(self, name, log_every=100, logdir="runs"):
        self.name = name
        self.log_every = log_every
        self.step = 0
        self.sums = defaultdict(float)
        self.counts = defaultdict(int)
        self._writer = None
        self._logdir = f"{logdir}/{name}"

    @property
    def writer(self):
        if self._writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._writer = SummaryWriter(self._logdir)
            except Exception:
                self._writer = False
        return self._writer

    def push(self, metrics):
        self.step += 1
        for k, v in metrics.items():
            self.sums[k] += float(v)
            self.counts[k] += 1
        if self.step % self.log_every == 0:
            means = {k: self.sums[k] / max(self.counts[k], 1)
                     for k in sorted(self.sums)}
            txt = " ".join(f"{k}={v:.4f}" for k, v in means.items())
            print(f"[{self.name} {self.step:6d}] {txt}", flush=True)
            if self.writer:
                for k, v in means.items():
                    self.writer.add_scalar(k, v, self.step)
            self.sums.clear()
            self.counts.clear()
