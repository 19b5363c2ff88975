"""Metric logging (the port's own copy of ``kinet_tpu/utils/logging.py``;
reference: util/misc.py:29-88 SmoothedValue, :162-271
MetricLogger.log_every).

Console meters with windowed medians/averages + ETA, for one process.
"""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    def __init__(self, print_freq: int = 50, delimiter: str = "  ",
                 debug: bool = False):
        self.meters = defaultdict(SmoothedValue)
        self.print_freq = print_freq
        self.delimiter = delimiter
        self.debug = debug

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable, header: str = "", length: int | None = None):
        if length is None:
            length = len(iterable)
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % self.print_freq == 0 or i == length - 1:
                eta = iter_time.global_avg * (length - i)
                print(
                    self.delimiter.join(
                        [
                            header,
                            f"[{i:{len(str(length))}d}/{length}]",
                            f"eta: {datetime.timedelta(seconds=int(eta))}",
                            str(self),
                            f"time: {iter_time}",
                            f"data: {data_time}",
                        ]
                    ),
                    flush=True,
                )
            i += 1
            end = time.time()
            if self.debug and i >= 2:
                break
        total = time.time() - start
        print(
            f"{header} Total time: {datetime.timedelta(seconds=int(total))} "
            f"({total / max(length, 1):.4f} s / it)",
            flush=True,
        )
