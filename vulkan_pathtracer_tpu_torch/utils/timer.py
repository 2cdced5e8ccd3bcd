"""Frame timer — the ``Timer.zig`` equivalent (a copy of
``vulkan_pathtracer_tpu/utils/timer.py``).

``lap()`` returns the delta time in seconds and flags once per elapsed
second (Timer.zig:19-28 semantics: one_second_elapsed is true on the
lap that crosses a 1-second boundary since the last flagged lap).
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self) -> None:
        self.start()

    def start(self) -> None:
        now = time.perf_counter()
        self._last = now
        self._second_anchor = now
        self.delta_time = 0.0
        self.one_second_elapsed = False

    def lap(self) -> float:
        now = time.perf_counter()
        self.delta_time = now - self._last
        self._last = now
        if now - self._second_anchor >= 1.0:
            self.one_second_elapsed = True
            self._second_anchor = now
        else:
            self.one_second_elapsed = False
        return self.delta_time
