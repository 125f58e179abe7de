"""Leveled logger with an in-memory log, console output, a callback hook
and TXT / HTML export; the named-event `Timer`, `RenderControl` (the render's
lifecycle state) and the console `ProgressBar`.

A copy of `libyafaray_tpu/utils/logger.py` (it imports neither JAX nor
torch): the reference's src/common/logger.cc (7 levels mirroring the C enum,
a console and memory log, saveTxtLog / saveHtmlLog logger.h:84-85,
setCallback logger.h:68), src/common/timer.cc and
src/render/progress_bar.cc. Logging happens on the host thread only, so it
takes no lock.
"""
from __future__ import annotations

import datetime
import sys
import time
from typing import Callable, List, Optional, Tuple

# levels mirror the reference's C enum (yafaray_LogLevel_t)
LOG_MUTE = 0
LOG_ERROR = 1
LOG_WARNING = 2
LOG_PARAMS = 3
LOG_INFO = 4
LOG_VERBOSE = 5
LOG_DEBUG = 6

_LEVEL_NAMES = {LOG_ERROR: "ERROR", LOG_WARNING: "WARNING",
                LOG_PARAMS: "PARAMS", LOG_INFO: "INFO",
                LOG_VERBOSE: "VERBOSE", LOG_DEBUG: "DEBUG"}
_LEVEL_COLORS = {LOG_ERROR: "\033[31m", LOG_WARNING: "\033[33m",
                 LOG_PARAMS: "\033[35m", LOG_INFO: "\033[32m",
                 LOG_VERBOSE: "\033[36m", LOG_DEBUG: "\033[34m"}


class Logger:
    def __init__(self, console_level: int = LOG_INFO,
                 memory_level: int = LOG_VERBOSE,
                 colors: bool = True):
        self.console_level = console_level
        self.memory_level = memory_level
        self.colors = colors
        self.entries: List[Tuple[float, int, str]] = []
        self.callback: Optional[Callable[[int, float, str], None]] = None

    def set_callback(self, cb) -> None:
        self.callback = cb

    def log(self, level: int, *msg) -> None:
        text = "".join(str(m) for m in msg)
        now = time.time()
        if level <= self.memory_level:
            self.entries.append((now, level, text))
        if level <= self.console_level:
            name = _LEVEL_NAMES.get(level, "?")
            stamp = datetime.datetime.fromtimestamp(now).strftime("%H:%M:%S")
            if self.colors:
                c = _LEVEL_COLORS.get(level, "")
                print(f"[{stamp}] {c}{name}\033[0m: {text}", file=sys.stderr)
            else:
                print(f"[{stamp}] {name}: {text}", file=sys.stderr)
        if self.callback is not None:
            self.callback(level, now, text)

    def error(self, *m):
        self.log(LOG_ERROR, *m)

    def warning(self, *m):
        self.log(LOG_WARNING, *m)

    def params(self, *m):
        self.log(LOG_PARAMS, *m)

    def info(self, *m):
        self.log(LOG_INFO, *m)

    def verbose(self, *m):
        self.log(LOG_VERBOSE, *m)

    def debug(self, *m):
        self.log(LOG_DEBUG, *m)

    def save_txt_log(self, path: str) -> None:
        with open(path, "w") as f:
            for ts, lv, text in self.entries:
                stamp = datetime.datetime.fromtimestamp(ts).isoformat()
                f.write(f"[{stamp}] {_LEVEL_NAMES.get(lv, '?')}: {text}\n")

    def save_html_log(self, path: str) -> None:
        rows = []
        colors = {LOG_ERROR: "#c33", LOG_WARNING: "#cc3", LOG_INFO: "#3a3",
                  LOG_PARAMS: "#a3a", LOG_VERBOSE: "#3aa", LOG_DEBUG: "#36c"}
        for ts, lv, text in self.entries:
            stamp = datetime.datetime.fromtimestamp(ts).strftime("%H:%M:%S")
            rows.append(
                f'<tr><td>{stamp}</td><td style="color:'
                f'{colors.get(lv, "#000")}">{_LEVEL_NAMES.get(lv, "?")}'
                f"</td><td>{text}</td></tr>")
        with open(path, "w") as f:
            f.write("<html><body><table border=1 cellpadding=2>"
                    "<tr><th>time</th><th>level</th><th>message</th></tr>"
                    + "".join(rows) + "</table></body></html>")

    def clear(self) -> None:
        self.entries.clear()


# module-level default logger (the reference passes Logger& everywhere;
# Python convention: a default instance, overridable per call site)
default_logger = Logger()


class Timer:
    """Named-event stopwatch (src/common/timer.cc: addEvent/start/stop/
    getTime); used for render stats and autosave intervals."""

    def __init__(self):
        self._start: dict = {}
        self._total: dict = {}

    def start(self, name: str) -> None:
        self._start[name] = time.time()

    def stop(self, name: str) -> None:
        if name in self._start:
            self._total[name] = (self._total.get(name, 0.0)
                                 + time.time() - self._start.pop(name))

    def get_time(self, name: str) -> float:
        running = time.time() - self._start[name] if name in self._start else 0
        return self._total.get(name, 0.0) + running

    def reset(self, name: str) -> None:
        self._start.pop(name, None)
        self._total.pop(name, None)


class RenderControl:
    """Render lifecycle state (include/render/render_control.h:30-65):
    started / in-progress / finished / canceled / resumed + progress.
    Cooperative cancel: the render loop polls `canceled` between passes
    (the wavefront pass itself is atomic, like the reference's per-tile
    granularity)."""

    def __init__(self):
        self.started = False
        self.finished = False
        self.canceled = False
        self.resumed = False
        self.progress = 0.0
        self.render_info = ""
        self.aa_noise_info = ""

    def set_started(self):
        self.started = True
        self.finished = False
        self.canceled = False

    def set_finished(self):
        self.finished = True

    def set_canceled(self):
        self.canceled = True

    def set_resumed(self):
        self.resumed = True

    def set_progress(self, fraction: float):
        self.progress = float(fraction)


class ProgressBar:
    """Console progress + callback fan-out (src/render/progress_bar.cc)."""

    def __init__(self, width: int = 40, callback=None, out=sys.stderr):
        self.width = width
        self.callback = callback
        self.out = out
        self.total = 1
        self.done = 0
        self.tag = ""

    def init(self, total: int, tag: str = "render"):
        self.total = max(total, 1)
        self.done = 0
        self.tag = tag
        self._draw()

    def update(self, steps: int = 1):
        self.done = min(self.done + steps, self.total)
        self._draw()

    def _draw(self):
        frac = self.done / self.total
        filled = int(frac * self.width)
        bar = "#" * filled + "-" * (self.width - filled)
        print(f"\r{self.tag}: [{bar}] {frac * 100:5.1f}%",
              end="", file=self.out)
        if self.done >= self.total:
            print(file=self.out)
        if self.callback is not None:
            self.callback(self.done, self.total, self.tag)
