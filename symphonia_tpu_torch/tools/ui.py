"""Terminal UI for the player (symphonia-play/src/ui.rs analog).

A curses now-playing view: metadata panel, progress gauge, elapsed/total
time, and transport keys (space pause/resume, q quit). The reference's
ratatui UI is ~1 kLoC of widget plumbing; the functional surface here is
the same panel/gauge/keys set on plain curses.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple


def format_clock(seconds: float) -> str:
    seconds = max(0.0, seconds)
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    return f"{h}:{m:02d}:{s:02d}" if h else f"{m}:{s:02d}"


class NowPlayingUI:
    """Draws the now-playing screen and handles transport keys.

    ``controls`` maps actions to callables: pause() -> None,
    resume() -> None, stop() -> None.
    """

    def __init__(self, title: str, info_lines: List[Tuple[str, str]],
                 total_s: float, controls: Optional[dict] = None):
        self.title = title
        self.info_lines = info_lines
        self.total_s = total_s
        self.controls = controls or {}
        self.paused = False
        self.quit = False

    def _draw(self, scr, elapsed: float) -> None:
        import curses

        scr.erase()
        h, w = scr.getmaxyx()
        w = max(20, w)

        def put(y, x, text, attr=0):
            if 0 <= y < h:
                try:
                    scr.addnstr(y, x, text, max(0, w - x - 1), attr)
                except Exception:
                    pass

        put(0, 1, "symphonia_tpu", __import__("curses").A_BOLD)
        put(1, 1, self.title)
        row = 3
        for key, val in self.info_lines[: h - 7]:
            put(row, 3, f"{key:>12}: {val}")
            row += 1
        # Progress gauge.
        gy = min(h - 3, row + 1)
        bar_w = max(4, w - 22)
        frac = min(1.0, elapsed / self.total_s) if self.total_s > 0 else 0.0
        filled = int(bar_w * frac)
        gauge = "#" * filled + "-" * (bar_w - filled)
        clock = f"{format_clock(elapsed)}/{format_clock(self.total_s)}"
        put(gy, 1, f"[{gauge}] {clock}")
        state = "PAUSED" if self.paused else "PLAYING"
        put(gy + 1, 1, f"{state}   [space] pause/resume   [q] quit")
        scr.refresh()

    def run(self, is_busy: Callable[[], bool],
            tick: float = 0.1) -> None:
        """Run the UI loop until playback ends or the user quits."""
        import curses

        def loop(scr):
            curses.curs_set(0)
            scr.nodelay(True)
            start = time.monotonic()
            paused_at = 0.0
            paused_total = 0.0
            while is_busy() and not self.quit:
                now = time.monotonic()
                elapsed = (paused_at - start - paused_total if self.paused
                           else now - start - paused_total)
                self._draw(scr, elapsed)
                try:
                    key = scr.getch()
                except Exception:
                    key = -1
                if key in (ord("q"), ord("Q")):
                    self.quit = True
                    if "stop" in self.controls:
                        self.controls["stop"]()
                elif key == ord(" "):
                    if self.paused:
                        paused_total += time.monotonic() - paused_at
                        self.paused = False
                        if "resume" in self.controls:
                            self.controls["resume"]()
                    else:
                        paused_at = time.monotonic()
                        self.paused = True
                        if "pause" in self.controls:
                            self.controls["pause"]()
                time.sleep(tick)

        curses.wrapper(loop)
