"""Interactive progressive viewer in the terminal.

The reference's render loop presents to a GLFW/Vulkan swapchain with WASD
movement, mouse panning, and progressive accumulation that resets on camera
moves (application.cpp:346-408, camera.cpp:18-60, raytracer.cpp:501-535).
Port of ``vulkan_raytracer_tpu/viewer.py`` over the port's ``Renderer``
(host code; it reads the device image only through ``draw_frame``).  A
render host has no swapchain; this viewer keeps the same loop contract
(poll input, draw one progressive sample, present, reset on move) and
presents with ANSI truecolor half-blocks (two pixels per character cell).

Input parity with the GLFW window (camera.cpp:18-60):
* w/a/s/d move, uppercase = 3x boost, z-prefix = 0.2x creep;
* REAL mouse drags via xterm SGR mouse reporting (ESC[?1002h/1006h):
  left-drag pans exactly like GLFW cursorMoved with the left button,
  right-drag-vertical adjusts fov with the 10-150 degree clamp;
* i/j/k/l keys remain as a pan fallback for terminals without mouse
  reporting, [ ] change speed, q quits.
"""

from __future__ import annotations

import os
import re
import select
import shutil
import sys
import time

import numpy as np

from .render.renderer import Renderer
from .utils import logging as log

#: SGR mouse report: ESC [ < button ; x ; y (M=press/drag, m=release)
_SGR_MOUSE = re.compile(r"\x1b\[<(\d+);(\d+);(\d+)([Mm])")


def parse_input(buf: str):
    """Split a raw tty chunk into ('key', ch) and ('mouse', b, x, y, down).

    Pure function so terminals can be simulated in tests.  Unrecognised
    escape sequences are dropped; returns (events, remainder) where the
    remainder is an incomplete trailing escape sequence to retry with more
    bytes.
    """
    events = []
    i = 0
    while i < len(buf):
        c = buf[i]
        if c == "\x1b":
            m = _SGR_MOUSE.match(buf, i)
            if m:
                b, x, y, kind = m.groups()
                events.append(("mouse", int(b), int(x), int(y), kind == "M"))
                i = m.end()
                continue
            # incomplete escape at the end -> keep for the next read
            if _looks_partial(buf[i:]):
                return events, buf[i:]
            i += 1  # unknown sequence intro; skip the ESC
            continue
        events.append(("key", c))
        i += 1
    return events, ""


def _looks_partial(s: str) -> bool:
    """Could ``s`` be a prefix of an SGR mouse report?"""
    return bool(re.fullmatch(r"\x1b(\[(<(\d+(;(\d+(;(\d+)?)?)?)?)?)?)?", s))


class MouseState:
    """Tracks drag deltas and feeds Camera.cursor_moved like GLFW would."""

    def __init__(self):
        self.last_xy = None
        self.buttons = set()

    def apply(self, camera, b, x, y, down):
        btn = b & 3  # 0=left, 2=right; bit 5 (32) marks motion events
        motion = bool(b & 32)
        if not motion:
            if down:
                self.buttons.add(btn)
                self.last_xy = (x, y)
            else:
                self.buttons.discard(btn)
                self.last_xy = None
            return
        if self.last_xy is None:
            self.last_xy = (x, y)
            return
        dx = (x - self.last_xy[0]) * 8.0  # cells are coarser than pixels
        dy = (y - self.last_xy[1]) * 16.0
        self.last_xy = (x, y)
        camera.cursor_moved(
            dx, dy, left=(0 in self.buttons), right=(2 in self.buttons)
        )


def _read_chunk(timeout: float = 0.0) -> str:
    if not sys.stdin.isatty():
        return ""
    r, _, _ = select.select([sys.stdin], [], [], timeout)
    if not r:
        return ""
    return os.read(sys.stdin.fileno(), 1024).decode(errors="ignore")


#: decimal strings for every byte value, so presenting never formats ints
_DEC = [str(i) for i in range(256)]


def _present(img: np.ndarray) -> str:
    """(H, W, 3) uint8 -> ANSI half-block framebuffer string.

    Hot at interactive resolutions (320x240 = 38,400 cells a frame): works on
    plain Python ints via ``tolist`` + a decimal-string table, and elides
    the SGR colour codes for cells whose colours repeat the previous cell
    (large flat regions collapse to a single escape).
    """
    h = img.shape[0] - (img.shape[0] % 2)
    dec = _DEC
    rows = []
    for y in range(0, h, 2):
        top = img[y].tolist()
        bot = img[y + 1].tolist()
        cells = []
        ap = cells.append
        prev_t = prev_b = None
        for t, b in zip(top, bot):
            if t != prev_t:
                ap("\x1b[38;2;" + dec[t[0]] + ";" + dec[t[1]] + ";" + dec[t[2]] + "m")
                prev_t = t
            if b != prev_b:
                ap("\x1b[48;2;" + dec[b[0]] + ";" + dec[b[1]] + ";" + dec[b[2]] + "m")
                prev_b = b
            ap("▀")
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


def display_size(width: int, height: int, term=None):
    """Display cells for a (width, height) render on the current terminal:
    half-block rows give 2 vertical pixels per text row.  The render runs
    at full resolution on the device; the uint8 display image is mean-pooled
    to this size on the device before the single host fetch (the terminal is
    the swapchain here, and it cannot show more cells than it has)."""
    term = term or shutil.get_terminal_size((100, 32))
    dw = max(min(width, term.columns - 2), 2)
    dh = max(min(height, 2 * (term.lines - 3)), 2)
    return dh, dw


def apply_resize(renderer, width: int, height: int, term=None):
    """Live window-resize handling (application.cpp:321-344 →
    raytracer.cpp:493-499): the terminal is the swapchain here, so a
    SIGWINCH plays the role of the GLFW framebuffer-resize callback —
    recompute the present (cell) grid and recreate images / reset
    accumulation through :meth:`Renderer.handle_resize`.  Render
    resolution is the CLI's, as in the reference's windowed mode; only
    the present blit target changes.  Returns the new display grid."""
    renderer.handle_resize(width, height)
    return display_size(width, height, term=term)


def run_viewer(tables, camera, width: int = 128, height: int = 96, max_depth: int = 4):
    """Progressive interactive loop (q to quit).  Requires a tty."""
    import signal
    import termios
    import tty

    if not sys.stdin.isatty():
        raise RuntimeError("interactive viewer needs a tty")
    renderer = Renderer(tables, camera, width, height, max_depth)
    disp = display_size(width, height)
    resized = [False]

    def _on_winch(signum, frame):
        resized[0] = True  # handled at the top of the loop, not re-entrant

    old_winch = signal.signal(signal.SIGWINCH, _on_winch)
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    sys.stdout.write("\x1b[2J")  # clear
    sys.stdout.write("\x1b[?1002h\x1b[?1006h")  # button-drag mouse reporting
    mouse = MouseState()
    pending = ""
    last = time.perf_counter()
    creep = False
    try:
        while True:
            now = time.perf_counter()
            dt = now - last
            last = now

            if resized[0]:
                resized[0] = False
                disp = apply_resize(renderer, width, height)
                sys.stdout.write("\x1b[2J")  # stale cells off the new grid

            events, pending = parse_input(pending + _read_chunk())
            quit_now = False
            for ev in events:
                if ev[0] == "mouse":
                    mouse.apply(camera, *ev[1:])
                    continue
                key = ev[1]
                if key == "q":
                    quit_now = True
                    break
                moves = {
                    "w": {"w"}, "s": {"s"}, "a": {"a"}, "d": {"d"},
                    "W": {"w", "shift"}, "S": {"s", "shift"},
                    "A": {"a", "shift"}, "D": {"d", "shift"},
                }
                if key == "z":  # creep toggle (GLFW ctrl modifier stand-in)
                    creep = not creep
                elif key in moves:
                    mod = moves[key] | ({"ctrl"} if creep else set())
                    camera.process_key_input(mod, max(dt, 1 / 30))
                elif key == "i":
                    camera.cursor_moved(0, -40, left=True)
                elif key == "k":
                    camera.cursor_moved(0, 40, left=True)
                elif key == "j":
                    camera.cursor_moved(-40, 0, left=True)
                elif key == "l":
                    camera.cursor_moved(40, 0, left=True)
                elif key in "+=":
                    camera.cursor_moved(0, -10, right=True)
                elif key == "-":
                    camera.cursor_moved(0, 10, right=True)
                elif key == "[":
                    camera.speed *= 0.5
                elif key == "]":
                    camera.speed *= 2.0
            if quit_now:
                break

            t0 = time.perf_counter()
            # swapchain-latency pipelining: present frame N-1 while N
            # renders (None on the very first call: nothing to show yet)
            img = renderer.draw_frame(display_size=disp, pipeline=True)
            frame_ms = 1e3 * (time.perf_counter() - t0)
            if img is None:
                continue
            sys.stdout.write("\x1b[H")  # home
            sys.stdout.write(_present(img))
            sys.stdout.write(
                f"\n\x1b[0m spp {renderer.sample_count:4d}  {frame_ms:6.1f} ms/frame"
                f"  pos ({camera.position[0]:.2f} {camera.position[1]:.2f}"
                f" {camera.position[2]:.2f})  [wasd move, drag pan, rdrag fov, q quit]\x1b[K"
            )
            sys.stdout.flush()
    finally:
        signal.signal(signal.SIGWINCH, old_winch)
        sys.stdout.write("\x1b[?1002l\x1b[?1006l")
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")
    log.info("viewer closed after %d samples, %d rays", renderer.sample_count, renderer.rays_traced)
