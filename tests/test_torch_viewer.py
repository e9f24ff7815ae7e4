"""The port's viewer input and fly camera: the twins of
tests/test_viewer_input.py on the port's modules, and the camera's input
handling bit-equal to the JAX package's ``Camera``."""

import os

import numpy as np

from vulkan_raytracer_tpu.scene.camera import Camera as JCamera
from vulkan_raytracer_tpu_torch.render.renderer import Renderer
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
from vulkan_raytracer_tpu_torch.scene.camera import Camera
from vulkan_raytracer_tpu_torch.viewer import (MouseState, _present, apply_resize,
                                               display_size, parse_input)


def _cam(cls=Camera):
    return cls(position=np.array([0.0, 1.0, 3.0]), direction=np.array([0.0, 0.0, -1.0]))


def test_parse_keys_and_mouse():
    events, rest = parse_input("wa\x1b[<0;10;5Ms\x1b[<32;12;6Mq")
    assert rest == ""
    assert events == [
        ("key", "w"),
        ("key", "a"),
        ("mouse", 0, 10, 5, True),
        ("key", "s"),
        ("mouse", 32, 12, 6, True),
        ("key", "q"),
    ]


def test_parse_partial_escape_kept():
    events, rest = parse_input("w\x1b[<0;1")
    assert events == [("key", "w")]
    assert rest == "\x1b[<0;1"
    events, rest = parse_input(rest + "0;5M")
    assert events == [("mouse", 0, 10, 5, True)]
    assert rest == ""


def test_left_drag_pans_like_cursor_moved():
    cam, ref = _cam(), _cam()
    m = MouseState()
    m.apply(cam, 0, 10, 5, True)  # LMB press at (10, 5)
    m.apply(cam, 32, 12, 5, True)  # drag 2 cells right
    ref.cursor_moved(16.0, 0.0, left=True)  # 2 cells * 8 px/cell
    np.testing.assert_allclose(cam.direction, ref.direction, atol=1e-6)
    assert cam.direction_changed


def test_right_drag_changes_fov_with_clamp():
    cam = _cam()
    m = MouseState()
    fov0 = cam.fov
    m.apply(cam, 2, 10, 5, True)  # RMB press
    m.apply(cam, 34, 10, 8, True)  # drag down 3 cells (b = 2 | 32)
    assert cam.fov > fov0
    for _ in range(100):
        m.apply(cam, 34, 10, 9, True)
        m.last_xy = (10, 8)
    assert cam.fov <= np.deg2rad(150.0) + 1e-6


def test_release_stops_dragging():
    cam = _cam()
    m = MouseState()
    m.apply(cam, 0, 10, 5, True)
    m.apply(cam, 0, 10, 5, False)  # release
    d0 = cam.direction.copy()
    m.apply(cam, 32, 14, 8, True)  # motion with no button held
    np.testing.assert_allclose(cam.direction, d0)


def test_present_elides_repeated_colours():
    """_present emits one SGR pair for a flat image and full codes on change."""
    flat = np.full((4, 8, 3), 17, np.uint8)
    s = _present(flat)
    # one fg + one bg escape per row, then only half-block glyphs
    assert s.count("\x1b[38;2;17;17;17m") == 2  # 4 rows -> 2 half-block rows
    assert s.count("\x1b[48;2;17;17;17m") == 2
    assert s.count("▀") == 16

    rng = np.random.default_rng(0)
    noisy = rng.integers(0, 256, (2, 5, 3), dtype=np.uint8)
    s2 = _present(noisy)
    assert s2.count("▀") == 5
    assert s2.count("\x1b[38;2;") == 5 and s2.count("\x1b[48;2;") == 5
    for x in range(5):  # per-cell colours land in order
        t = noisy[0, x]
        assert f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m" in s2


def test_sigwinch_resize_resets_accumulation():
    """apply_resize = the GLFW framebuffer-resize callback's contract
    (application.cpp:321-344 -> raytracer.cpp:493-499): new present grid,
    accumulation reset, pipelined in-flight frame dropped."""
    t = cornell_box_scene().upload("cpu")
    r = Renderer(t, _cam(), 16, 16, max_depth=2)
    r.draw_frame(display_size=(8, 8), pipeline=True)
    r.draw_frame(display_size=(8, 8), pipeline=True)
    assert r.sample_count == 2 and r._inflight is not None
    assert float(r.accum.abs().max()) > 0.0

    term = os.terminal_size((40, 12))
    disp = apply_resize(r, 16, 16, term=term)
    assert disp == (16, 16)  # render smaller than the new terminal grid
    assert r.sample_count == 0
    assert r._inflight is None
    assert not r.accum.any()

    # smaller terminal than the render: grid clamps to the cell budget
    tiny = os.terminal_size((10, 5))
    assert apply_resize(r, 16, 16, term=tiny) == (2 * (5 - 3), 10 - 2)
    assert display_size(16, 16, term=tiny) == (4, 8)


def test_camera_input_bit_equal_to_jax():
    """The same key and cursor input through both cameras: position,
    direction, fov, the changed flags and the matrices stay bit-equal."""
    cam, ref = _cam(), _cam(JCamera)
    rng = np.random.default_rng(3)
    keysets = [{"w"}, {"a", "shift"}, {"s", "d"}, {"d", "ctrl"}, set(), {"w", "a", "shift"}]
    for step in range(40):
        keys = keysets[step % len(keysets)]
        dt = float(rng.uniform(0.01, 0.1))
        dx, dy = (float(v) for v in rng.uniform(-30, 30, 2))
        left, right = bool(step % 3), bool(step % 4 == 0)
        for c in (cam, ref):
            c.process_key_input(keys, dt)
            c.cursor_moved(dx, dy, left=left, right=right)
        np.testing.assert_array_equal(cam.position, ref.position)
        np.testing.assert_array_equal(cam.direction, ref.direction)
        assert cam.fov == ref.fov
        assert (cam.position_changed, cam.direction_changed) == (
            ref.position_changed, ref.direction_changed)
    np.testing.assert_array_equal(cam.view_inverse(), ref.view_inverse())
    np.testing.assert_array_equal(cam.projection_inverse(), ref.projection_inverse())
    assert (cam.speed, cam.sensitivity) == (ref.speed, ref.sensitivity)
