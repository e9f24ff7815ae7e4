"""``tools/torch_lane_diff.py`` on the CPU: a frame against itself has no
differing lane, re-rendered lanes are the frame's (also on a repacked wave),
a lane nudged in a recorded run is found at the bounce and field nudged and
classed, each step the tool replays gives the recorded value, its dispatch
mode names an op that rounds differently, and the tool imports neither jax
nor the JAX package.  On the card the tool runs as ``python3
tools/torch_lane_diff.py`` (and inside ``chip_smoke.py``'s parity phases)."""

import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import torch_lane_diff as ld  # noqa: E402

from vulkan_raytracer_tpu_torch.render import integrator  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.procedural import dragon_scene  # noqa: E402

CAM = ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0])
SIZE, SPP, DEPTH = 8, 2, 3
FRAME = (CAM, SIZE, SIZE, DEPTH)


@pytest.fixture(scope="module")
def cornell():
    return cornell_box_scene().upload("cpu")


@pytest.fixture(scope="module")
def recorded(cornell):
    """Every lane of the 8x8 frame, recorded."""
    return ld.record_lanes(cornell, CAM, SIZE, SIZE, SPP, DEPTH, np.arange(SIZE * SIZE))


def test_cpu_against_cpu_has_no_differing_lane(cornell):
    res = ld.diagnose(cornell, CAM, SIZE, SIZE, SPP, DEPTH)
    assert res["rmse"] == 0.0 and res["rays"][0] == res["rays"][1] > SIZE * SIZE * SPP
    assert (res["differing_pixels"], res["differing_lanes"], res["void"]) == (0, 0, False)
    assert res["by_class"] == {"i": 0, "ii": 0}


def test_rerendered_lanes_are_the_frames(cornell, recorded):
    _, _, frame = ld.render_frame(cornell, CAM, SIZE, SIZE, SPP, DEPTH)
    assert len(frame) == len(recorded.radiance) == SIZE * SIZE * SPP
    assert ld.self_check(frame, recorded) == []
    assert set(recorded.final) == set(recorded.steps) == set(frame)
    assert ld.compare(recorded, copy.deepcopy(recorded)) == {}


def test_repacked_lanes_map_back_through_their_slot(monkeypatch):
    """A forced-BVH dragon on the repacked wavefront (re-sorts and the width
    ladder; 24 pixels x 2 samples, a multiple of 4): every lane of a subset of
    the frame comes out as in the whole frame."""
    monkeypatch.setattr(integrator, "_repack_preferred", lambda tables: True)
    tables = dragon_scene(detail=8).upload("cpu", traversal="bvh")
    cam = ([0.0, 2.2, 4.5], [0.0, -0.25, -1.0])
    integrator.reset_bounce_widths()
    _, _, frame = ld.render_frame(tables, cam, 16, 16, SPP, DEPTH)
    pixels = np.random.default_rng(3).choice(256, 24, replace=False)
    rec = ld.record_lanes(tables, cam, 16, 16, SPP, DEPTH, pixels)
    assert len(rec.radiance) == 48 and ld.self_check(frame, rec) == []
    assert any(len(steps) < DEPTH + 1 for steps in rec.steps.values())  # dead lanes left


def _nudged(recorded, field, how, bounce=1):
    """A copy of the record with one lane's ``field`` changed at ``bounce``;
    returns (copy, lane)."""
    key = sorted(k for k, steps in recorded.steps.items()
                 if bounce in steps and steps[bounce]["state"]["active"])[3]
    other = copy.deepcopy(recorded)
    state = other.steps[key][bounce]["state"]
    state[field] = how(np.array(state[field]))
    return other, key


def _ulps_up(n):
    def up(a):
        for _ in range(n):
            a[0] = np.nextafter(a[0], np.float32(np.inf), dtype=np.float32)
        return a
    return up


@pytest.mark.parametrize("field, how, kind, ulps, cls", [
    ("direction", _ulps_up(1), "float", 1, "i"),
    ("direction", _ulps_up(4), "float", 4, "i"),
    ("direction", _ulps_up(5), "float", 5, "ii"),
    ("throughput", lambda a: np.full_like(a, np.nan), "nonfinite", None, "ii"),
    ("seed", lambda a: a + 1, "exact", None, "ii"),
    ("active", lambda a: ~a, "exact", None, "ii"),
])
def test_a_nudged_lane_is_found_and_classed(recorded, field, how, kind, ulps, cls):
    other, key = _nudged(recorded, field, how)
    diffs = ld.compare(recorded, other)
    assert diffs == {key: {"bounce": 1, "field": field, "kind": kind, "ulps": ulps}}
    assert ld.classify(diffs[key]) == cls
    # where an op was looked for, none found is a fault; one found is judged
    # by the difference at its output
    assert ld.classify(diffs[key], op=None, attributed=True) == "ii"
    for op_ulps in (1, 4, 5):
        want = "i" if kind == "float" and op_ulps <= 4 else "ii"
        assert ld.classify(diffs[key], "rsqrt", True, op_ulps) == want


@pytest.mark.parametrize("diff", [
    {"bounce": 0, "field": "direction"}, {"bounce": 1, "field": "direction"},
    {"bounce": 2, "field": "throughput"}, {"bounce": 1, "field": "tri"},
    {"bounce": 1, "field": "t"}, {"bounce": "end", "field": "value"},
    {"bounce": "end", "field": "radiance"},
])
def test_each_replayed_step_gives_the_recorded_value(cornell, recorded, diff):
    key = sorted(k for k, steps in recorded.steps.items() if len(steps) == DEPTH + 1)[0]
    run, want = ld._step_runner(recorded, key, diff, FRAME)
    with torch.inference_mode():
        assert ld.field_difference(diff["field"], run(cornell), want) is None
    res = ld.attribute(cornell, cornell, recorded, recorded, key,
                       {**diff, "kind": "float", "ulps": 1}, FRAME)
    assert res == {"op": None, "op_ulps": None, "ops_differing": {}, "wave_dependent": False}


class _SimulatedCard(ld.AgainstCPU):
    """CPU tensors stand in for the card's, and the stand-in CPU rounds
    ``rsqrt`` one ulp up."""

    @staticmethod
    def _on_card(x):
        return isinstance(x, torch.Tensor)

    @staticmethod
    def _reference(func, args, kwargs):
        out = func(*args, **kwargs)
        if func.overloadpacket.__name__ == "rsqrt":
            out = torch.nextafter(out, torch.full_like(out, np.inf))
        return out


def test_the_dispatch_mode_names_the_op_and_substitutes_it():
    x = torch.as_tensor(np.random.default_rng(0).uniform(1e-3, 10.0, 64).astype(np.float32))

    def f(a):
        return a * torch.rsqrt(a * a + 1.0)

    plain = f(x)
    with _SimulatedCard(check=True) as mode:
        checked = f(x)
    assert mode.differ == {"rsqrt": 1}
    assert torch.equal(checked, plain)  # the card's own values
    with _SimulatedCard(check=False, substitute=["rsqrt"]):
        swapped = f(x)
    inv = torch.rsqrt(x * x + 1.0)
    assert torch.equal(swapped, x * torch.nextafter(inv, torch.full_like(inv, np.inf)))
    acc = torch.zeros(64)
    with _SimulatedCard(check=True, substitute=["add_"]) as mode:
        acc.add_(x)
    assert mode.differ == {} and torch.equal(acc, x)


def test_field_difference_counts_ulps_across_zero():
    tiny = np.float32(1e-45)
    assert ld.field_difference("t", np.float32(0.0), np.float32(-0.0)) == {"kind": "float",
                                                                            "ulps": 0}
    assert ld.field_difference("t", tiny, -tiny)["ulps"] == 2
    assert ld.field_difference("t", np.float32(np.inf), np.float32(1.0))["kind"] == "nonfinite"
    assert ld.field_difference("tri", np.int32(3), np.int32(3)) is None


def test_the_tool_runs_without_jax_and_refuses_a_missing_card():
    code = ("import sys; sys.path.insert(0, 'tools'); import torch_lane_diff as ld; "
            "ld.main(['--scene', 'cornell', '--device', 'cpu']); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vulkan_raytracer_tpu')); print('IMPORTED', bad)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "IMPORTED []" in proc.stdout and '"differing_lanes": 0' in proc.stdout
    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, "tools/torch_lane_diff.py", "--scene", "cornell"],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0 and "needs an NVIDIA card" in proc.stderr


def test_two_uploads_compare_without_hit_ids():
    """The smoke's gallery (a small dragon) instanced against flattened on
    the CPU: every differing lane's first difference is found in a field
    other than the hit id, whose encodings differ by design."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    res = ld.compare_uploads(cs.gallery_scene(detail=16, n_dragons=4), cs.gallery_camera(4),
                             24, 24, SPP, DEPTH, "cpu")
    assert res["rays"][0] > 24 * 24 * SPP and res["rmse"] < 1e-3
    assert res["differing_pixels"] > 0 and len(res["lanes"]) == res["differing_lanes"]
    assert all(lane["field"] != "tri" for lane in res["lanes"])
    assert sum(res["by_field"].values()) == res["differing_lanes"]


def test_upload_check_passes_and_catches_a_wrong_transform():
    """The smoke's instanced_vs_flattened check on a small gallery on the
    CPU: the two uploads' first hits agree lane by lane and their images
    within the bar; the first dragon moved by 1e-4 in the instanced upload
    alone fails on the first hits' t, though its image still passes."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    def check(shift):
        return ld.check_uploads(cs.gallery_scene(detail=16, n_dragons=4), cs.gallery_camera(4),
                                "cpu", frame=(24, 2, 2), shift=shift)

    ok = check(0.0)
    assert ok["ok"] and ok["first_hits"]["hits"] > 0 and ok["first_hits"]["faults"] == 0
    assert ok["first_hits"]["same_triangle"] == ok["first_hits"]["hits"]
    wrong = check(1e-4)
    assert not wrong["ok"] and wrong["image_ok"]
    assert wrong["first_hits"]["t_ulps_over_bound"] > 0 and wrong["first_hits"]["faults"] > 0
