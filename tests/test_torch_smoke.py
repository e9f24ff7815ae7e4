"""The host side of ``chip_smoke.py``: its ptxas parsing, its bounds and its
refusal to run without a card.  The card-side phases run only on the card
(``python3 chip_smoke.py``)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

REPORT = """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N_bvh_walk_cu19treelet_walk_kernelILb1EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N_bvh_walk_cu19treelet_walk_kernelILb1EEEv
    16 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 16 bytes cumulative stack size, 3456 bytes smem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N_dense_sweep_cu14closest_kernelEPKfi' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N_dense_sweep_cu14closest_kernelEPKfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 9216 bytes smem
"""


def test_ptxas_table_reads_each_variant():
    assert cs.ptxas_table(REPORT) == {
        "treelet_walk_shadow": {"stack_frame": 16, "spill_stores": 16, "spill_loads": 12,
                                "registers": 64},
        "dense_closest": {"stack_frame": 0, "spill_stores": 0, "spill_loads": 0,
                          "registers": 40},
    }


@pytest.mark.parametrize("ops, nbytes, by", [(67e9, 1e6, "operations"), (1e6, 3.35e9, "bytes")])
def test_bound_is_the_larger_of_the_two_times(ops, nbytes, by):
    b = cs.bound(ops, nbytes)
    assert b["bound_by"] == by and b["bound_ms"] == pytest.approx(1.0)


def test_smoke_refuses_to_run_without_a_card():
    """Without CUDA the smoke exits nonzero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke would run in full")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert not any(line.startswith("{") and '"ok"' in line for line in proc.stdout.splitlines())
    assert "CUDA is not available" in proc.stderr
    with pytest.raises(json.JSONDecodeError):
        json.loads(proc.stdout or "not json")


@pytest.mark.parametrize("share", cs.LIVE_SHARES)
def test_live_mask_has_the_share_and_the_edge_blocks(share):
    n = 1 << 14
    live = cs.live_mask(n, share, seed=3)
    if share == "one":
        assert live.sum() == 1
    elif share in (0.0, 1.0):
        assert live.sum() == share * n
    else:
        assert live[768:1024].all() and not live[1024:1280].any()
        rest = np.concatenate([live[:768], live[1280:]])
        sigma = (share * (1 - share) * rest.size) ** 0.5
        assert abs(rest.sum() - share * rest.size) < 5 * sigma + 1


@pytest.mark.parametrize("kernel", ["dense_closest", "dense_shadow", "dense_emissive_pdf"])
def test_sweep_work_counts_the_live_lanes_tests(kernel):
    """The bound's operations and bytes, against a count made one triangle
    at a time: every live lane tests every triangle (closest, pdf) or up to
    its first hit (occlusion), a test costing 28 operations where it stops
    at u and 54 where it runs through (no det of these rays is near 0); a
    pdf hit adds its weighted term."""
    from vulkan_raytracer_tpu_torch.ops import dense
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    tables = cornell_box_scene().upload("cpu")
    n = 512
    rays = cs.make_rays(n, seed=5, device="cpu")
    cols = dense.ray_columns(rays["o"], rays["d"])
    live = rays["active"]
    table = tables.em_table if kernel == "dense_emissive_pdf" else tables.tri_table
    n_t = table.shape[1]
    if kernel == "dense_closest":
        args = (table, cols, rays["t_min"], torch.where(live, rays["t_max"], 0.0))
        live = args[3] > args[2]
    elif kernel == "dense_shadow":
        args = (table, cols, torch.where(live, rays["t_shadow"], 0.0))
    else:
        args = (table, cols, live.float(), cs.EPS)
    n_live = int(live.sum())
    d = np.stack([c.numpy() for c in cols[3:]], 1).astype(np.float64)

    ops = torch.zeros(n, dtype=torch.int64)
    done = ~live
    stops = {28: 0, 54: 0}
    hits = 0
    for j in range(n_t):
        inside, u, _, t = dense.mt([table[k, j] for k in range(9)], list(cols))
        e1, e2 = table[3:6, j].double().numpy(), table[6:9, j].double().numpy()
        assert (np.abs(np.cross(d, e2) @ e1) > 1e-9).all()
        test = torch.where((u >= 0.0) & (u <= 1.0), 54, 28)
        for k in stops:
            stops[k] += int((~done & (test == k)).sum())
        ops += torch.where(done, 0, test)
        if kernel == "dense_shadow":
            done = done | (inside & (t > 0.0) & (t <= args[2]))
        elif kernel == "dense_emissive_pdf":
            hits += int((live & inside & (t > cs.EPS)).sum())
    assert stops[28] > 0 and stops[54] > 0
    ops = int(ops.sum()) + (cs.PDF_OPS - cs.MT_OPS) * hits
    nbytes = {"dense_closest": 16 * n, "dense_shadow": 8 * n, "dense_emissive_pdf": 8 * n}[kernel]
    nbytes += 24 * n_live + (80 if kernel == "dense_emissive_pdf" else 36) * n_t
    if kernel == "dense_emissive_pdf":
        assert hits > 0
    work = cs.sweep_work(kernel, args)
    assert (work["rays"], work["triangles"], work["live"]) == (n, n_t, n_live)
    assert work["ops"] == ops and work["bytes"] == nbytes


def test_mt_ops_stops_where_the_dense_test_stops():
    """One triangle in the plane z = 1 against four rays: parallel to it (det
    0: 16 operations), hitting its plane at u = 2.75 (28), inside it (54) and
    at u = 0.55, v = -0.1, a miss that the test only finds after u (54)."""
    from vulkan_raytracer_tpu_torch.ops import dense

    v0, v1, v2 = np.float32([[-1, -1, 1], [1, -1, 1], [0, 1, 1]])
    table = torch.as_tensor(np.concatenate([v0, v1 - v0, v2 - v0])[:, None, None].copy())
    o = np.float32([[0, 0, 3], [5, 0, 3], [0, 0, 3], [0, -1.2, 3]])
    d = np.float32([[1, 0, 0], [0, 0, -1], [0, 0, -1], [0, 0, -1]])
    rays = [torch.as_tensor(c.copy()) for c in (*o.T, *d.T)]
    ops, inside, _ = cs.mt_ops(table, rays)
    assert ops[0].tolist() == [cs.MT_DET_OPS, cs.MT_U_OPS, cs.MT_OPS, cs.MT_OPS] == [16, 28, 54, 54]
    assert inside[0].tolist() == [False, False, True, False]
    assert dense.mt([table[k, 0] for k in range(9)], rays)[0].tolist() == inside[0].tolist()


def test_gallery_is_instanced_by_auto_and_has_both_kinds_of_group():
    """The smoke's gallery: at full size ``upload(instancing="auto")`` keeps
    instances (16.8 M flattened triangles, 64 copies of one mesh); a small
    variant still has a BLAS group (the dragon, above DENSE_MAX_TRIS) and
    dense groups (the floor, the panels), and its rays reach all of them."""
    from vulkan_raytracer_tpu_torch.ops import dense

    full = cs.gallery_scene()
    assert full._should_instance("auto")
    tris = [p.indices.shape[0] // 3 for _n, p in full._iter_instances()]
    assert len(tris) == 67 and sum(tris) == 64 * 262144 + 2 + 4
    assert len({id(p) for _n, p in full._iter_instances()}) == 3

    small = cs.gallery_scene(detail=130, n_dragons=3)
    assert not small._should_instance("auto")  # 202,806 triangles: flattening is fine
    tables = small.upload("cpu", instancing=True)
    groups = tables.inst.groups
    assert groups[0].tri_cnt == 4 * 130 * 130 > dense.DENSE_MAX_TRIS
    assert groups[0].pblas is not None and groups[0].pblas.n_treelets > 1
    assert groups[0].table is None and groups[0].inv.shape[0] == 3
    assert [g.tri_cnt for g in groups[1:]] == [2, 2]
    assert all(g.pblas is None and g.table.shape == (9, 2) for g in groups[1:])
    assert tables.num_emissive_tris == 4 and tables.inst.num_instances == 6
    rays = cs.gallery_rays(512, 3, seed=1, device="cpu")
    from vulkan_raytracer_tpu_torch.ops import instanced

    _, enc, _, _ = instanced.instanced_closest(tables, rays["o"], rays["d"], t_min=rays["t_min"],
                                               t_max=rays["t_max"], active=rays["active"])
    pti, _ = tables.inst.decode(enc[enc >= 0])
    assert (pti < groups[0].tri_cnt).any() and (pti >= groups[0].tri_cnt).any()
    assert not (enc[~rays["active"]] >= 0).any()
    pos, direction = cs.gallery_camera(3)
    assert pos[1] > 0 and direction[2] < 0


def test_alpha_gallery_is_instanced_and_rejects_alpha_candidates():
    """The smoke's instanced alpha scene: shared MASK and BLEND quads, a
    backdrop and a light, uploaded instanced; from its camera the resample
    loop rejects candidates (more passes than calls) and the frame is lit."""
    from vulkan_raytracer_tpu_torch.render import integrator
    from vulkan_raytracer_tpu_torch.render.renderer import render_image
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    tables = cs.alpha_gallery_scene().upload("cpu", instancing=True)
    assert tables.has_alpha and tables.has_blend and tables.has_textures
    assert tables.inst.num_instances == 22 and len(tables.inst.groups) == 4
    integrator.reset_alpha_loop()
    cam = Camera(position=np.array(cs.TEXTURED_CAM[0]), direction=np.array(cs.TEXTURED_CAM[1]))
    img, _ = render_image(tables, cam, 16, 16, 2, max_depth=3, tonemap=False)
    assert np.isfinite(img).all() and img.mean() > 1e-3
    loop = integrator.ALPHA_LOOP
    assert loop["iterations"] > loop["calls"] > 0 and loop["max"] >= 2


def test_smi_samples_and_busy_window():
    """The fleet phase's utilization samples: nvidia-smi's lines parsed to
    wall-clock seconds, a cut line skipped, the mean taken in a window."""
    from datetime import datetime

    text = ("2026/10/16 22:40:01.000, 20\n2026/10/16 22:40:01.100, 40\n"
            "2026/10/16 22:40:01.200, 90\n2026/10/16 22:40:0")
    samples = cs.smi_samples(text)
    t0 = datetime(2026, 10, 16, 22, 40, 1).timestamp()
    assert [u for _, u in samples] == [20.0, 40.0, 90.0]
    assert abs(samples[1][0] - (t0 + 0.1)) < 1e-6
    smi = cs.SmiSampler()
    smi.samples = samples
    assert smi.busy(t0, t0 + 0.15) == 30.0
    assert smi.busy(t0 + 5, t0 + 6) is None


def test_parity_reports_lanes_and_fails_on_a_fault(monkeypatch):
    """The card-against-CPU check (here the CPU against itself): its RMSE bar
    and ray check, the lanes' counts by class, bounce, field and op; then a
    class ii lane from the lane tool fails it."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_lane_diff

    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    tables = cornell_box_scene().upload("cpu")
    res = cs._cuda_vs_cpu(tables, cs.CFG1_CAM, "cornell", size=8)
    assert res["rmse"] == 0.0 and res["rays_cuda"] == res["rays_cpu"]
    assert (res["differing_pixels"], res["lanes_by_class"]) == (0, {"i": 0, "ii": 0})
    assert res["first_bounce"] == res["lanes_by_op"] == {} and res["bar"] == cs.RMSE_BAR
    diagnose = torch_lane_diff.diagnose

    def with_fault(*args, **kwargs):
        out = diagnose(*args, **kwargs)
        lane = {"pixel": 3, "sample": 1, "bounce": 1, "field": "seed", "kind": "exact",
                "ulps": None, "class": "ii"}
        return {**out, "lanes": [lane], **torch_lane_diff.summarise([lane])}

    monkeypatch.setattr(torch_lane_diff, "diagnose", with_fault)
    with pytest.raises(AssertionError, match="1 lanes of class ii"):
        cs._cuda_vs_cpu(tables, cs.CFG1_CAM, "cornell", size=8)
