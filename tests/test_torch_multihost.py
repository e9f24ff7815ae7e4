"""The port's fleet layer (``parallel/multihost.py``) in one process and in a
real two-process gloo fleet on the CPU.

In one process (no process group) the contracts of tests/test_multihost.py:
the broadcast is the identity, the fleet mesh is this process's devices, the
fleet render is the sharded render, and a gather hook that is not the default
carries the same bytes.  Then two processes form a gloo group over localhost
(the worker is this file run as a script): rank 1 perturbs its tables, the
broadcast repairs them, and both ranks must return the same image, equal to
the port's unsharded render within the sharding tolerance (rtol 1e-5 / atol
1e-6, tests/test_torch_sharding.py), with its ray count.  Last, a dead peer:
rank 1 exits before the broadcast, and rank 0 must raise within the group's
timeout and write no image (the contract of tests/test_multihost_2proc.py).
"""

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # a fleet worker: the package from this checkout
    sys.path.insert(0, str(ROOT))

from vulkan_raytracer_tpu_torch.parallel import multihost  # noqa: E402
from vulkan_raytracer_tpu_torch.parallel.multihost import (  # noqa: E402
    broadcast_scene_tables,
    is_io_host,
    make_fleet_mesh,
    render_image_multihost,
)
from vulkan_raytracer_tpu_torch.parallel.sharding import render_image_sharded  # noqa: E402
from vulkan_raytracer_tpu_torch.render.renderer import render_image  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.camera import Camera  # noqa: E402

FRAME = dict(width=24, height=16, spp=2, max_depth=2)
GROUP_TIMEOUT_S = 20
TOL = dict(rtol=1e-5, atol=1e-6)


def _cam():
    return Camera(position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0]))


@pytest.fixture(scope="module")
def tables():
    return cornell_box_scene().upload("cpu")


def test_broadcast_is_identity_single_process(tables):
    assert broadcast_scene_tables(tables) is tables
    assert is_io_host()


def test_fleet_mesh_covers_the_devices():
    assert make_fleet_mesh(["cpu"] * 4) == [torch.device("cpu")] * 4
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fleet_mesh()


def test_structure_sees_shapes_and_counts_not_values(tables):
    """The crc the ranks compare covers field names, shapes, dtypes and the
    counts and flags, not the values the broadcast then carries."""
    import dataclasses

    base = multihost._structure(tables)
    assert "tables.v0.x: torch.float32 (36,)" in base
    assert "tables.num_emissive_tris = 2" in base
    doubled = dataclasses.replace(tables, v0=tables.v0._replace(x=tables.v0.x * 2))
    assert multihost._structure(doubled) == base
    assert multihost._structure(dataclasses.replace(tables, has_alpha=True)) != base
    from vulkan_raytracer_tpu_torch.scene.scenegraph import Material

    other = cornell_box_scene()
    other.materials.append(Material())  # one more (unused) material row
    assert multihost._structure(other.upload("cpu")) != base


@pytest.mark.parametrize("cap", [None, 64], ids=["whole", "banded"])
def test_gather_hook_carries_identical_bytes(tables, cap):
    """A gather hook that is not the default takes the host path (scatter
    and tonemap on the host); the image must be the default's bit for bit,
    and the fleet render of one process the sharded render."""
    kw = dict(FRAME, mesh=["cpu"] * 4, tonemap=True, max_lanes_per_pass=cap)
    img_d, rays_d = render_image_sharded(tables, _cam(), **kw)
    seen = []

    def gather(block):
        seen.append(tuple(block.shape))
        return block.numpy().copy()

    img_g, rays_g = render_image_sharded(tables, _cam(), gather=gather, **kw)
    assert seen == [(24 * 16, 3)]
    np.testing.assert_array_equal(img_g, img_d)
    assert rays_g == rays_d
    img_m, rays_m = render_image_multihost(tables, _cam(), **FRAME, mesh=["cpu"] * 4)
    img_t, _ = render_image_sharded(tables, _cam(), **FRAME, mesh=["cpu"] * 4)
    np.testing.assert_array_equal(img_m, img_t)
    assert rays_m == rays_d


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fleet(tmp_path, die_early: bool):
    """Start two workers; returns (their return codes, logs, output paths,
    seconds until both ended)."""
    port = _free_port()
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(port), str(outs[r]), str(int(die_early))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], logs, outs, time.perf_counter() - t0


def test_two_process_fleet_matches_single_process(tmp_path, tables):
    rcs, logs, outs, _ = _fleet(tmp_path, die_early=False)
    for r in range(2):
        assert rcs[r] == 0, f"rank {r} failed:\n{logs[r][-3000:]}"
    a, b = (np.load(o) for o in outs)
    np.testing.assert_array_equal(a["img"], b["img"])
    assert int(a["rays"]) == int(b["rays"])
    assert a["v0x_sum"] == b["v0x_sum"] == float(tables.v0.x.sum())  # rank 1 repaired
    img_1, rays_1 = render_image(tables, _cam(), **FRAME, tonemap=False)
    np.testing.assert_allclose(a["img"], img_1, **TOL)
    assert int(a["rays"]) == rays_1
    assert img_1.mean() > 1e-3


def test_fleet_detects_dead_peer_without_hanging(tmp_path):
    """Rank 1 exits after the group formed, before any collective: rank 0's
    broadcast must raise, within the group timeout, and write no image."""
    rcs, logs, outs, seconds = _fleet(tmp_path, die_early=True)
    assert rcs[1] == 17, logs[1][-2000:]  # the injected exit
    assert rcs[0] != 0, logs[0][-2000:]
    assert "RuntimeError" in logs[0] and "broadcast_scene_tables" in logs[0], logs[0][-2000:]
    assert not outs[0].exists() and not outs[1].exists()
    assert seconds < GROUP_TIMEOUT_S + 60, seconds


def _worker(rank: int, port: int, out: str, die_early: bool) -> None:
    """One rank of a two-process fleet on the CPU: form the group, perturb
    rank 1's tables, broadcast, render two CPU shards a rank."""
    import dataclasses

    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        assert is_io_host() == (rank == 0)
        if die_early and rank == 1:
            os._exit(17)
        tables = cornell_box_scene().upload("cpu")
        if rank == 1:
            # diverge this rank's scene: double one float column, and build
            # the cached sweep table from it, which must not survive
            tables = dataclasses.replace(tables, v0=tables.v0._replace(x=tables.v0.x * 2))
            assert tables.tri_table is not None
        tables = broadcast_scene_tables(tables)
        mesh = make_fleet_mesh(["cpu", "cpu"])
        assert len(mesh) == 4
        img, rays = render_image_multihost(tables, _cam(), **FRAME, mesh=mesh, tonemap=False)
        np.savez(out, img=img, rays=rays, v0x_sum=float(tables.v0.x.sum()))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4] == "1")
