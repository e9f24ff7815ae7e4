"""The benchmark of ``vulkan_raytracer_tpu_torch`` on one NVIDIA card.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` renders one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything a cell is made of is found by name: its configuration in
``configs/<config>.json`` (the scene module ``scenes/<scene>.py``, the
camera), its traffic in ``traffic/<traffic>.json``, its limits of the
output comparison in ``limits/<cell>.json`` and each per-layer metric's
reader in ``metrics/<metric>.py``.
"""
