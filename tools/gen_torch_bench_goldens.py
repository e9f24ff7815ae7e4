#!/usr/bin/env python
"""Write bench_goldens_torch.npz: the oracle crop of the built-in Cornell box
for the gate of ``vulkan_raytracer_tpu_torch/bench.py``'s cfg1.

``bench_goldens.npz`` (``tools/gen_bench_goldens.py``) holds cfg1's golden of
the reference renderer's ``res/CornellBox.gltf``; a checkout without that
file renders the built-in box, whose golden is this one.  The crop (48x48,
4 spp, depth 3 at cfg1's camera) is rendered by the JAX package's NumPy
oracle on the CPU and stored under ``golden_<key>`` with the gate's
fingerprint under ``fp_<key>``, for the key
``cfg1_cornell_builtin_512x512_d4_64spp``.  The fingerprint is the JAX
bench's digest of the JAX upload, and the port's digest of its own upload
must be the same string: the tool refuses to write otherwise.

Usage: python tools/gen_torch_bench_goldens.py   (about a minute on the CPU)
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("VKRT_LOG_LEVEL", "ERROR")

import numpy as np  # noqa: E402

import bench as jbench  # noqa: E402
from vulkan_raytracer_tpu.render import oracle  # noqa: E402
from vulkan_raytracer_tpu.scene.builtin import cornell_box_scene as j_cornell  # noqa: E402
from vulkan_raytracer_tpu_torch import bench as tbench  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene as t_cornell  # noqa: E402

KEY = "cfg1_cornell_builtin_512x512_d4_64spp"


def main() -> None:
    cfg = tbench.CONFIGS[-1]
    assert cfg["key"].format(src="builtin") == KEY
    cw, cspp, cdepth = cfg["crop"]
    t0 = time.time()
    jtables = j_cornell().upload()
    fp = jbench.gate_fingerprint(jtables, jbench._cam(*cfg["cam"]), cw, cspp, cdepth)
    fp_port = tbench.gate_fingerprint(t_cornell().upload("cpu"), tbench._cam(*cfg["cam"]),
                                      cw, cspp, cdepth)
    if fp_port != fp:
        raise SystemExit(f"the port's gate fingerprint {fp_port} differs from the JAX "
                         f"bench's {fp}")
    img = oracle.render_image(jtables, jbench._cam(*cfg["cam"]), cw, cw, spp=cspp,
                              max_depth=cdepth)
    np.savez_compressed(tbench.GOLDENS_TORCH, **{f"golden_{KEY}": np.asarray(img, np.float32),
                                                 f"fp_{KEY}": np.str_(fp)})
    print(f"{KEY}: {cw}x{cw} {cspp}spp d{cdepth} oracle crop in {time.time() - t0:.1f}s, "
          f"fingerprint {fp}")
    print(f"wrote {tbench.GOLDENS_TORCH} ({os.path.getsize(tbench.GOLDENS_TORCH)} bytes)")


if __name__ == "__main__":
    main()
