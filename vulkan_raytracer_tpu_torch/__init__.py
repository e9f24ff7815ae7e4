"""vulkan_raytracer_tpu_torch — the path tracer ported to PyTorch and CUDA.

A second package beside :mod:`vulkan_raytracer_tpu` (the JAX reference),
with the same sub-package layout so every module's counterpart sits at the
same path there:

* ``ops/`` — vector math, the shader RNG, the BSDF, texture sampling, the
  dense ray/triangle sweeps and the threaded-BVH walks; the sweeps and walks
  launch hand-written CUDA kernels (``csrc/dense_sweep.cu``,
  ``csrc/bvh_walk.cu``) on CUDA tensors and run their plain PyTorch versions
  on CPU tensors;
* ``accel/`` — the host-side threaded-BVH build (NumPy, or the repository's
  native C++ builder through g++);
* ``scene/`` — the host scene graph, the built-in and procedural scenes and
  the flat upload to
  :class:`~vulkan_raytracer_tpu_torch.scene.scenegraph.SceneTables`;
* ``render/`` — the wavefront integrator and the headless renderer.

The package imports ``torch`` and never ``jax`` or the JAX package; the
numpy-only modules it needs are ported beside the rest.
"""

__version__ = "0.1.0"
