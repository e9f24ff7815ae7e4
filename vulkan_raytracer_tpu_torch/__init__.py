"""vulkan_raytracer_tpu_torch — the path tracer ported to PyTorch and CUDA.

A second package beside :mod:`vulkan_raytracer_tpu` (the JAX reference),
with the same sub-package layout so every module's counterpart sits at the
same path there:

* ``ops/`` — vector math, the shader RNG, the BSDF, texture sampling and the
  dense ray/triangle sweeps; the sweeps launch hand-written CUDA kernels
  (``csrc/dense_sweep.cu``) on CUDA tensors and run their plain PyTorch
  versions on CPU tensors;
* ``scene/`` — the host scene graph and the flat upload to
  :class:`~vulkan_raytracer_tpu_torch.scene.scenegraph.SceneTables`;
* ``render/`` — the wavefront integrator and the headless renderer.

The package imports ``torch`` and never ``jax``.  It reuses the JAX
package's numpy-only modules (``scene.camera``, ``utils.image``,
``utils.logging``, ``render.oracle``).
"""

__version__ = "0.1.0"
