"""project3_cuda_path_tracer_tpu — a differentiable wavefront path tracer.

A JAX framework with the full capability surface of the CIS565 CUDA path
tracer: wavefront Monte Carlo rendering (camera ray generation, scene
intersection, BSDF shading), stream compaction, material-sorted shading,
stochastic AA, thin-lens depth of field, motion blur, OBJ meshes with an
8-wide BVH (a CUDA traversal kernel on NVIDIA GPUs), textures + HDR
environment lighting, progressive accumulation, PNG/HDR output — plus
end-to-end differentiability and multi-device sharding that the reference
lacks.

Quick start:
    from project3_cuda_path_tracer_tpu import load_scene, Renderer
    scene = load_scene("scenes/cornell.txt")
    r = Renderer(scene)
    accum = r.render(num_iterations=100)
    r.save(accum, 100)
"""
from .scene.parser import load_scene  # noqa: F401
from .scene import types as scene_types  # noqa: F401
from .render.integrator import Renderer, render_samples  # noqa: F401

__version__ = "0.1.0"
