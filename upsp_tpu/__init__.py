"""upsp_tpu — a JAX unsteady pressure-sensitive-paint (uPSP) engine.

A from-scratch JAX/XLA re-design of the capabilities of NASA's
``upsp-processing`` pipeline.  High-speed video of a
painted wind-tunnel model goes in; surface-pressure (delta-Cp) time histories on
a 3D model grid come out.

Layer map (a re-design, not a port):

- :mod:`upsp_tpu.io`        — grid / targets / video / config file formats (host side)
- :mod:`upsp_tpu.geometry`  — triangle soup, normals, BVH build (host), k-d queries
- :mod:`upsp_tpu.camera`    — pinhole+distortion model, pose solves, bundle adjustment
- :mod:`upsp_tpu.ops`       — jitted device ops: raycast, registration (ECC),
  patching, projection, detrend, detection, sub-pixel localization
- :mod:`upsp_tpu.pipeline`  — phase0/phase1/phase2 orchestration (the psp_process
  equivalent), fused per-frame XLA program
- :mod:`upsp_tpu.parallel`  — device mesh, shardings, the frames<->nodes reshard
  that replaces the reference's MPI global transpose
- :mod:`upsp_tpu.processing`— batch tree generation, kulite comparison utilities
"""

__version__ = "0.1.0"
