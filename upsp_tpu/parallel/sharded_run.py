"""Sharded datapoint processing: the full phase1 -> transpose -> phase2 plan.

One jitted program over the device mesh:

  frames (F, C, H, W)  [frame-sharded]
    -> lax.map(fused per-frame step)        phase 1, data-parallel over frames
    -> avg/rms reductions                   (the reference's MPI_Reduce)
    -> (N, F) reshard via all-to-all        (the reference's global_transpose)
    -> phase-2 conversion                   node-parallel
  outputs: pressure_transpose (node-sharded), per-node stats (replicated-ish)

Used by run_datapoint for multi-device execution and by the multi-chip dry run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from upsp_tpu.ops.polyfit import PolyDetrender
from upsp_tpu.ops.projection import coverage as proj_coverage
from upsp_tpu.parallel.mesh import FRAMES_AXIS, frame_sharding, node_sharding, pad_to_multiple
from upsp_tpu.pipeline.phase1 import make_frame_processor
from upsp_tpu.pipeline.phase2 import Phase2Constants, phase2_convert


class ShardedOutputs(NamedTuple):
    intensity: jax.Array  # (F, N) frame-sharded
    sol_avg: jax.Array  # (N,)
    sol_rms: jax.Array  # (N,)
    pressure_transpose: jax.Array  # (N, F) node-sharded
    rms: jax.Array
    avg: jax.Array
    gain: jax.Array


def make_sharded_pipeline(
    state,
    mesh: Mesh,
    const: Phase2Constants,
    det: PolyDetrender,
    steady: jax.Array,
    model_temp: jax.Array,
    coverage: jax.Array,
):
    """Build the jitted full-pipeline function frames -> ShardedOutputs."""
    step = make_frame_processor(state)
    f_sh = frame_sharding(mesh)
    n_sh = node_sharding(mesh)

    @jax.jit
    def pipeline(frames: jax.Array) -> ShardedOutputs:
        frames = jax.lax.with_sharding_constraint(frames, f_sh)
        intensity = jax.lax.map(step, frames)  # (F, N)
        intensity = jax.lax.with_sharding_constraint(intensity, f_sh)

        # frame-axis reductions (psum over the mesh under the hood)
        avg = jnp.nanmean(intensity, axis=0)
        rms = jnp.sqrt(jnp.nanmean(intensity * intensity, axis=0))

        # the global transpose: frames-major -> node-major (one all-to-all)
        it = jax.lax.with_sharding_constraint(intensity.T, n_sh)

        out2 = phase2_convert(it, avg, coverage, steady, model_temp, const, det)
        return ShardedOutputs(
            intensity=intensity,
            sol_avg=avg,
            sol_rms=rms,
            pressure_transpose=out2.pressure_transpose,
            rms=out2.rms,
            avg=out2.avg,
            gain=out2.gain,
        )

    return pipeline


def run_sharded(
    state,
    frames: np.ndarray,  # (F, C, H, W)
    cond,
    pcal,
    mesh: Optional[Mesh] = None,
    degree: int = 6,
    steady: Optional[np.ndarray] = None,
    model_temp: Optional[np.ndarray] = None,
) -> ShardedOutputs:
    """Convenience driver: shard, run the full plan, return device outputs.

    NOTE: builds (and compiles) a fresh pipeline closure per call; for repeated
    runs over the same Phase0State, build once with make_sharded_pipeline and
    reuse it.
    """
    from upsp_tpu.io.wtd import model_temperature
    from upsp_tpu.ops.polyfit import make_detrender
    from upsp_tpu.parallel.mesh import make_mesh
    from upsp_tpu.pipeline.phase2 import make_phase2_constants

    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    n_nodes = state.model.size

    frames_j, n_orig = pad_to_multiple(jnp.asarray(frames), 0, n_dev)
    if frames_j.shape[0] != frames.shape[0]:
        # pad with copies of the final frame so statistics need no masking of
        # invalid data (the driver trims outputs back to n_orig)
        pad = frames_j.shape[0] - n_orig
        frames_j = jnp.concatenate(
            [jnp.asarray(frames)] + [jnp.asarray(frames[-1:])] * pad, axis=0
        )
    frames_j = jax.device_put(frames_j, frame_sharding(mesh))

    const = make_phase2_constants(pcal, cond)
    det = make_detrender(int(frames_j.shape[0]), degree)
    cov = np.asarray(proj_coverage(state.projections, *state.image_hw))[
        state.model.superseded_by
    ]
    if steady is None:
        steady = np.zeros(n_nodes, np.float32)
    if model_temp is None:
        t = model_temperature(cond)
        model_temp = np.full(n_nodes, t, np.float32)

    n_sh = node_sharding(mesh)
    fn = make_sharded_pipeline(
        state, mesh, const, det,
        jax.device_put(jnp.asarray(steady), n_sh),
        jax.device_put(jnp.asarray(model_temp), n_sh),
        jax.device_put(jnp.asarray(cov), n_sh),
    )
    return fn(frames_j)
