"""Phase 2: intensity ratio -> detrend -> paint gain -> delta-Cp.

The reference's per-node OpenMP loop with a QR polyfit per node
(psp_process.cpp:2263-2622 — studied, not copied) becomes a handful of batched
matmuls/elementwise ops over the node-sharded (nodes, frames) block:

    ratio  = Iref_avg / I                       (Iref = frame-mean intensity)
    fit    = ratio @ detrend projector          (degree-6, one matmul)
    gain   = a + bT + cT^2 + (d + eT + fT^2) * (qbar * Cp_steady + ps)
    dP     = (ratio - fit) * gain               (psi)
    dCp    = dP * 144 / qbar

Nodes with zero coverage carry NaN throughout, exactly like the reference's
skip_fit path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from upsp_tpu.io.paint import PaintCalibration
from upsp_tpu.parallel.mesh import fetch_global
from upsp_tpu.io.wtd import TunnelConditions, model_temperature
from upsp_tpu.ops.polyfit import PolyDetrender, detrend, make_detrender

import logging

log = logging.getLogger("upsp_tpu")


class Phase2Constants(NamedTuple):
    """Scalar physics inputs, device-ready."""

    paint: jax.Array  # (6,) a..f
    qbar: jax.Array  # ()
    ps: jax.Array  # ()


class Phase2Outputs(NamedTuple):
    pressure_transpose: jax.Array  # (nodes, frames) delta-Cp
    rms: jax.Array  # (nodes,)
    avg: jax.Array  # (nodes,)
    gain: jax.Array  # (nodes,)
    # inputs surfaced for the steady_state / model_temp output files
    # (psp_process.cpp:2567-2588); None when the caller supplies its own
    steady_state: jax.Array = None  # (nodes,) steady Cp
    model_temp: jax.Array = None  # (nodes,) degF


def make_phase2_constants(
    pcal: PaintCalibration, cond: TunnelConditions
) -> Phase2Constants:
    return Phase2Constants(
        paint=jnp.asarray(pcal.coefficients()),
        qbar=jnp.asarray(cond.qbar, jnp.float32),
        ps=jnp.asarray(cond.ps, jnp.float32),
    )


@jax.jit
def paint_gain(paint: jax.Array, T: jax.Array, Pss: jax.Array) -> jax.Array:
    a, b, c, d, e, f = (paint[i] for i in range(6))
    return a + b * T + c * T * T + (d + e * T + f * T * T) * Pss


@jax.jit
def phase2_convert(
    intensity_transpose: jax.Array,  # (nodes_shard, F)
    sol_avg: jax.Array,  # (nodes_shard,) frame-mean intensity (Iref)
    coverage: jax.Array,  # (nodes_shard,)
    steady_cp: jax.Array,  # (nodes_shard,) steady Cp
    model_temp: jax.Array,  # (nodes_shard,) degF
    const: Phase2Constants,
    det: PolyDetrender,
) -> Phase2Outputs:
    """The full node-block conversion; everything fuses into one XLA program."""
    covered = coverage > 0

    Pss = const.qbar * steady_cp + const.ps
    gain = paint_gain(const.paint, model_temp, Pss)
    gain = jnp.where(covered, gain, jnp.nan)

    ratio = sol_avg[:, None] / intensity_transpose  # Iref / I
    resid = detrend(det, ratio)  # ratio - polynomial fit
    dP = resid * gain[:, None]  # psi
    dCp = dP * (144.0 / const.qbar)
    dCp = jnp.where(covered[:, None], dCp, jnp.nan)

    avg = jnp.where(covered, jnp.mean(dCp, axis=1), jnp.nan)
    rms = jnp.where(covered, jnp.sqrt(jnp.mean(dCp * dCp, axis=1)), jnp.nan)
    return Phase2Outputs(pressure_transpose=dCp, rms=rms, avg=avg, gain=gain)


def compute_model_temperature(
    cfg, cond: TunnelConditions, n_nodes: int, model=None
) -> np.ndarray:
    """Per-node model temperature: file-based if configured, else recovery est.

    Mirrors psp_process.cpp:2315-2345: a PLOT3D scalar function file overrides
    the recovery-factor estimate; unstructured grids interpolate from the
    steady grid (inverse-distance, k-NN).
    """
    if getattr(cfg, "model_temp_p3d", ""):
        from upsp_tpu.io.plot3d import read_p3d_function

        temps = read_p3d_function(cfg.model_temp_p3d)
        if temps.shape[0] == n_nodes:
            return temps.astype(np.float32)
        if model is not None and getattr(cfg, "steady_grid", ""):
            from upsp_tpu.geometry.grids import load_model
            from upsp_tpu.pipeline.interpolate import idw_interpolate

            steady_model = load_model(cfg.steady_grid, tolerance=cfg.grid_tol)
            return idw_interpolate(
                steady_model.vertices, temps, model.vertices
            ).astype(np.float32)
        raise ValueError(
            f"model_temp file has {temps.shape[0]} values, expected {n_nodes}"
        )
    t = model_temperature(
        cond,
        recovery_factor=cfg.recovery_factor,
        gamma=cfg.gamma,
        f_to_r=cfg.f_to_r,
    )
    return np.full(n_nodes, t, np.float32)


def load_steady_cp(cfg, n_nodes: int, model=None) -> np.ndarray:
    """Steady-state Cp per node (zeros for wind-off runs)."""
    if cfg.wind_off or not cfg.steady_psp:
        return np.zeros(n_nodes, np.float32)
    from upsp_tpu.io.plot3d import read_p3d_function

    steady = read_p3d_function(cfg.steady_psp)
    if steady.shape[0] == n_nodes:
        return steady.astype(np.float32)
    if model is not None and cfg.steady_grid:
        from upsp_tpu.geometry.grids import load_model
        from upsp_tpu.pipeline.interpolate import idw_interpolate

        steady_model = load_model(cfg.steady_grid, tolerance=cfg.grid_tol)
        return idw_interpolate(
            steady_model.vertices, steady, model.vertices
        ).astype(np.float32)
    raise ValueError(
        f"steady file has {steady.shape[0]} values, expected {n_nodes}"
    )


def run_phase2(
    cfg,
    intensity_transpose: jax.Array,
    sol_avg: jax.Array,
    coverage: jax.Array,
    cond: TunnelConditions,
    pcal: PaintCalibration,
    model=None,
) -> Phase2Outputs:
    n_nodes, n_frames = intensity_transpose.shape
    const = make_phase2_constants(pcal, cond)
    det = make_detrender(n_frames, cfg.degree)
    steady = jnp.asarray(load_steady_cp(cfg, n_nodes, model))
    mtemp = jnp.asarray(compute_model_temperature(cfg, cond, n_nodes, model))
    out = phase2_convert(
        intensity_transpose, sol_avg, coverage, steady, mtemp, const, det
    )
    return out._replace(steady_state=steady, model_temp=mtemp)


def run_phase2_sharded(
    cfg,
    intensity: np.ndarray,  # (frames, nodes) frame-major, from phase 1
    sol_avg: np.ndarray,
    coverage: np.ndarray,
    cond: TunnelConditions,
    pcal: PaintCalibration,
    mesh,
    model=None,
) -> Phase2Outputs:
    """Phase 2 over the device mesh: the frames->nodes reshard happens ON
    DEVICE as one XLA all-to-all over ICI (the reference's global_transpose,
    psp_process.cpp:707-771), then the node-sharded conversion runs in the
    same program.

    Both axes pad to device-count multiples (frame pads carry zeros and are
    sliced off *before* any math; node pads carry coverage 0 so they convert
    to NaN and are trimmed from the returned arrays).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_dev = int(mesh.devices.size)
    # block-decompose over the COMBINED mesh axes: on a 2-D (hosts, devices)
    # mesh both phases stay 1-D over the full rank space, hosts-major
    # (reference apportion over all ranks, psp_process.cpp:611-624)
    axis = tuple(mesh.axis_names)
    F, N = intensity.shape
    F_pad = -(-F // n_dev) * n_dev
    N_pad = -(-N // n_dev) * n_dev

    def pad_nodes(a, fill=0.0):
        return np.pad(
            np.asarray(a, np.float32), (0, N_pad - N), constant_values=fill
        )

    ipad = np.zeros((F_pad, N_pad), np.float32)
    ipad[:F, :N] = intensity
    f_sh = NamedSharding(mesh, P(axis))
    n_sh = NamedSharding(mesh, P(axis))

    const = make_phase2_constants(pcal, cond)
    det = make_detrender(F, cfg.degree)
    steady = load_steady_cp(cfg, N, model)
    mtemp = compute_model_temperature(cfg, cond, N, model)

    # make_array_from_callback, not device_put: every process holds the same
    # full host copy, but multi-process device_put rejects it because its
    # consistency check compares with == and NaN != NaN (skipped nodes are
    # NaN by design)
    def put(a, sh):
        a = np.asarray(a)
        return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])

    intensity_dev = put(ipad, f_sh)
    avg_dev = put(pad_nodes(sol_avg), n_sh)
    cov_dev = put(pad_nodes(coverage), n_sh)
    steady_dev = put(pad_nodes(steady), n_sh)
    mtemp_dev = put(pad_nodes(mtemp), n_sh)

    @jax.jit
    def convert(i_fs, avg, cov, st, mt):
        it = jax.lax.with_sharding_constraint(i_fs.T, n_sh)  # all-to-all
        it = it[:, :F]  # drop frame padding before any math
        return phase2_convert(it, avg, cov, st, mt, const, det)

    # reshard volume computed from the shapes: each
    # device holds an (F/D, N) block and keeps only its (F/D, N/D) diagonal
    egress = 4 * (F_pad // n_dev) * N_pad * (n_dev - 1) // n_dev
    log.info(
        "phase2 reshard: %d x %d f32 over %d devices -> "
        "%.2f MB egress/device/chunk (%.3f MB/frame)",
        F_pad, N_pad, n_dev, egress / 1e6,
        egress / 1e6 / max(F_pad // n_dev, 1),
    )
    out = convert(intensity_dev, avg_dev, cov_dev, steady_dev, mtemp_dev)
    return Phase2Outputs(
        pressure_transpose=fetch_global(out.pressure_transpose)[:N],
        rms=fetch_global(out.rms)[:N],
        avg=fetch_global(out.avg)[:N],
        gain=fetch_global(out.gain)[:N],
        steady_state=jnp.asarray(steady),
        model_temp=jnp.asarray(mtemp),
    )
