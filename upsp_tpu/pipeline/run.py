"""End-to-end datapoint processing: the ``psp_process`` equivalent.

Orchestrates: video open -> phase 0 (setup) -> phase 1 (fused per-frame
register/patch/filter/project, streamed in chunks with background decode) ->
statistics/coverage -> frames->nodes transpose -> phase 2 (delta-Cp) ->
flat files + HDF5 + vv regression dumps.

Call stack parity: psp_process.cpp main/RunAllPhases (:1330-1435 — studied,
not copied).  ``checkout=True`` runs phase 0 only, like the reference's cheap
input-validation mode (psp_process.cpp:1207).

Multi-device execution: pass ``mesh="auto"`` (or a 1-D ``jax.sharding.Mesh``)
and phase 1 runs ``shard_map``-ped over the frame axis — every device scans
its own contiguous frame block in parallel (the reference's per-rank
apportioning, psp_process.cpp:1520-1523) — and phase 2 reshards frames->nodes
on device via one XLA all-to-all (the reference's global_transpose,
psp_process.cpp:707-771) before the node-sharded conversion.

Multi-HOST execution (``upsp-process --distributed``): the same driver runs
SPMD on every process over a global mesh.  Each host background-decodes only
its own slice of every video chunk (_host_batch_iter — the reference's
per-rank read-ahead, psp_process.cpp:867-908), collectives span processes,
and all file output is rank-0 gated (psp_process.cpp:1930-2016).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from upsp_tpu.io.flatfile import FlatFileSet
from upsp_tpu.io.paint import PaintCalibration
from upsp_tpu.io.video import FramePrefetcher, video_reader
from upsp_tpu.io.wtd import read_wtd
from upsp_tpu.ops.projection import coverage as proj_coverage
from upsp_tpu.parallel.mesh import fetch_global
from upsp_tpu.pipeline.config import ProcessingConfig
from upsp_tpu.pipeline.phase0 import Phase0State, run_phase0
from upsp_tpu.pipeline.phase1 import make_chunk_processor
from upsp_tpu.pipeline.phase2 import Phase2Outputs, run_phase2, run_phase2_sharded

log = logging.getLogger("upsp_tpu")


@dataclasses.dataclass
class DatapointOutputs:
    state: Phase0State
    intensity: Optional[np.ndarray]  # (F, N)
    intensity_avg: Optional[np.ndarray]
    intensity_rms: Optional[np.ndarray]
    coverage: Optional[np.ndarray]
    phase2: Optional[Phase2Outputs]
    n_frames: int


def _packed_ingest_config(readers, frames_array, device_unpack):
    """Decide whether packed on-device ingest applies, and with what format.

    Packed mode requires every camera's format to support packed reads AND
    agree on bit depth + linearization LUT (the chunk unpacks as one flat
    buffer); mixed-format rigs fall back to host decode.
    """
    if (
        frames_array is not None
        or device_unpack not in ("auto", True)
        or not readers
        or not all(r.supports_packed_reads for r in readers)
    ):
        return False, {}
    bits = {r.packed_bits for r in readers}
    if len(bits) != 1:
        return False, {}
    luts = [r.packed_lut for r in readers]
    lut0 = luts[0]
    for lut in luts[1:]:
        if (lut is None) != (lut0 is None) or (
            lut0 is not None and not np.array_equal(lut, lut0)
        ):
            return False, {}
    return True, {"packed_bits": bits.pop(), "lut": lut0}


def open_videos(cfg: ProcessingConfig):
    """Open every camera's video; returns (readers, n_frames, start0).

    ``start0`` is the 0-based first frame to process — the deck's 1-based
    ``start_frame`` key (psp_process.cpp:392-471 stream setup skips to it);
    the ECC template / reference frame is the first *processed* frame.
    """
    readers = []
    for cam in cfg.cameras:
        r = video_reader(cam.video)
        r.open()
        readers.append(r)
    start0 = max(int(getattr(cfg, "start_frame", 1)) - 1, 0)
    avail = min(r.frame_count for r in readers) - start0
    if avail <= 0:
        raise ValueError(
            f"start_frame {cfg.start_frame} leaves no frames to process"
        )
    n_frames = avail if cfg.frames <= 0 else min(avail, cfg.frames)
    return readers, n_frames, start0


def _apply_frame_window(cfg, frames_array):
    """Apply the deck's 1-based start_frame + frame count to an array input."""
    fa_start = max(int(getattr(cfg, "start_frame", 1)) - 1, 0)
    if fa_start:
        frames_array = frames_array[fa_start:]
    if frames_array.shape[0] == 0:
        raise ValueError(
            f"start_frame {cfg.start_frame} leaves no frames to process"
        )
    n_frames = frames_array.shape[0]
    if cfg.frames > 0:
        n_frames = min(n_frames, cfg.frames)
        frames_array = frames_array[:n_frames]
    return frames_array, n_frames


def _resolve_mesh(mesh):
    """None | "auto" | Mesh -> Mesh or None (single-device)."""
    if mesh is None:
        return None
    if isinstance(mesh, str):
        if mesh == "auto":
            from upsp_tpu.parallel.mesh import make_mesh

            return make_mesh() if len(jax.devices()) > 1 else None
        if mesh in ("none", ""):
            return None
        raise ValueError(f"unknown mesh spec {mesh!r}")
    return mesh


def _camera_settings(readers, cfg, state) -> Dict:
    """Camera settings for the HDF5 Condition group, from reader properties.

    Parity: psp_process.cpp:1583-1588 (framerate/fstop/exposure from camera 0,
    focal lengths from the calibrations).
    """
    out = dict(
        focal_lengths=[float(p.fx) for p in state.cam_params],
        cam_nums=[c.number for c in cfg.cameras],
    )
    if readers:
        r0 = readers[0]
        out["framerate"] = int(getattr(r0, "frame_rate", 0) or 0)
        out["fstop"] = float(getattr(r0, "aperture", 0.0) or 0.0)
        out["exposure"] = float(getattr(r0, "exposure_us", 0.0) or 0.0)
    return out


def _chunk_iter(frames_array, readers, n_frames, start0, frames_per_chunk, packed):
    """Yield (start, (chunk, C, ...) stacks); background-prefetched from files."""
    if frames_array is not None:
        for s in range(0, n_frames, frames_per_chunk):
            yield s, frames_array[s : s + frames_per_chunk]
    else:
        prefetchers = [
            iter(
                FramePrefetcher(
                    r,
                    n_frames,
                    start=start0,
                    frames_per_chunk=frames_per_chunk,
                    packed=packed,
                )
            )
            for r in readers
        ]
        s = 0
        while s < n_frames:
            per_cam = [next(p) for p in prefetchers]
            stack = np.stack(per_cam, axis=1)  # (chunk, C, H, W) | (chunk, C, B)
            yield s, stack
            s += stack.shape[0]


def _pad_chunk(chunk: np.ndarray, n_dev: int):
    """Pad the frame axis to a device-count multiple (repeat the last frame).

    Inherent to even SPMD sharding (shard_map needs equal per-device blocks);
    only the FINAL chunk of a datapoint can pad, and by at most n_dev-1
    frames — the per-batch tail inside the frame program pads nothing
    (phase1._batched_map runs the remainder at its exact size).
    """
    valid = chunk.shape[0]
    pad = (-valid) % n_dev
    if pad:
        chunk = np.concatenate(
            [chunk, np.repeat(chunk[-1:], pad, axis=0)], axis=0
        )
    return chunk, valid


def _dist_info(mesh):
    """(process_id, process_count) when `mesh` spans multiple processes."""
    if mesh is None:
        return 0, 1
    try:
        pid, pcount = jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1
    if pcount <= 1:
        return 0, 1
    procs = {d.process_index for d in mesh.devices.flat}
    return (pid, pcount) if len(procs) > 1 else (0, 1)


def _is_rank0(mesh) -> bool:
    return _dist_info(mesh)[0] == 0


def _device_peak_bytes(mesh):
    """Peak bytes in use so far on each local device of the run, or None
    where the backend keeps no memory statistics (the CPU)."""
    devs = [jax.local_devices()[0]] if mesh is None else mesh.local_devices
    stats = [d.memory_stats() for d in devs]
    if not all(stats):
        return None
    return [int(s.get("peak_bytes_in_use", 0)) for s in stats]


def _host_batch_iter(
    readers, n_frames, start0, frames_per_chunk, packed, mesh, pid, pcount
):
    """Multi-process ingest: yield (start, valid, global sharded batch).

    Each process background-decodes only ITS contiguous block of every
    padded chunk (the reference's per-rank read-ahead slice,
    psp_process.cpp:867-908), then contributes it as the process-local data
    of a globally frame-sharded jax.Array — video ingest bandwidth scales
    with hosts.  Rows beyond each host's valid slice are padding whose
    outputs the caller trims.
    """
    from upsp_tpu.io.video import IntervalPrefetcher
    from upsp_tpu.parallel.launcher import chunk_plan
    from upsp_tpu.parallel.mesh import frame_sharding

    n_dev = int(mesh.devices.size)
    plan = chunk_plan(n_frames, frames_per_chunk, n_dev, pid, pcount)
    prefetchers = [
        iter(
            IntervalPrefetcher(
                r,
                [(start0 + c.local_start, c.local_valid) for c in plan],
                packed=packed,
            )
        )
        for r in readers
    ]
    sharding = frame_sharding(mesh)
    for c in plan:
        per_cam = [next(p) for p in prefetchers]
        local = np.stack(per_cam, axis=1)  # (local_valid, C, ...)
        if local.shape[0] < c.local_rows:
            pad_shape = (c.local_rows - local.shape[0],) + local.shape[1:]
            fill = (
                np.repeat(local[-1:], pad_shape[0], axis=0)
                if local.shape[0]
                else np.zeros(pad_shape, local.dtype)
            )
            local = np.concatenate([local, fill], axis=0)
        batch = jax.make_array_from_process_local_data(sharding, local)
        yield c.start, c.valid, batch


def _batch_iter(
    frames_array, readers, n_frames, start0, frames_per_chunk, packed, mesh
):
    """Unified chunk feed: yields (start, valid, device batch) for every
    ingest mode — in-memory array, callable frame source, single-process
    files, multi-process per-host file slices.

    A CALLABLE ``frames_array`` is a device-resident ingest hook
    ``source(start, count) -> (count, C, H, W)`` (device or host array) —
    used when frames are produced by something other than a video file (a
    simulator, a staged device buffer, the endurance benchmark's on-device
    synthesis) so ingest need not round-trip through host RAM.
    """
    if callable(frames_array):
        n_dev = 1 if mesh is None else int(mesh.devices.size)
        from upsp_tpu.parallel.mesh import frame_sharding

        for s in range(0, n_frames, frames_per_chunk):
            valid = min(frames_per_chunk, n_frames - s)
            batch = frames_array(s, valid)
            pad = (-valid) % n_dev
            if pad:
                batch = jnp.concatenate(
                    [batch, jnp.repeat(batch[-1:], pad, axis=0)], axis=0
                )
            if mesh is not None:
                batch = jax.device_put(batch, frame_sharding(mesh))
            yield s, valid, batch
        return
    pid, pcount = _dist_info(mesh)
    if pcount > 1 and frames_array is None:
        yield from _host_batch_iter(
            readers, n_frames, start0, frames_per_chunk, packed, mesh,
            pid, pcount,
        )
        return
    n_dev = 1 if mesh is None else int(mesh.devices.size)
    from upsp_tpu.parallel.mesh import frame_sharding

    for start, chunk in _chunk_iter(
        frames_array, readers, n_frames, start0, frames_per_chunk, packed
    ):
        chunk, valid = _pad_chunk(np.asarray(chunk), n_dev)
        batch = jnp.asarray(chunk)
        if mesh is not None:
            batch = jax.device_put(batch, frame_sharding(mesh))
        yield start, valid, batch


def run_datapoint(
    cfg: ProcessingConfig,
    checkout: bool = False,
    frames_per_chunk: int = 64,
    frames_array: Optional[np.ndarray] = None,
    write_outputs: bool = True,
    resume: bool = False,
    device_unpack: str = "auto",
    registration_telemetry: bool = False,
    mesh=None,
    warm_start="fft",
    frame_batch: int = 8,
    compute_dtype: str = "float32",
) -> DatapointOutputs:
    """Process one datapoint end to end.

    ``frames_array`` (F, C, H, W) bypasses video files (tests/benchmarks).
    ``resume=True`` reuses an existing, size-consistent ``intensity`` flat
    file in ``cfg.out_dir`` and skips phase 1 — the reference's restartability
    pattern of on-disk intermediates (SURVEY.md section 5: intensity flat
    files make the pipeline resumable per stage).
    ``device_unpack``: "auto"/True ships raw 10/12-bit-packed bytes to the
    device and unpacks there (25-37.5% less host->device traffic;
    ops/unpack.py); "auto" engages whenever every camera's format supports
    packed reads.  False always decodes on the host.
    ``registration_telemetry=True`` records per-frame/per-camera ECC quality
    [rho, iterations, warp_tx, warp_ty, 0] (free — the values fall out of
    the solve), writes it to the ``registration`` flat file (F*C*5 f32 +
    self-describing sidecar), and logs a convergence summary for
    epsilon/iteration-budget tuning.  Column 4 is always 0; it is kept so
    the flat-file layout stays (F, C, 5).  The sidecar also records each
    device's peak bytes in use (where the backend reports them).
    ``mesh``: None (single device), "auto" (all local devices), or a 1-D Mesh
    — phase 1 shards the frame axis, phase 2 reshards to nodes on device.
    ``warm_start``: ECC initialization — "fft" (default: per-frame phase-
    correlation estimate, deterministic across shardings, batched
    ``frame_batch`` frames per step), True/"scan" (carry the previous frame's
    warp; identity at chunk/shard boundaries), or False (identity starts —
    exact reference semantics, registration.cpp:53-64).
    """
    mesh = _resolve_mesh(mesh)
    # ---- open video, grab first frames -------------------------------------
    start0 = 0
    if frames_array is not None:
        frames_array, n_frames = _apply_frame_window(cfg, frames_array)
        first_frames = [frames_array[0, c] for c in range(frames_array.shape[1])]
        bit_depths = [12] * len(first_frames)
        readers = None
    else:
        readers, n_frames, start0 = open_videos(cfg)
        first_frames = [r.read_frame(start0) for r in readers]
        bit_depths = [r.bit_depth for r in readers]

    # ---- phase 0 ------------------------------------------------------------
    state = run_phase0(cfg, first_frames, bit_depths)
    camset = _camera_settings(readers, cfg, state)
    # phase-0 diagnostic images/datasets (psp_process.cpp:2061-2178); the
    # reference routes "additional debugging files" to -add_out_dir,
    # defaulting to the deck's output directory (psp_process.cpp:1261)
    diag_dir = cfg.add_out_dir or cfg.out_dir
    # multi-process: only rank 0 writes files (the reference gates every
    # non-offset write on rank 0, psp_process.cpp:1930-2016)
    if write_outputs and diag_dir and _is_rank0(mesh):
        try:
            from upsp_tpu.pipeline.diagnostics import write_phase0_diagnostics

            write_phase0_diagnostics(state, diag_dir)
        except ImportError:
            log.warning("opencv unavailable; skipped diagnostic images")
    if checkout:
        if readers:
            for r in readers:
                r.close()
        return DatapointOutputs(state, None, None, None, None, None, n_frames)

    # ---- phase 1: stream frame chunks through the fused program ------------
    n_nodes = state.model.size
    if resume and cfg.out_dir:
        from upsp_tpu.io.flatfile import read_flat

        ipath = os.path.join(cfg.out_dir, "intensity")
        expect = n_frames * n_nodes
        if os.path.exists(ipath) and os.path.getsize(ipath) == expect * 4:
            log.info("resume: reusing existing intensity file, skipping phase 1")
            intensity = read_flat(ipath).reshape(n_frames, n_nodes)
            if readers:
                for r in readers:
                    r.close()
            return _finish_from_intensity(
                cfg, state, intensity, write_outputs, mesh=mesh, camset=camset
            )
        log.info("resume requested but no consistent intensity file; running")

    use_packed, packed_kw = _packed_ingest_config(readers, frames_array, device_unpack)
    fn = make_chunk_processor(
        state,
        mesh=mesh,
        warm_start=warm_start,
        frame_batch=frame_batch if warm_start == "fft" else 1,
        with_telemetry=True,
        packed=use_packed,
        compute_dtype=compute_dtype,
        **packed_kw,
    )
    if use_packed:
        log.info(
            "phase1: on-device packed-byte ingest enabled (%d-bit)",
            packed_kw["packed_bits"],
        )
    if mesh is not None:
        log.info(
            "phase1: frame axis sharded over %d devices (%s)",
            mesh.devices.size, mesh.axis_names[0],
        )
    intensity = np.empty((n_frames, n_nodes), np.float32)
    reg_telemetry = None  # allocated lazily from the first chunk's width

    for start, valid, batch in _batch_iter(
        frames_array, readers, n_frames, start0, frames_per_chunk,
        use_packed, mesh,
    ):
        out, tele = fn(batch)
        tele_np = fetch_global(tele)[:valid]
        sol_np = fetch_global(out)[:valid]
        if reg_telemetry is None:
            reg_telemetry = np.empty(
                (n_frames,) + tele_np.shape[1:], np.float32
            )
        reg_telemetry[start : start + valid] = tele_np
        intensity[start : start + valid] = sol_np
        if start % (frames_per_chunk * 8) == 0:
            log.info("phase1: processed frame %d / %d", start, n_frames)

    if readers:
        pid, pcount = _dist_info(mesh)
        log.info(
            "phase1: host %d/%d decoded %d frames across %d cameras",
            pid, pcount, sum(r.frames_decoded for r in readers), len(readers),
        )
        for r in readers:
            r.close()

    if registration_telemetry and reg_telemetry is not None:
        rho, conv = reg_telemetry[..., 0], reg_telemetry[..., 1]
        # conv = iteration count (while-loop modes) or final |drho| of the
        # last GN step (fft/unrolled mode); the registration.json sidecar
        # written below records which contract this run used
        conv_semantics = "drho" if warm_start == "fft" else "iters"
        log.info(
            "registration: rho min/mean %.4f/%.4f, conv(%s) mean/max %.3g/%.3g, "
            "|t| max %.2f px",
            rho.min(), rho.mean(), conv_semantics, conv.mean(), conv.max(),
            np.abs(reg_telemetry[..., 2:4]).max(),
        )
        if cfg.out_dir and _is_rank0(mesh):
            from upsp_tpu.pipeline.diagnostics import write_registration_meta

            os.makedirs(cfg.out_dir, exist_ok=True)
            FlatFileSet(cfg.out_dir).write("registration", reg_telemetry)
            write_registration_meta(
                cfg.out_dir, conv_semantics,
                device_peak_bytes=_device_peak_bytes(mesh),
            )

    return _finish_from_intensity(
        cfg, state, intensity, write_outputs, mesh=mesh, camset=camset
    )


def run_datapoint_streaming(
    cfg: ProcessingConfig,
    frames_per_chunk: int = 64,
    node_block: int = 65536,
    frames_array: Optional[np.ndarray] = None,
    device_unpack: str = "auto",
    write_hdf5: bool = True,
    mesh=None,
    warm_start="fft",
    frame_batch: int = 8,
    compute_dtype: str = "float32",
    stage_clock=None,
) -> DatapointOutputs:
    """Out-of-core datapoint processing for runs larger than host RAM.

    The (frames x nodes) intensity never materializes in memory: phase-1
    chunks stream to the ``intensity`` flat file through the native
    write-behind queue while per-node sums accumulate; the native blocked
    transpose produces ``intensity_transpose``; phase 2 then converts
    node blocks read back from disk.  This is the reference's exact
    disk-intermediate pattern (psp_process.cpp:524-563 five-buffer scheme,
    upsp_matrix_transpose) with the compute on device.

    ``write_hdf5``: also emit the ``.h5`` pressure-history file, incrementally
    per node block — the (nodes, frames) dataset never materializes in RAM
    (write_frames_block at a node offset; same layout as the in-memory path).
    ``mesh``/``warm_start``: as in :func:`run_datapoint` (phase 1 shards the
    frame axis; phase 2 here is the disk-blocked path, node blocks in order).

    MULTI-PROCESS (mesh spanning hosts): the frames->nodes transpose runs as
    chunked on-device all-to-alls — each frame chunk reshards to node-major
    on the mesh and every host accumulates its node slice's columns into its
    disjoint region of the shared ``intensity_transpose`` file through a
    page-cache-backed memmap, so the full (F, N) matrix NEVER resides in
    aggregate HBM (the reference's out-of-core global_transpose,
    psp_process.cpp:707-771 + upsp_matrix_transpose.cpp:16-100).  Each host
    then converts and writes only its node slice (per-rank offset writes,
    write_block parity psp_process.cpp:958-1007); rank 0 assembles the HDF5
    from the finished ``pressure_transpose`` flat file (the reference's
    add_field pattern).
    """
    from upsp_tpu import native
    from upsp_tpu.io.flatfile import FlatFileSet, read_flat
    from upsp_tpu.ops.polyfit import make_detrender
    from upsp_tpu.pipeline.phase2 import (
        compute_model_temperature,
        load_steady_cp,
        make_phase2_constants,
        phase2_convert,
    )

    assert cfg.out_dir, "streaming mode requires an output directory"
    if not (cfg.sds and cfg.paint_cal):
        raise ValueError(
            "streaming mode runs phase 2 inline and requires both a wtd "
            "(sds) file and a paint calibration (the reference refuses to "
            "start without -paint_cal, psp_process.cpp:1240-1243); use "
            "run_datapoint for an intensity-only run"
        )
    mesh = _resolve_mesh(mesh)
    start0 = 0
    if callable(frames_array):
        # device-resident ingest hook (see _batch_iter); the frame count
        # must come from the config since there is no file to measure
        if cfg.frames <= 0:
            raise ValueError(
                "a callable frame source requires cfg.frames > 0"
            )
        n_frames = cfg.frames
        f0 = np.asarray(frames_array(0, 1))[0]
        first_frames = [f0[c] for c in range(f0.shape[0])]
        bit_depths = [12] * len(first_frames)
        readers = None
    elif frames_array is not None:
        frames_array, n_frames = _apply_frame_window(cfg, frames_array)
        first_frames = [frames_array[0, c] for c in range(frames_array.shape[1])]
        bit_depths = [12] * len(first_frames)
        readers = None
    else:
        readers, n_frames, start0 = open_videos(cfg)
        first_frames = [r.read_frame(start0) for r in readers]
        bit_depths = [r.bit_depth for r in readers]

    if stage_clock is None:
        from upsp_tpu.utils.timing import StageClock

        stage_clock = StageClock()
    state = run_phase0(cfg, first_frames, bit_depths)
    stage_clock.point("phase0")
    camset = _camera_settings(readers, cfg, state)
    n_nodes = state.model.size
    use_packed, packed_kw = _packed_ingest_config(readers, frames_array, device_unpack)
    pid, pcount = _dist_info(mesh)
    fn = make_chunk_processor(
        state, mesh=mesh, warm_start=warm_start,
        frame_batch=frame_batch if warm_start == "fft" else 1,
        packed=use_packed, compute_dtype=compute_dtype,
        **packed_kw
    )
    ffs = FlatFileSet(cfg.out_dir)
    if pcount > 1:
        return _streaming_multiprocess(
            cfg, state, camset, readers, frames_array, n_frames, start0,
            frames_per_chunk, node_block, use_packed, write_hdf5, mesh, fn,
            ffs, pid, pcount,
        )

    sum_i = np.zeros(n_nodes, np.float64)
    sumsq_i = np.zeros(n_nodes, np.float64)
    ratio0_src = None

    writer = native.AsyncWriter(ffs.path("intensity"))
    try:
        for start, valid, batch in _batch_iter(
            frames_array, readers, n_frames, start0, frames_per_chunk,
            use_packed, mesh,
        ):
            out = fetch_global(fn(batch))[:valid]
            writer.submit(start * n_nodes * 4, out.astype("<f4"))
            with np.errstate(invalid="ignore"):
                sum_i += np.nansum(out, axis=0, dtype=np.float64)
                sumsq_i += np.einsum(
                    "fn,fn->n", out, out, dtype=np.float64
                )
            if start == 0:
                ratio0_src = out[0].copy()
    finally:
        writer.close()
        if readers:
            for r in readers:
                r.close()
    stage_clock.point("phase1_stream")

    nan_mask = np.isnan(ratio0_src)
    sol_avg = np.where(nan_mask, np.nan, sum_i / n_frames).astype(np.float32)
    sol_rms = np.where(nan_mask, np.nan, np.sqrt(sumsq_i / n_frames)).astype(
        np.float32
    )
    cov = np.asarray(proj_coverage(state.projections, *state.image_hw))
    # overlap adjustment: superseded nodes mirror their primary's coverage
    cov = cov[state.model.superseded_by]
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio0 = sol_avg / ratio0_src - 1.0

    # frames-major -> node-major on disk (native blocked transpose)
    native.transpose_f32(
        ffs.path("intensity"), ffs.path("intensity_transpose"),
        n_frames, n_nodes,
    )
    stage_clock.point("disk_transpose")

    # phase 2 over node blocks
    cond = read_wtd(cfg.sds)
    cond.test_id, cond.run, cond.seq = cfg.test_id, cfg.run, cfg.sequence
    pcal = PaintCalibration.read(cfg.paint_cal)
    const = make_phase2_constants(pcal, cond)
    det = make_detrender(n_frames, cfg.degree)
    steady = load_steady_cp(cfg, n_nodes, state.model)
    mtemp = compute_model_temperature(cfg, cond, n_nodes, state.model)

    h5w = None
    if write_hdf5:
        try:
            from upsp_tpu.io.hdf5io import PSPWriter

            name = cfg.out_name or "output"
            h5w = PSPWriter(
                cfg.h5_out or os.path.join(cfg.out_dir, f"{name}.h5"),
                state.model,
                n_frames=n_frames,
                transposed=True,
                chunk_nodes=cfg.trans_nodes or 4096,
            )
            h5w.write_grid(cfg.grid_units)
            h5w.write_tunnel_conditions(cond)
            h5w.write_camera_settings(**camset)
        except ImportError:
            log.warning("h5py unavailable; skipped HDF5 output")

    pwriter = native.AsyncWriter(ffs.path("pressure_transpose"))
    rms_all = np.empty(n_nodes, np.float32)
    avg_all = np.empty(n_nodes, np.float32)
    gain_all = np.empty(n_nodes, np.float32)
    try:
        for n0 in range(0, n_nodes, node_block):
            nw = min(node_block, n_nodes - n0)
            block = read_flat(
                ffs.path("intensity_transpose"), count=nw * n_frames,
                offset_values=n0 * n_frames,
            ).reshape(nw, n_frames)
            out2 = phase2_convert(
                jnp.asarray(block),
                jnp.asarray(sol_avg[n0 : n0 + nw]),
                jnp.asarray(cov[n0 : n0 + nw]),
                jnp.asarray(steady[n0 : n0 + nw]),
                jnp.asarray(mtemp[n0 : n0 + nw]),
                const,
                det,
            )
            press = fetch_global(out2.pressure_transpose)
            pwriter.submit(n0 * n_frames * 4, press.astype("<f4"))
            if h5w is not None:
                h5w.write_frames_block(press, node_start=n0)
            rms_all[n0 : n0 + nw] = fetch_global(out2.rms)
            avg_all[n0 : n0 + nw] = fetch_global(out2.avg)
            gain_all[n0 : n0 + nw] = fetch_global(out2.gain)
        steady_out = _steady_for_output(steady)
        if h5w is not None:
            h5w.write_new_dataset("rms", rms_all, "delta Cp")
            h5w.write_new_dataset("average", avg_all, "delta Cp")
            h5w.write_new_dataset("coverage", cov)
            h5w.write_new_dataset("steady_state", steady_out, "Cp")
            h5w.write_new_dataset("model_temp", mtemp, "F")
    finally:
        pwriter.close()
        if h5w is not None:
            h5w.close()
    stage_clock.point("phase2_blocks")

    ffs.write_standard_outputs(
        state.model,
        {
            "intensity_avg": sol_avg,
            "intensity_rms": sol_rms,
            "intensity_ratio_0": ratio0,
            "coverage": cov,
        },
        {
            "avg": avg_all,
            "rms": rms_all,
            "gain": gain_all,
            "steady_state": steady_out,
            "model_temp": mtemp,
        },
    )

    return DatapointOutputs(
        state=state,
        intensity=None,
        intensity_avg=sol_avg,
        intensity_rms=sol_rms,
        coverage=cov,
        phase2=Phase2Outputs(
            pressure_transpose=None, rms=jnp.asarray(rms_all),
            avg=jnp.asarray(avg_all), gain=jnp.asarray(gain_all),
            steady_state=jnp.asarray(steady), model_temp=jnp.asarray(mtemp),
        ),
        n_frames=n_frames,
    )


def _ensure_file_size(path: str, nbytes: int) -> None:
    """Create/extend a file to exactly `nbytes` (shared multi-writer target)."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        if os.fstat(fd).st_size != nbytes:
            os.ftruncate(fd, nbytes)
    finally:
        os.close(fd)


def _streaming_multiprocess(
    cfg, state, camset, readers, frames_array, n_frames, start0,
    frames_per_chunk, node_block, use_packed, write_hdf5, mesh, fn, ffs,
    pid, pcount,
) -> DatapointOutputs:
    """Multi-host out-of-core streaming (see run_datapoint_streaming).

    Chunked on-device all-to-alls replace the reference's MPI
    global_transpose (psp_process.cpp:707-771): each frame chunk reshards to
    node-major on the mesh, every host folds its node slice's columns into
    its disjoint region of the shared ``intensity_transpose`` file (memmap,
    page-cache backed — the (F, N) matrix never resides in aggregate HBM or
    any single host's RAM), and phase 2 converts + writes per-host node
    slices at file offsets (write_block parity, psp_process.cpp:958-1007).
    """
    from jax.experimental import multihost_utils

    from upsp_tpu import native
    from upsp_tpu.io.flatfile import read_flat
    from upsp_tpu.ops.polyfit import make_detrender
    from upsp_tpu.parallel.mesh import local_block, node_sharding
    from upsp_tpu.pipeline.phase2 import (
        compute_model_temperature,
        load_steady_cp,
        make_phase2_constants,
        phase2_convert,
    )

    n_nodes = state.model.size
    n_dev = int(mesh.devices.size)
    n_pad = -(-n_nodes // n_dev) * n_dev
    lr_n = n_pad // pcount  # node rows per host (incl. padding)
    n0, n1 = pid * lr_n, min(pid * lr_n + lr_n, n_nodes)
    n_local = max(n1 - n0, 0)
    n_sh = node_sharding(mesh)

    @jax.jit
    def reshard(x):  # (Vp, N) frame-sharded -> (n_pad, Vp) node-sharded
        xt = jnp.pad(x.T, ((0, n_pad - x.shape[1]), (0, 0)))
        return jax.lax.with_sharding_constraint(xt, n_sh)

    tpath = ffs.path("intensity_transpose")
    _ensure_file_size(tpath, n_nodes * n_frames * 4)
    multihost_utils.sync_global_devices("upsp-stream-alloc")
    trans = (
        np.memmap(
            tpath, "<f4", mode="r+", offset=n0 * n_frames * 4,
            shape=(n_local, n_frames),
        )
        if n_local
        else None
    )

    sum_i = np.zeros(n_nodes, np.float64)
    sumsq_i = np.zeros(n_nodes, np.float64)
    ratio0_src = np.zeros(n_nodes, np.float32)

    writer = native.AsyncWriter(ffs.path("intensity"))
    try:
        for start, valid, batch in _batch_iter(
            frames_array, readers, n_frames, start0, frames_per_chunk,
            use_packed, mesh,
        ):
            out = fn(batch)  # (Vp, N) frame-sharded
            # this host's frame rows -> intensity file + stat partials
            row0, rows = local_block(out)
            lv = int(np.clip(valid - row0, 0, rows.shape[0]))
            if lv > 0:
                rows = np.asarray(rows[:lv], "<f4")
                writer.submit((start + row0) * n_nodes * 4, rows)
                with np.errstate(invalid="ignore"):
                    sum_i += np.nansum(rows, axis=0, dtype=np.float64)
                    sumsq_i += np.einsum(
                        "fn,fn->n", rows, rows, dtype=np.float64
                    )
                if start == 0 and row0 == 0:
                    ratio0_src = rows[0].copy()
            # chunked transpose: all-to-all this chunk into node-major and
            # fold this host's node slice into its transposed-file region
            trow0, tloc = local_block(reshard(out))
            assert trow0 == n0, (trow0, n0)
            if trans is not None:
                trans[:, start : start + valid] = tloc[:n_local, :valid]
    finally:
        writer.close()
        if readers:
            log.info(
                "phase1: host %d/%d decoded %d frames across %d cameras",
                pid, pcount,
                sum(r.frames_decoded for r in readers), len(readers),
            )
            for r in readers:
                r.close()
    if trans is not None:
        trans.flush()

    # combine per-host statistic partials; ratio0 row lives on host 0
    totals = np.asarray(
        multihost_utils.process_allgather(
            jnp.asarray(np.stack([sum_i, sumsq_i]))
        )
    ).sum(axis=0)
    sum_i, sumsq_i = totals[0], totals[1]
    ratio0_src = np.asarray(
        multihost_utils.broadcast_one_to_all(jnp.asarray(ratio0_src))
    )

    nan_mask = np.isnan(ratio0_src)
    sol_avg = np.where(nan_mask, np.nan, sum_i / n_frames).astype(np.float32)
    sol_rms = np.where(nan_mask, np.nan, np.sqrt(sumsq_i / n_frames)).astype(
        np.float32
    )
    cov = np.asarray(proj_coverage(state.projections, *state.image_hw))
    cov = cov[state.model.superseded_by]
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio0 = sol_avg / ratio0_src - 1.0

    # phase 2 over THIS HOST's node slice, written at per-rank offsets
    cond = read_wtd(cfg.sds)
    cond.test_id, cond.run, cond.seq = cfg.test_id, cfg.run, cfg.sequence
    pcal = PaintCalibration.read(cfg.paint_cal)
    const = make_phase2_constants(pcal, cond)
    det = make_detrender(n_frames, cfg.degree)
    steady = load_steady_cp(cfg, n_nodes, state.model)
    mtemp = compute_model_temperature(cfg, cond, n_nodes, state.model)

    rms_loc = np.full(lr_n, np.nan, np.float32)
    avg_loc = np.full(lr_n, np.nan, np.float32)
    gain_loc = np.full(lr_n, np.nan, np.float32)
    pwriter = native.AsyncWriter(ffs.path("pressure_transpose"))
    try:
        for b0 in range(n0, n1, node_block):
            nw = min(node_block, n1 - b0)
            block = np.asarray(trans[b0 - n0 : b0 - n0 + nw])
            out2 = phase2_convert(
                jnp.asarray(block),
                jnp.asarray(sol_avg[b0 : b0 + nw]),
                jnp.asarray(cov[b0 : b0 + nw]),
                jnp.asarray(steady[b0 : b0 + nw]),
                jnp.asarray(mtemp[b0 : b0 + nw]),
                const,
                det,
            )
            press = np.asarray(out2.pressure_transpose)
            pwriter.submit(b0 * n_frames * 4, press.astype("<f4"))
            rms_loc[b0 - n0 : b0 - n0 + nw] = np.asarray(out2.rms)
            avg_loc[b0 - n0 : b0 - n0 + nw] = np.asarray(out2.avg)
            gain_loc[b0 - n0 : b0 - n0 + nw] = np.asarray(out2.gain)
    finally:
        pwriter.close()

    def gather_nodes(loc):
        # host slices are contiguous process-major: tiled allgather IS the
        # global node order (padding rows fall off the end)
        g = np.asarray(
            multihost_utils.process_allgather(jnp.asarray(loc), tiled=True)
        )
        return g[:n_nodes]

    rms_all, avg_all, gain_all = map(gather_nodes, (rms_loc, avg_loc, gain_loc))
    steady_out = _steady_for_output(steady)
    # every host's pressure_transpose region must be on disk before rank 0
    # reads it back for the HDF5 (the reference's add_field pattern)
    multihost_utils.sync_global_devices("upsp-stream-flat")

    if pid == 0:
        if write_hdf5:
            try:
                from upsp_tpu.io.hdf5io import PSPWriter

                name = cfg.out_name or "output"
                with PSPWriter(
                    cfg.h5_out or os.path.join(cfg.out_dir, f"{name}.h5"),
                    state.model,
                    n_frames=n_frames,
                    transposed=True,
                    chunk_nodes=cfg.trans_nodes or 4096,
                ) as h5w:
                    h5w.write_grid(cfg.grid_units)
                    h5w.write_tunnel_conditions(cond)
                    h5w.write_camera_settings(**camset)
                    for b0 in range(0, n_nodes, node_block):
                        nw = min(node_block, n_nodes - b0)
                        press = read_flat(
                            ffs.path("pressure_transpose"),
                            count=nw * n_frames, offset_values=b0 * n_frames,
                        ).reshape(nw, n_frames)
                        h5w.write_frames_block(press, node_start=b0)
                    h5w.write_new_dataset("rms", rms_all, "delta Cp")
                    h5w.write_new_dataset("average", avg_all, "delta Cp")
                    h5w.write_new_dataset("coverage", cov)
                    h5w.write_new_dataset("steady_state", steady_out, "Cp")
                    h5w.write_new_dataset("model_temp", mtemp, "F")
            except ImportError:
                log.warning("h5py unavailable; skipped HDF5 output")
        ffs.write_standard_outputs(
            state.model,
            {
                "intensity_avg": sol_avg,
                "intensity_rms": sol_rms,
                "intensity_ratio_0": ratio0,
                "coverage": cov,
            },
            {
                "avg": avg_all,
                "rms": rms_all,
                "gain": gain_all,
                "steady_state": steady_out,
                "model_temp": mtemp,
            },
        )

    return DatapointOutputs(
        state=state,
        intensity=None,
        intensity_avg=sol_avg,
        intensity_rms=sol_rms,
        coverage=cov,
        phase2=Phase2Outputs(
            pressure_transpose=None, rms=jnp.asarray(rms_all),
            avg=jnp.asarray(avg_all), gain=jnp.asarray(gain_all),
            steady_state=jnp.asarray(steady), model_temp=jnp.asarray(mtemp),
        ),
        n_frames=n_frames,
    )


def _steady_for_output(steady: np.ndarray) -> np.ndarray:
    """Steady Cp output rule: values > 3.0 write as NaN (psp_process.cpp:2567-
    2572); the gain computation keeps the raw values."""
    s = np.asarray(steady, np.float32)
    return np.where(s > 3.0, np.nan, s)


def _finish_from_intensity(
    cfg: ProcessingConfig,
    state: Phase0State,
    intensity: np.ndarray,
    write_outputs: bool,
    mesh=None,
    camset: Optional[Dict] = None,
) -> DatapointOutputs:
    """Statistics + coverage + phase 2 + outputs, from a (F, N) intensity."""
    n_frames = intensity.shape[0]
    with np.errstate(invalid="ignore"):
        # f64 accumulation for both moments (reference reduces doubles,
        # psp_process.cpp:1725-1730, 2530-2546)
        sol_avg = intensity.mean(axis=0, dtype=np.float64).astype(np.float32)
        sol_rms = np.sqrt(
            np.einsum("fn,fn->n", intensity, intensity, dtype=np.float64)
            / n_frames
        ).astype(np.float32)
    cov = np.asarray(proj_coverage(state.projections, *state.image_hw))
    # overlap adjustment: superseded nodes mirror their primary's coverage
    cov = cov[state.model.superseded_by]
    # frame-1 Iref/I sample (intensity_ratio_0, psp_process.cpp:1936-1943)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio0 = sol_avg / intensity[0] - 1.0

    # ---- phase 2 ------------------------------------------------------------
    phase2 = None
    if not (cfg.sds and cfg.paint_cal):
        # the reference refuses to start without -paint_cal
        # (psp_process.cpp:1240-1243); as a library we allow phase-1-only
        # runs but never silently
        log.warning(
            "phase 2 skipped: missing %s — intensity outputs only",
            "sds (wtd)" if not cfg.sds else "paint_cal",
        )
    else:
        cond = read_wtd(cfg.sds)
        cond.test_id = cfg.test_id
        cond.run = cfg.run
        cond.seq = cfg.sequence
        pcal = PaintCalibration.read(cfg.paint_cal)
        if mesh is not None:
            phase2 = run_phase2_sharded(
                cfg, intensity, sol_avg, cov, cond, pcal, mesh,
                model=state.model,
            )
        else:
            phase2 = run_phase2(
                cfg,
                jnp.asarray(intensity.T),  # (N, F) node-major
                jnp.asarray(sol_avg),
                jnp.asarray(cov),
                cond,
                pcal,
                model=state.model,
            )

    # ---- outputs ------------------------------------------------------------
    # rank-0 gated: every process holds the full (allgathered) results, so
    # one writer suffices and concurrent writes to shared paths never happen
    if write_outputs and cfg.out_dir and _is_rank0(mesh):
        _write_outputs(
            cfg, state, intensity, sol_avg, sol_rms, ratio0, cov, phase2, camset
        )

    return DatapointOutputs(
        state=state,
        intensity=intensity,
        intensity_avg=sol_avg,
        intensity_rms=sol_rms,
        coverage=cov,
        phase2=phase2,
        n_frames=n_frames,
    )


def _write_outputs(
    cfg, state, intensity, sol_avg, sol_rms, ratio0, cov, phase2, camset=None
):
    ffs = FlatFileSet(cfg.out_dir)
    p1 = {
        "intensity": intensity,
        "intensity_avg": sol_avg,
        "intensity_rms": sol_rms,
        "intensity_ratio_0": ratio0,
        "coverage": cov,
    }
    p2 = None
    steady_out = mtemp = None
    if phase2 is not None:
        p2 = {
            "pressure_transpose": np.asarray(phase2.pressure_transpose),
            "avg": np.asarray(phase2.avg),
            "rms": np.asarray(phase2.rms),
            "gain": np.asarray(phase2.gain),
        }
        if phase2.steady_state is not None:
            steady_out = _steady_for_output(np.asarray(phase2.steady_state))
            p2["steady_state"] = steady_out
        if phase2.model_temp is not None:
            mtemp = np.asarray(phase2.model_temp)
            p2["model_temp"] = mtemp
    ffs.write_standard_outputs(state.model, p1, p2)

    if phase2 is not None:
        try:
            from upsp_tpu.io.hdf5io import PSPWriter

            cond = read_wtd(cfg.sds)
            cond.test_id = cfg.test_id
            cond.run = cfg.run
            cond.seq = cfg.sequence
            name = cfg.out_name or "output"
            with PSPWriter(
                cfg.h5_out or os.path.join(cfg.out_dir, f"{name}.h5"),
                state.model,
                n_frames=intensity.shape[0],
                transposed=True,
                chunk_nodes=cfg.trans_nodes or 4096,
            ) as w:
                w.write_grid(cfg.grid_units)
                w.write_tunnel_conditions(cond)
                w.write_camera_settings(
                    **(camset or dict(
                        focal_lengths=[float(p.fx) for p in state.cam_params],
                        cam_nums=[c.number for c in cfg.cameras],
                    ))
                )
                w.write_frames_block(np.asarray(phase2.pressure_transpose))
                w.write_new_dataset("rms", np.asarray(phase2.rms), "delta Cp")
                w.write_new_dataset("average", np.asarray(phase2.avg), "delta Cp")
                w.write_new_dataset("coverage", cov)
                if steady_out is not None:
                    w.write_new_dataset("steady_state", steady_out, "Cp")
                if mtemp is not None:
                    w.write_new_dataset("model_temp", mtemp, "F")
        except ImportError:
            log.warning("h5py unavailable; skipped HDF5 output")
