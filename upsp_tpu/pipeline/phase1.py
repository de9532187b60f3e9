"""Phase 1: the fused per-frame program — register, patch, filter, project.

The reference's OpenMP frame loop (psp_process.cpp:1743-1851 — studied, not
copied) becomes ONE jitted function per frame stack: hot-pixel repair -> ECC
alignment to the first frame -> fiducial patching (batched matmul) ->
Gaussian/box filter -> gather-projection -> multi-camera weighted sum ->
NaN-fill skipped nodes -> overlap adjustment.

Chunk execution is a ``lax.scan`` over the frame axis that carries each
camera's converged ECC warp into the next frame as its warm start — model
vibration is temporally coherent, so warm-started ECC converges in 1-3
iterations instead of 5-15 with an identical converged solution (the
objective and stopping rule do not change).  Under a device mesh the chunk is
``shard_map``-ped: each device scans its own contiguous frame block (identity
warp at block boundaries), which is exactly the reference's per-rank
contiguous frame apportioning (psp_process.cpp:1520-1523).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from upsp_tpu.ops.image import apply_filter, fix_hot_pixels
from upsp_tpu.ops.patching import PatchOperator, apply_patches
from upsp_tpu.ops.projection import NodeProjection, project_frame
from upsp_tpu.ops.registration import ecc_affine, identity_warp, warp_affine
from upsp_tpu.ops.warp import warp_affine_mxu


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "projections", "skipped", "patch_ops", "ref_frames",
        "superseded_by", "combined_index", "combined_weight",
    ],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Phase1Params:
    """Static-shape pytree consumed by the jitted per-frame program."""

    projections: Tuple[NodeProjection, ...]  # per camera
    skipped: jax.Array  # (N,) bool
    patch_ops: Tuple[Optional[PatchOperator], ...]
    ref_frames: jax.Array  # (C, H, W) float32
    superseded_by: jax.Array  # (N,) int32
    # BestView fast path: when every node has at most one positive camera
    # weight (the production default), the C per-camera gathers collapse to
    # ONE gather from the stacked (C, H, W) frame buffer — index is
    # camera*H*W + pixel
    combined_index: Optional[jax.Array] = None  # (N,) int32 into (C*H*W,)
    combined_weight: Optional[jax.Array] = None  # (N,) float32


def phase1_params(state) -> Phase1Params:
    import numpy as np

    projections = tuple(state.projections)
    combined_index = combined_weight = None
    if len(projections) >= 1:
        w = np.stack([np.asarray(p.weight) for p in projections])  # (C, N)
        if ((w > 0).sum(axis=0) <= 1).all():
            H, W = state.image_hw
            idx = np.stack([np.asarray(p.pixel_index) for p in projections])
            best = w.argmax(axis=0)  # 0 where all-zero (weight 0 kills it)
            n = np.arange(w.shape[1])
            combined_index = jnp.asarray(
                (best * H * W + idx[best, n]).astype(np.int32)
            )
            combined_weight = jnp.asarray(w[best, n].astype(np.float32))
    return Phase1Params(
        projections=projections,
        skipped=state.skipped,
        patch_ops=tuple(state.patch_ops),
        ref_frames=state.ref_frames,
        superseded_by=state.superseded_by,
        combined_index=combined_index,
        combined_weight=combined_weight,
    )


def _as_compute_dtype(compute_dtype):
    """Normalize a ``compute_dtype`` spec (str or dtype) to a jnp dtype."""
    if compute_dtype in (None, "float32", jnp.float32):
        return jnp.float32
    if compute_dtype in ("bfloat16", jnp.bfloat16):
        return jnp.bfloat16
    raise ValueError(
        f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}"
    )


def _process_frame_core(
    frames: jax.Array,  # (C, H, W) raw camera frames (uint16 or float)
    params: Phase1Params,
    registration: str,
    patch: bool,
    filter_type: str,
    filter_size: int,
    interpolation: str,
    adjust_overlap: bool,
    warp_init: Optional[jax.Array] = None,  # (C, 2, 3) ECC warm start
    ecc_unroll_iters: Optional[int] = None,
    ecc_coarse_iters: int = 0,
    ecc_band: Optional[int] = None,
    ecc_valid_shift: Optional[jax.Array] = None,  # (C, 2) pre-shift [tx, ty]
    ecc_epsilon: Optional[float] = None,  # while-loop |drho| stop (None=1e-3)
    ecc_max_iters: Optional[int] = None,  # while-loop iteration cap (None=50)
    compute_dtype=jnp.float32,  # image dtype between stages (f32 | bf16)
    fix_hot: bool = True,  # hot-pixel repair (False when done by the caller)
):
    """One multi-camera frame -> (intensity (N,), warps (C,2,3), telemetry (C,5)).

    Telemetry per camera is [rho, conv, warp_tx, warp_ty, 0] — the
    on-device analog of the reference's per-frame registration logging, at
    zero extra compute (the values fall out of the ECC solve; column 4 is
    always 0 and is kept so the ``registration`` flat-file layout stays
    (F, C, 5)).  ``conv`` is the
    iteration count in while-loop mode; in fixed-iteration (fft/unrolled)
    mode it is the final |drho| of the last GN step — the real convergence
    signal there (|drho| < epsilon means the solve reached the while_loop
    fixed point; the unroll count itself is a compile-time constant).

    ``ecc_unroll_iters``: run a fixed, statically-unrolled number of ECC
    Gauss-Newton steps instead of the |drho| while_loop — no data-dependent
    control flow, so the whole frame program vmaps over a frame batch.
    """
    n_cams = frames.shape[0]
    sol = None
    warps = []
    telemetry = []
    processed = []
    for c in range(n_cams):
        img = fix_hot_pixels(frames[c]) if fix_hot else frames[c]
        img = img.astype(compute_dtype)
        if registration == "pixel":
            init_c = None if warp_init is None else warp_init[c]
            ecc_kw = (
                {}
                if ecc_unroll_iters is None
                else dict(max_iters=ecc_unroll_iters, unroll=True,
                          coarse_iters=ecc_coarse_iters, band=ecc_band)
            )
            if ecc_unroll_iters is None:
                # while-loop mode: convergence controls (the reference's
                # cv2 criteria pair, psp_process semantics: COUNT 50 + EPS
                # 1e-3; a tighter epsilon yields the fully-converged oracle
                # used by the fixture vv parity tests)
                if ecc_epsilon is not None:
                    ecc_kw["epsilon"] = ecc_epsilon
                if ecc_max_iters is not None:
                    ecc_kw["max_iters"] = ecc_max_iters
            vs_c = (
                None if ecc_valid_shift is None else ecc_valid_shift[c]
            )
            warp, rho, conv = ecc_affine(
                params.ref_frames[c], img, warp_init=init_c,
                valid_shift=vs_c, return_iters=True, **ecc_kw
            )
            # telemetry records the TOTAL translation (pre-shift composed
            # back in) so the flat-file record is mode-independent
            t_tot = warp[:, 2] if vs_c is None else warp[:, 2] + vs_c
            telemetry.append(
                jnp.stack(
                    [rho, conv.astype(jnp.float32), t_tot[0], t_tot[1],
                     jnp.float32(0.0)]
                )
            )
            warps.append(warp)
            if interpolation == "nearest":
                img = warp_affine(img, warp, interpolation="nearest")
            else:
                img = warp_affine_mxu(img, warp, band=ecc_band)
        else:
            telemetry.append(
                jnp.array([1.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)
            )
            warps.append(identity_warp())
        if patch and params.patch_ops[c] is not None:
            img = apply_patches(img, params.patch_ops[c])
        img = apply_filter(img, filter_type, filter_size)
        if params.combined_index is not None:
            processed.append(img)
        else:
            c_sol = project_frame(img, params.projections[c])
            sol = c_sol if sol is None else sol + c_sol
    if params.combined_index is not None:
        stacked = jnp.stack(processed).reshape(-1)  # (C*H*W,)
        sol = stacked[params.combined_index] * params.combined_weight
    sol = jnp.where(params.skipped, jnp.nan, sol)
    if adjust_overlap:
        sol = sol[params.superseded_by]
    return sol, jnp.stack(warps), jnp.stack(telemetry)


def _process_frame_cams_batched(
    frames: jax.Array,  # (C, H, W) raw camera frames
    params: Phase1Params,
    registration: str,
    patch: bool,
    filter_type: str,
    filter_size: int,
    interpolation: str,
    adjust_overlap: bool,
    warp_init: Optional[jax.Array] = None,  # (C, 2, 3)
    ecc_unroll_iters: int = 2,
    ecc_coarse_iters: int = 0,
    ecc_band: Optional[int] = None,
    ecc_valid_shift: Optional[jax.Array] = None,
    ecc_epsilon: Optional[float] = None,  # while-loop only; unused here
    ecc_max_iters: Optional[int] = None,  # while-loop only; unused here
    compute_dtype=jnp.float32,
    fix_hot: bool = True,
):
    """Camera-vmapped variant of :func:`_process_frame_core`.

    The per-camera Python loop emits C separate warp matmuls / solves per
    frame; vmapping over the camera axis fuses them into BATCHED matmuls
    (batch C x frame_batch at full config — 4x larger than the loop form),
    cutting per-op dispatch/fusion overhead on multi-camera configs.  Only
    valid for modes without data-dependent control flow (fixed-iteration ECC
    or no registration) — the while-loop solve stays on the loop path.
    Numerics are identical op-for-op to the loop form (vmap of the same
    program); tests/test_phase1_cams.py locks the equivalence.
    """
    if ecc_valid_shift is not None:
        # the loop path masks statistics with the composed pre-shift; this
        # path has no such masking — silently dropping the shift would change
        # border semantics, so fail loudly instead (ecc_epsilon/ecc_max_iters
        # are while-loop-only controls, ignored in unrolled mode exactly as
        # _process_frame_core ignores them)
        raise NotImplementedError(
            "ecc_valid_shift is not supported on the camera-vmapped path; "
            "use the per-camera loop (vmap_cameras=False)"
        )
    n_cams = frames.shape[0]
    imgs = (
        jax.vmap(fix_hot_pixels)(frames) if fix_hot else frames
    ).astype(compute_dtype)
    if registration == "pixel":
        if warp_init is None:
            warp_init = jnp.broadcast_to(identity_warp(), (n_cams, 2, 3))

        def solve(ref, im, init):
            return ecc_affine(
                ref, im, warp_init=init, return_iters=True,
                max_iters=ecc_unroll_iters, unroll=True,
                coarse_iters=ecc_coarse_iters, band=ecc_band,
            )

        warps, rhos, convs = jax.vmap(solve)(
            params.ref_frames, imgs, warp_init
        )
        telemetry = jnp.stack(
            [rhos, convs.astype(jnp.float32), warps[:, 0, 2], warps[:, 1, 2],
             jnp.zeros((n_cams,), jnp.float32)],
            axis=1,
        )
        if interpolation == "nearest":
            imgs = jax.vmap(
                lambda im, w: warp_affine(im, w, interpolation="nearest")
            )(imgs.astype(jnp.float32), warps)
        else:
            imgs = jax.vmap(
                lambda im, w: warp_affine_mxu(im, w, band=ecc_band)
            )(imgs, warps)
    else:
        warps = jnp.broadcast_to(identity_warp(), (n_cams, 2, 3))
        telemetry = jnp.broadcast_to(
            jnp.array([1.0, 0.0, 0.0, 0.0, 0.0], jnp.float32), (n_cams, 5)
        )
    if patch and any(op is not None for op in params.patch_ops):
        imgs = jnp.stack(
            [apply_patches(imgs[c], params.patch_ops[c]) for c in range(n_cams)]
        )
    imgs = jax.vmap(lambda im: apply_filter(im, filter_type, filter_size))(imgs)
    if params.combined_index is not None:
        sol = imgs.reshape(-1)[params.combined_index] * params.combined_weight
    else:
        sol = None
        for c in range(n_cams):
            c_sol = project_frame(imgs[c], params.projections[c])
            sol = c_sol if sol is None else sol + c_sol
    sol = jnp.where(params.skipped, jnp.nan, sol)
    if adjust_overlap:
        sol = sol[params.superseded_by]
    return sol, warps, telemetry


@functools.partial(
    jax.jit,
    static_argnames=("registration", "patch", "filter_type", "filter_size",
                     "interpolation", "adjust_overlap", "with_telemetry"),
)
def process_frame(
    frames: jax.Array,  # (C, H, W) raw camera frames (uint16 or float)
    params: Phase1Params,
    registration: str = "pixel",
    patch: bool = True,
    filter_type: str = "gaussian",
    filter_size: int = 3,
    interpolation: str = "linear",
    adjust_overlap: bool = True,
    with_telemetry: bool = False,
):
    """One multi-camera frame -> per-node intensity (N,).

    ``with_telemetry`` additionally returns a (C, 4) registration-quality
    record per camera: [rho, iterations, warp_tx, warp_ty].
    """
    sol, _, telemetry = _process_frame_core(
        frames, params, registration, patch, filter_type, filter_size,
        interpolation, adjust_overlap,
    )
    if with_telemetry:
        return sol, telemetry
    return sol


def make_frame_processor(state, with_telemetry: bool = False):
    """Bind the phase-0 state + config into a frames->(N,) callable.

    ``with_telemetry``: fn returns (intensity, (C, 4) registration record).
    """
    p = phase1_params(state)
    cfg = state.config

    def fn(frames: jax.Array):
        return process_frame(
            frames,
            p,
            registration=cfg.registration,
            patch=(cfg.target_patcher == "polynomial"),
            filter_type=cfg.filter,
            filter_size=cfg.filter_size,
            interpolation=cfg.pixel_interpolation,
            with_telemetry=with_telemetry,
        )

    return fn


def _make_unpacker(packed_bits: int, lut, image_hw):
    """(F, C, B) uint8 packed bytes -> (F, C, H, W) uint16 pixels, on device.

    Shipping packed bytes instead of uint16 frames cuts host->device transfer
    by 25% (12-bit) or 37.5% (10-bit) (the reference always unpacks on the
    host: cpp/lib/PSPVideo.cpp unpack role).  ``lut``: optional
    (2**packed_bits,) uint16 linearization table applied on device (cine
    10->12 companding).
    """
    from upsp_tpu.ops.unpack import unpack_10bpp_jnp, unpack_12bpp_jnp

    if packed_bits not in (10, 12):
        raise ValueError(f"packed_bits must be 10 or 12, got {packed_bits}")
    unpack = unpack_12bpp_jnp if packed_bits == 12 else unpack_10bpp_jnp
    lut_dev = None if lut is None else jnp.asarray(lut, jnp.uint16)
    h, w = image_hw

    def unpack_chunk(packed: jax.Array) -> jax.Array:
        n_f, n_c = packed.shape[0], packed.shape[1]
        pix = unpack(packed.reshape(-1))
        if lut_dev is not None:
            pix = lut_dev[pix.astype(jnp.int32)]
        return pix.reshape(n_f, n_c, h, w)

    return unpack_chunk


def _batched_map(one, frames, frame_batch: int):
    """``lax.map(vmap(one))`` over frame batches; exact-size tail batch.

    B frames per loop step: elementwise passes and reductions amortize across
    the batch.  Requires ``one`` to be vmappable — no data-dependent control
    flow (fixed-iteration ECC or no registration).

    A non-multiple frame count runs the remainder through a SECOND vmap of
    the same program at the exact tail size instead of padding with repeated
    frames — no compute is spent on padding (the tail shape is static inside
    this trace, and a short last chunk retraces the whole program anyway).
    """
    if frame_batch <= 1:
        return jax.lax.map(one, frames)
    n_f = frames.shape[0]
    n_full = n_f // frame_batch
    rem = n_f - n_full * frame_batch
    if n_full == 0:
        return jax.vmap(one)(frames)
    batched = frames[: n_full * frame_batch].reshape(
        (n_full, frame_batch) + frames.shape[1:]
    )
    outs = jax.lax.map(jax.vmap(one), batched)
    outs = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), outs)
    if rem:
        tail = jax.vmap(one)(frames[n_full * frame_batch :])
        outs = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), outs, tail
        )
    return outs


def make_chunk_processor(
    state,
    mesh=None,
    warm_start: bool = True,
    with_telemetry: bool = False,
    packed: bool = False,
    packed_bits: int = 12,
    lut=None,
    frame_batch: int = 1,
    ecc_iters: Optional[int] = None,
    ecc_coarse_iters: Optional[int] = None,
    ecc_band: Optional[int] = None,
    ecc_epsilon: Optional[float] = None,
    ecc_max_iters: Optional[int] = None,
    compute_dtype="float32",
    vmap_cameras: bool = False,
    pre_shift: bool = False,
):
    """Build the chunk program: (F, C, H, W) frames -> (F, N) intensities.

    - ``warm_start``: how each frame's ECC solve is initialized.
        * ``"fft"``: per-frame phase-correlation translation estimate
          (ops/fftreg.py) — deterministic (depends only on the frame itself,
          so bit-invariant to chunk/shard boundaries) and extends capture
          range to +-H/4 px.
        * ``True`` / ``"scan"``: scan over frames carrying each camera's
          converged warp into the next solve.  NOTE the |drho| < epsilon
          stopping rule means warm- and identity-started solves agree only
          within the convergence tolerance, so intensities depend (within
          that tolerance) on chunk/shard boundaries.
        * ``False``: identity starts — the reference's semantics
          (registration.cpp:53-64), bit-invariant to the device count.
    - ``mesh``: a 1-D ``jax.sharding.Mesh`` over the ``frames`` axis; the
      chunk is ``shard_map``-ped so every device scans its own contiguous
      frame block in parallel — the reference's per-rank frame apportioning
      (psp_process.cpp:1520-1523) as SPMD.  Chunk length must divide evenly.
    - ``packed``: input is (F, C, B) uint8 packed camera bytes, unpacked on
      device before the frame program (ops/unpack.py).
    - ``with_telemetry``: returns (intensity, (F, C, 5) registration records
      [rho, conv, tx, ty, 0]).
    - ``frame_batch``: vmap this many frames per loop step (fft mode, and
      any mode without a while_loop ECC solve, e.g. registration "none") —
      fft mode uses fixed, unrolled Gauss-Newton steps (optional
      ``ecc_coarse_iters`` on a 2x decimated pair first, then ``ecc_iters``
      at full resolution).
      The default 2 full-res steps reach the while_loop fixed point from a
      phase-correlation init — GN converges quadratically from the sub-pixel
      start, verified in tests/test_fftreg.py::TestFixedIterECC.
    - ``ecc_band`` (fft mode only, opt-in): use the BANDED separable
      resample (ops/warp.py) for every warp — exact while total
      displacements stay within band-1 px; it doubles as an exactness
      oracle for the dense path's matmul precision.
    - ``compute_dtype``: dtype of the IMAGES between pipeline stages
      ("float32" default, or "bfloat16").  bf16 halves every image pass
      between stages.  All reductions, warp parameters, and solves stay
      f32 (bf16 pixels x f32 coordinates promote in registers).
      Quantization is ~|I| * 2^-8 ~ 8-16 counts per stage at 12-bit full
      scale — under the ~sqrt(I) ~ 50-count shot noise of real camera data;
      parity vs the f32 path is locked in tests/test_bf16.py.  Opt-in; f32
      remains the reference-parity mode.
    - ``pre_shift`` (fft mode, default off): split the phase-correlation
      estimate into integer + fractional parts, integer-shift the frame on
      device (ops/warp.py integer_shift — one elementwise pass) and solve
      ECC for the sub-pixel residual with the shift composed into the
      validity mask (the ``valid_shift`` machinery of ops/registration.py).
      Algebraically identical to solving the full warp (the composed sample
      positions coincide; the shift's zero strip is exactly the composed
      warp's out-of-bounds region).
    - ``vmap_cameras``: vmap the per-frame program over the camera axis
      instead of a Python loop (one batched program across C cameras).
      Opt-in; only valid in batchable modes (fft / no-registration).
    """
    # production default: 2 full-resolution GN steps, no coarse stage
    if ecc_iters is None:
        ecc_iters = 2
    if ecc_coarse_iters is None:
        ecc_coarse_iters = 0
    p = phase1_params(state)
    cfg = state.config
    n_cams = int(state.ref_frames.shape[0])
    cdtype = _as_compute_dtype(compute_dtype)
    static = dict(
        registration=cfg.registration,
        patch=(cfg.target_patcher == "polynomial"),
        filter_type=cfg.filter,
        filter_size=cfg.filter_size,
        interpolation=cfg.pixel_interpolation,
        adjust_overlap=True,
        ecc_epsilon=ecc_epsilon,
        ecc_max_iters=ecc_max_iters,
        compute_dtype=cdtype,
    )
    mode = warm_start if cfg.registration == "pixel" else False
    if mode is True:
        mode = "scan"
    # camera-vmapped per-frame path: only modes without data-dependent
    # control flow batch over cameras
    vmap_cameras = vmap_cameras and n_cams > 1 and (
        mode == "fft" or cfg.registration != "pixel"
    )
    # the camera-vmapped path carries no valid_shift (it raises)
    pre_shift = (
        pre_shift and mode == "fft" and cfg.registration == "pixel"
        and not vmap_cameras
    )
    unpack_chunk = (
        _make_unpacker(packed_bits, lut, state.image_hw) if packed else None
    )
    if mode == "fft":
        from upsp_tpu.ops.fftreg import (
            correlate,
            default_decimate,
            prepare_template,
            translation_warp,
        )

        fft_decimate = default_decimate(*state.image_hw)

    def local_chunk(chunk: jax.Array):
        """One device's frame block -> (intensity, telemetry)."""
        frames = unpack_chunk(chunk) if unpack_chunk is not None else chunk
        if mode == "scan":
            def body(carry, frame):
                sol, warps, tele = _process_frame_core(
                    frame, p, warp_init=carry, **static
                )
                return warps, (sol, tele)

            init = jnp.broadcast_to(identity_warp(), (n_cams, 2, 3))
            _, (sols, teles) = jax.lax.scan(body, init, frames)
        elif mode == "fft":
            # template spectra trace once per chunk (loop-invariant under
            # the frame map)
            tmpls = [
                prepare_template(p.ref_frames[c], fft_decimate)
                for c in range(n_cams)
            ]
            core = (
                _process_frame_cams_batched if vmap_cameras
                else _process_frame_core
            )

            def one(frame):
                if pre_shift:
                    # hot-pixel repair FIRST (the reference's order), then
                    # split the translation estimate: integer part shifted
                    # off on device, sub-pixel residual solved by ECC with
                    # the shift composed into the validity mask
                    from upsp_tpu.ops.warp import MAX_INTEGER_SHIFT, integer_shift

                    fixed = [fix_hot_pixels(frame[c]) for c in range(n_cams)]
                    tvecs = jnp.stack(
                        [correlate(tmpls[c], fixed[c]) for c in range(n_cams)]
                    )
                    # clamp to integer_shift's pad budget so the recorded
                    # shift and the shifted image stay consistent; an
                    # over-clamped frame carries the excess in the ECC
                    # residual
                    t_int = jnp.clip(
                        jnp.rint(tvecs), -MAX_INTEGER_SHIFT, MAX_INTEGER_SHIFT
                    )
                    shifted = jnp.stack(
                        [
                            integer_shift(
                                fixed[c].astype(jnp.float32), t_int[c]
                            )
                            for c in range(n_cams)
                        ]
                    )
                    init = jax.vmap(translation_warp)(tvecs - t_int)
                    sol, _, tele = core(
                        shifted, p, warp_init=init,
                        ecc_unroll_iters=ecc_iters,
                        ecc_coarse_iters=ecc_coarse_iters,
                        ecc_band=ecc_band, ecc_valid_shift=t_int,
                        fix_hot=False, **static
                    )
                    return sol, tele
                if vmap_cameras:
                    # vmapped phase correlation: one batched FFT over the
                    # camera axis (spectra stacked; window/prior/shape are
                    # shared across cameras of the same image size)
                    t0 = tmpls[0]
                    spec_b = jnp.stack([t.spectrum for t in tmpls])
                    tvecs = jax.vmap(
                        lambda s, im: correlate(t0._replace(spectrum=s), im)
                    )(spec_b, frame)
                else:
                    tvecs = jnp.stack(
                        [correlate(tmpls[c], frame[c]) for c in range(n_cams)]
                    )  # (C, 2) [tx, ty], full-res px
                init = jax.vmap(translation_warp)(tvecs)
                sol, _, tele = core(
                    frame, p, warp_init=init,
                    ecc_unroll_iters=ecc_iters,
                    ecc_coarse_iters=ecc_coarse_iters,
                    ecc_band=ecc_band, **static
                )
                return sol, tele

            sols, teles = _batched_map(one, frames, frame_batch)
        else:
            # without a while_loop ECC solve the frame program has no
            # data-dependent control flow, so it batches like fft mode
            batchable = static["registration"] != "pixel"
            core = (
                _process_frame_cams_batched if (vmap_cameras and batchable)
                else _process_frame_core
            )

            def one(frame):
                sol, _, tele = core(frame, p, **static)
                return sol, tele

            sols, teles = _batched_map(
                one, frames, frame_batch if batchable else 1
            )
        return sols, teles

    if mesh is not None and mesh.devices.size > 1:
        from jax.sharding import PartitionSpec as P

        axis = mesh.axis_names
        fn = jax.shard_map(
            local_chunk,
            mesh=mesh,
            in_specs=P(axis),
            out_specs=(P(axis), P(axis)),
            check_vma=False,
        )
    else:
        fn = local_chunk

    @jax.jit
    def process(chunk: jax.Array):
        sols, teles = fn(chunk)
        if with_telemetry:
            return sols, teles
        return sols

    return process


def make_packed_chunk_processor(
    state,
    with_telemetry: bool = False,
    packed_bits: int = 12,
    lut=None,
    mesh=None,
    warm_start: bool = True,
):
    """Fused ingest: packed camera bytes unpack *on device* then run phase 1.

    Takes (F, C, B) uint8 packed chunks (B = packed_bits/8 * H * W
    bytes/frame) and returns (F, N) intensities in one jitted program.  See
    :func:`make_chunk_processor` for the scan/shard semantics.
    """
    return make_chunk_processor(
        state,
        mesh=mesh,
        warm_start=warm_start,
        with_telemetry=with_telemetry,
        packed=True,
        packed_bits=packed_bits,
        lut=lut,
    )


def process_frames(
    state, frames: jax.Array, batched: bool = True
) -> jax.Array:
    """(F, C, H, W) frame stack -> (F, N) intensities.

    ``lax.map`` serializes over frames inside one XLA program — per-frame
    intermediates (C full images + gradients) never exist for more than one
    frame at a time, which keeps HBM residency flat for long sequences.
    (Stateless identity-start path, kept as the oracle for the warm-started
    chunk processor.)
    """
    fn = make_frame_processor(state)
    if not batched:
        return jnp.stack([fn(frames[i]) for i in range(frames.shape[0])])
    return jax.lax.map(fn, frames)


class Phase1Outputs(NamedTuple):
    intensity: jax.Array  # (F, N) — overlap-adjusted per-frame solutions
    sol_avg: jax.Array  # (N,) mean over frames (NaN where skipped)
    sol_rms: jax.Array  # (N,) root-mean-square over frames
    coverage: jax.Array  # (N,)


def phase1_statistics(intensity: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Frame-axis avg and rms, accumulated in f64 like the reference.

    The reference accumulates partial sums in double to tame round-off
    (psp_process.cpp:1722-1730).  Where x64 is enabled (tests, host) we
    promote; otherwise XLA's tree-shaped f32 reduction bounds the
    error at ~2e-7 relative at 50k frames — measured against an f64 oracle
    in tests/test_pipeline.py::TestStatisticsAccumulation, well inside the
    vv float tolerance (a naive sequential f32 sum would be ~1e-6 and
    growing with F; the tree keeps it O(sqrt(log F)) ulps).
    """
    i64 = intensity.astype(jnp.float64) if jax.config.jax_enable_x64 else intensity
    avg = jnp.mean(i64, axis=0).astype(jnp.float32)
    rms = jnp.sqrt(jnp.mean(i64 * i64, axis=0)).astype(jnp.float32)
    return avg, rms
