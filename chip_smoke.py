#!/usr/bin/env python3
"""Smoke run of ``scripts/upsp-process`` on one NVIDIA GPU at production width.

The deployment it drives is the reference's production datapoint: 4 cameras
x 1200x1800 packed 12-bit video, a ~1.05M-node grid, polynomial patching,
fft-initialised ECC registration, best-view projection, then the
frames->nodes transpose and phase 2 (delta-Cp).  Depth is cut to 128 frames
(two 64-frame chunks); the data is synthesized from a seed.

Phases, in order (any failure exits non-zero before the last line):

1. card and build: the card's name and power limit (``nvidia-smi``), the
   native host library built from ``cpp/`` with ``make``;
2. deck: the seeded datapoint (video, grid, camera JSONs, WTD, paint
   calibration, fiducial targets, input deck) in a temporary directory;
3. run: ``upsp-process -input_deck deck.inp --registration-telemetry`` in a
   child process, then checks of its outputs;
4. parity: ``pytest -m gpu`` in a child, then — in this process, the only
   one on the card from here on — each camera's patch fill gain (every
   boundary ring whole), the device unpack and the combined gather
   against numpy (exact), and the phase-1 chunk program on the GPU at
   default and at "highest" matmul precision against the CPU backend, on
   the frames whose registration the run's telemetry rates worst, with the
   largest error split between patched nodes and the rest; a bfloat16
   control must fail the default-precision tolerance;
5. informational timings (not a benchmark), each line naming the card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

``--four-gpus`` instead runs ``upsp-process --mesh auto`` in core and with
``--streaming`` over four cards and compares both with the one-card run of
the same deck, all at the default matmul precision, and checks from the
in-core run's telemetry sidecar that every card held its share.  Every
comparison reports before the first failure is raised; its last line
reports ``count`` 4.

Usage:  python chip_smoke.py [--four-gpus]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# production datapoint (ROADMAP deployment D1), depth cut to two chunks
SIZE = dict(
    n_cameras=4, image_hw=(1200, 1800), grid_shape=(1024, 1024),
    n_frames=128, n_targets=24,
)
FRAMES_PER_CHUNK = 64
PARITY_FRAMES = 4

# parity tolerances (error over full scale, covered nodes; see rel_err).
# "highest": both sides are full-f32 programs; they differ only in
# reduction order and FFT implementation, which move the converged ECC warp
# by ~1e-6 px.  Default precision: the GPU's f32 warp matmuls run as TF32
# (10-bit operand mantissa, ~5e-4 relative per rounding, a few roundings
# per warp); the patch matmul runs at "highest" (ops/patching.py), and a
# patched node carries its ring's rounding times the fill gain (~3.4 on
# this deck, checked).  A bfloat16 image pipeline rounds each stage to
# 2^-9 relative (~2.6e-3 at 3000 counts), so it must fail the p99 bound
# (checked).
TOL_HIGHEST = 1e-4
TOL_DEFAULT_MAX = 5e-3
TOL_DEFAULT_P99 = 1e-3
# every frame and camera of the deck must register: each frame is its
# template shifted by a sub-pixel amount with a 1% gain change
RHO_FLOOR = 0.999
# four cards vs one card of the same deck at the default precision.  Each
# card runs the one-card per-frame program on its frames; what separates
# them is f32/TF32 rounding and summation order (the GEMM algorithms each
# process's autotuner picks, phase 2's node blocks), times the fill gain on
# patched nodes.  Intensity:
# max |diff| / max |ref|.  Pressure: max |diff| in units of the
# intensity ratio (over max |gain| * 144 / qbar), since delta-Cp is the
# detrended ratio and its own maximum is only the ratio's fluctuation.
TOL_FOUR_VS_ONE = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- phase 1: card and build ----------------------------------------------


def card_line() -> str:
    """``name, power.limit`` of GPU 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi lists no GPU")
    return out[0].strip()


def build_native() -> None:
    subprocess.run(
        ["make", "-C", os.path.join(REPO, "cpp")], check=True,
        stdout=subprocess.DEVNULL, timeout=600,
    )


# ---- phase 2: deck ---------------------------------------------------------


def make_deck(root: str, size=None, seed: int = 0) -> str:
    """Write the seeded datapoint under ``root``; returns the deck path."""
    from upsp_tpu.pipeline.synthetic import write_datapoint

    s = dict(SIZE if size is None else size)
    return write_datapoint(
        root, s.pop("n_frames"), s.pop("image_hw"), s.pop("grid_shape"),
        seed=seed, **s,
    )


# ---- phase 3: run the entry point ----------------------------------------


def run_cli(deck: str, extra=(), env=None) -> float:
    """Run ``upsp-process`` on ``deck`` in a child; returns its wall time.

    The child's output goes to ``<deck>.log``; its tail is raised with the
    error when it fails.
    """
    cmd = [
        sys.executable, os.path.join(REPO, "scripts", "upsp-process"),
        "-input_deck", deck, "--registration-telemetry", "-v",
        "--frames-per-chunk", str(FRAMES_PER_CHUNK), *extra,
    ]
    log_path = deck + ".log"
    t0 = time.perf_counter()
    with open(log_path, "w") as fh:
        rc = subprocess.run(
            cmd, stdout=fh, stderr=subprocess.STDOUT, timeout=1800,
            env=dict(os.environ, **(env or {})),
        ).returncode
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(log_path) as fh:
            tail = fh.read()[-4000:]
        raise RuntimeError(f"upsp-process exited {rc}:\n{tail}")
    return wall


def check_outputs(out_dir: str, n_frames: int, n_nodes: int, n_cams: int,
                  telemetry: bool = True):
    """Assert the datapoint's outputs; returns a summary dict.

    All 15 flat files at their sizes, intensity finite on covered nodes,
    and (``telemetry``) the registration record of shape (F, C, 5) with
    every rho at least :data:`RHO_FLOOR`.
    """
    from upsp_tpu.io.flatfile import FLAT_FILES, read_flat
    from upsp_tpu.pipeline.diagnostics import read_registration_telemetry

    per_node = {"intensity", "intensity_transpose", "pressure_transpose"}
    bad = []
    for name in FLAT_FILES:
        path = os.path.join(out_dir, name)
        want = 4 * n_nodes * (n_frames if name in per_node else 1)
        got = os.path.getsize(path) if os.path.exists(path) else None
        if got != want:
            bad.append(f"{name}: {got} bytes, want {want}")
    if bad:
        raise AssertionError("flat files wrong: " + "; ".join(bad))
    cov = read_flat(os.path.join(out_dir, "coverage"))
    covered = cov > 0
    if covered.mean() < 0.5:
        raise AssertionError(f"only {covered.mean():.3f} of nodes covered")
    inten = np.memmap(
        os.path.join(out_dir, "intensity"), "<f4", mode="r",
        shape=(n_frames, n_nodes),
    )
    n_bad = int((~np.isfinite(inten[:, covered])).sum())
    if n_bad:
        raise AssertionError(f"{n_bad} non-finite intensities on covered nodes")
    summary = {
        "flat_files": len(FLAT_FILES),
        "covered_frac": float(covered.mean()),
        "h5_written": any(f.endswith(".h5") for f in os.listdir(out_dir)),
    }
    if telemetry:
        tele = read_registration_telemetry(
            os.path.join(out_dir, "registration"), n_cams
        )
        if tele.shape != (n_frames, n_cams, 5):
            raise AssertionError(f"telemetry shape {tele.shape}")
        rho = tele[..., 0]
        summary["rho_min"] = float(rho.min())
        if not rho.min() >= RHO_FLOOR:
            f, c = np.unravel_index(np.argmin(rho), rho.shape)
            raise AssertionError(
                f"frame {f} camera {c} registered at rho {rho[f, c]:.4f} "
                f"< {RHO_FLOOR}"
            )
    return summary


def worst_registered_frames(out_dir: str, n_cams: int, k: int) -> list:
    """The ``k`` frames with the lowest rho over cameras, worst first."""
    from upsp_tpu.pipeline.diagnostics import read_registration_telemetry

    tele = read_registration_telemetry(
        os.path.join(out_dir, "registration"), n_cams
    )
    return [int(f) for f in np.argsort(tele[..., 0].min(axis=1))[:k]]


# ---- phase 4: parity --------------------------------------------------------


def run_gpu_tests() -> str:
    """``pytest -m gpu`` in a child (this process is still off the card);
    returns pytest's summary line.  A skip counts as a failure here."""
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", os.path.join(REPO, "tests", "test_gpu.py")],
        cwd=REPO, timeout=900, capture_output=True, text=True,
    )
    summary = (r.stdout.strip().splitlines() or [""])[-1]
    if r.returncode != 0 or "skipped" in summary or "passed" not in summary:
        raise RuntimeError(
            f"pytest -m gpu: {summary}\n{r.stdout[-4000:]}{r.stderr[-2000:]}"
        )
    return summary


def load_state(deck: str):
    """Phase 0 on the deck in this process; returns (state, cfg, seconds)."""
    from upsp_tpu.pipeline.config import read_input_deck
    from upsp_tpu.pipeline.phase0 import run_phase0
    from upsp_tpu.pipeline.run import open_videos

    cfg = read_input_deck(deck)
    readers, _, _ = open_videos(cfg)
    try:
        first = [r.read_frame(0) for r in readers]
        bits = [r.bit_depth for r in readers]
    finally:
        for r in readers:
            r.close()
    t0 = time.perf_counter()
    state = run_phase0(cfg, first, bits)
    return state, cfg, time.perf_counter() - t0


def read_packed(cfg, frames) -> np.ndarray:
    """(F, C, B) packed bytes of the deck's ``frames``: a count (the first
    frames) or a list of frame indices."""
    from upsp_tpu.pipeline.run import open_videos

    readers, _, _ = open_videos(cfg)
    try:
        if isinstance(frames, int):
            return np.stack(
                [r.read_packed_frames(frames) for r in readers], axis=1
            )
        return np.stack([
            np.concatenate([r.read_packed_frames(1, start=f) for f in frames])
            for r in readers
        ], axis=1)
    finally:
        for r in readers:
            r.close()


def patched_nodes(state) -> np.ndarray:
    """(N,) bool: nodes whose value comes from a patch interior pixel or
    its 3x3 filter neighbourhood, in the output's (overlap-adjusted) order.

    Those pixels are a linear fill of the boundary ring, so they carry any
    error of the ring times the operator's fill gain.
    """
    from scipy.ndimage import binary_dilation

    from upsp_tpu.pipeline.phase1 import phase1_params

    H, W = state.image_hw
    mask = np.zeros((state.n_cameras, H * W), bool)
    for c, op in enumerate(state.patch_ops):
        if op is not None:
            idx = np.asarray(op.internal_idx).reshape(-1)
            mask[c, idx[idx < H * W]] = True
    mask = np.stack([binary_dilation(m.reshape(H, W)) for m in mask])
    p = phase1_params(state)
    if p.combined_index is None:
        raise AssertionError("best-view deck did not take the combined gather")
    return mask.reshape(-1)[np.asarray(p.combined_index)][
        np.asarray(state.superseded_by)]


def split_max(d: np.ndarray, patched: np.ndarray):
    """(max over patched nodes, max over the rest) of a (F, N) error."""
    d = np.where(np.isfinite(d), d, 0.0)
    return float(d[:, patched].max(initial=0.0)), float(
        d[:, ~patched].max(initial=0.0))


def rel_err(a: np.ndarray, ref: np.ndarray):
    """(max, p99, median) of |a - ref| over full scale (max |ref|), over
    entries finite in ``ref``.

    Full scale, not each entry's own value: a matmul's rounding error
    scales with its operands (the image, ~full scale), so a node whose
    warp sampled the zero border, and whose value is small, would read an
    ordinary TF32 error as a large relative one.
    """
    fin = np.isfinite(ref)
    if not np.array_equal(fin, np.isfinite(a)):
        raise AssertionError("finite masks differ")
    e = np.abs(a[fin] - ref[fin]) / np.abs(ref[fin]).max()
    return float(e.max()), float(np.percentile(e, 99)), float(np.median(e))


def check_unpack(state, packed: np.ndarray) -> None:
    """Device unpack of packed frames == the host unpacker, exactly."""
    import jax.numpy as jnp

    from upsp_tpu.io.video.util import unpack_12bpp
    from upsp_tpu.pipeline.phase1 import _make_unpacker

    H, W = state.image_hw
    got = np.asarray(_make_unpacker(12, None, (H, W))(jnp.asarray(packed)))
    F, C, _ = packed.shape
    want = np.stack(
        [np.stack([unpack_12bpp(packed[f, c]) for c in range(C)])
         for f in range(F)]
    ).reshape(F, C, H, W)
    if not np.array_equal(got, want):
        raise AssertionError("device unpack differs from the host unpacker")


def check_gather(state, seed: int = 0) -> None:
    """The combined projection gather == numpy take of the same indices."""
    import jax
    import jax.numpy as jnp

    from upsp_tpu.pipeline.phase1 import phase1_params

    p = phase1_params(state)
    if p.combined_index is None:
        raise AssertionError("best-view deck did not take the combined gather")
    idx = np.asarray(p.combined_index)
    C = state.n_cameras
    H, W = state.image_hw
    src = np.random.default_rng(seed).random(C * H * W, np.float32)
    got = np.asarray(jax.jit(lambda s: s[p.combined_index])(jnp.asarray(src)))
    if not np.array_equal(got, np.take(src, idx)):
        raise AssertionError("device gather differs from numpy take")


def chunk_program(state, frame_batch: int, compute_dtype: str = "float32"):
    """The production phase-1 program (fft ECC init, packed ingest)."""
    from upsp_tpu.pipeline.phase1 import make_chunk_processor

    return make_chunk_processor(
        state, warm_start="fft", frame_batch=frame_batch, packed=True,
        compute_dtype=compute_dtype,
    )


def parity(state, packed: np.ndarray):
    """Phase-1 chunk program on the default device (default and "highest"
    matmul precision, and the bfloat16 control) vs the f32 program on the
    CPU backend.  Returns ({name: (max, p99, median) relative error},
    {name: (max over patched nodes, max over the rest)})."""
    import jax

    cpu = jax.devices("cpu")[0]
    n = packed.shape[0]
    x = jax.numpy.asarray(packed)
    got = {"default": np.asarray(chunk_program(state, n)(x))}
    with jax.default_matmul_precision("highest"):
        got["highest"] = np.asarray(chunk_program(state, n)(x))
    got["bfloat16"] = np.asarray(chunk_program(state, n, "bfloat16")(x))
    with jax.default_device(cpu):
        st_cpu = state.to_device(cpu)
        ref = np.asarray(
            chunk_program(st_cpu, n)(jax.device_put(packed, cpu))
        )
    patched = patched_nodes(state)
    scale = np.nanmax(np.abs(ref))
    err = {k: rel_err(v, ref) for k, v in got.items()}
    split = {k: split_max(np.abs(v - ref) / scale, patched)
             for k, v in got.items()}
    return err, split


def check_patches(state) -> None:
    """Log each camera's patch fill gain; every cluster of the deck must
    keep its boundary ring, or the patched nodes would magnify rounding
    and noise past the parity bounds (ops/patching.fill_gain)."""
    from upsp_tpu.ops.patching import fill_gain
    from upsp_tpu.pipeline.phase0 import FILL_GAIN_WARN

    gains = [fill_gain(op) for op in state.patch_ops]
    clusters = [0 if op is None else op.n_clusters for op in state.patch_ops]
    log(f"patching: clusters per camera {clusters}, fill gain "
        f"{[round(g, 2) for g in gains]} (limit {FILL_GAIN_WARN:g})")
    if not min(clusters) > 0 or max(gains) > FILL_GAIN_WARN:
        raise AssertionError("the deck's patch operators are not well posed")


def check_parity(err: dict) -> None:
    """Hold :func:`parity`'s errors to the tolerances; the bfloat16 control
    must fail the default-precision p99 bound, or that bound could not
    tell a slip to bf16 from TF32."""
    if err["highest"][0] > TOL_HIGHEST:
        raise AssertionError("'highest' intensities off the CPU reference")
    if (err["default"][0] > TOL_DEFAULT_MAX
            or err["default"][1] > TOL_DEFAULT_P99):
        raise AssertionError("default-precision intensities off the CPU "
                             "reference")
    if err["bfloat16"][1] <= TOL_DEFAULT_P99:
        raise AssertionError("the bfloat16 control passes the p99 bound")


# ---- phase 5: informational timings ----------------------------------------


def time_call(fn, *args, reps: int = 10) -> float:
    """Mean seconds per call after one warm-up, ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def phase1_rate(state, packed_chunk: np.ndarray):
    """(compile s, frames/s) of the production chunk program on one chunk."""
    import jax
    import jax.numpy as jnp

    fn = chunk_program(state, 8)
    x = jnp.asarray(packed_chunk)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(x))
    compile_s = time.perf_counter() - t0
    per = time_call(fn, x, reps=3)
    return compile_s, packed_chunk.shape[0] / per


def op_times(state, packed_frame: np.ndarray) -> dict:
    """Per-op XLA times (ms) at the deck's width, one camera image each
    except the gather (all cameras, every node) and the unpack (one
    4-camera frame)."""
    import jax
    import jax.numpy as jnp

    from upsp_tpu.ops.image import apply_filter, fix_hot_pixels
    from upsp_tpu.ops.registration import ecc_affine, warp_affine
    from upsp_tpu.ops.warp import warp_affine_mxu
    from upsp_tpu.pipeline.phase1 import _make_unpacker, phase1_params

    H, W = state.image_hw
    raw = _make_unpacker(12, None, (H, W))(jnp.asarray(packed_frame))[0, 0]
    img = raw.astype(jnp.float32)
    ref = state.ref_frames[0]
    warp = jnp.asarray([[1.0003, -2e-4, 0.41], [1e-4, 0.9998, -0.73]],
                       jnp.float32)

    def ecc(k):
        return jax.jit(lambda r, i: ecc_affine(
            r, i, max_iters=k, unroll=True, warp_init=warp)[0])

    t1 = time_call(ecc(1), ref, img)
    t3 = time_call(ecc(3), ref, img)
    p = phase1_params(state)
    stacked = jnp.zeros((state.n_cameras * H * W,), jnp.float32) + 1.0
    out = {
        "gn_step": (t3 - t1) / 2,
        "ecc_solve_2_steps_with_blur": (t1 + t3) / 2,
        "final_warp_plus_filter": time_call(jax.jit(
            lambda i, w: apply_filter(warp_affine_mxu(i, w), "gaussian", 3)
        ), img, warp),
        "hot_pixel_repair": time_call(jax.jit(fix_hot_pixels), raw),
        "combined_gather_all_nodes": time_call(jax.jit(
            lambda s: s[p.combined_index] * p.combined_weight
        ), stacked),
        "unpack_one_frame_all_cameras": time_call(
            jax.jit(_make_unpacker(12, None, (H, W))),
            jnp.asarray(packed_frame),
        ),
        "dense_warp": time_call(warp_affine_mxu, img, warp),
        "gather_warp": time_call(warp_affine, img, warp),
    }
    with jax.default_matmul_precision("highest"):
        out["dense_warp_highest"] = time_call(warp_affine_mxu, img, warp)
    return {k: v * 1e3 for k, v in out.items()}


def matmul_precision() -> dict:
    """What a default-precision f32 matmul does on this card: its error
    against float64 next to the error at "highest"."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.random((1024, 1024), np.float32)
    b = rng.random((1024, 1024), np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    mm = jax.jit(jnp.matmul)
    d = np.asarray(mm(jnp.asarray(a), jnp.asarray(b)))
    with jax.default_matmul_precision("highest"):  # retraces under it
        h = np.asarray(mm(jnp.asarray(a), jnp.asarray(b)))
    return {
        "default_rel": float(np.abs(d - exact).max() / np.abs(exact).max()),
        "highest_rel": float(np.abs(h - exact).max() / np.abs(exact).max()),
    }


def device_json(devices) -> str:
    d0 = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices),
    }})


def require_gpus(n: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        raise SystemExit(
            f"chip_smoke needs {n} GPU(s); JAX found {devs}"
        )
    return devs[:n]


# ---- drivers ----------------------------------------------------------------


def smoke_one(root: str) -> None:
    from upsp_tpu.utils.compile_cache import enable_compile_cache

    card = card_line()
    log(f"card: {card}")
    build_native()
    from upsp_tpu import native  # loads the library it finds at import

    native_ok = native.available()
    log(f"native host library: {'built' if native_ok else 'MISSING'}")
    if not native_ok:
        raise RuntimeError("cpp/libupsp_native.so did not load after make")

    t0 = time.perf_counter()
    deck = make_deck(root)
    log(f"deck: {SIZE} written in {time.perf_counter() - t0:.1f} s")

    wall = run_cli(deck, ["--platform", "gpu"])
    from upsp_tpu.pipeline.config import read_input_deck

    cfg = read_input_deck(deck)
    n_nodes = SIZE["grid_shape"][0] * SIZE["grid_shape"][1]
    summary = check_outputs(
        cfg.out_dir, SIZE["n_frames"], n_nodes, SIZE["n_cameras"]
    )
    log(f"upsp-process: {SIZE['n_frames']} frames in {wall:.1f} s wall "
        f"(phase 0 + compile + phases 1-2 + output); outputs {summary}")
    from upsp_tpu.io.flatfile import FLAT_FILES

    log("flat files (bytes): " + ", ".join(
        f"{n} {os.path.getsize(os.path.join(cfg.out_dir, n))}"
        for n in FLAT_FILES))

    log(f"pytest -m gpu: {run_gpu_tests()}")

    # from here on this process is the one on the card
    enable_compile_cache()
    devs = require_gpus(1)
    import jax

    state, cfg, p0_s = load_state(deck)
    log(f"phase 0: {p0_s:.2f} s, {state.n_nodes} nodes, native raycast "
        f"{'yes' if native_ok else 'no'} [{card}]")
    check_patches(state)
    packed = read_packed(cfg, FRAMES_PER_CHUNK)
    check_unpack(state, packed[:2])
    log("parity: device unpack == host unpack_12bpp (exact)")
    check_gather(state)
    log("parity: combined gather == numpy take (exact)")
    worst = worst_registered_frames(cfg.out_dir, SIZE["n_cameras"],
                                    PARITY_FRAMES)
    err, split = parity(state, read_packed(cfg, worst))
    tols = {"default": f"tol max {TOL_DEFAULT_MAX:g}, p99 {TOL_DEFAULT_P99:g}",
            "highest": f"tol max {TOL_HIGHEST:g}",
            "bfloat16": f"control: must exceed p99 {TOL_DEFAULT_P99:g}"}
    for name, (mx, p99, med) in err.items():
        log(f"parity: intensity vs CPU backend (f32), frames {worst} (lowest "
            f"rho), GPU {name}: max/p99/median rel {mx:.3e}/{p99:.3e}/"
            f"{med:.3e}; max on patched / other nodes {split[name][0]:.3e}/"
            f"{split[name][1]:.3e} ({tols[name]})")
    check_parity(err)

    compile_s, fps = phase1_rate(state, packed)
    peak = (devs[0].memory_stats() or {}).get("peak_bytes_in_use", 0)
    log(f"info [{card}]: phase-1 chunk compile {compile_s:.1f} s; "
        f"phase-1 {fps:.1f} frames/s ({len(packed)}-frame chunk, device-resident, "
        f"block_until_ready); peak_bytes_in_use {peak / 2**30:.2f} GiB")
    for name, ms in op_times(state, packed[:1]).items():
        log(f"info [{card}]: op {name} {ms:.3f} ms")
    mp = matmul_precision()
    log(f"info [{card}]: f32 matmul 1024^3 max rel error vs float64: "
        f"default {mp['default_rel']:.2e}, highest {mp['highest_rel']:.2e}")
    print(device_json(devs), flush=True)


def smoke_four(root: str) -> None:
    """Four-card path: --mesh auto (in core, streaming) vs one card."""
    from upsp_tpu.pipeline.config import read_input_deck

    card = card_line()
    log(f"card: {card}")
    build_native()
    deck = make_deck(root)
    cfg = read_input_deck(deck)
    F, C = SIZE["n_frames"], SIZE["n_cameras"]
    n_nodes = SIZE["grid_shape"][0] * SIZE["grid_shape"][1]
    runs = {
        "one_card": (["--platform", "gpu"], {"CUDA_VISIBLE_DEVICES": "0"}),
        "mesh_in_core": (["--platform", "gpu", "--mesh", "auto"], {}),
        "mesh_streaming": (
            ["--platform", "gpu", "--mesh", "auto", "--streaming"], {}
        ),
    }
    outs = {}
    for name, (extra, env) in runs.items():
        deck_n = deck.replace("deck.inp", f"deck_{name}.inp")
        with open(deck) as src, open(deck_n, "w") as dst:
            dst.write(src.read().replace(cfg.out_dir, cfg.out_dir + "_" + name))
        wall = run_cli(deck_n, extra, env=env)
        outs[name] = cfg.out_dir + "_" + name
        log(f"{name}: {F} frames in {wall:.1f} s wall [{card} x "
            f"{1 if name == 'one_card' else 4}]")
        check_outputs(outs[name], F, n_nodes, C,
                      telemetry=name != "mesh_streaming")
    # the CLI children are done; phase 0 here says which nodes are patched
    state, _, _ = load_state(deck)
    check_patches(state)
    patched = patched_nodes(state)
    # every comparison runs and reports before the first failure is raised
    failed = []
    for name in ("mesh_in_core", "mesh_streaming"):
        try:
            lines = compare_runs(outs["one_card"], outs[name], cfg, n_nodes,
                                 C, patched)
        except AssertionError as e:
            failed.append(f"{name}: {e}")
            lines = str(e).splitlines()
        for line in lines:
            log(f"four cards vs one, {name}: {line}")

    # where the in-core mesh run's data went: each card must have held at
    # least its block of one chunk's packed frames
    from upsp_tpu.pipeline.diagnostics import read_registration_meta

    peaks = read_registration_meta(
        os.path.join(outs["mesh_in_core"], "registration")
    ).get("device_peak_bytes_in_use")
    share = FRAMES_PER_CHUNK // 4 * C * SIZE["image_hw"][0] \
        * SIZE["image_hw"][1] * 3 // 2
    log(f"mesh_in_core [{card} x 4]: peak GiB in use per device "
        f"{[round(p / 2**30, 2) for p in peaks or []]} (each >= its "
        f"packed-frame share {share / 2**30:.2f} GiB)")
    if peaks is None or len(peaks) != 4 or min(peaks) < share:
        failed.append("the mesh run does not spread over the cards")
    if failed:
        raise AssertionError("\n".join(failed))
    print(device_json(require_gpus(4)), flush=True)


def compare_runs(ref_dir: str, out_dir: str, cfg, n_nodes: int,
                 n_cams: int, patched=None) -> list:
    """Hold a run's intensity and delta-Cp to a reference run of the same
    deck (:data:`TOL_FOUR_VS_ONE`); returns report lines, the per-frame
    breakdown of the intensity difference beside each frame's rho first,
    then (given the ``patched`` node mask) its maximum on patched nodes
    and on the rest."""
    from upsp_tpu.io.flatfile import read_flat
    from upsp_tpu.io.wtd import read_wtd
    from upsp_tpu.pipeline.diagnostics import read_registration_telemetry

    def load(d, name, shape):
        return read_flat(os.path.join(d, name)).reshape(shape)

    F = os.path.getsize(os.path.join(ref_dir, "intensity")) // (4 * n_nodes)
    ref_i, got_i = (load(d, "intensity", (F, n_nodes))
                    for d in (ref_dir, out_dir))
    ref_p, got_p = (load(d, "pressure_transpose", (n_nodes, F))
                    for d in (ref_dir, out_dir))
    for name, a, b in (("intensity", ref_i, got_i),
                       ("pressure_transpose", ref_p, got_p)):
        if not np.array_equal(np.isfinite(a), np.isfinite(b)):
            raise AssertionError(f"{name}: finite masks differ")
    with np.errstate(invalid="ignore"):
        d_i = np.nan_to_num(np.abs(got_i - ref_i)) / np.nanmax(np.abs(ref_i))
        d_p = np.nan_to_num(np.abs(got_p - ref_p))
    gain = read_flat(os.path.join(ref_dir, "gain"))
    p_unit = np.nanmax(np.abs(gain)) * 144.0 / read_wtd(cfg.sds).qbar
    e_i, e_p = float(d_i.max()), float(d_p.max() / p_unit)
    rho = read_registration_telemetry(
        os.path.join(ref_dir, "registration"), n_cams
    )[..., 0].min(axis=1)
    per_frame = d_i.max(axis=1)
    worst = np.argsort(per_frame)[::-1][:3]
    lines = [
        "worst frames (max |diff| / max |ref|, rho): " + ", ".join(
            f"{f} ({per_frame[f]:.2e}, {rho[f]:.5f})" for f in worst),
    ]
    if patched is not None:
        lines.append("intensity max |diff| / max |ref| on patched / other "
                     "nodes {:.3e}/{:.3e}".format(*split_max(d_i, patched)))
    lines += [
        f"intensity max |diff| / max |ref| {e_i:.3e} "
        f"(tol {TOL_FOUR_VS_ONE:g})",
        f"pressure_transpose max |diff| / (max |gain| * 144 / qbar) "
        f"{e_p:.3e} (tol {TOL_FOUR_VS_ONE:g})",
    ]
    if max(e_i, e_p) > TOL_FOUR_VS_ONE:
        raise AssertionError("differs from the reference run:\n"
                             + "\n".join(lines))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card mesh path and its "
                         "one-card comparison")
    args = ap.parse_args(argv)
    # the GPU, and the CPU backend for the parity reference; children
    # inherit it.  Set before anything imports jax.
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    root = tempfile.mkdtemp(prefix="upsp_smoke_")
    try:
        (smoke_four if args.four_gpus else smoke_one)(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
