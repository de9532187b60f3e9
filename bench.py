"""Benchmark: frames/s on one GPU for the fused register+patch+filter+project step.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform", "kind", "count", "power_limit"}, ...}

It refuses to run without a GPU: a CPU number is never reported under a
device metric.  Times are host-clock spans around work that ends in
``block_until_ready``, after a warm-up call that compiles.

Baseline context: the reference (C++/OpenCV psp_process, SURVEY.md section 6)
publishes no frames/s numbers; BASELINE.md's derived anchor is the per-frame
cost of cv::findTransformECC + patch + blur + sparse project on a Xeon core.
``vs_baseline`` reports against a measured single-core OpenCV equivalent of
the same per-frame pipeline at the same sizes (computed here on the fly when
cv2 is available, else against a recorded constant).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N_FRAMES = int(os.environ.get("BENCH_FRAMES", "32"))
IMAGE_HW = (1024, 1024)  # 1 MP
GRID_SHAPE = (160, 128)  # ~20k nodes

# single-core OpenCV reference pipeline (cv::findTransformECC 50-iter cap +
# polynomial patching + GaussianBlur + SpMV) at 1 MP; recomputed live when
# cv2 import succeeds
FALLBACK_REFERENCE_FPS = 1.1


def card() -> dict:
    """JAX's view of the devices plus nvidia-smi's name and power limit;
    exits when there is no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py needs an NVIDIA GPU; JAX found {devs}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs), "power_limit": smi.split(",")[-1].strip(),
        "nvidia_smi": smi,
    }


def _bench_inputs():
    """Synthetic state + device-resident frame buffers (built once)."""
    import jax.numpy as jnp

    from upsp_tpu.pipeline.synthetic import make_frame_batch, make_synthetic_state

    state = make_synthetic_state(
        n_cameras=1, image_hw=IMAGE_HW, grid_shape=GRID_SHAPE
    )
    # tile 8 distinct sub-pixel-jittered frames to N_FRAMES: per-frame device
    # work (ECC iterations on distinct sub-pixel shifts) is unchanged
    n_distinct = min(8, N_FRAMES)
    distinct = make_frame_batch(state, n_distinct)
    reps_tile = -(-N_FRAMES // n_distinct)
    frames = jnp.asarray(np.tile(distinct, (reps_tile, 1, 1, 1))[:N_FRAMES])
    return state, frames


def bench_device(state, frames, compute_dtype: str = "float32", trials=5):
    """Sorted per-trial frames/s of the production chunk program."""
    import jax

    from upsp_tpu.pipeline.phase1 import make_chunk_processor

    # production shape (the run_datapoint default): phase-correlation ECC
    # init + 2 fixed Gauss-Newton steps, vmapped 8 frames per step.
    # BENCH_MODE overrides: fft (default) | scan | cold.
    mode = os.environ.get("BENCH_MODE", "fft")
    warm = {"fft": "fft", "scan": True, "cold": False}[mode]
    fn = make_chunk_processor(
        state,
        warm_start=warm,
        frame_batch=int(os.environ.get("BENCH_FRAME_BATCH", "8")) if mode == "fft" else 1,
        compute_dtype=compute_dtype,
    )
    jax.block_until_ready(fn(frames))  # compile + warm up
    fps = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(frames))
        fps.append(frames.shape[0] / (time.perf_counter() - t0))
    return sorted(fps)


def bench_reference_cpu(n_frames: int = 2) -> float:
    """Single-core OpenCV pipeline equivalent (the reference's per-frame work)."""
    try:
        import cv2
    except ImportError:
        return FALLBACK_REFERENCE_FPS
    cv2.setNumThreads(1)
    from upsp_tpu.pipeline.synthetic import make_frame_batch, make_synthetic_state

    state = make_synthetic_state(
        n_cameras=1, image_hw=IMAGE_HW, grid_shape=GRID_SHAPE
    )
    ref = np.array(state.ref_frames[0])
    frames = make_frame_batch(state, n_frames)[:, 0]
    pix = np.array(state.projections[0].pixel_index)
    w = np.array(state.projections[0].weight)

    t0 = time.perf_counter()
    for f in range(n_frames):
        img = frames[f]
        warp = np.eye(2, 3, dtype=np.float32)
        try:
            cv2.findTransformECC(
                ref, img, warp, cv2.MOTION_AFFINE,
                (cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 50, 1e-3),
            )
        except cv2.error:
            pass
        img = cv2.warpAffine(
            img, warp, (img.shape[1], img.shape[0]),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )
        img = cv2.GaussianBlur(img, (3, 3), 0)
        _ = img.ravel()[pix] * w
    dt = time.perf_counter() - t0
    return n_frames / dt


def main() -> None:
    from upsp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = card()
    print(dev["nvidia_smi"], flush=True)
    state, frames = _bench_inputs()
    # headline = the production DEFAULT (f32 images — reference-parity mode);
    # the bf16 opt-in is measured alongside and reported as an extra key.
    # BENCH_DTYPE pins a single dtype for ad-hoc runs.
    pinned = os.environ.get("BENCH_DTYPE")
    band = bench_device(state, frames, compute_dtype=pinned or "float32")
    fps = band[len(band) // 2]  # median trial
    band_bf16 = (
        None if pinned
        else bench_device(state, frames, compute_dtype="bfloat16")
    )
    try:
        ref_fps = bench_reference_cpu()
    except Exception:
        ref_fps = FALLBACK_REFERENCE_FPS
    rec = {
        "metric": "frames_per_sec_register_project_1MP",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / max(ref_fps, 1e-9),
        "trial_fps_min": band[0],
        "trial_fps_max": band[-1],
        "device": {k: dev[k] for k in ("platform", "kind", "count",
                                       "power_limit")},
    }
    if band_bf16 is not None:
        rec["bf16_optin_fps"] = band_bf16[len(band_bf16) // 2]
        rec["bf16_trial_fps_min"] = band_bf16[0]
        rec["bf16_trial_fps_max"] = band_bf16[-1]
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
