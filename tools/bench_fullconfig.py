"""Full-run-config benchmark: 4 cameras x 2 MP x 1M nodes on one GPU.

Measures the production chunk program (phase 1 fused register/patch/filter/
project) plus the frames->nodes transpose + phase-2 conversion, device-
resident (host ingest is not part of this number).  Times are host-clock
spans ending in ``block_until_ready``; the card's name and power limit are
printed beside them.  Refuses to run without a GPU.

Usage: python tools/bench_fullconfig.py [--mode fft|scan|cold] [--frames 32]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def timed(fn, *args, reps: int = 3) -> float:
    """Median seconds per call after a compiling warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="fft", choices=["fft", "scan", "cold"])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--cams", type=int, default=4)
    ap.add_argument("--hw", default="1200,1800")  # 2.16 MP
    ap.add_argument("--grid", default="1024,1024")  # ~1.05M nodes
    ap.add_argument("--frame-batch", type=int, default=8)
    ap.add_argument("--ecc-iters", type=int, default=None,
                    help="fine GN steps (default: production 2 full-res, 0 coarse)")
    ap.add_argument("--ecc-coarse-iters", type=int, default=None)
    ap.add_argument("--phase1-only", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--vmap-cameras", action="store_true",
                    help="camera-vmapped per-frame program")
    ap.add_argument("--json-out", default=None,
                    help="write the measured record to this JSON file")
    args = ap.parse_args()

    from upsp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from bench import card

    dev = card()
    print(dev["nvidia_smi"], flush=True)

    H, W = map(int, args.hw.split(","))
    gi, gj = map(int, args.grid.split(","))
    F, C = args.frames, args.cams

    from upsp_tpu.pipeline.phase1 import make_chunk_processor, phase1_statistics
    from upsp_tpu.pipeline.synthetic import make_synthetic_state

    t0 = time.time()
    state = make_synthetic_state(
        n_cameras=C, image_hw=(H, W), grid_shape=(gi, gj)
    )
    n_nodes = state.model.size
    print(f"state built: {C} cams x {H}x{W} ({H*W/1e6:.2f} MP), "
          f"{n_nodes/1e6:.2f}M nodes [{time.time()-t0:.1f}s]", flush=True)

    warm = {"fft": "fft", "scan": True, "cold": False}[args.mode]
    fn = make_chunk_processor(
        state,
        warm_start=warm,
        frame_batch=args.frame_batch if args.mode == "fft" else 1,
        ecc_iters=args.ecc_iters if args.mode == "fft" else None,
        ecc_coarse_iters=args.ecc_coarse_iters if args.mode == "fft" else None,
        compute_dtype=args.compute_dtype,
        vmap_cameras=args.vmap_cameras,
    )

    # synthetic frames: integer rolls of a textured base + intensity
    # modulation (ECC still does full solves)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = (
        2000
        + 0.5 * xx
        + 0.3 * yy
        + 400 * np.sin(xx / 37.0) * np.cos(yy / 29.0)
    ).astype(np.float32)
    frames = np.empty((F, C, H, W), np.float32)
    for f in range(F):
        sh = rng.integers(-2, 3, 2)
        img = np.roll(base, tuple(sh), axis=(0, 1))
        frames[f] = img[None] * (1 + 0.01 * np.sin(2 * np.pi * f / 7))
    fr_dev = jnp.asarray(frames)

    t0 = time.time()
    sols = jax.block_until_ready(fn(fr_dev))
    print(f"phase1 compile+run: {time.time()-t0:.1f}s", flush=True)
    t1 = timed(fn, fr_dev, reps=args.reps)
    print(f"phase1: {t1*1e3:.1f} ms / {F} frames = {F/t1:.1f} frames/s "
          f"[{dev['nvidia_smi']}]", flush=True)

    t2 = None
    if not args.phase1_only:
        from upsp_tpu.ops.polyfit import detrend, make_detrender

        det = make_detrender(F, 6)

        @jax.jit
        def phase2_like(sols):
            avg, rms = phase1_statistics(sols)
            ratio = avg[None, :] / jnp.where(sols == 0, 1.0, sols) - 1.0
            node_major = ratio.T  # the all-to-all on a mesh; transpose here
            dcp = detrend(det, node_major) * 1.7 * 144.0 / 350.0
            return dcp, avg, rms

        t2 = timed(phase2_like, sols, reps=args.reps)
        print(f"phase2: {t2*1e3:.1f} ms", flush=True)
        total = t1 + t2
        print(f"END2END: {F/total:.1f} frames/s "
              f"({total*1e3:.1f} ms / {F} frames) [{dev['nvidia_smi']}]",
              flush=True)

    if args.json_out:
        rec = {
            "config": {
                "cams": C, "hw": [H, W], "nodes": int(n_nodes), "frames": F,
                "mode": args.mode, "frame_batch": args.frame_batch,
                "compute_dtype": args.compute_dtype,
            },
            "device": {k: dev[k] for k in ("platform", "kind", "count",
                                           "power_limit")},
            "t_frame_ms_phase1": t1 * 1e3 / F,
            "fps_phase1": F / t1,
            "command": " ".join(sys.argv),
        }
        if t2 is not None:
            rec["t_phase2_ms_per_chunk"] = t2 * 1e3
            rec["t_frame_ms_end2end"] = (t1 + t2) * 1e3 / F
            rec["fps_end2end"] = F / (t1 + t2)
        with open(args.json_out, "w") as fh:
            json.dump(rec, fh, indent=1)
        print(f"wrote {args.json_out}", flush=True)


if __name__ == "__main__":
    main()
