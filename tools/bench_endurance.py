"""Sustained out-of-core endurance run at a size where out-of-core matters.

Drives the PRODUCTION ``run_datapoint_streaming`` driver end to end — phase 0
(BVH/projection build from real input files), the chunked phase-1 stream with
the native AsyncWriter, the native on-disk frames->nodes blocked transpose,
and the disk-blocked phase 2 — on a multi-thousand-frame 1 MP synthetic
datapoint whose (F, N) intensity matrix can exceed device memory (the
reference's operating regime: 1M nodes x 50k frames == 186 GB per flat file,
docs/md/upsp-user-manual.md:776-780; five-buffer disk scheme
psp_process.cpp:524-563).

Frames are synthesized ON DEVICE (a bank of statically-rolled variants of a
textured base frame, modulated per frame) through the driver's callable
frame-source hook, so the number measures the pipeline and the disk rather
than host-side synthesis.  The tool also measures the disk's raw sequential
bandwidth, the bound a production host's sustained rate meets.  Refuses to
run without a GPU.

Usage: python tools/bench_endurance.py --out-dir DIR [--frames 4608]
         [--grid 1024,1024] [--hw 1024,1024] [--chunk 64]
         [--node-block 65536] [--json-out FILE]
"""

import argparse
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def probe_disk(path: str, nbytes: int = 2 << 30) -> dict:
    """Raw sequential write/read bandwidth of the filesystem holding path."""
    import ctypes

    blk = np.random.default_rng(0).integers(
        0, 255, size=nbytes, dtype=np.uint8
    ).tobytes()
    fp = os.path.join(path, "_diskprobe.bin")
    t0 = time.perf_counter()
    with open(fp, "wb") as fh:
        fh.write(blk)
        fh.flush()
        os.fsync(fh.fileno())
    t_w = time.perf_counter() - t0
    # drop the page cache for this file so the read probe hits the disk
    fd = os.open(fp, os.O_RDONLY)
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.posix_fadvise(fd, 0, 0, 4)  # POSIX_FADV_DONTNEED
    finally:
        os.close(fd)
    t0 = time.perf_counter()
    with open(fp, "rb") as fh:
        while fh.read(64 << 20):
            pass
    t_r = time.perf_counter() - t0
    os.remove(fp)
    return {
        "write_MBps": round(nbytes / t_w / 1e6, 1),
        "read_MBps": round(nbytes / t_r / 1e6, 1),
        "probe_bytes": nbytes,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4608)
    ap.add_argument("--hw", default="1024,1024")
    ap.add_argument("--grid", default="1024,1024")
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--node-block", type=int, default=131072)
    ap.add_argument("--out-dir", required=True,
                    help="scratch directory for the flat files")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--keep-files", action="store_true")
    ap.add_argument("--write-hdf5", action="store_true",
                    help="also stream the HDF5 (adds another (N,F)-sized file)")
    args = ap.parse_args()

    H, W = map(int, args.hw.split(","))
    gi, gj = map(int, args.grid.split(","))
    F = args.frames
    n_nodes_approx = gi * gj
    fn_bytes = F * n_nodes_approx * 4
    print(
        f"endurance config: {F} frames x {H}x{W} ({H*W/1e6:.2f} MP), "
        f"{n_nodes_approx/1e6:.2f}M nodes -> (F,N) = {fn_bytes/2**30:.1f} GiB "
        f"per flat file",
        flush=True,
    )
    need = fn_bytes * (3 + (1 if args.write_hdf5 else 0)) + (4 << 30)
    free = shutil.disk_usage(os.path.dirname(args.out_dir) or "/").free
    if free < need:
        sys.exit(f"need ~{need/2**30:.0f} GiB free, have {free/2**30:.0f}")

    os.makedirs(args.out_dir, exist_ok=True)
    disk = probe_disk(args.out_dir)
    print(f"disk: {disk}", flush=True)

    from upsp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from bench import card

    dev = card()
    print(dev["nvidia_smi"], flush=True)

    from upsp_tpu.pipeline.config import CameraInputs, ProcessingConfig
    from upsp_tpu.pipeline.run import run_datapoint_streaming
    from upsp_tpu.pipeline.synthetic import (
        make_reference_frame,
        plate_focal_px,
        write_inputs,
    )
    from upsp_tpu.utils.timing import StageClock

    paths = write_inputs(
        args.out_dir, grid_shape=(gi, gj), focal_px=plate_focal_px((H, W))
    )
    cfg = ProcessingConfig(
        test_id="endurance", run=1, sequence=1,
        cameras=[CameraInputs(number=1, calibration=paths["cameras"][0])],
        grid=paths["grid"], sds=paths["wtd"], paint_cal=paths["paint"],
        registration="pixel", target_patcher="none",
        out_dir=os.path.join(args.out_dir, "out"),
        frames=F,
    )
    os.makedirs(cfg.out_dir, exist_ok=True)

    # device-resident frame bank: V statically-rolled variants of a textured
    # base (static rolls compile instantly), gathered + modulated per chunk
    V = 16
    base = make_reference_frame((H, W), seed=0).astype(np.float32)
    rng = np.random.default_rng(7)
    shifts = rng.integers(-2, 3, size=(V, 2))
    shifts[0] = 0  # frame 0 is the ECC template
    bank = jnp.asarray(
        np.stack([np.roll(base, tuple(s), axis=(0, 1)) for s in shifts])
    )  # (V, H, W), uploaded once

    @jax.jit
    def synth(idx):
        mod = 1.0 + 0.01 * jnp.sin(2.0 * jnp.pi * idx.astype(jnp.float32) / 7.0)
        return bank[idx % V][:, None] * mod[:, None, None, None]

    def source(start, count):
        return synth(jnp.arange(start, start + count))

    clock = StageClock()
    t0 = time.perf_counter()
    out = run_datapoint_streaming(
        cfg,
        frames_per_chunk=args.chunk,
        node_block=args.node_block,
        frames_array=source,
        write_hdf5=args.write_hdf5,
        stage_clock=clock,
    )
    wall = time.perf_counter() - t0
    n_nodes = int(out.intensity_avg.shape[0])
    stages = {label: round(since, 2) for label, _, since, _ in clock.records}
    t_proc = sum(
        stages.get(k, 0.0)
        for k in ("phase1_stream", "disk_transpose", "phase2_blocks")
    )
    rec = {
        "metric": "sustained_fps_out_of_core_1MP",
        "value": round(F / t_proc, 2),
        "unit": "frames/s",
        "config": {
            "frames": F, "hw": [H, W], "nodes": n_nodes,
            "chunk": args.chunk, "node_block": args.node_block,
            "flat_file_GiB": round(fn_bytes / 2**30, 2),
        },
        "device": {k: dev[k] for k in ("platform", "kind", "count",
                                       "power_limit")},
        "stages_s": stages,
        "wall_s": round(wall, 1),
        "phase1_fps": round(F / stages["phase1_stream"], 2),
        "disk": disk,
        "command": " ".join(sys.argv),
    }
    # a host's sustained rate is bound by min(device, disk): each frame
    # moves 4N bytes device->disk (write), then 4N disk->device->disk in
    # phase 2
    bytes_per_frame = 4 * n_nodes
    rec["disk_bound_fps"] = round(
        min(disk["write_MBps"], disk["read_MBps"]) * 1e6 / bytes_per_frame, 1
    )
    print(json.dumps(rec), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(rec, fh, indent=1)
        print(f"wrote {args.json_out}", flush=True)
    if not args.keep_files:
        shutil.rmtree(cfg.out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
