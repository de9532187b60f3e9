"""Trace one ECC Gauss-Newton step at full width on a GPU and reduce it.

Answers one question with two readings: how many passes over the (H, W)
image do the 42 masked GN moment reductions make once XLA has fused them?

1. Static: the optimized HLO of ``registration.gn_statistics`` and of one
   whole GN step (warp + statistics + 6x6 solve): the fusion launches whose
   computation contains a reduction, and the bytes their operands read,
   also counted in f32 (H, W) images.
2. Dynamic: a ``jax.profiler`` trace of ``--reps`` GN steps, reduced to each
   device kernel's launch count and summed device time, largest first.

Refuses to run without a GPU.  Prints the card's name and power limit.

Usage: python tools/profile_gn_step.py [--hw 1200,1800] [--reps 20]
           [--trace-dir DIR] [--top 25]
"""

import argparse
import collections
import glob
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
                "u16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
                "u64": 8}


def _shape_bytes(text: str) -> int:
    """Bytes of every array shape (``f32[1200,1800]{1,0}``) in ``text``."""
    total = 0
    for dtype, dims in re.findall(r"\b([a-z]+\d*)\[([\d,]*)\]", text):
        if dtype in _DTYPE_BYTES:
            n = int(np.prod([int(d) for d in dims.split(",") if d]))
            total += _DTYPE_BYTES[dtype] * n
    return total


def reduce_fusions(hlo: str):
    """(launches, operand bytes) of the fusion instructions whose called
    computation reduces, from optimized HLO text.  Operands are printed by
    name; their shapes come from the instructions that define them."""
    reducing = set()
    shapes = {}
    name = None
    for line in hlo.splitlines():
        head = re.match(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$", line)
        if head:
            name = head.group(1)
            continue
        inst = re.match(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*?)\s[\w\-]+\(",
                        line)
        if inst:
            shapes[inst.group(1)] = inst.group(2)
        if name and re.search(r"\breduce\(", line):
            reducing.add(name)
    launches = read = 0
    for line in hlo.splitlines():
        call = re.search(r"calls=%?([\w.\-]+)", line)
        if " fusion(" not in line or not call or call.group(1) not in reducing:
            continue
        operands = re.search(r" fusion\((.*?)\), kind=", line)
        launches += 1
        for op in re.findall(r"%?([\w.\-]+)",
                             operands.group(1) if operands else ""):
            read += _shape_bytes(shapes.get(op, ""))
    return launches, read


def kernel_times(trace_dir: str):
    """{kernel name: (launches, summed device ns)} over the GPU planes."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    prof = ProfileData.from_file(path)
    out = collections.defaultdict(lambda: [0, 0])
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Kernel" not in line.name and "Stream" not in line.name:
                continue
            for ev in line.events:
                out[ev.name][0] += 1
                out[ev.name][1] += ev.duration_ns
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default="1200,1800")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    from upsp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from bench import card

    dev = card()
    print(dev["nvidia_smi"], flush=True)

    from upsp_tpu.ops.registration import _ecc_core, gn_statistics
    from upsp_tpu.ops.warp import warp_affine_mxu
    from upsp_tpu.pipeline.synthetic import make_reference_frame

    H, W = map(int, args.hw.split(","))
    tmpl = jnp.asarray(make_reference_frame((H, W), seed=0))
    img = jnp.asarray(make_reference_frame((H, W), seed=0) * 1.01)
    warp = jnp.asarray([[1.0003, -2e-4, 0.41], [1e-4, 0.9998, -0.73]],
                       jnp.float32)
    iw = warp_affine_mxu(img, warp)

    stats = jax.jit(gn_statistics)
    step = jax.jit(lambda r, i, w: _ecc_core(
        r, i, w, max_iters=1, unroll=True)[0])
    image = 4 * H * W
    for label, compiled in (
        ("gn_statistics", stats.lower(iw, tmpl, warp, warp).compile()),
        ("whole GN step (with blur)", step.lower(tmpl, img, warp).compile()),
    ):
        n, read = reduce_fusions(compiled.as_text())
        print(f"reduction fusions, {label}: {n} launches reading "
              f"{read / 1e6:.1f} MB = {read / image:.1f} f32 images "
              f"[{H}x{W}]", flush=True)

    jax.block_until_ready(step(tmpl, img, warp))
    jax.block_until_ready(stats(iw, tmpl, warp, warp))
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="gn_trace_")
    with jax.profiler.trace(trace_dir):
        for _ in range(args.reps):
            out = stats(iw, tmpl, warp, warp)
        jax.block_until_ready(out)
    times = kernel_times(trace_dir)
    total = sum(t for _, t in times.values())
    print(f"gn_statistics trace: {len(times)} kernels, "
          f"{total / args.reps / 1e3:.1f} us device time per call "
          f"[{dev['nvidia_smi']}]", flush=True)
    for name, (n, t) in sorted(times.items(), key=lambda kv: -kv[1][1])[
            : args.top]:
        print(f"  {n / args.reps:5.1f} launches/call "
              f"{t / args.reps / 1e3:9.2f} us/call  {name[:100]}")


if __name__ == "__main__":
    main()
