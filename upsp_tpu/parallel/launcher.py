"""Multi-host launch: jax.distributed init + per-host work slicing.

The reference runs under PBS with `mpiexec psp_process` on 20-50 nodes
(docs/md/upsp-swdd.md:307-312); here a multi-host job initializes through
``jax.distributed`` (coordinator address + process id from env or arguments)
and each host reads only its own video-frame slice — the same contiguous
apportioning as the reference's per-rank reads (psp_process.cpp:867-908),
with device-level sharding handled by the mesh (upsp_tpu.parallel.mesh).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional, Tuple

log = logging.getLogger("upsp_tpu.launcher")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    require: bool = False,
) -> Tuple[int, int]:
    """Initialize multi-host JAX; returns (process_id, process_count).

    Arguments default to JAX's standard env vars; ``require=True`` (the
    ``upsp-process --distributed`` path) falls back to JAX's cluster
    auto-detection when nothing is configured explicitly.  On a single host
    with no configuration this is a no-op returning (0, 1).
    """
    import jax

    explicit = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if explicit or os.environ.get("JAX_NUM_PROCESSES"):
        jax.distributed.initialize(
            coordinator_address=explicit,
            num_processes=num_processes
            or int(os.environ.get("JAX_NUM_PROCESSES", "1")),
            process_id=process_id
            if process_id is not None
            else int(os.environ.get("JAX_PROCESS_ID", "0")),
        )
    elif require:
        # cluster auto-detection (SLURM, Open MPI, cloud environments)
        jax.distributed.initialize()
    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


@dataclasses.dataclass(frozen=True)
class ChunkSlice:
    """One global frame chunk and this process's contiguous block of it.

    The padded chunk splits into ``process_count`` equal blocks of
    ``local_rows`` frames (process-major device order, matching a 1-D frame
    sharding over ``jax.devices()``), so in a multi-process run each host
    decodes only its block — the reference's per-rank read-ahead slice
    (psp_process.cpp:867-908) applied per chunk.
    """

    start: int  # global first frame of the chunk (0-based, pre-start0)
    valid: int  # valid frames in the chunk
    padded: int  # chunk rows after padding to a device-count multiple
    local_start: int  # global index of this process's first row
    local_valid: int  # valid frames in this process's block
    local_rows: int  # rows this process contributes (incl. padding)


def chunk_plan(
    n_frames: int,
    frames_per_chunk: int,
    n_devices: int,
    process_id: int,
    process_count: int,
) -> List[ChunkSlice]:
    """Per-chunk host slices for multi-process video ingest."""
    if n_devices % process_count:
        raise ValueError(
            f"{n_devices} devices do not divide over {process_count} processes"
        )
    plan = []
    for s in range(0, n_frames, frames_per_chunk):
        valid = min(frames_per_chunk, n_frames - s)
        padded = -(-valid // n_devices) * n_devices
        local_rows = padded // process_count
        local_start = s + process_id * local_rows
        local_valid = max(0, min(valid - process_id * local_rows, local_rows))
        plan.append(
            ChunkSlice(s, valid, padded, local_start, local_valid, local_rows)
        )
    return plan


def host_frame_slice(n_frames: int, process_id: int, process_count: int):
    """This host's contiguous frame block (start, count) — apportion parity."""
    from upsp_tpu.parallel.mesh import apportion

    return apportion(n_frames, process_count)[process_id]


def host_reads_for_datapoint(cfg, process_id: int, process_count: int):
    """Open this host's video slice: returns (readers, start, count).

    Each host decodes only its own block of frames — video ingest bandwidth
    scales with hosts like the reference's per-rank read-ahead.
    """
    from upsp_tpu.pipeline.run import open_videos

    readers, n_frames, start0 = open_videos(cfg)
    start, count = host_frame_slice(n_frames, process_id, process_count)
    return readers, start0 + start, count
