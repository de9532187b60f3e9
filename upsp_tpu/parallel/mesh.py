"""Device mesh + shardings: the SPMD substrate replacing MPI ranks.

The reference is a frames x nodes 2-D block decomposition over MPI ranks with
one global transpose, reductions, and broadcasts (SURVEY.md section 2.3).  Here:

- phase 1 shards the *frame* axis of the video/intensity tensors over the mesh,
- phase 2 shards the *node* axis,
- the MPI Isend/Recv global transpose (psp_process.cpp:707-771) is a single
  sharding-constraint change on the transposed array — XLA emits the
  all-to-all (NVLink within a host, which joins every GPU to every other),
- MPI_Reduce(SUM) of avg/rms partials becomes jnp.mean/psum under the same
  sharding,
- phase-0 "replicate everywhere" is just replicated sharding.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


FRAMES_AXIS = "frames"
HOSTS_AXIS = "hosts"


def make_mesh(
    devices: Optional[Sequence] = None,
    axis: str = FRAMES_AXIS,
    n_hosts: Optional[int] = None,
) -> Mesh:
    """Device mesh over all (or given) devices.

    1-D by default (axis carries the block decomposition).  With ``n_hosts``
    the mesh is 2-D ``(hosts, axis)`` — hosts major so each host's devices
    hold a contiguous frame/node range and the phase-1<->2 all-to-all rides
    the in-host NVLink fabric before the network across hosts.
    """
    devices = list(devices) if devices is not None else jax.devices()
    if n_hosts is not None and n_hosts > 1:
        if len(devices) % n_hosts:
            raise ValueError(
                f"{len(devices)} devices do not divide over {n_hosts} hosts"
            )
        arr = np.array(devices).reshape(n_hosts, -1)
        return Mesh(arr, (HOSTS_AXIS, axis))
    return Mesh(np.array(devices), (axis,))


def mesh_axes(mesh: Mesh) -> tuple:
    """All mesh axis names, for sharding one array axis over every device.

    Both pipeline phases use a 1-D block decomposition over the full rank
    space (the reference's apportion over all MPI ranks, psp_process.cpp:
    611-624) — on a 2-D (hosts, devices) mesh that means sharding the data
    axis over the *combined* axes.
    """
    return tuple(mesh.axis_names)


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """(F, ...) arrays: frames block-distributed over every mesh axis
    (apportion() equivalent, phase-1 layout)."""
    return NamedSharding(mesh, P(mesh_axes(mesh)))


def node_sharding(mesh: Mesh) -> NamedSharding:
    """(N, ...) arrays: nodes block-distributed over every mesh axis
    (phase-2 layout).

    The spec coincides with :func:`frame_sharding` by design — the reference
    decomposes both phases 1-D over the same rank space; what changes between
    phases is WHICH array axis is distributed, not the device layout."""
    return NamedSharding(mesh, P(mesh_axes(mesh)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_frames(mesh: Mesh, array: jax.Array) -> jax.Array:
    return jax.device_put(array, frame_sharding(mesh))


@functools.partial(jax.jit, static_argnames=("mesh",))
def global_transpose(mesh: Mesh, intensity: jax.Array) -> jax.Array:
    """Frames-major (F, N) frame-sharded  ->  node-major (N, F) node-sharded.

    This is the reference's global_transpose / upsp_matrix_transpose collective
    (psp_process.cpp:707-771, cpp/exec/upsp_matrix_transpose.cpp) expressed as
    one resharding constraint; XLA lowers it to one all-to-all collective
    (NCCL over NVLink on a multi-GPU host).
    """
    t = intensity.T  # (N, F)
    return jax.lax.with_sharding_constraint(t, node_sharding(mesh))




def fetch_global(a) -> "np.ndarray":
    """Device array -> host numpy, multi-process safe.

    When the mesh spans processes, shards on other hosts are not addressable
    and plain ``np.asarray`` raises; every process allgathers the global
    value instead (the reference's equivalent is each rank holding only its
    slice + MPI collectives for full views).
    """
    if not hasattr(a, "devices"):
        return np.asarray(a)
    try:
        return np.asarray(a)
    except RuntimeError:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(a, tiled=True))


def local_block(a) -> tuple:
    """This process's contiguous axis-0 block of a row-sharded global array.

    Returns ``(row_start, np.ndarray)``.  With a process-major 1-D mesh
    (jax.devices() order) every process's addressable shards form one
    contiguous row range — the multi-host equivalent of "this rank's slice"
    (reference apportion, psp_process.cpp:611-624).
    """
    shards = sorted(
        a.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    start = shards[0].index[0].start or 0
    pos = start
    parts = []
    for s in shards:
        s0 = s.index[0].start or 0
        if s0 != pos:
            raise ValueError(
                "local shards are not contiguous along axis 0; "
                "use a process-major mesh"
            )
        d = np.asarray(s.data)
        parts.append(d)
        pos += d.shape[0]
    return start, np.concatenate(parts, axis=0)


def apportion(total: int, ranks: int) -> list:
    """Contiguous block sizes per rank (reference apportion, psp_process.cpp:611).

    Kept for host-side IO splitting (per-host video reads / file writes).
    """
    base = total // ranks
    rem = total % ranks
    sizes = [base + (1 if r < rem else 0) for r in range(ranks)]
    starts = [sum(sizes[:r]) for r in range(ranks)]
    return list(zip(starts, sizes))


def pad_to_multiple(array: jax.Array, axis: int, multiple: int, value=0.0):
    """Pad an axis up to a device-count multiple (frames rarely divide evenly)."""
    size = array.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return array, size
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, target - size)
    return jnp.pad(array, pad, constant_values=value), size
