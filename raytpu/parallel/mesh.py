"""Device mesh and distributed setup.

The reference's entire "distribution" story is a single OpenCL device found
by a GPU-type scan (main.cpp:206-211) and a capability printout
(device_info.cpp:30-125).  The JAX equivalents:

  * `make_mesh`      — a 1-D jax.sharding.Mesh over all addressable devices;
                       the axis (default 'px') shards the pixel grid, the
                       ray-tracing analogue of data/sequence parallelism.
                       Scene parameters are replicated (the multi-chip
                       analogue of the kernel's __local scene staging,
                       raytrace_kernel.cl:890-907).
  * `describe_devices` — the device_info.cpp equivalent.
  * `initialize_distributed` — multi-host bring-up (jax.distributed), a
    no-op on a single process.

Forward rendering needs zero collectives (pixels are independent); training
all-reduces scene-parameter gradients with one psum over the pixel axis
(see raytpu.grad.loss_and_grad_sharded / fit_scene).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

PIXEL_AXIS = "px"


def make_mesh(devices=None, axis_name: str = PIXEL_AXIS) -> Mesh:
    """1-D mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def pixel_sharding(mesh: Mesh, axis_name: str = PIXEL_AXIS) -> NamedSharding:
    """Sharding that splits the leading (pixel) axis across the mesh."""
    return NamedSharding(mesh, PartitionSpec(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully-replicated sharding (scene parameters)."""
    return NamedSharding(mesh, PartitionSpec())


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-host bring-up.  Call before any jax computation on pod slices;
    single-process callers can skip it (or call with no args, a no-op when
    jax.distributed is already initialised or unconfigured)."""
    if coordinator is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def gather_image(img):
    """Bring a (possibly cross-process) sharded render back to every host as
    one numpy array — the multi-host analogue of the reference's blocking
    readback (clEnqueueReadBuffer, main.cpp:460-461).  A no-op copy in
    single-process runs."""
    import numpy as np

    if jax.process_count() == 1:
        return np.asarray(img)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(img, tiled=True))


def describe_devices() -> str:
    """Human-readable device/topology dump (≙ output_device_info,
    device_info.cpp:30-125)."""
    lines = []
    lines.append(f"process {jax.process_index()}/{jax.process_count()}, "
                 f"backend={jax.default_backend()}")
    for d in jax.devices():
        lines.append(
            f"  [{d.id}] {d.device_kind} platform={d.platform} "
            f"process={d.process_index} "
            f"coords={getattr(d, 'coords', None)}")
    return "\n".join(lines)
