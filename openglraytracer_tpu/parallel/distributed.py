"""Multi-host runtime: initialization and host-side image gather.

The reference's 'distributed backend' is the single-GPU GL command queue
(main.cpp:223-238). The JAX equivalent (SURVEY.md §5):
``jax.distributed.initialize()`` for the multi-host coordinator, XLA
collectives (NCCL on GPUs) inside jitted code, and a process_allgather to
assemble the final image on every host (the analog of the fragment-shader
blit + swapchain, draw_screen_frag.glsl + main.cpp:243-260).
"""

from __future__ import annotations

import logging
import os

import jax
import numpy as np

log = logging.getLogger(__name__)


def _already_initialized() -> bool:
    # Prefer the public API (ADVICE r2: the private global_state moved once
    # already); fall back to the private attribute, then to process_count.
    if hasattr(jax.distributed, "is_initialized"):
        try:
            return bool(jax.distributed.is_initialized())
        except Exception:
            pass
    try:
        from jax._src import distributed
        return distributed.global_state.client is not None
    except Exception:
        return jax.process_count() > 1


def cluster_from_env() -> dict | None:
    """The cluster a launcher described in the environment, as keyword
    arguments for jax.distributed.initialize: JAX_COORDINATOR_ADDRESS (or
    COORDINATOR_ADDRESS) with JAX_NUM_PROCESSES and JAX_PROCESS_ID. None
    when no coordinator address is set."""
    addr = (os.environ.get("JAX_COORDINATOR_ADDRESS")
            or os.environ.get("COORDINATOR_ADDRESS"))
    if not addr:
        return None
    try:
        return dict(coordinator_address=addr,
                    num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
                    process_id=int(os.environ["JAX_PROCESS_ID"]))
    except KeyError as e:
        raise RuntimeError(f"coordinator address {addr!r} is set but {e} "
                           f"is not") from None


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize the JAX multi-host runtime.

    Explicit arguments initialize unconditionally (errors propagate — a
    mis-specified cluster must never silently fall back to single-process).
    With no arguments, a cluster described by the environment
    (cluster_from_env) initializes with those arguments; a plain
    single-host run stays single-process. No-op if already initialized.
    """
    if _already_initialized():
        return
    if coordinator_address is not None or num_processes is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        return
    cluster = cluster_from_env()
    if cluster is not None:
        jax.distributed.initialize(**cluster)
        log.info("jax.distributed initialized: process %d/%d",
                 jax.process_index(), jax.process_count())


def gather_image(image) -> np.ndarray:
    """Assemble a (possibly multi-host sharded) image on every host as numpy.

    Single-host arrays (even sharded over local devices) are fully addressable
    and transfer directly; multi-host arrays go through an allgather.
    """
    if jax.process_count() == 1 or image.is_fully_addressable:
        return np.asarray(image)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(image, tiled=True))
