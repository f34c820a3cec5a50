"""Asynchronous cluster runtime: real worker processes behind the serving
stack.

The modeled backends draw their completion process from a latency model;
the cluster runtime executes encode shards on real OS processes and feeds
the serving loop *measured* completion events:

* :mod:`~repro_torch.cluster.config`  — :class:`ClusterConfig` /
  :data:`global_config`: the runtime's tunables (the reference's
  ``SAC_CLUSTER_*`` environment defaults, explicit kwargs win).
* :mod:`~repro_torch.cluster.worker`  — worker processes (injectable chaos:
  sleep jitter / slow hosts / crash / hang) and the **compute seam**:
  :class:`ShardComputer` with numpy and device (the ``coded_matmul``
  kernel on the worker's card) implementations.
* :mod:`~repro_torch.cluster.transport` — the **transport seam**:
  :class:`Transport` (framed messages, operand broadcast, result
  streaming, heartbeat) with ``local`` pipes/shm and ``socket`` TCP.
* :mod:`~repro_torch.cluster.pool`    — :class:`WorkerPool`: ``acquire``/
  ``release`` with warm spares, liveness reaping, dead-worker replacement —
  the elastic controller's scale-*out* path.
* :mod:`~repro_torch.cluster.events`  — the :class:`ShardEvent` stream +
  :class:`TraceRecording` record/replay (cluster runs replay bit-identical
  through the simulated path).
* :mod:`~repro_torch.cluster.backend` — :class:`ClusterBackend` (live
  dispatch for the serving loop) and :class:`ReplayBackend`.

``worker`` is the multiprocessing spawn target, so this package stays
importable without torch; the backend (which pulls in the serving package)
is loaded lazily.
"""
from .config import ClusterConfig, global_config
from .events import BatchRecord, ShardEvent, TraceRecording
from .pool import WorkerHandle, WorkerPool
from .transport import (LocalTransport, SocketTransport, Transport,
                        TransportClosed, make_transport)
from .worker import (ChaosSpec, ComputeSpec, NumpyShardComputer,
                     ShardComputer, TorchShardComputer, WorkerPlan,
                     make_computer, worker_main)

__all__ = [
    "ShardEvent", "BatchRecord", "TraceRecording",
    "WorkerPool", "WorkerHandle", "ChaosSpec", "WorkerPlan", "worker_main",
    "ShardComputer", "NumpyShardComputer", "TorchShardComputer",
    "ComputeSpec", "make_computer",
    "Transport", "LocalTransport", "SocketTransport", "TransportClosed",
    "make_transport", "ClusterConfig", "global_config",
    "ClusterBackend", "ClusterDispatch", "ReplayBackend",
]


def __getattr__(name):
    if name in ("ClusterBackend", "ClusterDispatch", "ReplayBackend"):
        from . import backend
        return getattr(backend, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
