"""Global cluster-runtime configuration (the alpa ``GlobalConfig`` idiom).

One module-level :data:`global_config` instance holds every tunable of the
cluster runtime's two seams — the **compute layer** (which
:class:`~repro_torch.cluster.worker.ShardComputer` a worker builds, how many
of a host's cards the workers spread over, the device dtype) and the
**transport layer** (which :class:`~repro_torch.cluster.transport.Transport`
carries tasks/operands/results, the socket host list, framing bounds).
Options default from the reference's ``SAC_CLUSTER_*`` environment
variables, so a fleet is configured the same way in both packages (one
default differs: compute is ``"device"`` here, ``"numpy"`` there);
explicit ``WorkerPool``/``ClusterBackend`` keywords always win over the
globals.

This module is imported by the multiprocessing spawn target, so it must
stay stdlib-only — reading the config must never pay for torch.
"""
from __future__ import annotations

import os

__all__ = ["ClusterConfig", "global_config"]


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw is None else int(raw)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return default if raw is None else float(raw)


class ClusterConfig:
    """Global configuration of the cluster runtime's compute/transport seams."""

    def __init__(self):
        ########## Options of the compute layer ##########
        # which ShardComputer workers build: "device" (the coded_matmul
        # kernel; the port's default, where the reference's is "numpy") |
        # "numpy" (the reference's float64 einsum)
        self.compute: str = _env_str("SAC_CLUSTER_COMPUTE", "device")
        # how many devices a host's workers spread over: a device-compute
        # worker pins itself to ``cuda:{wid % count}``, where ``count`` is
        # this many cards, capped by the cards the host has (0: all of
        # them).  The reference reads the same variable as its number of
        # virtual XLA devices per CPU host.
        self.host_device_count: int = _env_int("SAC_CLUSTER_HOST_DEVICES", 8)
        # dtype the device path computes in, read for parity with the
        # reference: the port's device compute runs in float32 only, and a
        # ComputeSpec built from any other value raises
        self.device_dtype: str = _env_str("SAC_CLUSTER_DEVICE_DTYPE",
                                          "float32")

        ########## Options of the transport layer ##########
        # which Transport carries the pool's traffic: "local" | "socket"
        self.transport: str = _env_str("SAC_CLUSTER_TRANSPORT", "local")
        # listener addresses of the socket transport — one listener per
        # "host".  Two localhost entries exercise the multi-host assignment
        # path (round-robin worker → host) on a single machine.
        self.socket_hosts: tuple[str, ...] = tuple(
            h.strip() for h in
            _env_str("SAC_CLUSTER_HOSTS", "127.0.0.1,127.0.0.1").split(",")
            if h.strip())
        # port the socket listeners bind (0: ephemeral, per listener)
        self.socket_port: int = _env_int("SAC_CLUSTER_PORT", 0)
        # how long a spawned worker may take to dial back before the
        # connection attempt itself is abandoned
        self.connect_timeout: float = _env_float(
            "SAC_CLUSTER_CONNECT_TIMEOUT", 30.0)
        # hard ceiling on one framed message (operand broadcasts included);
        # a corrupt length prefix must fail fast, not allocate terabytes
        self.frame_max_bytes: int = _env_int("SAC_CLUSTER_FRAME_MAX",
                                             1 << 31)
        # socket workers cache the operand blocks of the last few batches
        # (speculative re-dispatch can revisit a batch already in flight)
        self.operand_cache_batches: int = _env_int(
            "SAC_CLUSTER_OPERAND_CACHE", 4)

    def backup_from(self, other: "ClusterConfig") -> None:
        """Copy every option from ``other`` (test save/restore helper)."""
        self.__dict__.update(dict(other.__dict__))


global_config = ClusterConfig()
