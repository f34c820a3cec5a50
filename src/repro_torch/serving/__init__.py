"""Streaming successive-refinement serving runtime, on the device.

* :class:`MasterScheduler` — request queue, batching, and the event loop
  that merges worker completions with deadline ticks.
* :class:`IncrementalDecoder` / :class:`RecomputeDecoder` — decode state on
  the products' device; weights solved on the host in float64.
* :class:`DecodeWeightCache` — service-wide LRU over decode weights.
* :class:`TorchDeviceBackend` (kernels on the card) and
  :class:`SimulatedBackend` (host numpy float64 oracle).
"""
from .backends import (BACKEND_NAMES, ExecutionBackend, SimulatedBackend,
                       SyntheticDispatch, TorchDeviceBackend, make_backend)
from .cache import DecodeWeightCache
from .incremental import (IncrementalDecoder, RecomputeDecoder, make_decoder,
                          recombine)
from .master import (Answer, MasterScheduler, MatmulRequest, RequestResult,
                     ServeConfig, merged_event_stream, serve_request)

__all__ = ["BACKEND_NAMES", "ExecutionBackend", "SimulatedBackend",
           "SyntheticDispatch", "TorchDeviceBackend", "make_backend",
           "DecodeWeightCache", "IncrementalDecoder", "RecomputeDecoder",
           "make_decoder", "recombine", "Answer", "MasterScheduler",
           "MatmulRequest", "RequestResult", "ServeConfig",
           "merged_event_stream", "serve_request"]
