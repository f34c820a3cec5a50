"""Streaming successive-refinement serving runtime, on the device.

* :class:`MasterScheduler` — request queue, batching, and the event loop
  that merges worker completions with deadline ticks; :meth:`~MasterScheduler
  .run_open` serves timestamped arrivals open-loop (admission, EDF, expiry,
  accuracy SLOs).
* :class:`IncrementalDecoder` / :class:`RecomputeDecoder` — decode state on
  the products' device; weights solved on the host in float64.
* :class:`DecodeWeightCache` — service-wide LRU over decode weights, with
  per-request-class budgets.
* :class:`TorchDeviceBackend` (kernels on the card) and
  :class:`SimulatedBackend` (host numpy float64 oracle).
* :mod:`~repro_torch.serving.loadgen` — open-loop multi-tenant load:
  :class:`TenantSpec` request classes with accuracy/latency SLOs, Poisson /
  bursty / replayed-trace arrivals, and :func:`summarize_load` per-tenant
  p99 time-to-target and goodput.
"""
from .backends import (BACKEND_NAMES, ExecutionBackend, SimulatedBackend,
                       SyntheticDispatch, TorchDeviceBackend, make_backend)
from .cache import DecodeWeightCache
from .incremental import (IncrementalDecoder, RecomputeDecoder, make_decoder,
                          recombine)
from .loadgen import (ARRIVAL_PROCESSES, LoadReport, OpenRequest, TenantSpec,
                      build_workload, bursty_arrivals, make_arrivals,
                      poisson_arrivals, run_load, summarize_load,
                      trace_arrivals)
from .master import (QUEUE_POLICIES, Answer, MasterScheduler, MatmulRequest,
                     RequestResult, ServeConfig, merged_event_stream,
                     serve_request)

__all__ = ["BACKEND_NAMES", "ExecutionBackend", "SimulatedBackend",
           "SyntheticDispatch", "TorchDeviceBackend", "make_backend",
           "DecodeWeightCache", "IncrementalDecoder", "RecomputeDecoder",
           "make_decoder", "recombine", "Answer", "MasterScheduler",
           "MatmulRequest", "RequestResult", "ServeConfig",
           "merged_event_stream", "serve_request", "QUEUE_POLICIES",
           "ARRIVAL_PROCESSES", "TenantSpec", "OpenRequest", "LoadReport",
           "build_workload", "make_arrivals", "poisson_arrivals",
           "bursty_arrivals", "trace_arrivals", "run_load",
           "summarize_load"]
