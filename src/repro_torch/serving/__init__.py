from repro_torch.serving.arrivals import (Arrival, ArrivalTrace, build_trace,
                                          bursty_trace, poisson_trace,
                                          replayed_trace, run_open_loop)
from repro_torch.serving.cluster import ClusterServingEngine
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.kvpool import KVPool
from repro_torch.serving.slo import RequestStats, SLOReport

__all__ = [
    "Arrival", "ArrivalTrace", "ClusterServingEngine", "KVPool", "Request",
    "RequestStats", "SLOReport", "ServingEngine", "build_trace",
    "bursty_trace", "poisson_trace", "replayed_trace", "run_open_loop",
]
