"""Serving of the port: LM prefill and decode steps (``serve_step``) and
trained-topographic-map batched inference (``maps.MapService`` single-map
endpoints on the bucketed ``BmuEngine``, one launch of the ``bmu``
kernel a chunk of at most the top bucket; ``gateway.MapGateway``, a
concurrent multi-map front end with cross-request coalescing;
``fleet.MapFleet``, replicated workers with admission control and rolling
reload; see ``repro_torch.launch.serve_map``)."""
from repro_torch.serving.fleet import FleetStats, MapFleet, Overloaded
from repro_torch.serving.gateway import GatewayStats, MapGateway
from repro_torch.serving.maps import (DEFAULT_BUCKETS, GLOBAL_COMPILE_CACHE,
                                      BmuEngine, CompileCache,
                                      LatencyHistogram, MapService,
                                      ServiceStats)
from repro_torch.serving.retry import call_with_retries
from repro_torch.serving.serve_step import (generate, init_serving_cache,
                                            make_decode_step, make_prefill)

__all__ = ["BmuEngine", "CompileCache", "DEFAULT_BUCKETS", "FleetStats",
           "GatewayStats", "GLOBAL_COMPILE_CACHE", "LatencyHistogram",
           "MapFleet", "MapGateway", "MapService", "Overloaded",
           "ServiceStats", "call_with_retries", "generate",
           "init_serving_cache", "make_decode_step", "make_prefill"]
