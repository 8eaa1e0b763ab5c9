"""Serving of the port: LM prefill and decode steps (``serve_step``). The
map-serving tier of the JAX package (``MapService``, ``MapGateway``,
``MapFleet``) is not ported yet."""
from repro_torch.serving.serve_step import (generate, init_serving_cache,
                                            make_decode_step, make_prefill)

__all__ = ["generate", "init_serving_cache", "make_decode_step",
           "make_prefill"]
