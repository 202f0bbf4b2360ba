"""Serving of the port: the Engine (prefill + decode steps), the request-stream
front end layered on it (``serve.frontend`` — admission control, deadlines,
retry / shedding and per-request fault isolation, batch-1 slots), and the
slot-recycling continuous-batching scheduler (``serve.scheduler`` + the
paged KV cache of ``serve.kv_cache`` — one shared batched decode step with
KV-block backpressure, preempt-and-resume, and per-row blast-radius
bisection; see each module docstring for its contract)."""
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: F401
from repro_torch.serve.frontend import (StreamConfig, StreamFrontend,  # noqa: F401
                                        VirtualClock)
from repro_torch.serve.kv_cache import BlockAllocator, PagedKVCache  # noqa: F401
from repro_torch.serve.requests import (Overloaded, Request,  # noqa: F401
                                        RequestResult)
from repro_torch.serve.scheduler import (ContinuousConfig,  # noqa: F401
                                         ContinuousScheduler)
