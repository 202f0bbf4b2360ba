"""Shared pieces of the serving-stack parity tests (the port against the JAX
package on the same numpy weights): the engines, the request lists, and
the per-request lifecycle summaries both registries are compared by."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import build as ref_build
from repro.serve import Engine as RefEngine
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import build
from repro_torch.serve import Engine, ServeConfig

# N(0, 0.08) weights: greedy decoding wanders over the vocabulary instead of
# repeating one token (the spread of test_torch_serve.py's scale 4).
WEIGHT_STD = 0.08


def numpy_tree(seed: int = 0) -> dict:
    """Reference-layout params of reduced olmo-1b, every leaf drawn with
    numpy from ``seed`` (the JAX init supplies the shapes only)."""
    cfg = dataclasses.replace(ref_reduced_config("olmo-1b"),
                              compute_dtype="float32")
    shapes = ref_build(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * WEIGHT_STD).astype(np.float32),
        shapes)


def engines(tree: dict, **serve):
    """(reference Engine, port Engine on the CPU) over the same weights,
    reduced olmo-1b in f32, max_len 32."""
    ref_cfg = dataclasses.replace(ref_reduced_config("olmo-1b"),
                                  compute_dtype="float32")
    cfg = dataclasses.replace(reduced_config("olmo-1b"),
                              compute_dtype="float32")
    ref = RefEngine(ref_build(ref_cfg), jax.tree.map(jnp.asarray, tree),
                    RefServeConfig(max_len=32, **serve))
    port = Engine(build(cfg, device="cpu"), params_from_numpy(tree, cfg, "cpu"),
                  ServeConfig(max_len=32, **serve), device="cpu")
    return ref, port


def requests(cls, n, *, seed=0, lengths=(4, 6, 8), budgets=(2, 3, 4, 6),
             deadline_s=None):
    """``n`` requests of ``cls`` (either package's Request) from ``seed``."""
    r = np.random.default_rng(seed)
    return [cls(request_id=i,
                tokens=r.integers(0, 64, int(r.choice(lengths))).astype(np.int32),
                max_new_tokens=int(r.choice(budgets)), deadline_s=deadline_s)
            for i in range(n)]


def lifecycle(report: dict) -> dict:
    """What the two registries are compared by: the counters, each
    request's status, retries and tokens emitted, and the count of every
    lifecycle event (bisection verdicts apart)."""
    events = collections.Counter()
    per_request = {}
    for rid, rec in report["requests"].items():
        per_request[rid] = (rec["status"], rec["retries"],
                            rec["tokens_emitted"])
        for e in rec["events"]:
            name = e["event"]
            if name == "bisect":
                name += ":" + e["detail"].split(":")[0]
            events[name] += 1
    return {"counters": report["counters"], "requests": per_request,
            "events": dict(events)}


def tokens_of(results) -> dict:
    return {rid: np.asarray(r.tokens).tolist() for rid, r in results.items()}


torch.set_num_threads(1)
