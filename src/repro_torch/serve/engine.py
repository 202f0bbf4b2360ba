"""Batched serving engine: prefill, then a greedy or sampled decode loop.

  * KV caches stay on the device across steps; the host loop moves tokens.
  * With the default ``ServeConfig`` the raw weights are served as they
    are: on the card each contraction lowers to the planner's strategy,
    ``gemm_tiled`` on the strided weight at decode and a per-call
    ``pack_b`` + the fused-A kernel at prefill.
  * ``ServeConfig.pack_weights=True`` packs every dense weight, every MoE
    expert stack and the LM head tile-major ONCE at engine construction
    (``models.layers.pack_model_params``); each step then runs the fused-A
    kernel with the activation in its store epilogue, and the grouped
    ragged kernel for the expert contractions. ``quantize`` stores them as
    int8 / int4 tiles with scales.
  * Sampling is per request: row r at step t draws by Gumbel-argmax with
    noise hashed from a key of (seed, request_id, step)
    (``serve.sampler``), so a request's stream never depends on its batch
    neighbours. The streams differ from the reference's JAX threefry
    streams; greedy decoding (temperature 0) matches token for token.
  * Two serving surfaces share the step programs: ``Engine.generate`` runs
    a fixed-size static batch, while ``serve.frontend.StreamFrontend``
    serves a request stream through the per-request step API
    (``prefill_request`` / ``decode_request`` / ``sample_tokens``) with
    admission control, deadlines, retry / shedding and per-request fault
    isolation, and ``serve.scheduler.ContinuousScheduler`` moves every
    live request into one batched decode step over a paged KV pool
    (``serve.kv_cache``). ``health_report`` / ``serve_report`` read the
    process-global registries of ``repro_torch.core.health``.
  * The engine runs on the card by default, and raises without one; pass
    ``device="cpu"`` to run on the CPU.
  * On the card the engine's steps replay captured CUDA graphs
    (``serve.graphs.StepGraph``), as the reference jits its prefill and
    its decode. The decode: one graph per batch width and cache layout,
    each step's token and position copied into its static buffers, the
    greedy argmax inside the graph; a sampled decode (temperature > 0)
    draws from the graph's static logits by the sampler's graph, one per
    logits shape (the reference jits its draw apart from its decode, one
    program per logits width): the fault site and the per-row numerics
    guard of the front end and the scheduler sit between the two. The
    prefill: one graph per input signature (``tokens`` [B, S], with
    ``patches`` or ``frames``), as the reference compiles one program per
    shape; prompts are never padded (an SSM's state and its causal conv
    would take the pad tokens in). Each graph's first call runs eagerly on the capture
    stream (its warm-up), the second captures, every later call replays.
    The caches' shapes depend on the width, ``max_len`` and the layout,
    never on S, so each prefill graph writes its caches in place into the
    static caches of the decode graph of its width and layout:
    ``generate`` runs a prefill replay, then decode replays, with one copy
    of the caches alive. ``prefill_request`` / ``decode_request`` (the
    front end's batch-1 steps) run the width-1 graphs: ``prefill_request``
    returns copies the caller keeps; ``decode_request`` copies the
    request's caches into the width-1 decode graph's static caches and
    returns those, which the next call overwrites. The engine's graphs
    share one memory pool. On the CPU, and for a family
    that ``serve.graphs.EAGER_FAMILIES`` names, the steps run eagerly;
    setting the private ``Engine._graphed`` to False runs them eagerly on
    the card too, the path a graph is compared with.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import health
from repro_torch.core.contraction import ContractionSpec, dispatch, is_packed
from repro_torch.core.dtypes import torch_dtype
from repro_torch.core.epilogue import EPILOGUE_SPECS
from repro_torch.models import Model
from repro_torch.models.layers import pack_model_params
from repro_torch.models.moe import GROUP_SIZE, _capacity
from repro_torch.models.model_registry import resolve_device
from repro_torch.serve import graphs, sampler


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0      # 0 => greedy
    cache_dtype: str = "float32"
    seed: int = 0
    pack_weights: bool = False    # load-time tile-major packing (fast path)
    quantize: Optional[str] = None  # "int8" | "int4" (+":col"); needs packing


def _find_moe_subtree(tree):
    if isinstance(tree, list):
        tree = tree[0] if tree else None
    if not isinstance(tree, dict):
        return None
    if isinstance(tree.get("moe"), dict):
        return tree["moe"]
    for v in tree.values():
        found = _find_moe_subtree(v)
        if found is not None:
            return found
    return None


def serving_dispatch_report(model_cfg, cfg: ServeConfig, params, *,
                            on_card: bool = False) -> Dict[str, str]:
    """The serving step's canonical contractions, declared as
    ContractionSpecs, with the lowering ``dispatch`` chooses for each (for
    operands on the card when ``on_card``): the LM head at prefill and
    decode shapes and, for an MoE model, the gate/up pair and the down
    projection at one routing group's capacity envelope with the
    balanced-router occupancy ``1 / capacity_factor``."""
    compute = model_cfg.compute_dtype
    d = model_cfg.d_model
    head = params.get("head_packed")
    report = {}
    for phase, m in (("prefill", cfg.max_len), ("decode", 1)):
        spec = ContractionSpec.dense(m, d, model_cfg.vocab_size, compute,
                                     w=head, accum="f32")
        report[f"lm_head.{phase}:{spec.describe()}"] = dispatch(
            spec, on_card=on_card).name
    moe = _find_moe_subtree(params)
    if moe is not None and model_cfg.num_experts > 1:
        e = model_cfg.num_experts
        capacity = _capacity(min(GROUP_SIZE, cfg.max_len), model_cfg)
        occ = min(1.0, 1.0 / model_cfg.capacity_factor)
        wg, wo = moe["wg"], moe["wo"]
        ragged = is_packed(wg)  # packed serving threads the routing counts
        f = wg.n if ragged else wg.shape[-1]
        gate = ContractionSpec.grouped(
            e, capacity, d, f, compute, w=wg,
            epilogue=EPILOGUE_SPECS["silu_gate"], counts=ragged,
            occupancy=occ)
        down = ContractionSpec.grouped(e, capacity, f, d, compute, w=wo,
                                       counts=ragged, occupancy=occ)
        report[f"moe.gate_up:{gate.describe()}"] = dispatch(
            gate, on_card=on_card).name
        report[f"moe.down:{down.describe()}"] = dispatch(
            down, on_card=on_card).name
    return report


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


class Engine:
    def __init__(self, model: Model, params, cfg: ServeConfig = ServeConfig(),
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        if cfg.quantize and not cfg.pack_weights:
            raise ValueError("ServeConfig.quantize requires pack_weights=True "
                             "(quantization lives in the packed-tile format)")
        params = _to_device(params, self.device)
        if cfg.pack_weights:
            params = pack_model_params(model.cfg, params,
                                       quantize=cfg.quantize)
        self.params = params
        self.cfg = cfg
        self.dispatch_report = serving_dispatch_report(
            model.cfg, cfg, params, on_card=self.device.type == "cuda")
        # Prefill and decode through captured graphs on the card (False:
        # the eager steps).
        self._graphed = (self.device.type == "cuda"
                         and graphs.eager_reason(model.cfg) is None)
        # The decode graphs by cache layout, the prefill graphs by input
        # signature.
        self._graphs: Dict[tuple, graphs.StepGraph] = {}
        self._prefill_graphs: Dict[tuple, graphs.StepGraph] = {}
        # The sampler's graphs by logits shape and temperature.
        self._sample_graphs: Dict[tuple, graphs.StepGraph] = {}
        # One memory pool for all of them (made at the first capture).
        self._graph_pool = None

    @torch.inference_mode()
    def _prefill(self, batch):
        """``batch``: the model-format batch on the device, ``tokens``
        [B, S] with ``patches`` or ``frames`` where the model takes them."""
        return self.model.prefill(self.params, batch,
                                  max_len=self.cfg.max_len,
                                  cache_dtype=torch_dtype(self.cfg.cache_dtype))

    @torch.inference_mode()
    def _decode(self, caches, token: torch.Tensor, pos: torch.Tensor):
        return self.model.decode(self.params, caches, token, pos)

    def health_report(self) -> Dict[str, dict]:
        """The dispatch-health registry's degradation report: an empty dict
        is healthy. Each entry records a ``(spec, lowering)`` that failed
        under guarded dispatch (``contraction.run_guarded``): its failure
        count, classified cause, the fallback that took over and the last
        failure's detail. On the CPU every contraction of every step is
        guarded. On the card a failing contraction raises instead (no other
        lowering takes over there), so nothing of dispatch is recorded, and
        the decode step is a captured graph: its contractions are guarded
        at the warm-up step and the capture pass only, as the reference's
        jit'd engine guards the first trace of a program; a replay runs no
        guard. The registry is process-global
        (``repro_torch.core.health.HEALTH``): engines sharing a process
        share the report."""
        return health.health_report()

    def serve_report(self) -> Dict[str, dict]:
        """The request-lifecycle report of the stream front end and the
        continuous scheduler: ``counters`` are the monotonic conservation
        counters (offered = admitted + shed; every admitted request ends
        exactly once as completed / evicted / deadline_miss), ``requests``
        the retained per-request records (a bounded ring;
        ``dropped_records`` counts what the ring dropped, never from the
        counters), and ``dispatch_health`` the dispatch registry's bound
        stats. Process-global (``repro_torch.core.health.SERVE``)."""
        return health.serve_report()

    def _tokens(self, tokens) -> torch.Tensor:
        if not torch.is_tensor(tokens):
            tokens = torch.as_tensor(np.asarray(tokens))
        return tokens.to(device=self.device, dtype=torch.long)

    def sample_tokens(self, logits: torch.Tensor, request_ids,
                      step) -> torch.Tensor:
        """One token per row of ``logits`` [B, V] (int32 [B], the caller's
        to keep): argmax when greedy, else the Gumbel-argmax draw from
        ``softmax(row / temperature)`` keyed by (seed, request_ids[r],
        step[r]) (``serve.sampler.draw``). A row with NaN / Inf logits
        (which only the opt-in numerics guard turns into an eviction)
        takes its argmax, as the reference's Gumbel-argmax draw lands on
        its first NaN, so an unguarded poisoned row yields a token instead
        of failing every row sampled with it. The keys are made on the
        host in one pass; nothing is read back. Through the graphs
        (``_graphed``) the draw replays the sampler's graph for this
        logits shape."""
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        keys = torch.from_numpy(sampler.row_keys(self.cfg.seed, request_ids,
                                                 step))
        if self.device.type == "cuda":
            keys = keys.pin_memory().to(self.device, non_blocking=True)
        if not self._graphed:
            return sampler.draw(logits, keys, self.cfg.temperature)
        inputs = {"logits": logits, "keys": keys}
        return self._sample_graph(inputs)(inputs).clone()

    def _sample_graph(self, inputs: dict) -> graphs.StepGraph:
        """The sampler's graph for the logits' shape and the temperature:
        static logits [B, V] and keys [B], the draw inside."""
        key = (graphs.signature(inputs["logits"]), self.cfg.temperature)
        step = self._sample_graphs.get(key)
        if step is None:
            step = graphs.StepGraph(
                functools.partial(_sample_body, self.cfg.temperature),
                graphs.static_like(inputs), capture=self.device.type == "cuda",
                pool=self._pool())
            self._sample_graphs[key] = step
        return step

    def prefill_request(self, tokens) -> tuple:
        """Prefill ONE request's prompt ([S] ints) in its own batch-1 slot:
        (last-position logits [1, V], decode caches), the caller's to keep.
        Through the graphs (``_graphed``) they are copies of the prefill
        graph's static outputs, which the engine's next step overwrites."""
        batch = {"tokens": self._tokens(tokens)[None]}
        if self._graphed:
            return tuple(graphs.clone(self._graphed_prefill(batch)))
        return self._prefill(batch)

    def decode_request(self, caches, token, pos: int) -> tuple:
        """One decode step for one request: ``token`` [1, 1] at absolute
        position ``pos``: (logits [1, 1, V], caches). Eagerly it writes
        ``caches`` in place. Through the graphs (``_graphed``) it copies
        them into the width-1 decode graph's static caches, replays, and
        returns the static logits and caches, which the next call
        overwrites; ``caches`` is left as it was. Either way a caller
        that keeps ``caches`` across steps copies the returned caches back
        into them (``graphs.copy_back``: nothing to copy for a leaf written
        in place)."""
        if self._graphed:
            step = self._decode_graph(caches, 1)
            res = step({"caches": caches, "tok": self._tokens(token),
                        "pos": pos})
            return res["logits"][:, None], step.static["caches"]
        pos_v = torch.full((1,), pos, dtype=torch.long, device=self.device)
        return self._decode(caches, self._tokens(token), pos_v)

    def generate(self, batch: dict, max_new_tokens: int,
                 prompt_len: Optional[int] = None,
                 request_ids=None) -> np.ndarray:
        """batch: ``{"tokens": [B, S]}``, with ``patches`` [B, P, d] for a
        VLM or ``frames`` [B, Se, d] for an encoder-decoder; returns
        [B, max_new_tokens]. A VLM's decode positions follow its
        ``num_patches`` prefix positions."""
        tokens = self._tokens(batch["tokens"])
        b, t = tokens.shape
        prompt_len = prompt_len or t
        prefix = (self.model.cfg.num_patches
                  if self.model.cfg.family == "vlm" else 0)
        rids = np.arange(b) if request_ids is None else np.asarray(request_ids)
        inputs = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
                  else v for k, v in batch.items() if k != "tokens"}
        batch = {**_to_device(inputs, self.device), "tokens": tokens}
        step = None
        if self._graphed:
            # The prefill writes the decode graph's static caches: one copy
            # of the cache is alive through the decode.
            last_logits, caches = self._graphed_prefill(batch)
            step = self._decode_graph(caches, b)
            caches = None
        else:
            last_logits, caches = self._prefill(batch)
        out = []
        tok = self.sample_tokens(last_logits, rids, 0)[:, None]
        for i in range(max_new_tokens):
            out.append(tok.cpu().numpy())
            at = prefix + prompt_len + i
            if step is None:
                pos = torch.full((b,), at, dtype=torch.long,
                                 device=self.device)
                logits, caches = self._decode(caches, tok.to(torch.long), pos)
                tok = self.sample_tokens(logits[:, 0], rids, i + 1)[:, None]
                continue
            res = step({"tok": tok, "pos": at})
            tok = (res["next"] if self.cfg.temperature <= 0.0 else
                   self.sample_tokens(res["logits"], rids, i + 1)[:, None])
        return np.concatenate(out, axis=1)

    def _decode_graph(self, caches, b: int) -> graphs.StepGraph:
        """The decode step's graph for ``b`` rows of caches of this layout
        (its key: the caches' structure, shapes and dtypes): static caches,
        token [B, 1] and position [B], the argmax inside (captured on the
        card, run over the static tree on the CPU). The engine's graphs
        share one memory pool, as they replay one at a time on one stream:
        a graph's outputs hold until the engine's next replay of any width."""
        key = graphs.signature(caches)
        step = self._graphs.get(key)
        if step is None:
            static = {"caches": graphs.static_like(caches),
                      "tok": torch.zeros((b, 1), dtype=torch.long,
                                         device=self.device),
                      "pos": torch.zeros((b,), dtype=torch.long,
                                         device=self.device)}
            step = graphs.StepGraph(
                functools.partial(_decode_body, self.model, self.params),
                static, capture=self.device.type == "cuda",
                pool=self._pool())
            self._graphs[key] = step
        return step

    def _pool(self):
        """The memory pool the engine's graphs share (None on the CPU)."""
        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _graphed_prefill(self, batch) -> tuple:
        """The prefill through its graph for ``batch``'s signature (the
        model-format batch on the device): (last-position logits [B, V],
        the static caches of the decode graph of this width and layout,
        which hold the prefill's caches). The signature's first call is
        the eager warm-up, which finds the caches' layout: its caches are
        copied into that decode graph's static caches, and the graph's body
        writes there from then on."""
        key = graphs.signature(batch)
        step = self._prefill_graphs.get(key)
        if step is None:
            step = graphs.StepGraph(
                functools.partial(_prefill_body, self.model, self.params,
                                  self.cfg.max_len,
                                  torch_dtype(self.cfg.cache_dtype)),
                graphs.static_like(batch), capture=self.device.type == "cuda",
                pool=self._pool())
            self._prefill_graphs[key] = step
        out = step(batch)
        if "caches" in out:
            decode = self._decode_graph(out["caches"],
                                        batch["tokens"].shape[0])
            graphs.copy_in(decode.static["caches"], out["caches"])
            step.static["caches"] = decode.static["caches"]
        return out["logits"], step.static["caches"]


def _prefill_body(model: Model, params, max_len: int, cache_dtype,
                  static) -> dict:
    """The captured prefill: the model's prefill over the static batch,
    writing its caches into the static caches (``static["caches"]``, the
    decode graph's) in place, and its last-position logits. Before the
    static caches are known (the warm-up, which finds their layout) it
    returns the caches it made instead."""
    batch = {k: v for k, v in static.items() if k != "caches"}
    logits, caches = model.prefill(params, batch, max_len=max_len,
                                   cache_dtype=cache_dtype,
                                   caches=static.get("caches"))
    if "caches" not in static:
        return {"logits": logits, "caches": caches}
    return {"logits": logits}


def _decode_body(model: Model, params, static) -> dict:
    """The captured decode: the model's step over the static tree, its
    functional leaves copied back, the logits and their argmax. A function
    of the model and its weights, not of the engine, so that the graph
    holds no reference back to the engine that holds it."""
    logits, caches = model.decode(params, static["caches"], static["tok"],
                                  static["pos"])
    graphs.copy_back(static["caches"], caches)
    logits = logits[:, 0]
    return {"logits": logits,
            "next": torch.argmax(logits, dim=-1).to(torch.int32)[:, None]}


def _sample_body(temperature: float, static) -> torch.Tensor:
    """The captured draw over the static logits and keys."""
    return sampler.draw(static["logits"], static["keys"], temperature)
