"""Port vs reference: the eight configs beyond olmo-1b and mixtral-8x22b —
qwen3-4b, phi3-mini (head_dim 96), llama4-scout (MoE, top-1),
command-r-plus (parallel block), mamba2-130m (SSM), hymba-1.5b (attention
and SSM averaged, sliding window), paligemma-3b (VLM prefix-LM) and
whisper-base (encoder-decoder) — on reduced configs in f32 on the CPU.

Inputs (tokens, patch and frame embeddings, weights scaled by 4 so that
greedy decoding wanders) are made from a seed with numpy and handed to
both sides; the reference's tree crosses through
``repro_torch.interop.params_from_numpy``. Tolerances: logits within 1e-4
of the reference's logit scale (the same f32 products, other summation
orders), greedy tokens equal; the SSD pieces within 1e-5 of their output
scale; the routing counts exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import PackedWeight as RefPackedWeight
from repro.models import attention as rattn
from repro.models import build as ref_build
from repro.models import encdec as rencdec
from repro.models import moe as rmoe
from repro.models import ssm as rssm
from repro.models.layers import pack_model_params as ref_pack_model_params
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.kv_cache import PagedKVCache as RefPagedKVCache
from repro_torch import configs as tconfigs
from repro_torch.core.layered import PackedWeight
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import build
from repro_torch.models import encdec as tencdec
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.kv_cache import PagedKVCache

torch.set_num_threads(1)

NEW_ARCHS = ["command-r-plus-104b", "phi3-mini-3.8b", "qwen3-4b",
             "llama4-scout-17b-a16e", "whisper-base", "paligemma-3b",
             "hymba-1.5b", "mamba2-130m"]
PROMPT = (2, 6)
STEPS = 6


def _cfgs(arch, **changes):
    changes.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(rconfigs.reduced_config(arch), **changes),
            dataclasses.replace(tconfigs.reduced_config(arch), **changes))


def _ref_tree(rcfg, scale=4.0):
    params = ref_build(rcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: np.asarray(x) * scale, params)


def _batch(cfg, seed=0):
    """Tokens, and the stub frontends' embeddings where the model takes
    them, from numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (PROMPT[0], cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (PROMPT[0], cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _engines(arch, pack, max_len=48):
    rcfg, tcfg = _cfgs(arch)
    tree = _ref_tree(rcfg)
    ref_engine = RefEngine(ref_build(rcfg), jax.tree.map(jnp.asarray, tree),
                           RefServeConfig(max_len=max_len, pack_weights=pack))
    engine = Engine(build(tcfg, device="cpu"),
                    params_from_numpy(tree, tcfg, "cpu"),
                    ServeConfig(max_len=max_len, pack_weights=pack),
                    device="cpu")
    return ref_engine, engine, tcfg


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def test_arch_ids_equal_the_reference():
    assert tconfigs.ARCH_IDS == rconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_config_field_for_field(arch):
    """Each config, and its reduced cut, equals the reference's."""
    assert dataclasses.asdict(tconfigs.get_config(arch)) == \
        dataclasses.asdict(rconfigs.get_config(arch))
    assert dataclasses.asdict(tconfigs.reduced_config(arch)) == \
        dataclasses.asdict(rconfigs.reduced_config(arch))


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_build_takes_every_config(arch):
    model = build(tconfigs.get_config(arch), device="cpu")
    assert model.cfg.name == arch


# ---------------------------------------------------------------------------
# Served end to end: prefill, a decode step, greedy tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pack", [False, True], ids=["raw", "packed"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_logits_match_reference(arch, pack):
    """Prefill's last-position logits and one greedy decode step's, within
    1e-4 of the reference's logit scale."""
    ref_engine, engine, cfg = _engines(arch, pack)
    batch = _batch(cfg)
    lr, cr = ref_engine._prefill(ref_engine.params, _ref_batch(batch))
    lp, cp = engine._prefill(_port_batch(batch))
    _close(lp.numpy(), lr)
    tok = np.asarray(jnp.argmax(lr, -1)).astype(np.int32)[:, None]
    np.testing.assert_array_equal(torch.argmax(lp, -1).numpy(), tok[:, 0])
    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    pos = prefix + PROMPT[1]
    lr, _ = ref_engine._decode(ref_engine.params, cr, jnp.asarray(tok),
                               jnp.full((PROMPT[0],), pos, jnp.int32))
    lp, _ = engine._decode(cp, torch.as_tensor(tok).long(),
                           torch.full((PROMPT[0],), pos, dtype=torch.long))
    _close(lp.numpy(), lr)


@pytest.mark.parametrize("pack", [False, True], ids=["raw", "packed"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_greedy_tokens_match_reference(arch, pack):
    """``Engine.generate`` over 6 steps (with ``patches`` for paligemma and
    ``frames`` for whisper): the same tokens on both sides, and not one
    token repeated throughout."""
    ref_engine, engine, cfg = _engines(arch, pack)
    batch = _batch(cfg, seed=1)
    want = np.asarray(ref_engine.generate(_ref_batch(batch), STEPS))
    got = engine.generate(batch, STEPS)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 2


def test_vlm_decode_positions_follow_the_patches():
    """paligemma's decode steps run at positions num_patches + S + i, as
    the reference's ``generate`` places them."""
    _, engine, cfg = _engines("paligemma-3b", False)
    seen = []
    decode = engine.model.decode

    def recording(params, caches, token, pos):
        seen.append(pos.tolist())
        return decode(params, caches, token, pos)
    engine.model = dataclasses.replace(engine.model, decode=recording)
    engine.generate(_batch(cfg), 3)
    first = cfg.num_patches + PROMPT[1]
    assert seen == [[first + i] * PROMPT[0] for i in range(3)]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-base"])
def test_decode_past_the_cache_matches_reference(arch):
    """hymba's sliding-window ring wraps (a 6-token prompt, 12 steps, a
    window of 8 slots); whisper's positions clamp into its sinusoidal
    table past the cache's slots. Every step's logits within 1e-4."""
    changes = {"sliding_window": 8} if arch == "hymba-1.5b" else {}
    rcfg, tcfg = _cfgs(arch, **changes)
    tree = _ref_tree(rcfg)
    max_len = 16 if arch == "hymba-1.5b" else 12
    ref_engine = RefEngine(ref_build(rcfg), jax.tree.map(jnp.asarray, tree),
                           RefServeConfig(max_len=max_len))
    engine = Engine(build(tcfg, device="cpu"),
                    params_from_numpy(tree, tcfg, "cpu"),
                    ServeConfig(max_len=max_len), device="cpu")
    batch = _batch(tcfg, seed=2)
    lr, cr = ref_engine._prefill(ref_engine.params, _ref_batch(batch))
    lp, cp = engine._prefill(_port_batch(batch))
    for i in range(12):
        _close(lp.numpy(), lr)
        tok = np.asarray(jnp.argmax(lr, -1)).astype(np.int32)[:, None]
        pos = PROMPT[1] + i
        lr, cr = ref_engine._decode(ref_engine.params, cr, jnp.asarray(tok),
                                    jnp.full((PROMPT[0],), pos, jnp.int32))
        lp, cp = engine._decode(cp, torch.as_tensor(tok).long(),
                                torch.full((PROMPT[0],), pos, dtype=torch.long))
        lr, lp = lr[:, 0], lp[:, 0]


# ---------------------------------------------------------------------------
# The SSD pieces
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b=2, length=21, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((b, length, h, p)).astype(np.float32),
        dt=np.log1p(np.exp(rng.standard_normal((b, length, h)))).astype(np.float32),
        a=np.log(np.linspace(1.0, 16.0, h)).astype(np.float32),
        b=rng.standard_normal((b, length, n)).astype(np.float32),
        c=rng.standard_normal((b, length, n)).astype(np.float32),
        state=rng.standard_normal((b, h, p, n)).astype(np.float32))


@pytest.mark.parametrize("initial", [False, True], ids=["zero", "given"])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunked_matches_reference(chunk, initial):
    """Length 21, a multiple of no chunk (32: one padded chunk): the padded
    tail is cut back; y and the final state within 1e-5 of their scale,
    and finite."""
    d = _ssd_inputs(chunk)
    state = d["state"] if initial else None
    ry, rs = rssm.ssd_chunked(
        jnp.asarray(d["x"]), jnp.asarray(d["dt"]), jnp.asarray(d["a"]),
        jnp.asarray(d["b"]), jnp.asarray(d["c"]), chunk,
        initial_state=None if state is None else jnp.asarray(state))
    ty, ts = tssm.ssd_chunked(
        *(torch.from_numpy(d[k]) for k in ("x", "dt", "a", "b", "c")), chunk,
        initial_state=None if state is None else torch.from_numpy(state))
    assert ty.shape == (2, 21, 3, 4) and ts.shape == (2, 3, 4, 5)
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(ts).all())
    _close(ty.numpy(), ry, 1e-5)
    _close(ts.numpy(), rs, 1e-5)


def _ssm_layer(arch="mamba2-130m"):
    rcfg, tcfg = _cfgs(arch)
    tree = _ref_tree(rcfg, scale=1.0)
    layer = jax.tree.map(lambda x: x[0], tree["layers"]["ssm"])
    return rcfg, tcfg, layer


@pytest.mark.parametrize("seq", [2, 21])
def test_apply_ssm_and_its_state_match_reference(seq):
    """The block's output and its decode cache; a 2-token prompt is shorter
    than the conv's receptive field (3), so its conv tail is left-padded."""
    rcfg, tcfg, layer = _ssm_layer()
    x = np.random.default_rng(seq).standard_normal(
        (2, seq, tcfg.d_model)).astype(np.float32)
    rout, rcache = rssm.apply_ssm(rcfg, jax.tree.map(jnp.asarray, layer),
                                  jnp.asarray(x), return_state=True)
    tout, tcache = tssm.apply_ssm(
        tcfg, {k: torch.from_numpy(np.array(v)) for k, v in layer.items()},
        torch.from_numpy(x), return_state=True)
    _close(tout.numpy(), rout, 1e-5)
    for key in ("state", "conv"):
        assert tuple(tcache[key].shape) == rcache[key].shape
        _close(tcache[key].numpy(), rcache[key], 1e-5)


def test_decode_ssm_matches_reference():
    """One recurrence step from a non-zero state and conv window."""
    rcfg, tcfg, layer = _ssm_layer()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    empty = tssm.init_ssm_cache(tcfg, 2)
    cache = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
             for k, v in empty.items()}
    rout, rnew = rssm.decode_ssm(rcfg, jax.tree.map(jnp.asarray, layer),
                                 jnp.asarray(x),
                                 jax.tree.map(jnp.asarray, cache))
    tout, tnew = tssm.decode_ssm(
        tcfg, {k: torch.from_numpy(np.array(v)) for k, v in layer.items()},
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in cache.items()})
    _close(tout.numpy(), rout, 1e-5)
    for key in ("state", "conv"):
        _close(tnew[key].numpy(), rnew[key], 1e-5)


def test_ssm_init_cache_matches_reference():
    rcfg, tcfg, _ = _ssm_layer()
    ref = rssm.init_ssm_cache(rcfg, 3, jnp.float32)
    port = tssm.init_ssm_cache(tcfg, 3)
    for key in ("state", "conv"):
        assert tuple(port[key].shape) == ref[key].shape
        assert port[key].dtype == torch.float32 and not port[key].any()


# ---------------------------------------------------------------------------
# Encoder-decoder pieces
# ---------------------------------------------------------------------------

def _whisper():
    rcfg, tcfg = _cfgs("whisper-base")
    tree = _ref_tree(rcfg, scale=1.0)
    return rcfg, tcfg, tree, params_from_numpy(tree, tcfg, "cpu")


def test_encode_matches_reference():
    rcfg, tcfg, tree, params = _whisper()
    frames = np.random.default_rng(6).standard_normal(
        (2, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)
    want = rencdec.encode(rcfg, jax.tree.map(jnp.asarray, tree),
                          jnp.asarray(frames), remat=False)
    got = tencdec.encode(tcfg, params, torch.from_numpy(frames))
    _close(got.numpy(), want, 1e-5)


def test_cross_attention_and_encode_kv_match_reference():
    rcfg, tcfg, tree, params = _whisper()
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((2, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    rp = jax.tree.map(lambda v: jnp.asarray(v[1]), tree["layers"]["xattn"])
    tp = params["layers"][1]["xattn"]
    rk, rv = rattn.encode_kv(rcfg, rp, jnp.asarray(enc))
    tk, tv = tattn.encode_kv(tcfg, tp, torch.from_numpy(enc))
    _close(tk.numpy(), rk, 1e-5)
    _close(tv.numpy(), rv, 1e-5)
    want = rattn.cross_attention(rcfg, rp, jnp.asarray(x), rk, rv)
    got = tattn.cross_attention(tcfg, tp, torch.from_numpy(x), tk, tv)
    _close(got.numpy(), want, 1e-5)


def test_encdec_init_caches_hold_the_cross_kv():
    """``init_caches`` computes the cross K / V the reference's does, with
    empty self-attention caches."""
    rcfg, tcfg, tree, params = _whisper()
    frames = np.random.default_rng(8).standard_normal(
        (2, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)
    want = rencdec.init_caches(rcfg, jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(frames), 16, jnp.float32)
    got = tencdec.init_caches(tcfg, params, torch.from_numpy(frames), 16,
                              torch.float32)
    assert len(got) == tcfg.num_layers
    for i, c in enumerate(got):
        for key in ("cross_k", "cross_v"):
            _close(c[key].numpy(), want[key][i], 1e-5)
        assert tuple(c["kv"]["k"].shape) == want["kv"]["k"].shape[1:]
        assert not c["kv"]["k"].any()


# ---------------------------------------------------------------------------
# llama4-scout's top-1 routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_llama4_routing_counts_match_reference(capacity_factor):
    """Layer 0 of reduced llama4-scout (4 experts, top-1) on 2 x 24 tokens:
    counts and dropped exactly equal, the layer's output within 1e-5."""
    rcfg, tcfg = _cfgs("llama4-scout-17b-a16e",
                       capacity_factor=capacity_factor)
    assert tcfg.num_experts_per_tok == 1
    tree = _ref_tree(rcfg, scale=1.0)
    moe = jax.tree.map(lambda v: v[0], tree["layers"]["moe"])
    x = np.random.default_rng(9).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    rout, _, rstats = rmoe.apply_moe(rcfg, jax.tree.map(jnp.asarray, moe),
                                     jnp.asarray(x))
    tout, _, tstats = tmoe.apply_moe(
        tcfg, {k: torch.from_numpy(np.array(v)) for k, v in moe.items()},
        torch.from_numpy(x))
    np.testing.assert_array_equal(tstats["expert_counts"].numpy(),
                                  np.asarray(rstats["expert_counts"]))
    assert int(tstats["dropped_tokens"]) == int(rstats["dropped_tokens"])
    assert (int(tstats["dropped_tokens"]) > 0) == (capacity_factor < 1)
    _close(tout.numpy(), rout, 1e-5)


# ---------------------------------------------------------------------------
# Interop and the paged pool
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("pack", [False, True], ids=["raw", "packed"])
@pytest.mark.parametrize("arch", ["whisper-base", "mamba2-130m"])
def test_interop_carries_the_tree_byte_for_byte(arch, pack):
    """Every leaf of the reference's tree (whisper's encoder layers split by
    ``encoder_layers``; the SSM's leaves, ``A_log`` and ``conv_w``
    included), and with ``pack`` every packed buffer, lands in the port
    with the same bytes, layer by layer."""
    rcfg, tcfg = _cfgs(arch, compute_dtype="bfloat16")
    tree = ref_build(rcfg).init(jax.random.PRNGKey(0))
    if pack:
        tree = ref_pack_model_params(rcfg, tree)
    tree = jax.tree.map(np.asarray, tree)
    port = params_from_numpy(tree, tcfg, "cpu")

    def check(ref_layers, port_layers, n):
        assert len(port_layers) == n
        for path, leaf in _leaves(ref_layers):
            stacked = np.asarray(leaf.packed if _is_ref_packed(leaf) else leaf)
            for i, layer in enumerate(port_layers):
                node = layer
                for key in path:
                    node = node[key]
                if _is_ref_packed(leaf):
                    assert isinstance(node, PackedWeight), path
                    node = node.packed
                got = node.contiguous().view(torch.uint8).numpy().tobytes()
                assert got == np.ascontiguousarray(stacked[i]).tobytes(), (path, i)

    check(tree["layers"], port["layers"], tcfg.num_layers)
    names = {p[-1] for p, _ in _leaves(tree["layers"])}
    if arch == "whisper-base":
        check(tree["encoder"]["layers"], port["encoder"]["layers"],
              tcfg.encoder_layers)
        assert {"xattn", "norm3"} <= {p[0] for p, _ in _leaves(tree["layers"])}
    else:
        assert {"A_log", "dt_bias", "D", "conv_w", "in_proj", "out_proj"} <= names
    assert _is_ref_packed(tree["layers"]["mlp" if arch == "whisper-base"
                                         else "ssm"]["out_proj" if arch ==
                                                     "mamba2-130m" else "wo"]) == pack


def _is_ref_packed(x) -> bool:
    return isinstance(x, RefPackedWeight)


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_paged_pool_refuses_what_the_reference_refuses(arch):
    """The paged KV pool takes the configs the reference's takes (the
    full-attention token decoders) and refuses the others — sliding
    window, SSM, encoder-decoder, VLM — naming the config."""
    rcfg, tcfg = _cfgs(arch)
    kw = dict(max_live=2, max_len=32, block_size=8, num_blocks=8)
    try:
        RefPagedKVCache(rcfg, **kw)
        refused = False
    except ValueError as exc:
        assert "not pageable" in str(exc)
        refused = True
    if refused:
        with pytest.raises(ValueError, match="not pageable") as info:
            PagedKVCache(tcfg, device="cpu", **kw)
        assert tcfg.name in str(info.value)
    else:
        PagedKVCache(tcfg, device="cpu", **kw)
    want = {"mixtral-8x22b", "whisper-base", "paligemma-3b", "hymba-1.5b",
            "mamba2-130m"}
    assert refused == (arch in want)
