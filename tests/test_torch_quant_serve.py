"""Quantized serving (``ServeConfig(pack_weights=True, quantize=...)``) in f32
on the CPU, reduced mixtral-8x22b and reduced olmo-1b, on the reference's
own terms (``tests/test_quant_gemm.py``: f32, ``capacity_factor=16``):

  (a) the port's int8 engine tracks the port's float engine: prefill and
      one decode step within 5% of the float logits' scale (max |logit|),
      the reference's bound for its own int8 engine;
  (b) the port serves the reference's quantized bytes as the reference
      does: the reference packs (its planner's tiles, its quantizer), the
      packed leaves cross through ``repro_torch.interop`` byte for byte,
      and prefill plus every decode step agree within 1e-4 of the logit
      scale (the same f32 products; the reference scales each tile's
      partial, the port's plain version dequantizes the tile first, so
      sums round differently) with equal greedy tokens, for int8,
      int8:col, int4 and int4:col;
  (c) as (b) with tiles shallower than K (bk 32: two and four k-tiles a
      column), where tile and col scales are different numbers and give
      different logits; at the reduced widths every weight is one k-tile
      deep under either planner, so (b) alone cannot tell them apart.

Also pinned: ``pack_model_params(quantize=)`` puts int8 / int4 tiles and
their scale grids on every dense projection, the LM head and all three
expert stacks, the gate/up pair on one plan.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.core import GroupedPackedWeight as RefGroupedPackedWeight
from repro.core import PackedWeight as RefPackedWeight
from repro.core.planner import plan_gemm as ref_plan_gemm
from repro.models import build as ref_build
from repro.models.layers import DENSE_WEIGHT_KEYS as REF_DENSE_KEYS
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.configs import reduced_config
from repro_torch.core.layered import GroupedPackedWeight, PackedWeight
from repro_torch.interop import params_from_numpy
from repro_torch.models import build
from repro_torch.models.layers import pack_model_params
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)
MAX_LEN = 32
QUANTIZE = ["int8", "int8:col", "int4", "int4:col"]


def _cfgs(arch):
    changes = dict(compute_dtype="float32")
    if arch == "mixtral-8x22b":
        changes["capacity_factor"] = 16.0
    return (dataclasses.replace(ref_reduced_config(arch), **changes),
            dataclasses.replace(reduced_config(arch), **changes))


def _tree(rcfg, scale=1.0):
    return jax.tree.map(lambda x: np.asarray(x) * scale,
                        ref_build(rcfg).init(jax.random.PRNGKey(0)))


def _prompt(cfg, seed=4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)


def _port_engine(tcfg, params, quantize):
    return Engine(build(tcfg, device="cpu"), params,
                  ServeConfig(max_len=MAX_LEN, pack_weights=True,
                              quantize=quantize), device="cpu")


def _port_steps(engine, prompt, steps):
    """Prefill + greedy decode: per-step logits [B, V] and tokens."""
    lp, cp = engine._prefill(
        {"tokens": torch.as_tensor(prompt, dtype=torch.long)})
    logits, toks = [lp.numpy()], []
    b, s = prompt.shape
    for i in range(steps):
        tp = torch.argmax(lp, -1)[:, None]
        toks.append(tp.numpy())
        lp, cp = engine._decode(cp, tp, torch.full((b,), s + i,
                                                   dtype=torch.long))
        lp = lp[:, 0]
        logits.append(lp.numpy())
    return logits, toks


def _ref_steps(engine, prompt, steps):
    lr, cr = engine._prefill(engine.params, {"tokens": jnp.asarray(prompt)})
    logits, toks = [np.asarray(lr)], []
    b, s = prompt.shape
    for i in range(steps):
        tr = jnp.argmax(lr, -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tr))
        lr, cr = engine._decode(engine.params, cr, tr,
                                jnp.full((b,), s + i, jnp.int32))
        lr = lr[:, 0]
        logits.append(np.asarray(lr))
    return logits, toks


def _assert_same_run(ref_run, port_run):
    """Every step's logits within 1e-4 of the logit scale, equal tokens."""
    (rl, rt), (pl, pt) = ref_run, port_run
    for i, (r, p) in enumerate(zip(rl, pl)):
        scale = np.abs(r).max()
        assert np.abs(p - r).max() <= 1e-4 * scale, (i, np.abs(p - r).max(),
                                                      scale)
    for r, p in zip(rt, pt):
        np.testing.assert_array_equal(p, r)


# -- pack_model_params(quantize=) ------------------------------------------------

@pytest.mark.parametrize("arch", ["mixtral-8x22b", "olmo-1b"])
@pytest.mark.parametrize("quantize", QUANTIZE)
def test_every_packed_weight_is_quantized(arch, quantize):
    """Every dense projection, the LM head and (mixtral) all three expert
    stacks hold int8 tiles (int4: two nibbles a byte) with their scale
    grid: [Nb, Kb] / [E, Nb, Kb] per tile, [Nb] / [E, Nb] per column; the
    gate/up pair shares one plan."""
    _, tcfg = _cfgs(arch)
    params = build(tcfg, device="cpu").init(0)
    packed = pack_model_params(tcfg, params, quantize=quantize)
    base, _, gran = quantize.partition(":")
    col = gran == "col"

    def check(w, grouped):
        assert isinstance(w, GroupedPackedWeight if grouped else PackedWeight)
        assert w.packed.dtype == torch.int8 and w.fmt.dtype == base
        lead = (w.e,) if grouped else ()
        nb, kb = w.packed.shape[len(lead):len(lead) + 2]
        tile = (w.fmt.bk, w.fmt.bn // 2 if base == "int4" else w.fmt.bn)
        assert tuple(w.packed.shape[-2:]) == tile
        assert w.scales.dtype == torch.float32
        assert tuple(w.scales.shape) == lead + ((nb,) if col else (nb, kb))

    check(packed["head_packed"], False)
    seen = 0
    for layer in packed["layers"]:
        for key in ("wq", "wk", "wv", "wo"):
            check(layer["attn"][key], False)
            seen += 1
        if "moe" in layer:
            for key in ("wg", "wu", "wo"):
                check(layer["moe"][key], True)
            assert layer["moe"]["wg"].plan == layer["moe"]["wu"].plan
        else:
            for key in ("wg", "wu", "wo"):
                check(layer["mlp"][key], False)
    assert seen == 4 * tcfg.num_layers


# -- (a) the port's int8 engine against its float engine ------------------------

@pytest.mark.parametrize("arch", ["mixtral-8x22b", "olmo-1b"])
def test_int8_engine_tracks_the_float_engine(arch):
    """Prefill and one decode step of the int8 engine within 5% of the
    float engine's logit scale (quantization error: the reference holds
    its own int8 engine to the same bound)."""
    rcfg, tcfg = _cfgs(arch)
    tree = _tree(rcfg)
    prompt = _prompt(tcfg)
    float_run = _port_steps(Engine(build(tcfg, device="cpu"),
                                   params_from_numpy(tree, tcfg, "cpu"),
                                   ServeConfig(max_len=MAX_LEN), device="cpu"),
                            prompt, 1)
    quant = _port_engine(tcfg, params_from_numpy(tree, tcfg, "cpu"), "int8")
    # One decode step fed the float engine's token, as the reference test.
    lp, cp = quant._prefill(
        {"tokens": torch.as_tensor(prompt, dtype=torch.long)})
    tok = torch.as_tensor(float_run[1][0], dtype=torch.long)
    dp, _ = quant._decode(cp, tok, torch.full((2,), prompt.shape[1],
                                              dtype=torch.long))
    for want, got in ((float_run[0][0], lp.numpy()),
                      (float_run[0][1], dp[:, 0].numpy())):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 0.05 * scale
    toks = quant.generate({"tokens": prompt}, 4)
    assert toks.shape == (2, 4)
    assert np.all((toks >= 0) & (toks < tcfg.vocab_size))


# -- (b) the reference's quantized bytes, served by both ------------------------

@pytest.mark.parametrize("arch", ["mixtral-8x22b", "olmo-1b"])
@pytest.mark.parametrize("quantize", QUANTIZE)
def test_reference_bytes_give_reference_logits(arch, quantize):
    """The reference packs and quantizes; its packed tree crosses to the
    port through interop; prefill and 4 greedy decode steps agree within
    1e-4 of the logit scale with equal tokens. The weights are scaled by 4
    (both sides get the same tree) so that greedy decoding wanders."""
    rcfg, tcfg = _cfgs(arch)
    ref_engine = RefEngine(ref_build(rcfg),
                           jax.tree.map(jnp.asarray, _tree(rcfg, 4.0)),
                           RefServeConfig(max_len=MAX_LEN, pack_weights=True,
                                          quantize=quantize))
    crossed = params_from_numpy(jax.tree.map(np.asarray, ref_engine.params),
                                tcfg, "cpu")
    head = crossed["head_packed"]
    assert head.fmt.is_quantized and head.scales is not None
    engine = _port_engine(tcfg, crossed, quantize)
    assert engine.params["head_packed"] is head  # served as carried, not repacked
    prompt = _prompt(tcfg)
    _assert_same_run(_ref_steps(ref_engine, prompt, 4),
                     _port_steps(engine, prompt, 4))


# -- (c) tiles shallower than K: tile and col scales differ ---------------------

def _ref_pack_shallow(rcfg, tree, quantize, bk):
    """The reference's pack_model_params with every plan's bk set to
    ``bk`` (jnp packer, the reference's quantizer)."""
    from repro.models.layers import GROUPED_WEIGHT_KEYS

    def plan(k, n):
        base, _, gran = quantize.partition(":")
        p = ref_plan_gemm(1024, k, n, "float32", b_dtype=base,
                          scale_granularity=gran or "tile")
        return dataclasses.replace(p, bk=bk)

    def walk(t, in_moe=False):
        if not isinstance(t, dict):
            return t
        out = {}
        for key, val in t.items():
            val_f = hasattr(val, "ndim") and np.issubdtype(val.dtype,
                                                            np.floating)
            if in_moe and key in GROUPED_WEIGHT_KEYS and val_f:
                out[key] = RefGroupedPackedWeight.pack(
                    jnp.asarray(val), plan=plan(*val.shape[-2:]),
                    quantize=quantize, backend="jnp")
            elif not in_moe and key in REF_DENSE_KEYS and val_f \
                    and val.ndim in (2, 3):
                out[key] = RefPackedWeight.pack(
                    jnp.asarray(val), plan=plan(*val.shape[-2:]),
                    quantize=quantize, backend="jnp")
            else:
                out[key] = walk(val, in_moe or key == "moe")
        return out

    out = walk(tree)
    table = (tree["embed"]["table"] if rcfg.tie_embeddings
             else tree["head"]["table"])
    out["head_packed"] = RefPackedWeight.pack(
        jnp.asarray(table).T, plan=plan(*table.T.shape), quantize=quantize,
        backend="jnp")
    out.pop("head", None)
    return jax.tree.map(jnp.asarray, out)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "olmo-1b"])
@pytest.mark.parametrize("base", ["int8", "int4"])
def test_shallow_tiles_tell_tile_and_col_scales_apart(arch, base):
    """bk 32 (K = 64 and 128 at the reduced widths: two and four k-tiles a
    column): port against reference on the same bytes within 1e-4 of the
    logit scale with equal tokens, for tile and col scales; and the two
    granularities give logits further apart than that tolerance."""
    rcfg, tcfg = _cfgs(arch)
    tree = _tree(rcfg, 4.0)
    prompt = _prompt(tcfg)
    prefill = {}
    for gran in ("", ":col"):
        quantize = base + gran
        ref_params = _ref_pack_shallow(rcfg, tree, quantize, 32)
        ref_engine = RefEngine(ref_build(rcfg), ref_params,
                               RefServeConfig(max_len=MAX_LEN))
        crossed = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                    tcfg, "cpu")
        kb = crossed["layers"][0]["attn"]["wq"].packed.shape[1]
        assert kb == tcfg.d_model // 32 > 1
        engine = _port_engine(tcfg, crossed, quantize)
        run = _port_steps(engine, prompt, 2)
        _assert_same_run(_ref_steps(ref_engine, prompt, 2), run)
        prefill[gran] = run[0][0]
    scale = np.abs(prefill[""]).max()
    assert np.abs(prefill[""] - prefill[":col"]).max() > 1e-3 * scale
