"""The port's ``init_params`` tree against the reference's ``init``.

For every config (all ten; each also with qk-norm and biases switched
on), ``build(cfg, device="cpu").init(0)`` must give the reference's key
tree, shapes and dtypes, with the reference's stacked ``[L, ...]`` layer
leaves split per layer (an encoder's too), and the same deterministic
leaves (norm scales and qk-norm scales of ones, zero biases, the SSM's
``A_log``, ``dt_bias`` and ``D``). The random matrices differ by
construction (another generator).
A prefill parity check then shows that the port applies non-zero biases
and qk-norm scales handed to it through ``interop``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import build as ref_build
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import build

torch.set_num_threads(1)

ARCHS = ["command-r-plus-104b", "phi3-mini-3.8b", "qwen3-4b", "olmo-1b",
         "mixtral-8x22b", "llama4-scout-17b-a16e", "whisper-base",
         "paligemma-3b", "hymba-1.5b", "mamba2-130m"]
STACKS = ("layers", "encoder")
VARIANTS = {"as published": {},
            "qk_norm + use_bias": dict(qk_norm=True, use_bias=True)}


def _configs(arch, variant):
    change = VARIANTS[variant]
    return (dataclasses.replace(ref_reduced_config(arch), **change),
            dataclasses.replace(reduced_config(arch), **change))


def _flatten(tree, prefix=()):
    """{path: leaf} of a nested dict tree."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def _ref_tree(ref_cfg):
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _port_layers(params):
    """The port's per-layer list as one flat {path: [L] list of leaves}."""
    flat = [_flatten(layer) for layer in params["layers"]]
    return {path: [f[path] for f in flat] for path in flat[0]}, flat


def _stacks(ref, port):
    """(name, reference's stacked layers, port's per-layer list, L): the
    decoder's layers and, for an encoder-decoder, the encoder's."""
    out = [("layers", ref["layers"], port["layers"])]
    if "encoder" in ref:
        out.append(("encoder", ref["encoder"]["layers"],
                    port["encoder"]["layers"]))
    return out


def _top(tree):
    """Every leaf outside the layer stacks."""
    top = {k: v for k, v in tree.items() if k != "layers"}
    if "encoder" in top:
        top["encoder"] = {k: v for k, v in top["encoder"].items()
                          if k != "layers"}
    return _flatten(top)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_the_reference(arch, variant):
    """Same paths, shapes and dtypes; every layer has the same paths."""
    ref_cfg, cfg = _configs(arch, variant)
    ref = _ref_tree(ref_cfg)
    port = build(cfg, device="cpu").init(0)
    assert set(port) == set(ref)
    top_ref, top_port = _top(ref), _top(port)
    assert set(top_port) == set(top_ref)
    for path, leaf in top_ref.items():
        assert tuple(top_port[path].shape) == leaf.shape, path
        assert str(top_port[path].dtype) == f"torch.{leaf.dtype}", path
    for name, ref_stack, port_stack in _stacks(ref, port):
        n = cfg.num_layers if name == "layers" else cfg.encoder_layers
        ref_layers = _flatten(ref_stack)
        per_layer = [_flatten(layer) for layer in port_stack]
        assert len(port_stack) == n
        assert all(set(f) == set(ref_layers) for f in per_layer)
        for path, leaf in ref_layers.items():
            assert leaf.shape[0] == n, path
            for f in per_layer:
                assert tuple(f[path].shape) == leaf.shape[1:], path
                assert str(f[path].dtype) == f"torch.{leaf.dtype}", path


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_init_deterministic_leaves_match_the_reference(arch, variant):
    """Every reference leaf that is all ones or all zeros (norm scales,
    qk-norm scales, biases) is the same in the port, layer by layer; the
    switched-on variant has such leaves under attn and mlp."""
    ref_cfg, cfg = _configs(arch, variant)
    ref = _ref_tree(ref_cfg)
    port = build(cfg, device="cpu").init(0)
    fixed = []
    for _, ref_stack, port_stack in _stacks(ref, port):
        per_layer = [_flatten(layer) for layer in port_stack]
        for path, leaf in _flatten(ref_stack).items():
            if path[-1] in SSM_FIXED:
                fixed.append(path)
                for i, f in enumerate(per_layer):
                    np.testing.assert_allclose(f[path].numpy(), leaf[i],
                                               rtol=1e-6, atol=0)
                continue
            for value in (0.0, 1.0):
                if np.all(leaf == value):
                    fixed.append(path)
                    for f in per_layer:
                        assert torch.all(f[path] == value), path
    top_port = _top(port)
    for path, leaf in _top(ref).items():
        if np.all(leaf == 1.0) or np.all(leaf == 0.0):
            np.testing.assert_array_equal(top_port[path].numpy(), leaf)
    names = {p[-1] for p in fixed}
    if cfg.has_ssm:
        assert set(SSM_FIXED) | {"D", "norm", "conv_b"} <= names
    # qk-norm scales and biases exactly where the config switches them on
    # (the switched-on variant everywhere a layer has attention or an MLP).
    want = set()
    if cfg.has_attention and cfg.qk_norm:
        want |= {"q_norm", "k_norm"}
    if cfg.has_attention and cfg.use_bias:
        want |= {"bq", "bk", "bv", "bo"}
    if cfg.use_bias and cfg.d_ff and not cfg.is_moe:
        want |= {"bi", "bo"}
    assert names & {"q_norm", "k_norm", "bq", "bk", "bv", "bo", "bi"} == want
    if VARIANTS[variant] and cfg.has_attention:
        assert {"q_norm", "k_norm", "bq", "bk", "bv", "bo"} <= want


# The SSM's leaves that are neither all zeros nor all ones but fixed:
# A_log = log(linspace(1, 16, heads)), dt_bias = softplus^-1(0.01).
SSM_FIXED = ("A_log", "dt_bias")


def _with_live_bias_and_norms(tree, rng):
    """The reference tree with every bias drawn N(0, 0.1) and every
    qk-norm scale 1 + N(0, 0.1): leaves a model must apply to match."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name in ("bq", "bk", "bv", "bo", "bi"):
            return rng.normal(0, 0.1, node.shape).astype(node.dtype)
        if name in ("q_norm", "k_norm"):
            return (1 + rng.normal(0, 0.1, node.shape)).astype(node.dtype)
        return node
    return walk(tree)


def test_f32_prefill_applies_biases_and_qk_norm():
    """olmo-1b reduced with qk-norm and biases, f32: the reference's tree,
    with non-zero biases and qk-norm scales set from numpy, crosses through
    ``interop``; the port's last-position prefill logits agree with the
    reference's within 1e-4 of the logit scale (same products, other
    summation orders, as the other f32 parity tests). Zeroing the biases
    and the qk-norm moves the logits by far more, so the check sees them."""
    ref_cfg, cfg = (dataclasses.replace(c, compute_dtype="float32")
                    for c in _configs("olmo-1b", "qk_norm + use_bias"))
    rng = np.random.default_rng(0)
    # Weights x4 (as test_torch_serve does) so that the logits are of order 1.
    tree = jax.tree.map(lambda x: np.asarray(x) * 4, _ref_tree(ref_cfg))
    tree = _with_live_bias_and_norms(tree, rng)
    tokens = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    want, _ = ref_build(ref_cfg).prefill(jax.tree.map(jax.numpy.asarray, tree),
                                         {"tokens": jax.numpy.asarray(tokens)})
    want = np.asarray(want)
    model = build(cfg, device="cpu")
    got, _ = model.prefill(params_from_numpy(tree, cfg, "cpu"),
                           {"tokens": torch.as_tensor(tokens, dtype=torch.long)})
    scale = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-4 * scale, (err, scale)
    plain = jax.tree.map(lambda x: x, tree)
    for layer in (plain["layers"]["attn"], plain["layers"]["mlp"]):
        for name in list(layer):
            if name.startswith("b"):
                layer[name] = np.zeros_like(layer[name])
            if name.endswith("_norm"):
                layer[name] = np.ones_like(layer[name])
    off, _ = model.prefill(params_from_numpy(plain, cfg, "cpu"),
                           {"tokens": torch.as_tensor(tokens, dtype=torch.long)})
    assert float(np.abs(off.numpy() - want).max()) > 100 * 1e-4 * scale
