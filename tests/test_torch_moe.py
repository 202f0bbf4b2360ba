"""Port vs reference: MoE routing, the MoE layer, and serving reduced
mixtral-8x22b (packed and raw), all in f32 on the CPU.

Inputs are made from a seed with numpy and handed to both sides; the
reference's ``init_params`` tree crosses to the port through numpy
(``repro_torch.interop``). Tolerances: routing stats exactly equal; the MoE
layer's output within 1e-5 (the same f32 products, summed in different
orders); logits within 1e-4 after two layers, with identical greedy tokens.
The grouped CUDA kernels are held against their plain versions on the card
(``cuda`` marker; they skip here)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.core import GroupedPackedWeight as RefGroupedPackedWeight
from repro.models import build as ref_build
from repro.models import moe as rmoe
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.configs import reduced_config
from repro_torch.core import tile_format as ttf
from repro_torch.core.layered import GroupedPackedWeight
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import gemm_grouped as gg
from repro_torch.kernels import ref as tref
from repro_torch.models import build
from repro_torch.models import moe as tmoe
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)
ARCH = "mixtral-8x22b"


def _cfgs(**changes):
    changes.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(ref_reduced_config(ARCH), **changes),
            dataclasses.replace(reduced_config(ARCH), **changes))


def _moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": rng.standard_normal((d, e)).astype(np.float32),
            "wg": (0.2 * rng.standard_normal((e, d, f))).astype(np.float32),
            "wu": (0.2 * rng.standard_normal((e, d, f))).astype(np.float32),
            "wo": (0.2 * rng.standard_normal((e, f, d))).astype(np.float32)}


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_route_matches_reference_exactly(capacity_factor):
    """Dispatch, counts and dropped equal; combine and aux within 1e-6.
    capacity_factor 0.5 drops assignments."""
    rcfg, tcfg = _cfgs(capacity_factor=capacity_factor)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((tcfg.d_model, tcfg.num_experts)).astype(np.float32)
    rd, rc, raux, rstats = rmoe.route(rcfg, jnp.asarray(w), jnp.asarray(x))
    td, tc, taux, tstats = tmoe.route(tcfg, torch.from_numpy(w),
                                      torch.from_numpy(x))
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(tstats["counts"].numpy(),
                                  np.asarray(rstats["counts"]))
    assert int(tstats["dropped"]) == int(rstats["dropped"])
    assert (int(tstats["dropped"]) > 0) == (capacity_factor < 1)
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-6)


def test_route_breaks_ties_toward_the_lower_expert():
    """Experts 1 and 2 (and 0 and 3) have identical router columns, so
    every token's logits tie pairwise; both sides keep the lower index."""
    rcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 24, tcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((tcfg.d_model, 2)).astype(np.float32)
    w = w[:, [0, 1, 1, 0]]
    rd, _, _, rstats = rmoe.route(rcfg, jnp.asarray(w), jnp.asarray(x))
    td, _, _, tstats = tmoe.route(tcfg, torch.from_numpy(w),
                                  torch.from_numpy(x))
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(tstats["counts"].numpy(),
                                  np.asarray(rstats["counts"]))


def _ref_pack(p):
    return {**p, **{k: RefGroupedPackedWeight.pack(
        jnp.asarray(p[k]), backend="jnp", n_b_streams=2 if k != "wo" else 1)
        for k in ("wg", "wu", "wo")}}


def _port_pack(p):
    return {**p, **{k: GroupedPackedWeight.pack(
        p[k], n_b_streams=2 if k != "wo" else 1) for k in ("wg", "wu", "wo")}}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_apply_moe_matches_reference(packed, capacity_factor):
    """Raw stacks (batched einsum) and packed stacks (ragged grouped GEMM,
    its plain version here): counts and dropped equal, out within 1e-5."""
    rcfg, tcfg = _cfgs(capacity_factor=capacity_factor)
    p = _moe_params(tcfg, 2)
    x = np.random.default_rng(3).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    if packed:
        rp, tp = _ref_pack(rp), _port_pack(tp)
    rout, raux, rstats = rmoe.apply_moe(rcfg, rp, jnp.asarray(x))
    tout, taux, tstats = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_array_equal(tstats["expert_counts"].numpy(),
                                  np.asarray(rstats["expert_counts"]))
    assert int(tstats["dropped_tokens"]) == int(rstats["dropped_tokens"])
    np.testing.assert_allclose(tout.numpy(), np.asarray(rout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-6)


def _engines(pack, scale=4.0, max_len=32, **changes):
    rcfg, tcfg = _cfgs(**changes)
    ref_model = ref_build(rcfg)
    tree = jax.tree.map(lambda x: np.asarray(x) * scale,
                        ref_model.init(jax.random.PRNGKey(0)))
    ref_engine = RefEngine(ref_model, jax.tree.map(jnp.asarray, tree),
                           RefServeConfig(max_len=max_len, pack_weights=pack))
    engine = Engine(build(tcfg, device="cpu"),
                    params_from_numpy(tree, tcfg, "cpu"),
                    ServeConfig(max_len=max_len, pack_weights=pack),
                    device="cpu")
    return ref_engine, engine


def _check_steps(ref_engine, engine, prompt, steps):
    """Prefill + greedy decode on both engines: every step's logits within
    1e-4, every greedy token equal."""
    lr, cr = ref_engine._prefill(ref_engine.params,
                                 {"tokens": jnp.asarray(prompt)})
    lp, cp = engine._prefill(
        {"tokens": torch.as_tensor(prompt, dtype=torch.long)})
    b, s = prompt.shape
    toks = []
    for i in range(steps + 1):
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), rtol=0,
                                   atol=1e-4)
        tr = jnp.argmax(lr, -1).astype(jnp.int32)[:, None]
        tp = torch.argmax(lp, -1)[:, None]
        np.testing.assert_array_equal(tp.numpy(), np.asarray(tr))
        toks.append(tp.numpy())
        if i == steps:
            break
        lr, cr = ref_engine._decode(ref_engine.params, cr, tr,
                                    jnp.full((b,), s + i, jnp.int32))
        lp, cp = engine._decode(cp, tp, torch.full((b,), s + i,
                                                   dtype=torch.long))
        lr, lp = lr[:, 0], lp[:, 0]
    return np.concatenate(toks, axis=1)


@pytest.mark.parametrize("pack", [True, False])
def test_reduced_mixtral_logits_and_greedy_tokens_match_reference(pack):
    """Prefill and 8 decode steps of reduced mixtral-8x22b; ``generate``
    gives the same tokens on both sides. The weights are scaled by 4 (both
    sides get the same tree) so that greedy decoding wanders."""
    ref_engine, engine = _engines(pack)
    prompt = np.random.default_rng(4).integers(0, 256, (2, 6)).astype(np.int32)
    toks = _check_steps(ref_engine, engine, prompt, 8)
    assert len(np.unique(toks)) > 2
    got = engine.generate({"tokens": prompt}, 8)
    np.testing.assert_array_equal(
        got, ref_engine.generate({"tokens": jnp.asarray(prompt)}, 8))


def test_gqa_and_sliding_window_ring_wrap_match_reference():
    """The reduced config is MHA (4 heads, 4 KV heads) with a 64-token
    window; here both sides use 2 KV heads (GQA, group 2) and a 16-token
    window, so a 12-token prompt plus 8 steps wraps the ring cache."""
    ref_engine, engine = _engines(True, num_kv_heads=2, sliding_window=16)
    prompt = np.random.default_rng(5).integers(0, 256, (2, 12)).astype(np.int32)
    _check_steps(ref_engine, engine, prompt, 8)


def test_dispatch_report_names_the_grouped_lowerings():
    _, packed = _engines(True)
    _, raw = _engines(False)
    moe_entries = {k.split(":")[0]: v for k, v in packed.dispatch_report.items()
                   if k.startswith("moe.")}
    assert moe_entries == {"moe.gate_up": "grouped_packed_weight",
                           "moe.down": "grouped_packed_weight"}
    assert {v for k, v in raw.dispatch_report.items()
            if k.startswith("moe.")} == {"grouped_einsum"}
    assert "|counts|" in next(k for k in packed.dispatch_report
                              if k.startswith("moe.down"))


# ---------------------------------------------------------------------------
# The silu-gate pair's geometry: a gate and an up stack of other widths
# ---------------------------------------------------------------------------

def _pair_inputs(up_shape, seed=0):
    """The gate [2, 64, 8] and an up stack of ``up_shape`` packed with the
    gate's plan (stacks of N 8 and 12 pad to one buffer under it), and a
    [2, 4, 64] activation with its [2, 1, 4, 64] ragged form and counts."""
    rng = np.random.default_rng(seed)
    wg = rng.standard_normal((2, 64, 8)).astype(np.float32)
    wu = rng.standard_normal(up_shape).astype(np.float32)
    a = rng.standard_normal((2, 4, 64)).astype(np.float32)
    counts = np.array([[4], [2]], np.int32)
    return wg, wu, a, counts


def _port_pair(wg, wu):
    gate = GroupedPackedWeight.pack(torch.as_tensor(wg), n_b_streams=2)
    return gate, GroupedPackedWeight.pack(torch.as_tensor(wu), plan=gate.plan)


def _port_silu_gate(gate, up, a, counts, ragged):
    a = torch.as_tensor(a)
    if ragged:
        return gate.silu_gate(up, a.reshape(2, 1, 4, a.shape[-1]),
                              counts=torch.as_tensor(counts))
    return gate.silu_gate(up, a)


@pytest.mark.parametrize("ragged", [False, True], ids=["packed", "ragged"])
@pytest.mark.parametrize("up_shape", [(2, 64, 12), (2, 48, 8), (3, 64, 8)],
                         ids=["n", "k", "e"])
def test_silu_gate_pair_of_another_geometry_raises(up_shape, ragged):
    """A pair whose N, K or E differ raises ValueError before any lowering
    runs (the probe of N 8 against 12 returned a truncated [2, 4, 8]
    product before the check compared widths)."""
    wg, wu, a, counts = _pair_inputs(up_shape)
    gate, up = _port_pair(wg, wu)
    with pytest.raises(ValueError, match="one geometry"):
        _port_silu_gate(gate, up, a, counts, ragged)


def test_reference_silu_gate_raises_on_the_pair_of_other_widths():
    """The reference refuses the same pair (N 8 against 12, packed with the
    gate's plan) in its count-free form: its product of the two streams
    cannot broadcast."""
    wg, wu, a, _ = _pair_inputs((2, 64, 12))
    gate = RefGroupedPackedWeight.pack(jnp.asarray(wg), n_b_streams=2)
    up = RefGroupedPackedWeight.pack(jnp.asarray(wu), plan=gate.plan)
    with pytest.raises(TypeError, match="incompatible shapes"):
        gate.silu_gate(up, jnp.asarray(a))


@pytest.mark.parametrize("ragged", [False, True], ids=["packed", "ragged"])
def test_matched_silu_gate_pair_matches_reference(ragged):
    """A pair of one geometry still runs: silu(a @ Wg) * (a @ Wu) within
    1e-5 of the reference's on the same numpy inputs (f32)."""
    wg, wu, a, counts = _pair_inputs((2, 64, 8), seed=1)
    gate, up = _port_pair(wg, wu)
    got = _port_silu_gate(gate, up, a, counts, ragged).numpy()
    rgate = RefGroupedPackedWeight.pack(jnp.asarray(wg), n_b_streams=2)
    rup = RefGroupedPackedWeight.pack(jnp.asarray(wu), plan=rgate.plan)
    if ragged:
        want = rgate.silu_gate(rup, jnp.asarray(a.reshape(2, 1, 4, 64)),
                               counts=jnp.asarray(counts))
    else:
        want = rgate.silu_gate(rup, jnp.asarray(a))
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

def _cuda_case(seed, e, s, c, k, n, dtype, gran, layout, gate):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = dict(scale=ttf.ScaleSpec(granularity=gran)) if gran else {}
    fmt = ttf.TileFormat(64, 64, layout, dtype, **scale)

    def stack():
        w = torch.randn((e, k, n), generator=gen, device="cuda") * 0.05
        out = tref.pack_b_grouped_ref(w if gran else w.to(torch.bfloat16), fmt)
        return out if gran else (out, None)

    (bp, sc), (b2p, sc2) = stack(), (stack() if gate else (None, None))
    a = torch.randn((e, s, c, k), generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(b2_packed=b2p, b_scales=sc, b2_scales=sc2, b_format=fmt,
              epilogue="silu_gate" if gate else "gelu",
              bias=None if gate else torch.randn((e, n), generator=gen,
                                                 device="cuda"))
    return a, bp, kw


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 70])
@pytest.mark.parametrize("dtype,gran,layout,gate", [
    ("bfloat16", None, "row", True), ("int8", "tile", "col", False),
    ("int4", "col", "row", True)])
def test_cuda_k2_matches_plain_version(c, dtype, gran, layout, gate):
    """K2 on the card against its plain version (bf16 output: rtol 2e-2 for
    the final rounding, summation order differs); rows past the counts are
    exactly 0. C = 8 takes the decode blocks, C = 70 the prefill blocks."""
    e, s, k, n = 3, 2, 200, 192
    a, bp, kw = _cuda_case(0, e, s, c, k, n, dtype, gran, layout, gate)
    counts = torch.tensor([[0, c], [c // 2, 1], [c + 9, -1]], dtype=torch.int32,
                          device="cuda")
    got = gg.gemm_grouped_packed_ragged(a, bp, n, counts, **kw)
    want = gg.gemm_grouped_packed_ragged_plain(a, bp, n, counts, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=1e-3)
    mask = tref.ragged_row_mask(c, counts.clamp(0, c))
    assert not got[~mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,gran,layout,gate", [
    ("bfloat16", None, "col", False), ("int8", "col", "row", True)])
def test_cuda_k3_matches_plain_version(dtype, gran, layout, gate):
    """K3 (no counts: every row live) on the card against its plain
    version; tolerance as for K2."""
    e, m, k, n = 3, 40, 200, 192
    a, bp, kw = _cuda_case(1, e, 1, m, k, n, dtype, gran, layout, gate)
    got = gg.gemm_grouped_packed(a[:, 0], bp, n, **kw)
    want = gg.gemm_grouped_packed_plain(a[:, 0], bp, n, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=1e-3)
