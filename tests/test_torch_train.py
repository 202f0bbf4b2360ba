"""Port vs reference: training — the losses, AdamW, ``Model.forward``, the
gradient of the train loss, the train step (plain, microbatched,
bf16-compressed), remat, the data pipeline, checkpoints across the two
packages and the train -> checkpoint -> serve lifecycle — on reduced
configs in f32 on the CPU.

Inputs are made from a seed with numpy and handed to both sides; the
reference's tree crosses through ``repro_torch.interop.params_from_numpy``.
Tolerances: losses and one AdamW update within 1e-6; logits within 1e-4 of
the reference's logit scale; each gradient leaf within 1e-4 relative
Frobenius error; train-step losses within 1e-5 relative; after n steps
the params as ``test_train_steps_match_reference`` reasons from
Adam's update; batches and checkpoints bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import pipeline as rpipe
from repro.models import build as ref_build
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.train import checkpoint as rckpt
from repro.train import losses as rlosses
from repro.train import optimizer as ropt
from repro.train.loop import TrainConfig as RefTrainConfig
from repro.train.loop import make_train_step as ref_make_train_step
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipe
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import build
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import losses as tlosses
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import _flatten
from repro_torch.train.loop import TrainConfig, make_train_step

torch.set_num_threads(1)

FORWARD_ARCHS = ["olmo-1b", "mixtral-8x22b", "qwen3-4b", "mamba2-130m",
                 "hymba-1.5b", "paligemma-3b", "whisper-base"]
BATCH = (2, 8)
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _cfgs(arch, **changes):
    changes.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(rconfigs.reduced_config(arch), **changes),
            dataclasses.replace(tconfigs.reduced_config(arch), **changes))


def _ref_tree(rcfg, scale=1.0):
    params = ref_build(rcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: np.asarray(x) * scale, params)


def _batch(cfg, seed=0, shape=BATCH):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (shape[0], shape[1] + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (shape[0], cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (shape[0], cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32
            else torch.as_tensor(v) for k, v in batch.items()}


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (den if den > 0 else 1.0)


def _leafwise(got_tree, want_tree):
    """{leaf name: (port array, reference array)} over the reference's
    layout (the port's tree stacked by ``params_to_numpy``)."""
    got = _flatten(params_to_numpy(got_tree))
    want = _flatten(jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    return {k: (got[k], want[k]) for k in want}


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# Losses and the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_next_token_xent_and_train_loss_match_reference(masked):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 5, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.4).astype(np.float32) if masked else None
    want, wm = rlosses.next_token_xent(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got, gm = tlosses.next_token_xent(
        torch.from_numpy(logits), torch.from_numpy(labels).long(),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in ("xent", "accuracy"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)
    aux = np.float32(0.37)
    want, wm = rlosses.train_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(aux))
    got, gm = tlosses.train_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels).long(),
                                 torch.tensor(aux))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in ("loss", "xent", "accuracy", "moe_aux"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 55, 100, 140])
def test_schedule_matches_reference(step):
    """Warmup (0-9), the cosine (10-100) and past its end."""
    cfg = dict(lr=2e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = ropt.schedule(ropt.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32))
    got = topt.schedule(topt.AdamWConfig(**cfg), torch.tensor(step,
                                                              dtype=torch.int32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    want, wn = ropt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                        max_norm)
    got, gn = topt.clip_by_global_norm(
        jax.tree.map(torch.from_numpy, tree), max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for k, (g, w) in _leafwise(got, want).items():
        np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)


def test_apply_updates_matches_reference():
    """One AdamW update on the same params, grads and a state three steps
    in (non-zero moments), clipping active."""
    rng = np.random.default_rng(5)

    def tree(scale):
        return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
                "n": {"s": (rng.standard_normal(5) * scale).astype(np.float32)}}
    params, grads = tree(1.0), tree(3.0)
    mu, nu = tree(0.1), jax.tree.map(np.abs, tree(0.01))
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=1.0)
    rstate = {"mu": jax.tree.map(jnp.asarray, mu),
              "nu": jax.tree.map(jnp.asarray, nu),
              "step": jnp.asarray(3, jnp.int32)}
    tstate = {"mu": jax.tree.map(torch.from_numpy, mu),
              "nu": jax.tree.map(torch.from_numpy, nu),
              "step": torch.tensor(3, dtype=torch.int32)}
    wp, ws, wm = ropt.apply_updates(ropt.AdamWConfig(**cfg),
                                    jax.tree.map(jnp.asarray, params),
                                    jax.tree.map(jnp.asarray, grads), rstate)
    gp, gs, gm = topt.apply_updates(topt.AdamWConfig(**cfg),
                                    jax.tree.map(torch.from_numpy, params),
                                    jax.tree.map(torch.from_numpy, grads),
                                    tstate)
    for got, want in ((gp, wp), (gs["mu"], ws["mu"]), (gs["nu"], ws["nu"])):
        for k, (g, w) in _leafwise(got, want).items():
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=k)
    assert int(gs["step"]) == int(ws["step"]) == 4
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)


# ---------------------------------------------------------------------------
# Model.forward and the gradient of the train loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_matches_reference(arch):
    """Logits [B, S, V] (text positions only for the VLM; with ``frames``
    for whisper) within 1e-4 of the logit scale, the MoE aux loss within
    1e-5."""
    rcfg, tcfg = _cfgs(arch)
    tree = _ref_tree(rcfg, scale=4.0)
    batch = _batch(tcfg)
    want, waux = ref_build(rcfg).forward(jax.tree.map(jnp.asarray, tree),
                                         _ref_batch(batch), remat=False)
    model = build(tcfg, device="cpu")
    got, gaux = model.forward(params_from_numpy(tree, tcfg, "cpu"),
                              _port_batch(batch), remat=False)
    assert tuple(got.shape) == BATCH + (tcfg.vocab_size,)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5, atol=1e-7)


def _loss_grads(model, params, batch):
    req = topt.tree_map(lambda p: p.detach().requires_grad_(True), params)
    logits, aux = model.forward(req, batch, remat=True)
    loss, _ = tlosses.train_loss(logits, batch["labels"], aux)
    leaves = topt.tree_leaves(req)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    from repro_torch.train.loop import tree_unflatten
    return float(loss.detach()), tree_unflatten(params, list(grads))


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x22b"])
def test_train_loss_gradients_match_jax_grad(arch):
    """Every leaf's gradient (the MoE aux loss's included for mixtral)
    within 1e-4 relative Frobenius error of ``jax.grad``'s."""
    rcfg, tcfg = _cfgs(arch)
    tree = _ref_tree(rcfg, scale=4.0)
    batch = _batch(tcfg, seed=1)
    rmodel = ref_build(rcfg)

    def loss_fn(p, b):
        logits, aux = rmodel.forward(p, b, remat=True)
        return rlosses.train_loss(logits, b["labels"], aux)[0]
    wloss, wgrads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, tree), _ref_batch(batch))
    gloss, ggrads = _loss_grads(build(tcfg, device="cpu"),
                                params_from_numpy(tree, tcfg, "cpu"),
                                _port_batch(batch))
    np.testing.assert_allclose(gloss, float(wloss), rtol=1e-6)
    errs = {k: _rel_fro(g, w) for k, (g, w) in _leafwise(ggrads, wgrads).items()}
    assert max(errs.values()) < 1e-4, errs
    if arch == "mixtral-8x22b":
        assert float(np.abs(np.asarray(wgrads["layers"]["moe"]["router"])).max()) > 0


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x22b"])
def test_remat_is_bitwise_the_plain_forward(arch):
    """remat=True and remat=False give the same logits, aux and gradients,
    bit for bit."""
    rcfg, tcfg = _cfgs(arch)
    params = params_from_numpy(_ref_tree(rcfg, scale=4.0), tcfg, "cpu")
    model = build(tcfg, device="cpu")
    batch = _port_batch(_batch(tcfg, seed=2))
    outs = []
    for remat in (True, False):
        req = topt.tree_map(lambda p: p.detach().requires_grad_(True), params)
        logits, aux = model.forward(req, batch, remat=remat)
        loss, _ = tlosses.train_loss(logits, batch["labels"], aux)
        grads = torch.autograd.grad(loss, topt.tree_leaves(req),
                                    allow_unused=True, materialize_grads=True)
        outs.append((logits.detach(), aux.detach(), grads))
    (l1, a1, g1), (l0, a0, g0) = outs
    assert torch.equal(l1, l0) and torch.equal(a1, a0)
    assert all(torch.equal(x, y) for x, y in zip(g1, g0))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

TRAIN_VARIANTS = {"plain": {}, "microbatches2": {"microbatches": 2},
                  "bf16": {"grad_compression": "bf16"}}


@pytest.fixture(scope="module")
def olmo_train_setup():
    rcfg, tcfg = _cfgs("olmo-1b", vocab_size=64)
    tree = _ref_tree(rcfg)
    data = tpipe.MarkovLM(tpipe.DataConfig(vocab_size=64, seq_len=16,
                                           global_batch=4))
    return rcfg, tcfg, tree, [data.batch_at(i) for i in range(5)]


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("variant", list(TRAIN_VARIANTS))
def test_train_steps_match_reference(olmo_train_setup, variant, steps):
    """``steps`` train steps of the port against
    ``jax.jit(make_train_step(...))`` from the same params and batches:
    each step's loss within 1e-5 relative. The params' tolerance follows
    from Adam's update, about ``lr * sign(g)`` wherever |g| >> eps: where
    the two gradients agree to 1e-4 the updates agree to about 1e-4 of
    lr, but an element whose |g| is near eps (1e-8) has an unsettled
    moment ratio and can move by up to lr differently in a step. So each
    leaf's total update ``p_n - p_0`` is held within 1e-3 relative
    Frobenius error of the reference's (measured: 1.1e-4 at most), and
    every element within ``steps * lr`` (measured: 1.4e-5, one element in
    16384, against 1e-3)."""
    rcfg, tcfg, tree, batches = olmo_train_setup
    kw = TRAIN_VARIANTS[variant]
    rstep = jax.jit(ref_make_train_step(ref_build(rcfg), RefTrainConfig(
        optim=ropt.AdamWConfig(**OCFG), **kw)))
    tstep = make_train_step(build(tcfg, device="cpu"), TrainConfig(
        optim=topt.AdamWConfig(**OCFG), **kw))
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ropt.init_state(rp)
    tp = params_from_numpy(tree, tcfg, "cpu")
    ts = topt.init_state(tp)
    for i in range(steps):
        rp, rs, rm = rstep(rp, rs, _ref_batch(batches[i]))
        tp, ts, tm = tstep(tp, ts, _port_batch(batches[i]))
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                                   rtol=1e-5)
        for k in ("xent", "accuracy", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
    init = _flatten(jax.tree.map(np.asarray, tree))
    leaves = _leafwise(tp, rp)
    upd = {k: _rel_fro(g - init[k], w - init[k]) for k, (g, w) in leaves.items()}
    assert max(upd.values()) < 1e-3, upd
    far = {k: float(np.abs(g - w).max()) for k, (g, w) in leaves.items()}
    assert max(far.values()) <= steps * OCFG["lr"], far
    assert int(ts["step"]) == steps


def test_loss_decreases_on_markov_data():
    """The reference's ``test_loss_decreases_on_learnable_data`` at its
    settings, with the port's own initial weights."""
    cfg = dataclasses.replace(tconfigs.reduced_config("olmo-1b"),
                              compute_dtype="float32", vocab_size=64)
    model = build(cfg, device="cpu")
    params = model.init(0)
    state = topt.init_state(params)
    step = make_train_step(model, TrainConfig(
        optim=topt.AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=40)))
    data = tpipe.MarkovLM(tpipe.DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=32, global_batch=8),
                          branching=2)
    losses = []
    for i in range(40):
        params, state, metrics = step(params, state,
                                      _port_batch(data.batch_at(i)))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# Data and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["SyntheticLM", "MarkovLM"])
@pytest.mark.parametrize("hosts,host", [(1, 0), (2, 1), (4, 2)])
def test_batches_byte_identical(kind, hosts, host):
    cfg = dict(vocab_size=97, seq_len=13, global_batch=8, seed=11,
               num_hosts=hosts, host_index=host)
    ref = getattr(rpipe, kind)(rpipe.DataConfig(**cfg))
    port = getattr(tpipe, kind)(tpipe.DataConfig(**cfg))
    for step in (0, 1, 7, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()


def _states(arch="olmo-1b"):
    """A reference train state two steps in and the same state in the
    port's layout."""
    rcfg, tcfg = _cfgs(arch, vocab_size=64)
    tree = _ref_tree(rcfg)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ropt.init_state(rp)
    rstep = jax.jit(ref_make_train_step(ref_build(rcfg), RefTrainConfig(
        optim=ropt.AdamWConfig(**OCFG))))
    for i in range(2):
        rp, rs, _ = rstep(rp, rs, _ref_batch(_batch(rcfg, seed=i)))
    rstate = {"params": rp, "opt": rs}
    npstate = jax.tree.map(np.asarray, rstate)
    tstate = {"params": params_from_numpy(npstate["params"], tcfg, "cpu"),
              "opt": {"mu": params_from_numpy(npstate["opt"]["mu"], tcfg, "cpu"),
                      "nu": params_from_numpy(npstate["opt"]["nu"], tcfg, "cpu"),
                      "step": torch.tensor(npstate["opt"]["step"])}}
    return rstate, tstate


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-base"])
def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path, arch):
    rstate, tstate = _states(arch)
    rckpt.save(str(tmp_path), 2, rstate)
    zeros = topt.tree_map(torch.zeros_like, tstate)
    restored, step = tckpt.restore(str(tmp_path), zeros)
    assert step == 2
    for k, (g, w) in _leafwise(restored, rstate).items():
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-base"])
def test_port_checkpoint_restores_in_the_reference_bitwise(tmp_path, arch):
    rstate, tstate = _states(arch)
    tckpt.save(str(tmp_path), 2, tstate)
    template = jax.tree.map(jnp.zeros_like, rstate)
    restored, step = rckpt.restore(str(tmp_path), template)
    assert step == 2
    for k, (g, w) in _leafwise(tstate, restored).items():
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    # the same leaf names, in the same order, in both files' manifests
    rckpt.save(str(tmp_path / "ref"), 2, rstate)
    import json
    with open(tmp_path / "step_2.json") as f, \
            open(tmp_path / "ref" / "step_2.json") as g:
        assert json.load(f)["leaves"] == json.load(g)["leaves"]


def test_lifecycle_train_checkpoint_serve_matches_reference(tmp_path):
    """The reference's train -> checkpoint -> serve lifecycle in the port:
    the loss falls over 30 steps on Markov data; the checkpoint restored
    by the port and by the reference serves the same greedy tokens."""
    cfg = dataclasses.replace(tconfigs.reduced_config("olmo-1b"),
                              compute_dtype="float32", vocab_size=64)
    rcfg = dataclasses.replace(rconfigs.reduced_config("olmo-1b"),
                               compute_dtype="float32", vocab_size=64)
    model = build(cfg, device="cpu")
    params = model.init(0)
    state = topt.init_state(params)
    step = make_train_step(model, TrainConfig(
        optim=topt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30)))
    data = tpipe.MarkovLM(tpipe.DataConfig(vocab_size=64, seq_len=32,
                                           global_batch=8), branching=2)
    losses = []
    for i in range(30):
        params, state, m = step(params, state, _port_batch(data.batch_at(i)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    tckpt.save(str(tmp_path), 30, {"params": params})

    restored, _ = tckpt.restore(str(tmp_path), {"params": model.init(1)})
    engine = Engine(model, restored["params"], ServeConfig(max_len=48),
                    device="cpu")
    rmodel = ref_build(rcfg)
    rtemplate = {"params": jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))}
    rrestored, _ = rckpt.restore(str(tmp_path), rtemplate)
    ref_engine = RefEngine(rmodel, rrestored["params"],
                           RefServeConfig(max_len=48))
    prompt = np.random.default_rng(6).integers(0, 64, (2, 4)).astype(np.int32)
    got = engine.generate({"tokens": prompt}, 8)
    want = np.asarray(ref_engine.generate({"tokens": jnp.asarray(prompt)}, 8))
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
