"""The train step as a captured graph (``repro_torch.train.loop.TrainStep``)
on the CPU.

On the card ``make_train_step`` returns a step that captures the
functional train step into a CUDA graph and updates the params and the
optimizer state in place, the counterpart of the reference's
``jax.jit(step_fn, donate_argnums=(0, 1))``. The function captured there
is the graph's body over its static tree, which runs uncaptured here. It is
held to the functional eager step (``TrainStep._eager``) bit for bit over
three steps (params, both moments, the step count, every metric) on reduced
olmo-1b and mixtral-8x22b, plain, with two microbatches and with bf16
gradient compression; the static leaves keep their addresses; a checkpoint
restored into the static tree resumes bit for bit; and the step holds
``tests/test_torch_train.py``'s tolerances against the reference's jitted
step from the same numpy inputs. Reduced configs in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build as ref_build
from repro.train import optimizer as ropt
from repro.train.loop import TrainConfig as RefTrainConfig
from repro.train.loop import make_train_step as ref_make_train_step
from repro_torch.interop import params_from_numpy
from repro_torch.models import build
from repro_torch.models.layers import remat_call
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import _flatten
from repro_torch.train.loop import TrainConfig, TrainStep, make_train_step
from test_torch_train import (OCFG, TRAIN_VARIANTS, _batch, _cfgs, _leafwise,
                              _port_batch, _ref_batch, _ref_tree, _rel_fro)

torch.set_num_threads(1)

STEPS = 3
SHAPE = (4, 8)


def _setup(arch, **kw):
    rcfg, tcfg = _cfgs(arch, vocab_size=64)
    tree = _ref_tree(rcfg)
    step = make_train_step(build(tcfg, device="cpu"), TrainConfig(
        optim=topt.AdamWConfig(**OCFG), **kw))
    batches = [_batch(tcfg, seed=i, shape=SHAPE) for i in range(STEPS + 2)]
    return rcfg, tcfg, tree, step, batches


def _fresh(tree, tcfg):
    params = params_from_numpy(tree, tcfg, "cpu")
    return params, topt.init_state(params)


def _assert_bitwise(got, want):
    la, lb = topt.tree_leaves(got), topt.tree_leaves(want)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("variant", list(TRAIN_VARIANTS))
@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x22b"])
def test_graph_body_is_bitwise_the_eager_step(arch, variant):
    """Three steps of the graph's body (uncaptured: the CPU) against three
    of the functional step: params, moments, step and metrics bit for bit;
    the step returns the trees it adopted, their leaves at the same
    addresses; the functional step leaves its inputs as they were."""
    _, tcfg, tree, step, batches = _setup(arch, **TRAIN_VARIANTS[variant])
    assert isinstance(step, TrainStep)
    gp, gs = _fresh(tree, tcfg)
    ep, es = _fresh(tree, tcfg)
    adopted = (gp, gs)
    ptrs = [t.data_ptr() for t in topt.tree_leaves(adopted)]
    for i in range(STEPS):
        batch = _port_batch(batches[i])
        gp, gs, gm = step(gp, gs, batch)
        before = topt.tree_map(torch.clone, {"p": ep, "s": es})
        ep, es, em = step._eager(ep, es, batch)
        assert gp is adopted[0] and gs is adopted[1]
        _assert_bitwise({"p": ep, "s": es}, {"p": gp, "s": gs})
        assert sorted(gm) == sorted(em) == sorted(
            ("loss", "xent", "accuracy", "moe_aux", "grad_norm", "lr"))
        for k in gm:
            assert torch.equal(gm[k], em[k]), k
        assert not torch.equal(before["p"]["embed"]["table"],
                               ep["embed"]["table"])
    assert int(gs["step"]) == STEPS
    assert step.graph.capture is False
    assert [t.data_ptr() for t in topt.tree_leaves(adopted)] == ptrs


def test_batches_of_another_shape_are_refused():
    """The static batch has the first batch's shape: another shape raises
    (the reference's jit would compile a second program)."""
    _, tcfg, tree, step, batches = _setup("olmo-1b")
    p, s = _fresh(tree, tcfg)
    p, s, _ = step(p, s, _port_batch(batches[0]))
    short = _port_batch(_batch(tcfg, seed=9, shape=(2, 8)))
    with pytest.raises(ValueError, match="static leaf"):
        step(p, s, short)


def test_checkpoint_restored_into_the_static_tree_resumes_bitwise(tmp_path):
    """Two steps, a checkpoint, two more; the checkpoint restored into
    fresh trees and handed to the same step: copied into its static tree
    (the addresses kept), and the same two steps bit for bit."""
    _, tcfg, tree, step, batches = _setup("olmo-1b")
    p, s = _fresh(tree, tcfg)
    ptrs = [t.data_ptr() for t in topt.tree_leaves((p, s))]
    for i in range(2):
        p, s, _ = step(p, s, _port_batch(batches[i]))
    tckpt.save(str(tmp_path), 2, {"params": p, "opt": s})
    straight = []
    for i in (2, 3):
        p, s, m = step(p, s, _port_batch(batches[i]))
        straight.append(float(m["loss"]))
    end = topt.tree_map(torch.clone, {"p": p, "s": s})
    zp, zs = _fresh(tree, tcfg)
    restored, at = tckpt.restore(str(tmp_path), {"params": zp, "opt": zs})
    assert at == 2
    rp, rs = restored["params"], restored["opt"]
    resumed = []
    for i in (2, 3):
        rp, rs, m = step(rp, rs, _port_batch(batches[i]))
        resumed.append(float(m["loss"]))
    assert resumed == straight
    assert rp is p and rs is s
    assert [t.data_ptr() for t in topt.tree_leaves((rp, rs))] == ptrs
    _assert_bitwise({"p": rp, "s": rs}, end)


def test_a_failed_remat_forward_raises_and_leaves_no_hooks_behind():
    """An exception inside a remat'd forward (a fault at a train step's
    warm-up) propagates as raised, with no saved-tensor hooks left
    installed, and the next remat'd forward's gradient is bitwise the
    plain one's (the checkpoint's frame of the failed call saves
    nothing of it)."""
    w = torch.randn(8, 8, requires_grad=True, generator=torch.Generator()
                    .manual_seed(1))
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(2))
    boom = RuntimeError("a failed forward")

    def bad(a):
        torch.tanh(a @ w)
        raise boom

    def good(a):
        return torch.tanh(a @ w) @ w
    with pytest.raises(RuntimeError) as info:
        remat_call(bad, True, x)
    assert info.value is boom
    assert torch._C._autograd._top_saved_tensors_default_hooks(False) is None
    (g1,) = torch.autograd.grad(remat_call(good, True, x).sum(), w)
    (g0,) = torch.autograd.grad(remat_call(good, False, x).sum(), w)
    assert torch.equal(g1, g0)


@pytest.mark.parametrize("variant", list(TRAIN_VARIANTS))
def test_graph_step_matches_reference(variant):
    """The step against ``jax.jit(make_train_step(...))`` from the same
    params and batches, at ``test_train_steps_match_reference``'s
    tolerances: each step's loss within 1e-5 relative and the other
    metrics within 1e-4; each leaf's total update within 1e-3 relative
    Frobenius error of the reference's, every element within
    ``steps * lr``."""
    rcfg, tcfg, tree, tstep, batches = _setup("olmo-1b",
                                              **TRAIN_VARIANTS[variant])
    rstep = jax.jit(ref_make_train_step(ref_build(rcfg), RefTrainConfig(
        optim=ropt.AdamWConfig(**OCFG), **TRAIN_VARIANTS[variant])))
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ropt.init_state(rp)
    tp, ts = _fresh(tree, tcfg)
    for i in range(STEPS):
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
    assert max(far.values()) <= STEPS * OCFG["lr"], far
    assert int(ts["step"]) == STEPS
