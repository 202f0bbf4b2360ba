"""The sampler on the device (``repro_torch.serve.sampler``) on the CPU.

``Engine.sample_tokens`` draws a sampled token by Gumbel-argmax over one
function of tensors, ``draw(logits, keys, temperature)``, with each row's
key hashed from (seed, request_id, step) on the host. Here it is held to a
numpy implementation of the same hash (``uint64``) and the same draw (the
noise in f64 rounded to f32, the scores in f32), bit for bit; a row's
token is shown to be its own whatever the batch around it (alone, in a
batch, beside the scheduler's padding rows); the draws follow the softmax
by a chi-square test of 20000 draws at a fixed seed (p > 1e-4); a row with
a non-finite softmax takes its argmax; ties go to the first maximal index.
The card's draws are held to these on the card in
``tests/test_torch_train_graph_card.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.configs import reduced_config
from repro_torch.models import build
from repro_torch.serve import Engine, ServeConfig, sampler

torch.set_num_threads(1)

U64 = np.uint64


def _mix64(*vals):
    """splitmix64 over the values, in Python integers."""
    mask = (1 << 64) - 1
    x = sampler.GOLDEN
    for v in vals:
        x = (x ^ (v & mask)) * sampler.MIX1 & mask
        x = (x ^ (x >> 31)) * sampler.MIX2 & mask
        x ^= x >> 29
    return x & ((1 << 63) - 1)


def np_uniforms(keys, width):
    x = keys.astype(U64)[:, None] + np.arange(1, width + 1, dtype=U64) * U64(
        sampler.GOLDEN)
    x = (x ^ (x >> U64(30))) * U64(sampler.MIX1)
    x = (x ^ (x >> U64(27))) * U64(sampler.MIX2)
    x = x ^ (x >> U64(31))
    return ((x >> U64(41)) * U64(2) + U64(1)).astype(np.float64) * 2.0 ** -24


def np_draw(logits, keys, temperature):
    """The numpy reference of ``sampler.draw``."""
    x = logits.astype(np.float32)
    g = (-np.log(-np.log(np_uniforms(keys, x.shape[-1])))).astype(np.float32)
    scores = x * np.float32(1.0 / temperature) + g
    finite = np.isfinite(x.max(axis=-1))
    return np.where(finite, scores.argmax(-1), x.argmax(-1)).astype(np.int32)


def _logits(rows, width, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, width)) * scale).astype(np.float32)


def _draw(logits, keys, temperature):
    return sampler.draw(torch.from_numpy(logits), torch.from_numpy(keys),
                        temperature).numpy()


def test_row_keys_are_splitmix64_of_seed_request_and_step():
    rids = np.array([0, 1, 7, 2 ** 40 + 3, 123456789])
    steps = np.array([0, 5, 2 ** 31, 1, 999])
    got = sampler.row_keys(11, rids, steps)
    assert got.dtype == np.int64
    assert got.tolist() == [_mix64(11, int(r), int(s))
                            for r, s in zip(rids, steps)]
    # a scalar step broadcasts over the rows
    assert sampler.row_keys(11, rids, 5).tolist() == [
        _mix64(11, int(r), 5) for r in rids]


@pytest.mark.parametrize("rows,width", [(64, 16), (32, 512), (4, 50304)])
def test_uniforms_and_noise_are_bitwise_the_numpy_hash(rows, width):
    keys = sampler.row_keys(3, np.arange(rows), 2)
    u = sampler.uniforms(torch.from_numpy(keys), width).numpy()
    want = np_uniforms(keys, width)
    assert u.dtype == np.float64 and np.array_equal(u, want)
    assert u.min() > 0.0 and u.max() < 1.0
    assert np.array_equal(u.astype(np.float32).astype(np.float64), u)
    g = sampler.gumbel(torch.from_numpy(keys), width).numpy()
    assert np.array_equal(g, (-np.log(-np.log(want))).astype(np.float32))


@pytest.mark.parametrize("temperature", [0.7, 1.0, 1.5])
@pytest.mark.parametrize("rows,width", [(256, 16), (64, 512), (4, 50304)])
def test_draw_is_bitwise_the_numpy_reference(rows, width, temperature):
    logits = _logits(rows, width, seed=rows)
    keys = sampler.row_keys(5, np.arange(rows) * 3 + 1, np.arange(rows) % 7)
    got = _draw(logits, keys, temperature)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np_draw(logits, keys, temperature))


def test_a_rows_token_is_the_same_alone_in_a_batch_and_beside_padding():
    """Row 1 of a batch of three, drawn alone and in the batch; then the
    scheduler's full width (8 rows), the rows that do not commit padded
    with the first committing row's (request, step) over stale logits."""
    logits = _logits(3, 512, seed=4)
    keys = sampler.row_keys(2, [9, 5, 1], [4, 4, 6])
    batch = _draw(logits, keys, 0.8)
    alone = _draw(logits[1:2], keys[1:2], 0.8)
    assert alone[0] == batch[1]
    width = 8
    padded_logits = _logits(width, 512, seed=5)
    padded_logits[2:5] = logits
    rids = np.full(width, 9)
    steps = np.full(width, 4)
    rids[2:5], steps[2:5] = [9, 5, 1], [4, 4, 6]
    padded = _draw(padded_logits, sampler.row_keys(2, rids, steps), 0.8)
    np.testing.assert_array_equal(padded[2:5], batch)


def _engine(temperature=0.8, seed=3):
    cfg = dataclasses.replace(reduced_config("olmo-1b"),
                              compute_dtype="float32", vocab_size=256)
    model = build(cfg, device="cpu")
    return Engine(model, model.init(0), ServeConfig(
        max_len=16, temperature=temperature, seed=seed), device="cpu")


@pytest.mark.parametrize("graphed", [True, False], ids=["graph-body", "eager"])
def test_sample_tokens_is_the_draw_of_the_engine_keys(graphed, monkeypatch):
    """``Engine.sample_tokens`` is ``draw`` over the keys of (seed, rid,
    step), through the sampler's graph body (a graph per logits shape) or
    eagerly; it makes no ``torch.Generator``; a row's token is its own."""
    engine = _engine()
    engine._graphed = graphed

    def no_generator(*args, **kw):
        raise AssertionError("sample_tokens made a torch.Generator")
    monkeypatch.setattr(torch, "Generator", no_generator)
    logits = _logits(3, 256, seed=8)
    got = engine.sample_tokens(torch.from_numpy(logits), [9, 5, 1], 4).numpy()
    want = np_draw(logits, sampler.row_keys(3, [9, 5, 1], 4), 0.8)
    np.testing.assert_array_equal(got, want)
    alone = engine.sample_tokens(torch.from_numpy(logits[1:2]), [5], 4)
    assert int(alone[0]) == got[1]
    again = engine.sample_tokens(torch.from_numpy(logits), [9, 5, 1], 4)
    np.testing.assert_array_equal(again.numpy(), got)
    assert len(engine._sample_graphs) == (2 if graphed else 0)
    steps = {int(engine.sample_tokens(torch.from_numpy(logits[1:2]), [5], s)[0])
             for s in range(8)}
    assert len(steps) > 1   # the step enters the stream


def test_greedy_is_the_argmax():
    engine = _engine(temperature=0.0)
    logits = torch.from_numpy(_logits(4, 256, seed=9))
    got = engine.sample_tokens(logits, [0, 1, 2, 3], 0)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.argmax(logits, dim=-1).to(torch.int32))
    assert not engine._sample_graphs


@pytest.mark.parametrize("temperature", [0.7, 1.5])
def test_draws_follow_the_softmax(temperature):
    """20000 draws from one fixed 16-way row, one request each: the
    counts against ``softmax(logits / T)`` by Pearson's chi-square with 15
    degrees of freedom, p > 1e-4 at this fixed seed."""
    n = 20000
    row = np.random.default_rng(12).standard_normal(16).astype(np.float32)
    logits = np.broadcast_to(row, (n, 16)).copy()
    keys = sampler.row_keys(7, np.arange(n), 0)
    counts = np.bincount(_draw(logits, keys, temperature), minlength=16)
    z = row.astype(np.float64) / temperature
    p = np.exp(z - z.max())
    p /= p.sum()
    stat, pval = stats.chisquare(counts, n * p)
    assert pval > 1e-4, (stat, pval, counts.tolist())


def test_a_nonfinite_row_takes_its_argmax():
    """A NaN, a +Inf or every logit -Inf: the row's argmax (the first NaN
    for a NaN row); a -Inf logit in a finite row is never drawn."""
    logits = _logits(5, 64, seed=10)
    logits[0, 17] = np.nan
    logits[1, 40] = np.inf
    logits[2, :] = -np.inf
    logits[3, :60] = -np.inf
    keys = sampler.row_keys(1, np.arange(5), 3)
    got = _draw(logits, keys, 0.9)
    t = torch.from_numpy(logits)
    assert got[0] == 17 and got[1] == 40
    assert got[2] == int(torch.argmax(t[2]))
    assert 60 <= got[3] < 64
    np.testing.assert_array_equal(got, np_draw(logits, keys, 0.9))
    # many draws of row 3 never land on a -Inf logit
    many = np.broadcast_to(logits[3], (2000, 64)).copy()
    draws = _draw(many, sampler.row_keys(1, np.arange(2000), 3), 0.9)
    assert draws.min() >= 60


def test_ties_go_to_the_first_maximal_index_at_the_served_width():
    """``torch.argmax`` and numpy's take the first of equal maxima, at
    olmo-1b's vocabulary (50304)."""
    x = np.zeros((6, 50304), np.float32)
    firsts = [0, 1, 4097, 25000, 50302, 50303]
    for r, c in enumerate(firsts):
        x[r, c:] = 1.0 if r % 2 else 0.0
        x[r, c] = x[r, -1] = 2.0
    got = torch.argmax(torch.from_numpy(x), dim=-1).tolist()
    assert got == firsts == x.argmax(-1).tolist()
