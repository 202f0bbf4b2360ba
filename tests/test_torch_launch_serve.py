"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU:

  * ``main([..., "--device", "cpu"])`` at the ``tiny`` preset for olmo-1b,
    an MoE (mixtral-8x22b), a VLM (paligemma-3b, patch embeddings) and an
    encoder-decoder (whisper-base, audio frame embeddings): the
    reference's printed lines, tokens in the vocabulary, and a health
    report that stays empty, printed after them; a degradation is printed
    there, and on the card a report that is not empty fails the run;
  * the port's version of the reference's train -> checkpoint -> serve
    lifecycle (``tests/test_system.py``), through the two launchers: the
    loss falls, and the served tokens equal those of an ``Engine`` built
    on ``checkpoint.restore``'s params;
  * the JAX package's ``tiny`` checkpoint served through the port's
    launcher gives the reference engine's greedy tokens (f32).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch.train import preset_config as ref_preset_config
from repro.models import build as ref_build
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.train import checkpoint as rckpt
from repro_torch.core import health
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build
from repro_torch.serve import Engine, ServeConfig
from repro_torch.testing import faults
from repro_torch.train import checkpoint as ckpt

SERVE = ["--requests", "2", "--prompt-len", "8", "--new", "4",
         "--device", "cpu"]


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    for var in ("REPRO_TORCH_GEMM_STRATEGY", faults.ENV_FAULT,
                health.ENV_NUMERICS_GUARD):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    health.clear_health()
    yield
    health.clear_health()


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x22b", "paligemma-3b",
                                  "whisper-base"])
def test_launcher_serves_each_family(arch, capsys):
    assert launch_serve.main(["--arch", arch] + SERVE) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == (f"arch={arch}-reduced-tiny requests=2 prompt=8 "
                        f"new=4")
    assert lines[1].startswith("steady-state: ") and \
        lines[1].endswith(" ms/decode-step)")
    first = json.loads(lines[2].removeprefix("first request: "))
    vocab = launch_train.preset_config(arch, "tiny").vocab_size
    assert len(first) == 4 and all(0 <= t < vocab for t in first)
    assert lines[3] == "health: no degradation"
    assert health.health_report() == {}


def test_launcher_prints_the_health_report(capsys, monkeypatch):
    """A degradation on the CPU is printed after the reference's lines and
    the run completes; on the card a report that is not empty fails the
    run (exit code 1)."""
    with faults.inject("kernel_run", nth=1):
        assert launch_serve.main(SERVE) == 0
    line = capsys.readouterr().out.splitlines()[3]
    report = json.loads(line.removeprefix("health: "))
    entry, = report.values()
    assert entry["cause"] == "runtime" and entry["count"] == 1
    for on_card, report, code in ((True, {"x": {}}, 1), (True, {}, 0),
                                  (False, {"x": {}}, 0)):
        monkeypatch.setattr(launch_serve, "run", lambda argv, on_card=on_card,
                            report=report: {"on_card": on_card,
                                            "health": report})
        assert launch_serve.main([]) == code


def test_launcher_batches_carry_patches_and_frames():
    """A VLM's batch carries patch embeddings, an encoder-decoder's frame
    embeddings, drawn after the prompts from the same generator as the
    reference's launcher draws them."""
    for arch, key, width in (("paligemma-3b", "patches", "num_patches"),
                             ("whisper-base", "frames", "encoder_seq")):
        cfg = launch_train.preset_config(arch, "tiny")
        batch = launch_serve.request_batch(cfg, 3, 5)
        rng = np.random.default_rng(0)
        np.testing.assert_array_equal(
            batch["tokens"], rng.integers(0, cfg.vocab_size, (3, 5)))
        assert batch[key].shape == (3, getattr(cfg, width), cfg.d_model)
        np.testing.assert_array_equal(
            batch[key], rng.normal(size=batch[key].shape).astype(np.float32))
    assert set(launch_serve.request_batch(
        launch_train.preset_config("olmo-1b", "tiny"), 1, 2)) == {"tokens"}


def test_launcher_lifecycle_train_checkpoint_serve(tmp_path, capsys):
    """Train through the training launcher, checkpoint, restore and serve
    through the serving launcher: the loss falls, and the launcher's
    greedy tokens are those of an Engine on the restored params."""
    ckpt_dir, metrics = str(tmp_path / "ckpt"), tmp_path / "metrics.json"
    assert launch_train.main([
        "--preset", "tiny", "--steps", "12", "--batch", "4", "--seq", "32",
        "--lr", "3e-3", "--ckpt-dir", ckpt_dir, "--log-every", "1",
        "--metrics-out", str(metrics), "--device", "cpu"]) == 0
    history = json.loads(metrics.read_text())
    assert history[-1]["loss"] < history[0]["loss"]
    capsys.readouterr()
    res = launch_serve.run(["--preset", "tiny", "--ckpt-dir", ckpt_dir]
                           + SERVE)
    assert "loaded checkpoint step 12" in capsys.readouterr().out

    cfg = launch_train.preset_config("olmo-1b", "tiny")
    model = build(cfg, device="cpu")
    restored, step = ckpt.restore(ckpt_dir, {"params": model.init(1)})
    assert step == 12
    engine = Engine(model, restored["params"], ServeConfig(max_len=20),
                    device="cpu")
    want = engine.generate(launch_serve.request_batch(cfg, 2, 8), 4)
    np.testing.assert_array_equal(res["tokens"], want)
    assert health.health_report() == {}


@pytest.mark.parametrize("arch", ["olmo-1b", "paligemma-3b"])
def test_reference_checkpoint_through_the_port_launcher(tmp_path, arch):
    """The JAX package's tiny params, saved by its checkpoint module, served
    by the port's launcher: the reference engine's greedy tokens on the
    same batch."""
    rcfg = ref_preset_config(arch, "tiny")
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(3))
    rckpt.save(str(tmp_path), 5, {"params": rparams})
    res = launch_serve.run(["--arch", arch, "--ckpt-dir", str(tmp_path)]
                           + SERVE)
    batch = launch_serve.request_batch(res["cfg"], 2, 8)
    ref_engine = RefEngine(rmodel, rparams, RefServeConfig(max_len=20))
    want = np.asarray(ref_engine.generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, max_new_tokens=4))
    np.testing.assert_array_equal(res["tokens"], want)
