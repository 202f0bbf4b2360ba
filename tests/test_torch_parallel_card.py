"""The multi-device layer without JAX: on the CPU the properties that need
no reference (``shard`` adds nothing without a mesh, the placements of a
spec, the meshes a process without a group gets, one source for the card's
figures, the dry run's report), and on the card (``cuda``) the
sequence-parallel decode collective under a one-rank NCCL group, in a
process of its own, at olmo-1b's decode width.

On the card: ``PYTHONPATH=src python3 -m pytest -q -m cuda
tests/test_torch_parallel_card.py``."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import paper_gemm, reduced_config
from repro_torch.core import planner
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import build
from repro_torch.parallel import mesh as pm
from repro_torch.roofline import hw, report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("active", [None, pm.AbstractMesh((16, 16),
                                                          ("data", "model"))])
def test_shard_returns_its_input_without_a_device_mesh(active):
    x = torch.randn(4, 8, 16)
    with pm.use_mesh(active):
        assert pm.shard(x, "batch", "seq") is x
        assert pm.shard(x, "batch", None, "model") is x
        assert pm.settle(x) is x


def test_served_and_trained_paths_are_the_same_program_under_an_abstract_mesh():
    """Resolving specs under an abstract mesh changes no op: the prefill's
    logits and caches and the train forward are bitwise those with no
    mesh."""
    cfg = reduced_config("olmo-1b")
    model = build(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens}
    plain = model.prefill(params, batch, max_len=16)
    fwd, _ = model.forward(params, batch, remat=False)
    with pm.use_mesh(pm.AbstractMesh((2, 16, 16), ("pod", "data", "model"))):
        meshed = model.prefill(params, batch, max_len=16)
        fwd2, _ = model.forward(params, batch, remat=False)
    assert torch.equal(plain[0], meshed[0])
    for a, b in zip(plain[1], meshed[1]):
        assert torch.equal(a["kv"]["k"], b["kv"]["k"])
    assert torch.equal(fwd, fwd2)


def test_spec_placements_are_pod_major():
    from torch.distributed.tensor import Replicate, Shard
    mesh = pm.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert pm.spec_placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert pm.spec_placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        pm.spec_placements((("data", "pod"),), mesh)


def test_meshes_without_a_group():
    assert make_host_mesh(1) == pm.AbstractMesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError):
        make_host_mesh(2)
    assert make_production_mesh() == pm.AbstractMesh((16, 16),
                                                      ("data", "model"))
    multi = make_production_mesh(multi_pod=True)
    assert multi.size == 512 and multi.axis_names == ("pod", "data", "model")


def test_named_sharding_check_refuses_what_a_leaf_cannot_take():
    from torch.distributed.tensor import Replicate, Shard
    mesh = pm.AbstractMesh((2, 4), ("data", "model"))
    pm.NamedSharding(mesh, (Shard(0), Shard(1))).check((8, 8))
    with pytest.raises(ValueError, match="split"):
        pm.NamedSharding(mesh, (Shard(0), Shard(0))).check((4, 8))
    with pytest.raises(ValueError, match="placements"):
        pm.NamedSharding(mesh, (Replicate(),)).check((4, 8))
    with pytest.raises(ValueError, match="shape"):
        pm.NamedSharding(mesh, (Shard(2), Replicate())).check((4, 8))


def test_the_card_has_one_source():
    assert planner.H100 is hw.H100 and planner.HopperTarget is hw.HopperTarget
    assert hw.peak_flops("bfloat16") == hw.peak_flops("float16") == 989e12
    assert hw.peak_flops("float32") == 67e12
    assert hw.peak_flops("int8") == 1979e12
    assert hw.H100.nvlink_bw == 450e9 and hw.H100.nic_bw == 50e9
    sys.path.insert(0, REPO)
    import chip_smoke
    assert chip_smoke.H100_BF16_FLOPS == 989e12
    assert chip_smoke.H100_HBM_BYTES == 3.35e12
    assert chip_smoke.H100_F32_FLOPS == 67e12
    assert chip_smoke.SWEEP_SIZES == (paper_gemm.SMALL_SIZES
                                      + paper_gemm.MEDIUM_SIZES
                                      + paper_gemm.LARGE_SIZES)
    assert chip_smoke.gemm_bound_ms(4, 2048, 2048, 4 * 2048 * 2, 2048 * 2048 * 2,
                                    2, 989e12)[1] == "bytes"


def test_report_renders_ok_and_failed_cells(tmp_path):
    import json
    ok = {"arch": "a", "shape": "train_4k", "mesh": "single", "tag": "",
          "status": "ok", "chips": 256, "run_s": 12.0, "fits_hbm": True,
          "memory": {"argument_bytes": 2**30, "peak_per_device": 3 * 2**30},
          "roofline": {"compute_s": 1.0, "memory_s": 0.5,
                       "collective_s": 0.25, "collective_bytes_nvlink": 0.0,
                       "collective_bytes_per_device": 1e9,
                       "bottleneck": "compute", "model_flops": 1e18,
                       "useful_flops_ratio": 0.8, "roofline_fraction": 1.0}}
    bad = {"arch": "b", "shape": "decode_32k", "mesh": "multi", "tag": "",
           "status": "failed", "op": "aten.index_put.default", "error": "x"}
    for name, d in (("a.json", ok), ("b.json", bad)):
        with open(tmp_path / name, "w") as f:
            json.dump(d, f)
    rows = report.load(str(tmp_path))
    table = report.dryrun_table(rows)
    assert "| a | train_4k | single | 256 | ok | 12 | 1.00 | 3.00 | yes |" in table
    assert "FAILED: aten.index_put.default" in table
    assert "**compute**" in report.roofline_table(rows, "single")
    assert report.bottleneck_summary(rows, "single") == {"compute": 1}
    assert report.worst_cells(rows, "single")[0][0]["arch"] == "a"


# -- on the card ---------------------------------------------------------------

SP_CARD_SCRIPT = textwrap.dedent("""
    import os, socket
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.parallel import collectives as coll
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1)
    mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("model",))
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, h, d, s = 4, 16, 128, 2048
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for window, invalid in ((None, 0), (1024, 300), (None, 2048)):
            q = torch.randn((b, h, d), generator=gen, device="cuda").to(dt)
            k = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
            v = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
            kpos = torch.arange(s, device="cuda")[None].repeat(b, 1)
            kpos[:, :invalid] = -1
            qpos = torch.full((b,), s - 1, device="cuda")
            got = coll.sp_decode_attention(q, k, v, kpos, qpos, mesh=mesh,
                                           window=window)
            want = coll.ref_decode_attention(q, k, v, kpos, qpos, window)
            err = float((got.float() - want.float()).abs().max())
            assert got.dtype == dt and err <= tol, (dt, window, invalid, err)
            if invalid == s:   # every slot masked: the row divides by 1
                assert float(got.float().abs().max()) == 0.0
    del mesh   # the mesh holds the group: let it end inside destroy
    dist.destroy_process_group()
    print("sp decode on the card OK")
""")


@pytest.mark.cuda
def test_cuda_sp_decode_under_a_one_rank_nccl_group():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", SP_CARD_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "sp decode on the card OK" in out.stdout
