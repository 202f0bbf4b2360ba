"""Quickstart of the PyTorch/CUDA port: the layered GEMM as a declarative
library call, on the card.

  PYTHONPATH=src python3 examples/torch_quickstart.py                 # on the card
  PYTHONPATH=src python3 examples/torch_quickstart.py --device cpu    # plain versions

Walks the port's public API (``repro_torch.core``): planner ->
ContractionSpec / EpilogueSpec + dispatch -> LayeredGemm -> PackedWeight.
A contraction is declared once (a frozen spec) and the registry chooses
its lowering: explicit > env > auto. On the card every named strategy
launches its hand-written kernel (K1, K5-K8); on the CPU the same calls
run the kernels' plain torch versions. Each section prints its error
against ``kernels.ref.matmul_ref`` beside the gate it must meet, as
``max|err| = E (gate G)``; the exit code is 1 if any error is over it.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.core import (ContractionSpec, EPILOGUE_SPECS, LayeredGemm,
                              PackedWeight, contract, dispatch, lowerings_for,
                              plan_gemm, should_pack)
from repro_torch.core.epilogue import apply_epilogue
from repro_torch.kernels import ref
from repro_torch.models.model_registry import cli_device

# f32 products summed in other orders: the error gate is this fraction of
# the largest |output| (with TF32 off, as torch's default is).
REL_GATE = 1e-4


def report(label: str, got: torch.Tensor, want: torch.Tensor) -> bool:
    """Print ``label``'s max |got - want| beside its gate; returns whether
    the error is within it."""
    want32 = want.to(torch.float32)
    err = float((got.to(torch.float32) - want32).abs().max())
    gate = REL_GATE * max(float(want32.abs().max()), 1.0)
    print(f"  {label:34s} max|err| = {err:.2e} (gate {gate:.2e})")
    return err <= gate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = cli_device(args.device, "torch_quickstart")
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(0)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    print(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}")
    # The reference also prints its accumulator grid (vaccs x haccs), a TPU
    # matrix-unit count with no Hopper counterpart; the shared-memory
    # working set stands in place of its VMEM.
    print("== 1. The planner (paper Eq. 1-7 on the H100's memory hierarchy) ==")
    for (m, k, n) in [(16, 16, 16), (512, 512, 512), (4096, 4096, 4096)]:
        plan = plan_gemm(m, k, n, "float32")
        print(f"  {m:5d}^3: blocks (bm={plan.bm:4d}, bk={plan.bk:5d}, "
              f"bn={plan.bn:4d})  smem={plan.smem_working_set() / 2**10:6.1f}"
              f"KiB  pack={'yes' if should_pack(m, k, n, 'float32') else 'no'}")

    print("\n== 2. Declare once, dispatch anywhere ==")
    a, b = tensor(96, 160), tensor(160, 224)
    want = ref.matmul_ref(a, b)
    spec = ContractionSpec.dense(96, 160, 224, "float32", accum="f32")
    names = sorted(low.name for low in lowerings_for(spec))
    print(f"  spec: {spec.describe()}")
    print(f"  capable lowerings: {', '.join(names)}")
    print(f"  auto dispatch picks: {dispatch(spec, on_card=on_card).name}")
    ok = all([report(s, contract(spec, a, b, strategy=s), want)
              for s in names])

    print("\n== 3. EpilogueSpec: the declared store chain ==")
    bias = tensor(224)
    fused = ContractionSpec.dense(96, 160, 224, "float32",
                                  epilogue=EPILOGUE_SPECS["bias_gelu"],
                                  accum="f32")
    y = contract(fused, a, b, bias=bias, strategy="tiling_packing_fused")
    print(f"  {fused.describe()}")
    print(f"  chain steps = {fused.epilogue.steps}, out = {tuple(y.shape)}")
    ok &= report("bias_gelu", y, apply_epilogue("gelu", want + bias))

    print("\n== 4. LayeredGemm module (plan once, run many) ==")
    lg = LayeredGemm(96, 160, 224, epilogue="relu")
    out = lg(a, b)
    print(f"  strategy={lg.strategy}  out={tuple(out.shape)}  "
          f"(relu epilogue fused: min={float(out.min()):.1f})")
    ok &= report(f"LayeredGemm {lg.strategy}", out,
                 apply_epilogue("relu", want))

    print("\n== 5. PackedWeight: load-time packing for serving ==")
    w, x = tensor(160, 96), tensor(8, 160)
    pw = PackedWeight.pack(w)
    pspec = ContractionSpec.dense(8, 160, 96, "float32", w=pw)
    print(f"  packed spec: {pspec.describe()}")
    print(f"  dispatch picks: {dispatch(pspec, on_card=on_card).name} (the "
          f"only lowering whose supports() covers packed weights)")
    y = contract(pspec, x, pw)
    print(f"  packed buffer {tuple(pw.packed.shape)} (tile-major), "
          f"y={tuple(y.shape)}")
    ok &= report("PackedWeight", y, ref.matmul_ref(x, w))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
