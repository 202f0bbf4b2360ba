"""Training example of the PyTorch/CUDA port, on the card.

  PYTHONPATH=src python3 examples/torch_train_lm.py                    # tiny, 200 steps
  PYTHONPATH=src python3 examples/torch_train_lm.py --preset 100m      # the ~100M run
  PYTHONPATH=src python3 examples/torch_train_lm.py --arch mixtral-8x22b
  PYTHONPATH=src python3 examples/torch_train_lm.py --device cpu --steps 20

A thin wrapper over ``repro_torch.launch.train.main``: deterministic Markov
data (the loss really falls), checkpoints and auto-resume, the straggler
monitor; on the card the step is a captured CUDA graph over the kernels.
It adds the reference example's defaults, ``--steps 200`` and a checkpoint
directory of its own, ``repro_torch_train_ckpt`` under the temporary
directory (``$TMPDIR``, else ``/tmp``). Stop it mid-run and start it again
with the same ``--ckpt-dir`` to watch it resume.
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch import train
from repro_torch.models.model_registry import cli_device


def with_defaults(argv) -> list:
    """``argv`` with ``--steps 200`` and the example's checkpoint directory
    where it names neither."""
    argv = list(argv)
    if not any(a.startswith("--steps") for a in argv):
        argv += ["--steps", "200"]
    if not any(a.startswith("--ckpt-dir") for a in argv):
        argv += ["--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                            "repro_torch_train_ckpt")]
    return argv


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    cli_device(ap.parse_known_args(argv)[0].device, "torch_train_lm")
    return train.main(with_defaults(argv))


if __name__ == "__main__":
    sys.exit(main())
