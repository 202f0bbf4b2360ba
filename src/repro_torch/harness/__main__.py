"""``python -m repro_torch.harness``: the harness CLI (``cli.main``)."""
import sys

from repro_torch.harness.cli import main

sys.exit(main())
