"""``python -m photon_tpu_torch.analysis``: the photon-lint entry point."""

import sys

from photon_tpu_torch.analysis.cli import main

sys.exit(main())
