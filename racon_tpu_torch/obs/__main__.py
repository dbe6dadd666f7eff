"""``python -m racon_tpu_torch.obs check FILE``: validate a run report."""

import sys

from .report import main

sys.exit(main(sys.argv[1:]))
