"""``python -m racon_tpu_torch.serve SOCK [racon options]``: the resident
polishing service, as ``racon --serve SOCK [options]`` (the options set the
server's engine profile: -m/-x/-g/-b, -t, -c, --cudaaligner-batches,
--device, --workers, --serve-budget; ``--serve-dir D`` makes it crash-safe:
the durable job journal, the result spool, restart recovery)."""

import sys

from ..cli import main

sys.exit(main(["--serve"] + sys.argv[1:]))
