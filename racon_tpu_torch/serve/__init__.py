"""racon_tpu_torch.serve: the resident polishing service (the port of
``racon_tpu/serve``).

A long-lived server process (``racon --serve SOCK`` / ``python -m
racon_tpu_torch.serve SOCK``) keeps a pool of engine pairs on the card and
runs submitted polish jobs through :meth:`Polisher.run` with a slot's
engines injected. Jobs arrive over a newline-JSON unix-socket protocol
(:mod:`.protocol`), pass admission on the exec planner's cost model, walk
the degradation ladder on faults, and return their polished FASTA
byte-identical to a one-shot CLI run with a run report of kind ``job``
(:mod:`.service`); ``--serve-dir`` journals them durably (:mod:`.journal`).
The client (``racon --submit SOCK ...``, :mod:`.client`) streams the FASTA
to stdout as the one-shot CLI would print it.
"""

from .client import ServiceClient, submit_and_stream  # noqa: F401
from .service import PolishServer  # noqa: F401
