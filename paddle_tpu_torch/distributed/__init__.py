"""The distributed runtime a serving fleet on one host needs: graceful
preemption (``preemption``), the framed-TCP transport (``wire``) and the
coordination service (``coordination``: leases, the KV, the WAL). The
rest of the reference's ``paddle_tpu/distributed/`` (launch, the
parameter-server tier, cross-host rendezvous) waits for ROADMAP queue 1
item 8."""

from . import coordination, preemption, wire  # noqa: F401
from .coordination import CoordClient, CoordServer  # noqa: F401
