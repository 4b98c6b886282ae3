"""The distributed runtime's worker side that one process needs:
graceful preemption (``preemption``). The rest of the reference's
``paddle_tpu/distributed/`` (launch, the coordination service, the
parameter-server tier) waits for ROADMAP queue 1 item 8."""

from . import preemption  # noqa: F401
