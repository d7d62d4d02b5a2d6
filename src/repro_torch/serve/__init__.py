"""Serving layer of the port (``repro.serve`` in the reference).

* `frontend.ReadFrontEnd` — the robust store-serving front end:
  deadlines + hedged reads, end-to-end share CRCs with corrupt-share
  quarantine, and a bounded admission queue with typed ``Overloaded``
  shedding;
* `engine.CodedReadServer` — degraded-read block serving over the
  cluster simulator (imported from `repro_torch.serve.engine` directly,
  as in the reference).  The reference's ``ServingEngine`` needs the
  model stack and is not ported yet.
"""
from .frontend import (FrontEndMetrics, NodeHealth, Overloaded,
                       ReadFrontEnd, ReadReceipt, ReadTicket)

__all__ = ["ReadFrontEnd", "ReadTicket", "ReadReceipt", "NodeHealth",
           "FrontEndMetrics", "Overloaded"]
