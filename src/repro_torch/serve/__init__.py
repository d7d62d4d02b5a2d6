"""Serving layer of the port (``repro.serve`` in the reference).

* `frontend.ReadFrontEnd` — the robust store-serving front end:
  deadlines + hedged reads, end-to-end share CRCs with corrupt-share
  quarantine, and a bounded admission queue with typed ``Overloaded``
  shedding;
* `engine.CodedReadServer` / `engine.ServingEngine` — degraded-read
  block serving over the cluster simulator and the batched LLM inference
  engine it can feed (imported from `repro_torch.serve.engine` directly,
  as in the reference, so importing the front end does not pull the
  model stack).
"""
from .frontend import (FrontEndMetrics, NodeHealth, Overloaded,
                       ReadFrontEnd, ReadReceipt, ReadTicket)

__all__ = ["ReadFrontEnd", "ReadTicket", "ReadReceipt", "NodeHealth",
           "FrontEndMetrics", "Overloaded"]
