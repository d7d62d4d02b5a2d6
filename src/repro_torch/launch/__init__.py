"""Launch helpers of the port (``repro.launch`` in the reference).  Only
the train step is ported (`steps`); the mesh, the dry run and the HLO
statistics wait for ROADMAP A15."""
