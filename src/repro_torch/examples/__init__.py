"""Twins of the reference's examples (``examples/``), run as modules:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.store_demo [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]

Each takes its reference's flags and defaults plus ``--device`` (default:
the card), prints its reference's lines and asserts its invariants.  The
fourth example, ``train_tiny_lm``, is ``repro_torch.train.tiny_lm``."""
