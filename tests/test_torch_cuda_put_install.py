"""The put's install on the card's host: a 128 MiB put at S = 2^20 (one
window of 8 stripes of the [16, 8] code) shares its share checks out over
the store's pool while the put waits at the pipeline's closing barrier.

Marked `cuda`, skipped on hosts without a card, and free of JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_put_install.py
"""
import numpy as np
import pytest
from _torch_parity import cuda  # noqa: F401 (fixture)

from repro_torch.core.circulant import CodeSpec

pytestmark = pytest.mark.cuda


def test_put_installs_its_window_on_several_threads(cuda):
    """``t_install / t_barrier`` above 1.5: the threads of
    `Pipeline.fan_out` check the window's 128 shares side by side, and
    every stored derived block is a view of the window's encode result."""
    from repro_torch.store import CodedObjectStore
    s = 1 << 20
    store = CodedObjectStore(CodeSpec.make(8, 257), n_nodes=20,
                             stripe_symbols=s, io_workers=4,
                             pipeline_depth=2)
    payload = np.random.default_rng(0).integers(
        0, 256, 8 * 16 * s, np.uint8).tobytes()      # 128 MiB, 8 stripes
    with store:
        store.put("a", payload)                      # warms the encode
        store.pipeline.reset_stage_stats()
        store.put("a", payload)
        st = store.pipeline.stage_stats()
        assert store._fan_out_helpers() == 3
        share = next(iter(store._shares[0].values()))
        assert all(b.flags.c_contiguous and b.shape == (s,)
                   for b in share[1:])
        assert store.get("a") == payload
    assert st["t_install"] >= st["t_crc"] > 0.0
    assert st["t_install"] / st["t_barrier"] > 1.5, st
