"""The benchmark's frozen reference (``reference.py``, plain torch)
against the JAX package's encode and regeneration at a small size: the
yardstick rests on the reference of record; and the JAX package's
placement passes the check's rule for where shares may live.  The only file
under perfbench/ that imports the JAX package; nothing a run executes
imports this one."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import placement as jplacement  # noqa: E402
from repro.core.circulant import CodeSpec  # noqa: E402
from repro.core.msr import DoubleCirculantMSR  # noqa: E402

from perfbench import reference  # noqa: E402

C = [195, 101, 85, 228, 68, 59, 183, 160]


def test_reference_equals_the_jax_package():
    spec = CodeSpec.make(8, 257, c=C)
    code = DoubleCirculantMSR(spec)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 257, (16, 777), dtype=np.int32)
    red = np.array(code.encode(data))
    got = reference.encode(torch.from_numpy(data), C, 257).numpy()
    assert np.array_equal(got, red)
    for node in range(1, 17):
        prev, nxt = reference.helpers(node, 16)
        plan = code.repair_plan(node)
        assert (prev, nxt) == (plan.prev_node, tuple(plan.next_nodes))
        helpers = data[[x - 1 for x in nxt]]
        ja, jr = code.regenerate(node, red[prev - 1], helpers)
        a, r = reference.regenerate(node, torch.from_numpy(red[prev - 1]),
                                    torch.from_numpy(helpers), C, 257)
        assert np.array_equal(a.numpy(), np.asarray(ja))
        assert np.array_equal(r.numpy(), np.asarray(jr))


def test_placement_equals_the_jax_package():
    """The port's store places a stripe where the JAX package does, and
    that placement passes the check's rule (n distinct nodes)."""
    from repro_torch.core.circulant import CodeSpec as TorchSpec
    from repro_torch.store import CodedObjectStore

    from perfbench import verify
    layout = jplacement.rack_layout(20, 2)
    store = CodedObjectStore(TorchSpec.make(8, 257, c=C), n_nodes=20,
                             n_racks=2, stripe_symbols=16, device="cpu")
    try:
        store.put("a", bytes(range(256)) * 200)       # 200 stripes
        for t in range(0, 200, 7):
            want = jplacement.rotate_placement(layout, 16, t)
            assert store.placement_of("a", t) == tuple(want)
            assert verify.placement_ok(want, 16, 20)
    finally:
        store.close()
