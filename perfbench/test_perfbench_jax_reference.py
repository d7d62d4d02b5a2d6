"""The benchmark's frozen references (``reference.py`` and
``reference_pm.py``, plain torch) against the JAX package's encode and
regeneration at a small size: the yardstick rests on the reference of
record; and the JAX package's
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

from perfbench import reference, reference_pm  # noqa: E402

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


@pytest.mark.parametrize("n,k,d,g", [(16, 8, 14, tuple(range(1, 17))),
                                     (8, 4, 7, tuple(range(1, 10)))])
def test_product_matrix_reference_equals_the_jax_package(n, k, d, g):
    """At (16, 8, 14) and at the shortened (8, 4, 7) (one virtual
    node): every share of the encode, and each node rebuilt from three
    helper sets (the one set there is where d = n - 1)."""
    from repro.codes import CodeClass, make_code
    code = make_code(CodeClass("product-matrix", n, k, d, 257))
    assert tuple(int(x) for x in code.gens) == g
    ref = reference_pm.make(n, k, d, 257, g)
    rng = np.random.default_rng(2)
    data = rng.integers(0, 257, (ref.data_blocks, 333), dtype=np.int32)
    shares = np.asarray(code.encode_shares(data))
    got = reference_pm.encode(ref, torch.from_numpy(data))
    assert np.array_equal(got.numpy(), shares)
    for node in range(1, n + 1):
        rest = [j for j in range(1, n + 1) if j != node]
        for hs in {tuple(rest[:d]), tuple(rest[-d:]),
                   reference_pm.helpers(ref, node)}:
            hs = tuple(sorted(hs))
            plan = code.repair_plan(node, available=hs)
            assert tuple(plan.helpers) == hs
            sends = np.stack([code.helper_send(sm, shares[h - 1])
                              for sm, h in zip(plan.send_matrices, hs)])
            ref_sends = torch.stack([
                reference_pm.send(ref, node, torch.from_numpy(shares[h - 1]))
                for h in hs])
            assert np.array_equal(ref_sends.numpy(), sends)
            want = np.asarray(code.regenerate(plan, sends))
            rebuilt = reference_pm.regenerate(ref, node, hs, ref_sends)
            assert np.array_equal(rebuilt.numpy(), want)
            assert np.array_equal(want, shares[node - 1])


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
