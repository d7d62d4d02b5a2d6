"""Port parity — the ring encode and the int8 ring mean (mirrors
tests/test_distributed_ring.py's single-controller half).

``ring_encode`` runs on a storage mesh of n CPU devices (``["cpu"] * n``:
torch lets a device repeat) and is held bit for bit to the reference's
oracle ``ring_encode_reference`` (``DoubleCirculantMSR.encode``) on both
wires.  ``int8_ring_mean`` is held to a composition of the reference's
own ``quantize`` / ``dequantize`` run hop by hop here, because the
reference's shard_map version fails on the installed jax.  Tolerance:
exact (0) — every step is the same IEEE float32 elementwise op in both
packages, in the same order; and within 10 x the int8 scale of the true
mean, the reference test's bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import rand

from repro.core import ring as rring
from repro.core.circulant import CodeSpec as RSpec
from repro.optim import compression as rcomp
from repro_torch.core import ring as tring
from repro_torch.core.circulant import CodeSpec
from repro_torch.launch.mesh import make_host_mesh, make_storage_mesh
from repro_torch.optim import compression as tcomp

P = 257


def storage_mesh(n):
    return make_storage_mesh(n, devices=["cpu"] * n)


@pytest.mark.parametrize("byte_wire", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_ring_encode_matches_reference_oracle(k, byte_wire):
    spec, rspec = CodeSpec.make(k, P), RSpec.make(k, P)
    s = 257 + 2 * k                             # odd stream lengths
    data = rand((spec.n, s), 256, k)            # raw bytes: byte wire valid
    want = np.asarray(rring.ring_encode_reference(jnp.asarray(data), rspec))
    traffic = tring.LinkTraffic()
    got = tring.ring_encode(data, spec, storage_mesh(spec.n),
                            byte_wire=byte_wire, traffic=traffic)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tring.ring_encode_reference(data, spec, device="cpu").numpy(), want)
    links = {(j, (j - 1) % spec.n) for j in range(spec.n)}   # j -> j-1
    assert set(traffic.blocks) == links
    assert set(traffic.blocks.values()) == {
        tring.ring_link_traffic_blocks(spec)}
    assert set(traffic.bytes.values()) == {k * s * (1 if byte_wire else 4)}


def test_ring_encode_wire_default_and_tensor_input():
    spec = CodeSpec.make(2, 251)                # p <= 256: byte wire
    data = rand((4, 99), 251, 7)
    traffic = tring.LinkTraffic()
    got = tring.ring_encode(torch.from_numpy(data).long(), spec,
                            storage_mesh(4), traffic=traffic)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(rring.ring_encode_reference(
            jnp.asarray(data), RSpec.make(2, 251))))
    assert set(traffic.bytes.values()) == {2 * 99}


def test_ring_encode_axis_size_and_traffic_blocks():
    spec = CodeSpec.make(3, P)
    with pytest.raises(ValueError, match="storage"):
        tring.ring_encode(rand((6, 8), P, 0), spec, storage_mesh(4))
    with pytest.raises(ValueError, match="no axis"):
        tring.ring_encode(rand((6, 8), P, 0), spec, storage_mesh(6),
                          axis="data")
    for k in (1, 2, 3, 8):
        assert tring.ring_link_traffic_blocks(CodeSpec.make(k, P)) == \
            rring.ring_link_traffic_blocks(RSpec.make(k, P))


def ring_mean_reference(x: np.ndarray) -> np.ndarray:
    """int8_ring_mean's algebra with the reference's quantize/dequantize,
    hop by hop: reduce-scatter (re-quantized each hop), then the int8
    all-gather, every row the gathered mean."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    pad = (-size) % n
    chunks = [jnp.pad(jnp.asarray(flat[i]), (0, pad)).reshape(n, -1)
              for i in range(n)]
    accs = [chunks[i][i] for i in range(n)]
    for t in range(n - 1):
        wire = [rcomp.quantize(a) for a in accs]       # sent j -> j+1
        accs = [rcomp.dequantize(*wire[(i - 1) % n])
                + chunks[i][(i - t - 1) % n] for i in range(n)]
    done = [rcomp.quantize(a / n) for a in accs]
    order = [(c - 1) % n for c in range(n)]
    q = jnp.stack([done[j][0] for j in order])
    s = jnp.stack([done[j][1] for j in order])
    full = np.asarray(rcomp.dequantize(q, s[:, None])).reshape(-1)[:size]
    return np.broadcast_to(full.reshape(x.shape[1:]), x.shape)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_int8_ring_mean_matches_hop_by_hop_reference(n):
    rng = np.random.default_rng(n)
    for shape in ((n, 37, 13), (n, 5)):         # 481 and 5: padded chunks
        x = rng.standard_normal(shape).astype(np.float32)
        mesh = make_host_mesh(devices=["cpu"] * n)
        got = tcomp.int8_ring_mean(torch.from_numpy(x), mesh, "data")
        assert got.dtype == torch.float32 and got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), ring_mean_reference(x))
        scale = np.abs(x).max() / 127.0
        assert np.abs(got.numpy() - x.mean(0)).max() <= 10 * scale


def test_int8_ring_mean_rejects_wrong_leading_dim():
    mesh = make_host_mesh(devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="leading dim"):
        tcomp.int8_ring_mean(torch.zeros(3, 8), mesh, "data")
