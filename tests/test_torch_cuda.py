"""The port on the card: the Hopper kernels against their plain torch
versions, the planner's pinned staging, and the slice end to end.

Every test here is marked `cuda` and skips on hosts without a card.  The
file imports nothing of JAX, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The plain versions it compares against are the ones the CPU parity tests
(tests/test_torch_*.py) hold to the JAX reference.
"""
import numpy as np
import pytest
import torch
from _torch_parity import cuda, npy, rand  # noqa: F401 (fixture)

from repro_torch.core.circulant import CodeSpec
from repro_torch.core import msr as tmsr
from repro_torch.exec import plan as tplan
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.circulant_encode import circulant_encode
from repro_torch.kernels.gf_matmul import fold_mismatches, gf_matmul

P = 257
pytestmark = pytest.mark.cuda


def on(dev, x):
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("p", [5, 257, 46337])
def test_gf_matmul_matches_plain(cuda, p):
    for m, k, s in ((2, 8, 4099), (16, 16, 4096), (18, 16, 1000),
                    (3, 300, 640), (1, 7, 130), (128, 128, 256)):
        a, b = on(cuda, rand((m, k), p, s)), on(cuda, rand((k, s), p, s + 1))
        n0 = gf_matmul.launches
        got = gf_matmul(a, b, p)
        assert gf_matmul.launches == n0 + 1
        assert torch.equal(got, ref.gf_matmul_ref(a, b, p)), (m, k, s)
    b = on(cuda, rand((4, 8, 1001), p, 3))
    for a in (rand((2, 8), p, 4), rand((4, 2, 8), p, 5)):
        a = on(cuda, a)
        assert torch.equal(gf_matmul(a, b, p), ref.gf_matmul_ref(a, b, p))
    for k in (127, 128, 129, 300):
        a = torch.full((2, k), p - 1, dtype=torch.int32, device=cuda)
        b = torch.full((k, 384), p - 1, dtype=torch.int32, device=cuda)
        assert torch.equal(gf_matmul(a, b, p), ref.gf_matmul_ref(a, b, p))
    torch.cuda.synchronize()


@pytest.mark.parametrize("p", [5, 257, 46337])
def test_gf_matmul_row_sources_match_plain(cuda, p):
    """The kernel on 1-4 row sources, every tile width (m up to 16, 32, 64
    and past it), k across a staging chunk, aligned and unaligned streams,
    a misaligned source base, batching with a shared and a per-element a,
    and unreduced inputs."""
    rng = np.random.default_rng(p)
    cases = [(m, k, s) for m in (1, 2, 16, 18, 33, 65) for k in (1, 9, 300)
             for s in (3, 1027, 4096)]
    for i, (m, k, s) in enumerate(cases):
        nsrc = min(k, 1 + i % 4)
        cuts = [k - nsrc + 1] + [1] * (nsrc - 1)
        lead = () if i % 3 == 0 else (2,)
        hi = p if i % 2 else 4 * p
        srcs = [on(cuda, rng.integers(-hi, hi, lead + (r, s), dtype=np.int32))
                for r in cuts]
        if i % 5 == 4:        # first source 4 bytes past a 16-byte boundary
            flat = torch.zeros(1 + srcs[0].numel(), dtype=torch.int32,
                               device=cuda)
            flat[1:] = srcs[0].reshape(-1)
            srcs[0] = flat[1:].view(srcs[0].shape)
        a = on(cuda, rng.integers(-hi, hi, (lead if i % 3 == 2 else ()) +
                                  (m, k), dtype=np.int32))
        n0 = gf_matmul.launches
        got = gf_matmul(a, tuple(srcs), p)
        assert gf_matmul.launches == n0 + 1
        assert torch.equal(got, ref.gf_matmul_ref(a, torch.cat(srcs, -2), p)),\
            (m, k, s, cuts, lead)
    torch.cuda.synchronize()


@pytest.mark.parametrize("p", [5, 257, 46337])
def test_barrett_fold_exact_for_every_uint32(cuda, p):
    assert fold_mismatches(p) == 0


@pytest.mark.parametrize("planned", [False, True])
def test_every_regenerate_is_one_launch(cuda, planned):
    spec = CodeSpec.make(4, P)
    code = tmsr.DoubleCirculantMSR(spec)
    data = on(cuda, rand((spec.n, 4099), P, 7))
    red = code.encode(data)
    nodes = [2, 5, 8]
    plans = [code.repair_plan(i) for i in nodes]
    r_prevs = red[torch.as_tensor([pl.prev_node - 1 for pl in plans])]
    helpers = data[torch.as_tensor([list(pl.data_indices) for pl in plans])]
    eng = code.repair
    ops = ([lambda: eng.regenerate_planned(2, r_prevs[0], helpers[0]).host(),
            lambda: eng.regenerate_batch_planned(nodes, r_prevs,
                                                 helpers).host()]
           if planned else
           [lambda: torch.stack(eng.regenerate(2, r_prevs[0], helpers[0])),
            lambda: eng.regenerate_batch(nodes, r_prevs, helpers)])
    for op in ops:
        n0 = gf_matmul.launches
        out = npy(op())
        assert gf_matmul.launches == n0 + 1
        pairs = out[None] if out.ndim == 2 else out
        for j, pair in enumerate(pairs):
            np.testing.assert_array_equal(pair[0], npy(data[nodes[j] - 1]))
            np.testing.assert_array_equal(pair[1], npy(red[nodes[j] - 1]))


def test_gf_matmul_reduces_unreduced_inputs(cuda):
    rng = np.random.default_rng(3)
    a = on(cuda, rng.integers(-1000, 1000, (3, 5)).astype(np.int32))
    b = on(cuda, rng.integers(-1000, 1000, (5, 403)).astype(np.int32))
    assert torch.equal(gf_matmul(a, b, P), ref.gf_matmul_ref(a, b, P))


@pytest.mark.parametrize("p", [5, 257, 46337])
def test_circulant_encode_matches_plain(cuda, p):
    for k in (1, 2, 3, 8, 16, 64, 130, 256):
        c = [int(x) for x in np.random.default_rng(k).integers(1, p, k)]
        for s in (4096, 1001):
            d = on(cuda, rand((2 * k, s), p, k + s))
            n0 = circulant_encode.launches
            assert torch.equal(circulant_encode(d, c, p),
                               ref.circulant_encode_ref(d, c, p)), (k, s)
            assert circulant_encode.launches == n0 + 1
    torch.cuda.synchronize()


def test_wrappers_raise_instead_of_falling_back(cuda):
    a = on(cuda, rand((2, 8), P, 0))
    b = on(cuda, rand((16, 8), P, 1))
    with pytest.raises(ValueError, match="contiguous"):
        gf_matmul(a, b.T, P)
    with pytest.raises(ValueError, match="k <= 256"):
        circulant_encode(on(cuda, rand((514, 8), P, 2)), [1] * 257, P)
    with pytest.raises(ValueError, match="a on"):
        gf_matmul(a.cpu(), on(cuda, rand((8, 4), P, 3)), P)


def test_planner_stages_numpy_through_pinned_pool(cuda):
    spec = CodeSpec.make(4, P)
    pc = tplan.PlanCache(dispatch.get("cuda"), P, bucket_min=32, device=cuda)
    assert pc.staging.pin
    data = rand((spec.n, 333), P, 9)
    res = pc.circulant_encode(data, spec.c)
    assert pc.staging.stats().in_use == 1     # held until the copy is done
    out = res.host()
    assert pc.staging.stats().in_use == 0
    np.testing.assert_array_equal(
        out, npy(tmsr.DoubleCirculantMSR(spec, device="cpu").encode(data)))


@pytest.mark.parametrize("k", [2, 8])
def test_slice_matches_cpu(cuda, k):
    payload = np.random.default_rng(k).integers(
        0, 256, size=16 * 4099 + 3, dtype=np.uint8).tobytes()
    spec = CodeSpec.make(k, P)
    code = tmsr.DoubleCirculantMSR(spec)
    assert code.backend_name == "cuda"
    enc = tmsr.encode_file(payload, spec, code)
    cpu = tmsr.encode_file(payload, spec, device="cpu")
    np.testing.assert_array_equal(npy(enc.red), npy(cpu.red))
    nodes = [1, 2 * k]
    plans = [code.repair_plan(i) for i in nodes]
    out = code.regenerate_batch(
        nodes, enc.red[torch.as_tensor([pl.prev_node - 1 for pl in plans])],
        enc.data[torch.as_tensor([list(pl.data_indices) for pl in plans])])
    for j, i in enumerate(nodes):
        assert torch.equal(out[j, 0], enc.data[i - 1])
        assert torch.equal(out[j, 1], enc.red[i - 1])
    assert tmsr.reconstruct_file(enc, list(range(k + 1, 2 * k + 1))) == \
        payload
    use = list(range(2, k + 2))
    idx = torch.as_tensor([i - 1 for i in use], device=cuda)
    dat, red = code.reconstruct_with_repair(use, enc.data[idx], enc.red[idx],
                                            [1])
    assert torch.equal(dat, enc.data) and torch.equal(red, enc.red[:1])
