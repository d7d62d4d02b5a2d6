"""Port parity — gf_matmul's row-source form and the callers that use it.

``gf_matmul(a, (b_0, ..., b_{n-1}), p)`` reads its 1-4 row sources as if
concatenated along the contraction axis.  On this host the wrapper gets
CPU tensors and runs its plain version; the CUDA kernel is held to the
same plain version by tests/test_torch_cuda.py and chip_smoke.py on the
card.  Every comparison here is exact (tolerance 0: GF arithmetic is
exact), and every input comes from seeded numpy:

* the source form against the JAX ``gf_matmul`` (Pallas in interpret
  mode) and its oracle on the concatenated operand;
* the fused engine's reconstruct, multi-failure repair, regenerate and
  batched regenerate, and their planned twins, against the JAX engine at
  odd and even stream lengths and F in {1, 3}, on both port backends;
* a custom matmul (``fused=False``) still gets one concatenated tensor,
  and the fused engine hands its backend the sources uncopied;
* the wrapper refuses what the kernel does not take.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import npy, rand, t

from repro.core import msr as rmsr
from repro.core.circulant import CodeSpec as RSpec
from repro.kernels import gf_matmul as rgm
from repro.kernels import ref as rref
from repro_torch.core import msr as tmsr
from repro_torch.core import repair as trepair
from repro_torch.core.circulant import CodeSpec
from repro_torch.exec import plan as tplan
from repro_torch.kernels import ref
from repro_torch.kernels.gf_matmul import gf_matmul

P = 257


def split_rows(b: np.ndarray, nsrc: int) -> tuple:
    """b's contraction axis cut into nsrc uneven row sources (CPU
    tensors): one row each, the rest in the last."""
    k = b.shape[-2]
    cuts = np.cumsum([1] * (nsrc - 1))
    parts = np.split(b, cuts, axis=-2) if nsrc > 1 else [b]
    assert sum(x.shape[-2] for x in parts) == k
    return tuple(t(x) for x in parts)


# --------------------------------------------------------------- the kernel
@pytest.mark.parametrize("p", [5, 257])
@pytest.mark.parametrize("nsrc", [1, 2, 3, 4])
@pytest.mark.parametrize("s", [130, 333])
def test_source_form_matches_reference_on_concatenation(p, nsrc, s):
    m, k = 6, 9
    a = rand((m, k), p, seed=nsrc * s)
    b = rand((k, s), p, seed=nsrc + s)
    got = npy(gf_matmul(t(a), split_rows(b, nsrc), p))
    np.testing.assert_array_equal(
        got, npy(rgm.gf_matmul(a, b, p, interpret=True)))
    np.testing.assert_array_equal(
        got, npy(rref.gf_matmul_ref(jnp.asarray(a), jnp.asarray(b), p)))
    np.testing.assert_array_equal(
        npy(ref.gf_matmul_ref(t(a), split_rows(b, nsrc), p)), got)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("nsrc", [2, 4])
def test_batched_source_form_matches_reference(shared, nsrc):
    f, m, k, s = 3, 2, 9, 257
    b = rand((f, k, s), P, 21)
    a = rand((m, k), P, 22) if shared else rand((f, m, k), P, 23)
    got = npy(gf_matmul(t(a), split_rows(b, nsrc), P))
    assert got.shape == (f, m, s)
    for i in range(f):
        np.testing.assert_array_equal(got[i], npy(rref.gf_matmul_ref(
            jnp.asarray(a if shared else a[i]), jnp.asarray(b[i]), P)))


def test_source_form_reduces_unreduced_and_negative_inputs():
    rng = np.random.default_rng(5)
    a = rng.integers(-1000, 1000, (4, 7)).astype(np.int32)
    b = rng.integers(-2 ** 31, 2 ** 31 - 1, (7, 99), dtype=np.int64)
    b = b.astype(np.int32)
    np.testing.assert_array_equal(
        npy(gf_matmul(t(a), split_rows(b, 3), P)),
        npy(rref.gf_matmul_ref(jnp.asarray(a), jnp.asarray(b), P)))


def bad_sources():
    a, b = t(rand((2, 4), P, 0)), t(rand((4, 8), P, 1))
    three = t(rand((3, 2, 8), P, 2))
    return {
        "no sources": (a, (), ValueError, "1 to 4"),
        "five sources": (t(rand((2, 5), P, 3)),
                         tuple(b[:1] for _ in range(5)), ValueError, "1 to 4"),
        "stream lengths differ": (a, (b[:2], t(rand((2, 9), P, 4))),
                                  ValueError, "stream length"),
        "batches differ": (a, (three, t(rand((2, 2, 8), P, 5))),
                           ValueError, "batch"),
        "batched beside unbatched": (a, (three, b[2:]), ValueError,
                                     "need a"),
        "int64 source": (a, (b[:2], b[2:].long()), TypeError, "int32"),
        "non-tensor source": (a, (b[:2], np.zeros((2, 8), np.int32)),
                              TypeError, "torch.Tensor"),
        "mixed devices": (a, (b[:2], b[2:].to("meta")), ValueError, "a on"),
        "contraction": (a, (b[:2], b[:1]), ValueError, "contraction"),
        "not contiguous": (a, (b[:2], t(rand((8, 2), P, 6)).T), ValueError,
                           "contiguous"),
    }


@pytest.mark.parametrize("case", sorted(bad_sources()))
def test_wrapper_rejects_bad_sources(case):
    a, srcs, exc, match = bad_sources()[case]
    with pytest.raises(exc, match=match):
        gf_matmul(a, srcs, P)


# ------------------------------------------------------------- the engine
def pair(k, backend):
    return (rmsr.DoubleCirculantMSR(RSpec.make(k, P)),
            tmsr.DoubleCirculantMSR(CodeSpec.make(k, P), backend=backend,
                                    device="cpu"))


def coded(rc, k, s, seed):
    data = rand((2 * k, s), P, seed)
    return data, npy(rc.encode(data))


def helpers(code, data, red, nodes):
    plans = [code.repair_plan(i) for i in nodes]
    return (np.stack([red[pl.prev_node - 1] for pl in plans]),
            np.stack([data[list(pl.data_indices)] for pl in plans]))


BACKENDS = ["torch-int32", "cuda"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("s", [37, 64])
@pytest.mark.parametrize("f", [1, 3])
def test_reconstruct_and_repair_match_reference(backend, s, f):
    k = 4
    rc, tc = pair(k, backend)
    data, red = coded(rc, k, s, seed=s + f)
    failed = [2, 5, 7][:f]
    use = [i for i in range(1, 2 * k + 1) if i not in failed][:k]
    idx = [i - 1 for i in use]
    shuffled = use[::-1]                      # unsorted ids: a row gather
    sidx = [i - 1 for i in shuffled]
    np.testing.assert_array_equal(
        npy(tc.reconstruct(shuffled, data[sidx], red[sidx])),
        npy(rc.reconstruct(shuffled, data[sidx], red[sidx])))
    got_d, got_r = tc.reconstruct_with_repair(use, data[idx], red[idx],
                                              failed)
    want_d, want_r = rc.reconstruct_with_repair(use, data[idx], red[idx],
                                                failed)
    np.testing.assert_array_equal(npy(got_d), npy(want_d))
    np.testing.assert_array_equal(npy(got_r), npy(want_r))
    np.testing.assert_array_equal(npy(got_r), red[[i - 1 for i in failed]])
    # the planned twin: one matmul over the concatenated download
    dl = np.concatenate([data[idx], red[idx]])
    mat = rc.repair.decode_repair_matrix(use, failed)
    np.testing.assert_array_equal(tc.repair.apply_planned(mat, dl).host(),
                                  rc.repair.apply_planned(mat, dl).host())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("s", [37, 64])
@pytest.mark.parametrize("f", [1, 3])
def test_regenerate_matches_reference(backend, s, f):
    k = 4
    rc, tc = pair(k, backend)
    data, red = coded(rc, k, s, seed=10 * s + f)
    nodes = [1, 4, 8][:f]
    r_prevs, nxt = helpers(rc, data, red, nodes)
    for j, i in enumerate(nodes):
        for got, want in zip(tc.regenerate(i, r_prevs[j], nxt[j]),
                             rc.regenerate(i, r_prevs[j], nxt[j])):
            np.testing.assert_array_equal(npy(got), npy(want))
        np.testing.assert_array_equal(
            tc.repair.regenerate_planned(i, r_prevs[j], nxt[j]).host(),
            rc.repair.regenerate_planned(i, r_prevs[j], nxt[j]).host())
    got = npy(tc.regenerate_batch(nodes, r_prevs, nxt))
    np.testing.assert_array_equal(got, npy(rc.regenerate_batch(
        nodes, r_prevs, nxt)))
    np.testing.assert_array_equal(got[:, 0], data[[i - 1 for i in nodes]])
    np.testing.assert_array_equal(got[:, 1], red[[i - 1 for i in nodes]])
    np.testing.assert_array_equal(
        tc.repair.regenerate_batch_planned(nodes, r_prevs, nxt).host(),
        rc.repair.regenerate_batch_planned(nodes, r_prevs, nxt).host())
    with tplan.planning_disabled():
        np.testing.assert_array_equal(
            tc.repair.regenerate_batch_planned(nodes, r_prevs, nxt).host(),
            got)


# ------------------------------------------------ what the matmul receives
class Spy:
    """A matmul that records the form of each contraction operand."""

    def __init__(self):
        self.forms = []

    def __call__(self, a, b, p):
        self.forms.append(tuple(tuple(x.shape) for x in b)
                          if isinstance(b, tuple) else tuple(b.shape))
        return ref.gf_matmul_ref(a, b, p)


def run_op(engine, op, data, red):
    k = engine.k
    if op == "reconstruct":
        engine.reconstruct([1, 3, 5, 7], data[[0, 2, 4, 6]],
                           red[[0, 2, 4, 6]])
    elif op == "reconstruct_with_repair":
        engine.reconstruct_with_repair([1, 3, 5, 7], data[[0, 2, 4, 6]],
                                       red[[0, 2, 4, 6]], [2, 8])
    elif op == "regenerate":
        r_prevs, nxt = helpers(engine_code(k), data, red, [3])
        engine.regenerate(3, r_prevs[0], nxt[0])
    else:
        r_prevs, nxt = helpers(engine_code(k), data, red, [3, 6])
        engine.regenerate_batch([3, 6], r_prevs, nxt)


def engine_code(k):
    return tmsr.DoubleCirculantMSR(CodeSpec.make(k, P), device="cpu")


OPS = ["reconstruct", "reconstruct_with_repair", "regenerate",
       "regenerate_batch"]


@pytest.mark.parametrize("op", OPS)
def test_custom_matmul_gets_one_concatenated_tensor(op):
    k, s = 4, 40
    spy = Spy()
    engine = trepair.RepairEngine(CodeSpec.make(k, P), spy, fused=False,
                                  device="cpu")
    data, red = coded(rmsr.DoubleCirculantMSR(RSpec.make(k, P)), k, s, 3)
    run_op(engine, op, data, red)
    assert spy.forms and all(isinstance(f[0], int) for f in spy.forms), \
        spy.forms
    if op.startswith("reconstruct"):
        assert spy.forms == [(2 * k, s)]      # the concatenated download
    elif op == "regenerate":
        assert spy.forms == [(k + 1, s)]      # the literal stacked helpers


@pytest.mark.parametrize("op", OPS)
def test_fused_engine_hands_row_sources_uncopied(op):
    k, s = 4, 40
    spy = Spy()
    engine = trepair.RepairEngine(CodeSpec.make(k, P), spy, fused=True,
                                  device="cpu")
    data, red = coded(rmsr.DoubleCirculantMSR(RSpec.make(k, P)), k, s, 4)
    run_op(engine, op, data, red)
    want = {"reconstruct": [((k, s), (k, s))],
            "reconstruct_with_repair": [((k, s), (k, s))],
            "regenerate": [((1, s), (k, s))],
            "regenerate_batch": [((2, 1, s), (2, k, s))]}[op]
    assert spy.forms == want


def test_make_regen_fn_is_one_product_over_sources():
    spec = CodeSpec.make(3, P)
    rmat = torch.from_numpy(trepair.build_repair_matrix(spec))
    assert int(rmat[1, 0]) == 0                # the re-encode row skips r_prev
    spy = Spy()
    fn = tplan.make_regen_fn(spy, P)
    r_prev = t(rand((50,), P, 1))
    nxt = t(rand((3, 50), P, 2))
    out = fn(rmat, r_prev, nxt)
    assert spy.forms == [((1, 50), (3, 50))]
    np.testing.assert_array_equal(
        npy(out), npy(ref.gf_matmul_ref(rmat, torch.cat([r_prev[None], nxt]),
                                        P)))
