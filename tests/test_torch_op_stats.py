"""Port parity -- ``repro_torch.launch.op_stats`` (the port's counterpart
of ``repro.launch.hlo_stats``): the reference's three analytic programs
(tests/test_hlo_stats.py) counted EXACTLY in the port, on the CPU and on
the ``meta`` device, and within the reference test's bands of the
reference's own ``hlo_stats.analyze`` of the same jitted jax function;
collectives read from ``place.traffic`` over a small sharded call; the
bytes proxy, composite ops under inference mode, and the meta table."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch import hlo_stats
from repro_torch.launch import op_stats
from repro_torch.launch.mesh import checked_mesh
from repro_torch.sharding import place
from repro_torch.sharding.mesh import P


def ref_flops(fn, n: int) -> float:
    x = jax.ShapeDtypeStruct((n, n), jnp.float32)
    return hlo_stats.analyze(
        jax.jit(fn).lower(x).compile().as_text())["flops"]


def both(fn, n: int) -> list:
    """Port counts of ``fn`` on an n x n float32 operand, on the CPU and
    on the meta device (twice: the second answered from the table)."""
    cpu = op_stats.analyze(fn, torch.randn(n, n))
    meta = [op_stats.analyze(fn, torch.empty(n, n, device="meta"))
            for _ in range(2)]
    return [cpu] + meta


def loop5(a):
    c = a
    for _ in range(5):
        c = c @ a
    return c


def nested(a):
    c = a
    for _ in range(4):
        for _ in range(3):
            c = c @ a
    return c


def r_loop5(a):
    def body(c, _):
        return c @ a, None
    return jax.lax.scan(body, a, None, length=5)[0]


def r_nested(a):
    def outer(c, _):
        def inner(ci, _):
            return ci @ a, None
        return jax.lax.scan(inner, c, None, length=3)[0], None
    return jax.lax.scan(outer, a, None, length=4)[0]


@pytest.mark.parametrize("fn,rfn,n,trips,band", [
    (loop5, r_loop5, 128, 5, (0.8, 1.6)),
    (nested, r_nested, 64, 12, (0.8, 1.8)),
    (lambda a: a @ a, lambda a: a @ a, 256, 1, (0.9, 1.3)),
], ids=["scan_5x128", "nested_3x4x64", "one_256"])
def test_analytic_programs_exact(fn, rfn, n, trips, band):
    want = trips * 2 * n ** 3
    for res in both(fn, n):
        assert res["flops"] == want, (res["flops"], want)
        assert res["collectives"]["total_bytes"] == 0
    got = op_stats.analyze(fn, torch.randn(n, n))["flops"]
    ref = ref_flops(rfn, n)
    # the reference's test holds its count to [lo, hi] x the analytic one
    assert band[0] * got <= ref <= band[1] * got, (ref, got)


def test_bytes_proxy_operands_plus_result_views_free():
    a = torch.randn(64, 32)
    res = op_stats.analyze(lambda x: (x + x).t().narrow(0, 0, 8), a)
    assert res["hbm_bytes"] == 3 * a.numel() * 4         # 2 reads + 1 write
    assert res["flops"] == a.numel()                      # one add
    cast = op_stats.analyze(lambda x: x.to(torch.bfloat16), a)
    assert cast["flops"] == a.numel()                     # a convert
    assert cast["hbm_bytes"] == a.numel() * (4 + 2)


def test_reductions_count_their_input():
    a = torch.randn(16, 48)
    assert op_stats.analyze(lambda x: x.sum(-1), a)["flops"] == a.numel()
    assert op_stats.analyze(lambda x: x.amax(0), a)["flops"] == a.numel()


def test_composites_under_inference_mode_decompose():
    a, w = torch.randn(4, 8, 16), torch.randn(16, 32)
    with torch.inference_mode():
        mm = op_stats.analyze(lambda x, y: torch.matmul(x, y), a, w)
        es = op_stats.analyze(
            lambda x, y: torch.einsum("bsd,de->bse", x, y), a, w)
    assert mm["flops"] == es["flops"] == 2 * 4 * 8 * 16 * 32


def test_meta_table_matches_running_the_op():
    """A repeat answered from the table gives the layout and counts that
    running the op's meta function gives."""
    def fn(x, w):
        h = torch.nn.functional.silu(x @ w).float()
        return torch.softmax(h, -1).to(torch.bfloat16) * 2.0
    x = torch.empty(3, 5, 16, dtype=torch.bfloat16, device="meta")
    w = torch.empty(16, 24, dtype=torch.bfloat16, device="meta")
    op_stats._META_TABLE.clear()
    first = op_stats.analyze(fn, x, w)
    again = op_stats.analyze(fn, x, w)
    cpu = op_stats.analyze(fn, torch.randn(3, 5, 16).bfloat16(),
                           torch.randn(16, 24).bfloat16())
    for k in ("flops", "hbm_bytes", "n_ops"):
        assert first[k] == again[k] == cpu[k], k
    for r in (first, again):
        out = r["result"]
        assert (out.shape, out.dtype, out.stride()) == (
            cpu["result"].shape, cpu["result"].dtype,
            cpu["result"].stride())


def test_collectives_from_place_traffic():
    mesh = checked_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    w = place.shard(torch.randn(8, 12), mesh, P("data", "model"))

    def call():
        full = w.relayout(P())                             # an all-gather
        parts = [torch.ones(5) for _ in range(3)]
        return full, place.all_reduce(parts)               # an all-reduce

    t0 = (place.traffic.gathers, place.traffic.gather_bytes,
          place.traffic.reduces, place.traffic.reduce_bytes)
    res = op_stats.analyze(call)
    t1 = (place.traffic.gathers, place.traffic.gather_bytes,
          place.traffic.reduces, place.traffic.reduce_bytes)
    c = res["collectives"]
    assert (c["all-gather"]["count"], c["all-gather"]["bytes"],
            c["all-reduce"]["count"], c["all-reduce"]["bytes"]) == tuple(
        b - a for a, b in zip(t0, t1))
    # every position shares one CPU tensor of the replicated block: the
    # first position reads the three blocks it does not hold
    assert c["all-gather"] == {"count": 3, "bytes": 3 * 4 * 6 * 4}
    assert c["all-reduce"] == {"count": 2, "bytes": 2 * 5 * 4}
    assert c["total_bytes"] == 3 * 96 + 40 and c["total_count"] == 5
    assert c["reduce-scatter"] == {"count": 0, "bytes": 0}
