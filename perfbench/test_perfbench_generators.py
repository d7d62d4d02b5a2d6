"""The traffic generator and the configurations' object sizes are
functions of the seed alone, and every seed gets the same work."""
import collections
import math

from perfbench import deploy, tiny, traffic_gen

LOG_UNIFORM = {"objects": {"count": 512, "size_dist": "log_uniform",
                           "size_min": 65536, "size_max": 4194304,
                           "assign_seed": 0}}


def test_node_order_is_a_seeded_permutation():
    a = traffic_gen.node_order(20, 2 ** 31 + 7)
    assert a == traffic_gen.node_order(20, 2 ** 31 + 7)
    assert sorted(a) == list(range(1, 21))
    assert a != traffic_gen.node_order(20, 2 ** 31 + 8)


def test_payloads_are_seeded():
    g1 = traffic_gen.rng(5, traffic_gen.STREAM_OBJECTS)
    g2 = traffic_gen.rng(5, traffic_gen.STREAM_OBJECTS)
    g3 = traffic_gen.rng(6, traffic_gen.STREAM_OBJECTS)
    p1 = traffic_gen.payload(g1, 4096)
    assert p1 == traffic_gen.payload(g2, 4096) != traffic_gen.payload(g3,
                                                                      4096)
    assert len(p1) == 4096


def test_fnv1a64_is_a_non_negative_long():
    vals = [traffic_gen.fnv1a64(i) for i in range(1000)]
    assert vals == [traffic_gen.fnv1a64(i) for i in range(1000)]
    assert all(0 <= v < 2 ** 63 for v in vals)
    assert len(set(vals)) == 1000


def test_zipf_keys_are_a_fixed_skewed_multiset():
    keys = traffic_gen.zipf_keys(512, 0.99, 2000)
    assert (keys == traffic_gen.zipf_keys(512, 0.99, 2000)).all()
    assert keys.min() >= 0 and keys.max() < 512
    top = collections.Counter(keys.tolist()).most_common(1)[0][1]
    zeta = sum(1 / (i + 1) ** 0.99 for i in range(512))
    # the hottest key takes about 1 / zeta of the requests
    assert abs(top / 2000 - 1 / zeta) < 0.02


def test_log_uniform_sizes_are_the_same_for_every_seed():
    cfg = LOG_UNIFORM
    sizes = deploy.object_sizes(cfg)
    assert sizes == deploy.object_sizes(cfg)
    assert len(sizes) == 512
    assert min(sizes) >= 65536 and max(sizes) <= 4194304
    assert 470 << 20 < sum(sizes) < 500 << 20
    lo, hi = math.log(65536), math.log(4194304)
    want = sorted(round(math.exp(lo + (i + 0.5) / 512 * (hi - lo)))
                  for i in range(512))
    assert sorted(sizes) == want
    assert sizes != sorted(sizes)      # handed out in a shuffled order


def test_open_schedule_same_work_in_another_order():
    mix = tiny.mix("rgw-read-update")
    a = traffic_gen.open_schedule(mix, 512, 10.0, 11)
    assert a == traffic_gen.open_schedule(mix, 512, 10.0, 11)
    b = traffic_gen.open_schedule(mix, 512, 10.0, 12)
    m = round(mix["rate_per_s"] * 10.0)
    assert len(a) == len(b) == m
    assert [op.due_s for op in a] == sorted(op.due_s for op in a)
    assert a[0].due_s == 0 and a[-1].due_s < 10.0
    # the same gaps between arrivals, but the one before the first
    ga = {round(y.due_s - x.due_s, 9) for x, y in zip(a, a[1:])}
    gb = {round(y.due_s - x.due_s, 9) for x, y in zip(b, b[1:])}
    assert len(ga & gb) >= m - 3
    assert sorted((op.kind, op.key) for op in a) != sorted(
        (op.kind, op.key) for op in b) or a != b
    assert sorted(op.key for op in a) == sorted(op.key for op in b)
    assert sorted(op.kind for op in a) == sorted(op.kind for op in b)
    puts = [op for op in a if op.kind == "put"]
    assert len(puts) == round(m * (1 - mix["read_share"]))
    assert [op.payload for op in puts] == list(range(len(puts)))
    assert a != b


def test_ingest_plan_overwrites_the_oldest_key():
    plan = [traffic_gen.ingest_plan(8, 9, i) for i in range(10)]
    assert [k for k, _v in plan] == [0, 1, 2, 3, 4, 5, 6, 7, 0, 1]
    assert [v for _k, v in plan] == [8, 0, 1, 2, 3, 4, 5, 6, 7, 8]


def test_configurations_hold_their_sizes():
    hdfs = deploy.load_config("dc16-hdfs128m")
    assert hdfs["store"]["stripe_symbols"] == 1 << 20
    assert deploy.object_sizes(hdfs) == [134217728] * 8
    rgw = deploy.load_config("dc16-rgw4m")
    assert rgw["store"]["stripe_symbols"] == 4096
    assert set(deploy.object_sizes(rgw)) == {4194304}
