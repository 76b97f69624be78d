"""The traffic generators repeat exactly from a seed, differ across seeds,
and give every seed the same sizes and arrivals (in another order)."""

import numpy as np

import tiny
from harness import common


def _offline_pool(seed):
    logs = []
    ctx = tiny.context("convnext.offline", seed=seed, logs=logs, rows=2, tokens=[20, 30], pool=3,
                       n_frames=256, frame_margin=16)
    cell = common.load_module("traffic", "offline").Cell(ctx)
    cell.setup()
    return cell


def test_offline_pool_repeats_and_differs():
    a, b, c = _offline_pool(7), _offline_pool(7), _offline_pool(2 ** 31 + 11)
    for pa, pb in zip(a.pool, b.pool):
        assert np.array_equal(pa.x, pb.x) and np.array_equal(pa.x_lengths, pb.x_lengths)
    assert a.d_factor == b.d_factor
    assert not all(np.array_equal(pa.x, pc.x) for pa, pc in zip(a.pool, c.pool))
    # the same multiset of row lengths, in another order
    la = np.sort(np.concatenate([p.x_lengths for p in a.pool]))
    lc = np.sort(np.concatenate([p.x_lengths for p in c.pool]))
    assert np.array_equal(la, lc)


def _requests(seed, seconds=5.0, rate=40.0):
    ctx = tiny.context("convnext.batcher", seed=seed)
    return common.load_module("traffic", "batcher").Cell(ctx).requests(seconds, rate)


def test_batcher_requests_repeat_and_differ():
    a, b, c = _requests(3), _requests(3), _requests(2 ** 31 + 5)
    key = lambda reqs: [(due, tuple(s), cls, mu) for due, s, cls, mu in reqs]  # noqa: E731
    assert key(a) == key(b)
    assert key(a) != key(c)
    # every seed gets the same arrivals and the same requests, reordered
    assert [r[0] for r in a] == [r[0] for r in c]
    assert sorted((tuple(s), cls, mu) for _, s, cls, mu in a) == \
        sorted((tuple(s), cls, mu) for _, s, cls, mu in c)


def test_batcher_mix_follows_its_parameters():
    reqs = _requests(9, seconds=400.0, rate=40.0)
    p = common.workload("convnext.batcher")["params"]
    n = len(reqs)
    assert abs(n / 400.0 - 40.0) < 3.0
    sent = np.array([len(s) for _, s, _, _ in reqs])
    for k, share in enumerate(p["sentences_p"], start=1):
        assert abs((sent == k).mean() - share) < 0.03
    for name, c in p["classes"].items():
        assert abs(np.mean([cls == name for _, _, cls, _ in reqs]) - c["p"]) < 0.03
    assert abs(np.mean([mu for *_, mu in reqs]) - p["mulaw_share"]) < 0.03
    tok = np.concatenate([s for _, s, _, _ in reqs])
    lo, hi = p["tokens"]["clip"]
    assert tok.min() >= lo and tok.max() <= hi
    assert abs(np.median(tok) - p["tokens"]["median"]) <= 3
