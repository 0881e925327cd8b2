"""The traffic generator repeats for a seed and serves every seed the same
sizes."""
import collections
import itertools
import json

import numpy as np

from perfbench.harness import bench, traffic


def test_serve_schedule_repeats_and_keeps_the_mix():
    tr = bench.load_json("traffic", "long_docs")
    cycle = sum(tr["prompt_lengths"].values())
    a = list(itertools.islice(traffic.serve_schedule(tr, 2**31 + 5), 4 * cycle))
    b = list(itertools.islice(traffic.serve_schedule(tr, 2**31 + 5), 4 * cycle))
    c = list(itertools.islice(traffic.serve_schedule(tr, 7), 4 * cycle))
    assert a == b and a != c
    want = collections.Counter({int(k): v for k, v in tr["prompt_lengths"].items()})
    for i in range(4):
        assert collections.Counter(a[i * cycle:(i + 1) * cycle]) == want
        assert collections.Counter(c[i * cycle:(i + 1) * cycle]) == want


def test_prompts_repeat_for_a_seed():
    a = traffic.prompts(traffic.prompt_rng(2**32 + 3, 2), 2, 64, 1000)
    b = traffic.prompts(traffic.prompt_rng(2**32 + 3, 2), 2, 64, 1000)
    assert a.dtype == np.int32 and a.shape == (2, 64)
    assert (a == b).all() and a.min() >= 0 and a.max() < 1000


def test_ycsb_records_repeat_and_keep_the_schema():
    a = traffic.ycsb_records(300, 11, 0)
    assert a == traffic.ycsb_records(300, 11, 0)
    assert a != traffic.ycsb_records(300, 11, 1)
    for r in a:
        obj = json.loads(r)
        assert list(obj) == ["customer_id", "isActive", "linear_score", "weighted_score",
                             "phone_country", "age_group", "age_by_group", "url_domain",
                             "url_site", "email", "name", "children", "address", "phone",
                             "visits"]
        assert isinstance(obj["isActive"], bool) and 0 <= obj["linear_score"] < 100
        assert obj["url_site"].endswith("." + obj["url_domain"])
