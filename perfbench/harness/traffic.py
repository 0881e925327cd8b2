"""The general traffic generator: every mix is a parameter file it reads.

``serve_closed_loop`` mixes (``perfbench/traffic/<name>.json``):
``batch`` prompts a request, each ``output_tokens`` long in output, prompt
lengths drawn from ``prompt_lengths`` (length -> count in one cycle): each
cycle is that multiset in an order drawn from the seed, so every seed
serves the same sizes in another order; prompt tokens uniform over the
vocabulary.  ``check_requests`` of the finished requests are compared with
the reference.

``train_ciao`` mixes: ``batch`` x ``seq_len`` token batches fed from
``records`` records of ``dataset`` (ycsb: the schema of the YCSB-style
customer objects the CIAO paper loads), ``clients`` record streams of
``chunks_per_client`` chunks of ``chunk_records``, loaded under a budget
of ``budget_us`` per record; the recipe is the top pushed clause of a
zipf(``zipf_a``) workload of ``recipe_queries`` queries;
``prefetch_depth`` batches are made ahead.
"""
from __future__ import annotations

import numpy as np


def serve_schedule(traffic: dict, seed: int):
    """Prompt lengths of the requests, without end: cycles of the mix."""
    rng = np.random.default_rng([seed, 1])
    cycle = [int(length) for length, n in traffic["prompt_lengths"].items()
             for _ in range(n)]
    while True:
        for i in rng.permutation(len(cycle)):
            yield cycle[i]


def prompt_rng(seed: int, stream: int) -> np.random.Generator:
    """Token draws: stream 0 warms up, stream 2 is the measured requests."""
    return np.random.default_rng([seed, stream])


def prompts(rng: np.random.Generator, batch: int, length: int, vocab: int):
    return rng.integers(0, vocab, size=(batch, length), dtype=np.int64).astype(np.int32)


_WORDS = ("delicious amazing terrible friendly slow fast cozy loud quiet great "
          "awful fresh stale crowded empty cheap pricey clean dirty lovely bland "
          "spicy sweet salty crispy tender juicy dry warm cold attentive rude").split()
_DOMAINS = "com org net io edu gov co uk de jp fr ca".split()
_SITES = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambdaone "
          "mutual").split()
_COUNTRIES = ["US", "CN", "IN"]
_AGE_GROUPS = ["child", "young", "adult", "senior"]


def ycsb_records(n: int, seed: int, stream: int) -> list[bytes]:
    """``n`` YCSB-style customer records as compact JSON, drawn in bulk
    from ``(seed, stream)``."""
    rng = np.random.default_rng([seed, 100 + stream])
    r = {k: rng.integers(lo, hi, size=n).tolist() for k, lo, hi in (
        ("cid", 0, 10**8), ("lin", 0, 100), ("wei", 0, 100), ("abg", 0, 100),
        ("dom", 0, len(_DOMAINS)), ("site", 0, len(_SITES)),
        ("first", 0, len(_WORDS)), ("num", 0, 999), ("kids", 0, 5),
        ("house", 1, 9999), ("street", 0, len(_WORDS)), ("cc", 1, 99),
        ("tel", 10**6, 10**7), ("visits", 0, 1000), ("age", 0, 4))}
    active = (rng.random(n) < 0.5).tolist()
    country = rng.choice(3, size=n, p=[0.5, 0.3, 0.2]).tolist()
    out = []
    for i in range(n):
        dom, site, first = _DOMAINS[r["dom"][i]], _SITES[r["site"][i]], _WORDS[r["first"][i]]
        out.append((
            f'{{"customer_id":{r["cid"][i]},"isActive":{"true" if active[i] else "false"},'
            f'"linear_score":{r["lin"][i]},"weighted_score":{r["wei"][i]},'
            f'"phone_country":"{_COUNTRIES[country[i]]}","age_group":"{_AGE_GROUPS[r["age"][i]]}",'
            f'"age_by_group":{r["abg"][i]},"url_domain":"{dom}","url_site":"www.{site}.{dom}",'
            f'"email":"{first}{r["num"][i]}@{site}.{dom}","name":"{first.capitalize()}",'
            f'"children":{r["kids"][i]},"address":"{r["house"][i]} {_WORDS[r["street"][i]]} st",'
            f'"phone":"+{r["cc"][i]}-{r["tel"][i]}","visits":{r["visits"][i]}}}'
        ).encode())
    return out
