"""Seeded synthetic JSON datasets, schema-faithful to the paper (§VII-B).

Three generators mirroring the paper's datasets and their predicate templates
(Table II):

  * ``yelp``   — review objects: stars/useful/funny/cool ints, user_id,
    free text, date.
  * ``winlog`` — Windows system log rows: time, level, service, info message.
  * ``ycsb``   — fakeit-style customer objects: isActive, scores,
    phone_country, age_group, url_domain/site, email, and filler attributes.

Records are emitted as JSON bytes (one object per record).  All draws are
seeded; the same (dataset, seed, n) is bit-identical across runs, which the
ingest checkpoint/restart tests rely on.
"""
from __future__ import annotations

import json
from typing import Callable, Iterator

import numpy as np

from repro_torch.core.predicates import (
    Clause,
    clause,
    exact,
    key_value,
    presence,
    substring,
)

_WORDS = (
    "delicious amazing terrible friendly slow fast cozy loud quiet great "
    "awful fresh stale crowded empty cheap pricey clean dirty lovely bland "
    "spicy sweet salty crispy tender juicy dry warm cold attentive rude"
).split()

_SERVICES = (
    "CBS TrustedInstaller WindowsUpdateAgent SessionManager NetworkProfile "
    "Defender Scheduler DHCP DNSCache EventLog"
).split()

_LOG_TEMPLATES = (
    "Loaded Servicing Stack v6.1.7601.{n} with Core",
    "Warning: Unrecognized packageExtended attribute {n}",
    "Failed to connect to endpoint {n} retrying",
    "Read out cached package applicability for package {n}",
    "Session {n} initialized by client WindowsUpdateAgent",
    "Expecting attribute name {n} in manifest",
    "Service {n} entered the running state",
    "Scavenging cache entry {n} complete",
)

_DOMAINS = "com org net io edu gov co uk de jp fr ca".split()
_SITES = (
    "alpha beta gamma delta epsilon zeta eta theta iota kappa lambdaone mutual"
).split()
_COUNTRIES = ["US", "CN", "IN"]
_AGE_GROUPS = ["child", "young", "adult", "senior"]
_LEVELS = ["Info", "Warning", "Error"]


def _text(rng: np.random.Generator, n_words: int) -> str:
    idx = rng.integers(0, len(_WORDS), size=n_words)
    return " ".join(_WORDS[i] for i in idx)


def yelp_record(rng: np.random.Generator) -> dict:
    y, mo, d = int(rng.integers(2005, 2019)), int(rng.integers(1, 13)), int(rng.integers(1, 29))
    return {
        "review_id": f"r{int(rng.integers(0, 10**9)):09d}",
        "user_id": f"u{int(rng.integers(0, 50)):04d}",
        "business_id": f"b{int(rng.integers(0, 10**6)):07d}",
        "stars": int(rng.integers(1, 6)),
        "useful": int(rng.geometric(0.08) - 1) % 100,
        "funny": int(rng.geometric(0.12) - 1) % 100,
        "cool": int(rng.geometric(0.10) - 1) % 100,
        "text": _text(rng, int(rng.integers(8, 40))),
        "date": f"{y:04d}-{mo:02d}-{d:02d}",
    }


def winlog_record(rng: np.random.Generator) -> dict:
    mo, d = int(rng.integers(1, 13)), int(rng.integers(1, 29))
    h, mi, s = int(rng.integers(0, 24)), int(rng.integers(0, 60)), int(rng.integers(0, 60))
    tpl = _LOG_TEMPLATES[int(rng.integers(0, len(_LOG_TEMPLATES)))]
    return {
        "time": f"2016-{mo:02d}-{d:02d} {h:02d}:{mi:02d}:{s:02d},{int(rng.integers(0,1000)):03d}",
        "level": _LEVELS[int(rng.choice(3, p=[0.8, 0.15, 0.05]))],
        "service": _SERVICES[int(rng.integers(0, len(_SERVICES)))],
        "info": tpl.format(n=int(rng.integers(0, 100000))),
    }


def ycsb_record(rng: np.random.Generator) -> dict:
    age_group = _AGE_GROUPS[int(rng.integers(0, 4))]
    dom = _DOMAINS[int(rng.integers(0, len(_DOMAINS)))]
    site = _SITES[int(rng.integers(0, len(_SITES)))]
    first = _text(rng, 1)
    rec = {
        "customer_id": int(rng.integers(0, 10**8)),
        "isActive": bool(rng.random() < 0.5),
        "linear_score": int(rng.integers(0, 100)),
        "weighted_score": int(rng.integers(0, 100)),
        "phone_country": _COUNTRIES[int(rng.choice(3, p=[0.5, 0.3, 0.2]))],
        "age_group": age_group,
        "age_by_group": int(rng.integers(0, 100)),
        "url_domain": dom,
        "url_site": f"www.{site}.{dom}",
        "email": f"{first}{int(rng.integers(0,999))}@{site}.{dom}",
        "name": first.capitalize(),
        "children": int(rng.integers(0, 5)),
        "address": f"{int(rng.integers(1,9999))} {_text(rng,1)} st",
        "phone": f"+{int(rng.integers(1,99))}-{int(rng.integers(10**6,10**7))}",
        "visits": int(rng.integers(0, 1000)),
    }
    return rec


_GENERATORS: dict[str, Callable[[np.random.Generator], dict]] = {
    "yelp": yelp_record,
    "winlog": winlog_record,
    "ycsb": ycsb_record,
}


def generate_records(dataset: str, n: int, seed: int = 0) -> list[bytes]:
    gen = _GENERATORS[dataset]
    rng = np.random.default_rng(seed)
    return [json.dumps(gen(rng), separators=(",", ":")).encode() for _ in range(n)]


def record_stream(dataset: str, seed: int = 0) -> Iterator[bytes]:
    gen = _GENERATORS[dataset]
    rng = np.random.default_rng(seed)
    while True:
        yield json.dumps(gen(rng), separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# predicate pools per dataset (paper Table II)
# ---------------------------------------------------------------------------

def predicate_pool(dataset: str, rng: np.random.Generator | None = None) -> list[Clause]:
    rng = rng or np.random.default_rng(1)
    pool: list[Clause] = []
    if dataset == "yelp":
        for field_name, n_cand in (("useful", 100), ("cool", 100), ("funny", 100)):
            for v in range(n_cand):
                pool.append(clause(key_value(field_name, v)))
        for v in range(1, 6):
            pool.append(clause(key_value("stars", v)))
        for v in range(5):
            pool.append(clause(exact("user_id", f"u{v:04d}")))
        for w in _WORDS[:5]:
            pool.append(clause(substring("text", w)))
        for y in range(2005, 2019):
            pool.append(clause(substring("date", f"{y:04d}-")))
        for mo in range(1, 13):
            pool.append(clause(substring("date", f"-{mo:02d}-")))
    elif dataset == "winlog":
        # info LIKE <string>: 200 candidates drawn from template fragments
        frags = [
            "Servicing Stack", "Unrecognized", "Failed to connect", "cached package",
            "initialized by client", "attribute name", "running state", "Scavenging",
        ]
        for i in range(200):
            f = frags[i % len(frags)]
            pool.append(clause(substring("info", f if i < len(frags) else f"{f} {i}")))
        for mo in range(1, 13):
            pool.append(clause(substring("time", f"-{mo:02d}-")))
        for d in range(1, 29):
            pool.append(clause(substring("time", f"-{d:02d} ")))
        for h in range(0, 24):
            pool.append(clause(substring("time", f" {h:02d}:")))
        for mi in range(0, 60):
            pool.append(clause(substring("time", f":{mi:02d}:")))
        for s in range(0, 60):
            pool.append(clause(substring("time", f":{s:02d},")))
    elif dataset == "ycsb":
        for b in (True, False):
            pool.append(clause(key_value("isActive", b)))
        for f in ("linear_score", "weighted_score", "age_by_group"):
            for v in range(100):
                pool.append(clause(key_value(f, v)))
        for c in _COUNTRIES:
            pool.append(clause(exact("phone_country", c)))
        for g in _AGE_GROUPS:
            pool.append(clause(exact("age_group", g)))
        for d in _DOMAINS:
            pool.append(clause(substring("url_domain", d)))
        for s in _SITES:
            pool.append(clause(substring("url_site", f"www.{s}.")))
        pool.append(clause(substring("email", "@")))
        pool.append(clause(presence("email")))
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    return pool


DATASETS = tuple(_GENERATORS)
