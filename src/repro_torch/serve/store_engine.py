"""Async store serving plane: CiaoServeEngine (DESIGN.md §17).

The port of ``repro.serve.store_engine``.  NOT the LLM serving engine:
:mod:`repro_torch.serve.engine` serves the *model* (prefill/decode);
this module serves *store queries* while ingest is live.  The two share
nothing but the package.

:class:`CiaoServeEngine` wraps a :class:`~repro_torch.core.server.CiaoStore`
or :class:`~repro_torch.core.shard.ShardedCiaoStore` and runs ingest and scans
concurrently with zero reader blocking:

  * **writers** — ``ingest_chunk`` validates the chunk synchronously
    (epoch / tier / bitvector dimensions, so
    :class:`~repro_torch.core.server.StaleEpochError` still surfaces at the
    submit site and the :class:`~repro_torch.data.pipeline.IngestCoordinator`
    retry loop works unchanged), routes it into per-shard slices in the
    submitting thread, and enqueues each slice onto its shard's bounded
    write queue.  A writer pool drains the queues; shard *s* is always
    drained by writer ``s % writers``, so every shard has exactly ONE
    concurrent mutator (the invariant the store's summary versioning and
    ingest locks are designed around) and per-shard ingest order equals
    submit order.  A full queue exerts **backpressure**: policy
    ``"block"`` makes the submitter wait (time accounted), ``"reject"``
    raises :class:`BackpressureError` immediately.
  * **readers** — ``query`` / ``query_batch`` execute against an
    immutable store snapshot (:meth:`CiaoStore.snapshot`), never against
    live shard state, so scans see a consistent ``(epoch, data_version)``
    view while appends continue.  Readers take the current snapshot
    bundle by atomic reference — a background refresher rebuilds it at
    most every ``refresh_interval_s`` when the store version moved, so
    reads are bounded-stale and NEVER wait on writer-held locks
    (``quiesce()`` forces a refresh: read-your-quiesced-writes holds).
    :class:`~repro_torch.core.batch_scan.ResultCache` fencing stays exact
    because snapshot-local JIT promotion forks the version negative
    (see :class:`~repro_torch.core.server.StoreSnapshot`).
  * **admission** — an optional :class:`QueryAdmission` maps tenants to
    tiers with per-tier in-flight quotas; an over-quota query blocks or
    raises :class:`AdmissionError` per the tier's policy, *before* any
    scan work happens.

``quiesce()`` drains every write queue (the post-quiesce store answers
bit-identically to a store that ingested the same chunks serially —
the oracle gate in ``repro_torch.benchmarks.bench_serve``); ``close()`` drains,
stops the writer pool and joins it.  Epoch advances must go through
:meth:`CiaoServeEngine.advance_epoch`, which quiesces first — otherwise
queued chunks validated under the old epoch would fail at drain time.

``mode="device"`` queries run on the card unless the engine is asked
otherwise: ``device_backend`` defaults to ``"cuda"`` (kernel B over each
snapshot's resident plane) and raises at the first device query where
there is no card; ``"torch"`` and ``"numpy"`` run the plain versions on
the CPU.  One snapshot bundle's device scanner is shared by every reader
of that snapshot, and its calls run one at a time (the port's segment
cache updates resident tensors in place).

``stats_report()["snapshots"]`` counts what the snapshot bundles cost:
bundles built, the seconds their captures took (the wait for every
shard's ingest lock included), the bundles that built a device scanner,
and their planes' ``sync`` calls, segments admitted, uploads, bytes
uploaded and host seconds in ``sync`` (summed over every such bundle,
also those already dropped).
"""
from __future__ import annotations

import queue
import threading
import time
import weakref
from dataclasses import dataclass

from repro_torch.core.batch_scan import ResultCache, ScanBatcher
from repro_torch.core.device_scan import DeviceScanner, ShardedDeviceScanner
from repro_torch.core.server import (
    CiaoStore, DataSkippingScanner, LoadStats, ScanResult,
    resolve_ingest_coverage,
)
from repro_torch.core.shard import ShardedCiaoStore, ShardedScanner
from repro_torch.core.predicates import Query


class BackpressureError(RuntimeError):
    """An ingest submit found its shard's write queue full
    (``backpressure="reject"``)."""


class AdmissionError(RuntimeError):
    """A query was denied by tenant-tier admission control
    (``on_full="reject"``)."""


@dataclass(frozen=True)
class TierPolicy:
    """Admission policy for one tenant tier.

    ``max_inflight`` concurrent queries; when the quota is full,
    ``on_full="block"`` queues the caller (FIFO per condition wakeup)
    and ``"reject"`` raises :class:`AdmissionError` immediately.
    """

    max_inflight: int
    on_full: str = "block"

    def __post_init__(self) -> None:
        if self.max_inflight < 0:
            raise ValueError(f"max_inflight must be >= 0, "
                             f"got {self.max_inflight}")
        if self.on_full not in ("block", "reject"):
            raise ValueError(f"unknown on_full policy {self.on_full!r}")


class QueryAdmission:
    """Tenant-tier query admission control (DESIGN.md §17).

    ``tiers`` maps tier name -> :class:`TierPolicy`; ``tenant_tiers``
    maps tenant -> tier name (unmapped tenants use ``default_tier``).
    Thread-safe; counters (admitted / rejected / blocked seconds) are
    kept per tier for :meth:`stats`, and — when ``telemetry`` is set
    (the engine wires its store's plane automatically) — every outcome
    is also recorded per TENANT into the
    :class:`~repro_torch.core.telemetry.TelemetryPlane`, so admission pressure
    shows up in the same per-tenant ``stats_report()`` as scan stats.
    """

    def __init__(self, tiers: dict[str, TierPolicy], *,
                 tenant_tiers: dict[str, str] | None = None,
                 default_tier: str | None = None,
                 telemetry=None):
        if not tiers:
            raise ValueError("need >= 1 tier")
        self.tiers = dict(tiers)
        self.tenant_tiers = dict(tenant_tiers or {})
        self.default_tier = default_tier or next(iter(self.tiers))
        if self.default_tier not in self.tiers:
            raise ValueError(f"default tier {self.default_tier!r} "
                             f"not in tiers {sorted(self.tiers)}")
        for name in self.tenant_tiers.values():
            if name not in self.tiers:
                raise ValueError(f"tenant tier {name!r} not in tiers")
        self.telemetry = telemetry  # optional TelemetryPlane
        self._cond = threading.Condition()
        self._inflight = {name: 0 for name in self.tiers}
        self._admitted = {name: 0 for name in self.tiers}
        self._rejected = {name: 0 for name in self.tiers}
        self._blocked_s = {name: 0.0 for name in self.tiers}

    def tier_of(self, tenant: str) -> str:
        return self.tenant_tiers.get(tenant, self.default_tier)

    def acquire(self, tenant: str) -> str:
        """Admit one query for ``tenant``; returns the tier name to pass
        to :meth:`release`.  Blocks or raises per the tier's policy."""
        tier = self.tier_of(tenant)
        pol = self.tiers[tier]
        blocked = 0.0
        try:
            with self._cond:
                if self._inflight[tier] >= pol.max_inflight:
                    if pol.on_full == "reject":
                        self._rejected[tier] += 1
                        raise AdmissionError(
                            f"tier {tier!r} at max_inflight="
                            f"{pol.max_inflight} (tenant {tenant!r})")
                    t0 = time.perf_counter()
                    while self._inflight[tier] >= pol.max_inflight:
                        self._cond.wait()
                    blocked = time.perf_counter() - t0
                    self._blocked_s[tier] += blocked
                self._inflight[tier] += 1
                self._admitted[tier] += 1
        except AdmissionError:
            # telemetry outside _cond: the plane has its own lock
            if self.telemetry is not None:
                self.telemetry.record_admission(tenant=tenant, rejected=1)
            raise
        if self.telemetry is not None:
            self.telemetry.record_admission(tenant=tenant, admitted=1,
                                            blocked_s=blocked)
        return tier

    def release(self, tier: str) -> None:
        with self._cond:
            self._inflight[tier] -= 1
            self._cond.notify_all()

    def stats(self) -> dict:
        with self._cond:
            return {
                name: {
                    "inflight": self._inflight[name],
                    "admitted": self._admitted[name],
                    "rejected": self._rejected[name],
                    "blocked_s": round(self._blocked_s[name], 6),
                    "max_inflight": self.tiers[name].max_inflight,
                    "on_full": self.tiers[name].on_full,
                }
                for name in self.tiers
            }


#: the counters of each device cache that ``stats_report`` sums
_PLANE_COUNTERS = ("syncs", "admitted", "uploads", "upload_bytes", "sync_s")


class _SnapshotReaders:
    """Scanner bundle over one pinned snapshot, built lazily per mode.

    Scanners are constructed with ``telemetry=False`` — the engine
    records each query ONCE into the store's plane with the caller's
    tenant, so per-tenant attribution survives the shared bundle.
    """

    def __init__(self, engine: "CiaoServeEngine", snap) -> None:
        self._engine = engine
        self.snap = snap
        self._lock = threading.Lock()
        self._host = None
        self._batch = None
        self._device = None

    @property
    def host(self):
        with self._lock:
            if self._host is None:
                e = self._engine
                if e._sharded:
                    self._host = ShardedScanner(
                        self.snap, log_queries=e.log_queries,
                        cache=e.result_cache, telemetry=False)
                else:
                    self._host = DataSkippingScanner(
                        self.snap, log_queries=e.log_queries,
                        telemetry=False)
            return self._host

    @property
    def batch(self) -> ScanBatcher:
        with self._lock:
            if self._batch is None:
                e = self._engine
                self._batch = ScanBatcher(
                    self.snap, cache=e.result_cache,
                    log_queries=e.log_queries, telemetry=False)
            return self._batch

    @property
    def device(self):
        """The snapshot's device scanner, shared by its readers; its
        ``scan``/``scan_batch`` calls run one at a time."""
        with self._lock:
            if self._device is None:
                e = self._engine
                if e._sharded:
                    self._device = ShardedDeviceScanner(
                        self.snap, backend=e.device_backend,
                        log_queries=e.log_queries, telemetry=False)
                    caches = self._device.caches
                else:
                    self._device = DeviceScanner(
                        self.snap, backend=e.device_backend,
                        log_queries=e.log_queries, telemetry=False,
                        result_cache=e.result_cache)
                    caches = [self._device.cache]
                e._count_planes(self, caches)
            return self._device


class CiaoServeEngine:
    """Concurrent ingest + scan front-end over one CIAO store.

    See the module docstring for the architecture.  The engine presents
    the coordinator-facing ingest surface (``ingest_chunk`` with
    synchronous :class:`~repro_torch.core.server.StaleEpochError` validation,
    ``plan`` / ``family`` for the stale-chunk retry path), so
    :class:`~repro_torch.data.pipeline.IngestCoordinator` can feed it as its
    ``store`` unchanged.

    Parameters:
      * ``queue_depth`` — per-writer bounded queue capacity (slices).
      * ``writers`` — writer-pool size, default one per shard (capped at
        the shard count: shard -> writer assignment is ``s % writers``).
      * ``backpressure`` — ``"block"`` (default) or ``"reject"``.
      * ``admission`` — optional :class:`QueryAdmission`.
      * ``result_cache`` — optional shared
        :class:`~repro_torch.core.batch_scan.ResultCache` (thread-safe).
      * ``device_backend`` — backend for ``mode="device"`` queries:
        ``"cuda"`` (kernel B on the card, the default), ``"torch"`` (its
        plain version on the CPU) or ``"numpy"``.
    """

    def __init__(self, store: "CiaoStore | ShardedCiaoStore", *,
                 queue_depth: int = 64, writers: int | None = None,
                 backpressure: str = "block",
                 admission: QueryAdmission | None = None,
                 result_cache: ResultCache | None = None,
                 device_backend: str = "cuda",
                 eager_promote_uncovered: bool = True,
                 refresh_interval_s: float = 0.02,
                 log_queries: bool = True):
        if backpressure not in ("block", "reject"):
            raise ValueError(f"unknown backpressure policy {backpressure!r}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if device_backend not in ("cuda", "torch", "numpy"):
            raise ValueError(f"unknown device backend {device_backend!r}")
        self.store = store
        self._sharded = isinstance(store, ShardedCiaoStore)
        self._shards = list(store.shards) if self._sharded else [store]
        self.backpressure = backpressure
        self.admission = admission
        if admission is not None and admission.telemetry is None:
            admission.telemetry = getattr(store, "telemetry", None)
        self.result_cache = result_cache
        self.device_backend = device_backend
        # a raw remainder with EMPTY pushed coverage (n_covered == 0) is
        # unskippable by construction — every query must JIT-promote it.
        # Laziness buys no client-assisted savings there, so the writer
        # promotes those groups eagerly at ingest, keeping the decode
        # cost off the snapshot read path (covered remainders stay lazy:
        # their skipping potential is the paper's whole point).
        self.eager_promote_uncovered = eager_promote_uncovered
        self.log_queries = log_queries
        self.writers = max(1, min(len(self._shards),
                                  writers or len(self._shards)))
        self._queues: list[queue.Queue] = [
            queue.Queue(maxsize=int(queue_depth))
            for _ in range(self.writers)
        ]
        self._stats_lock = threading.Lock()
        self.submitted = 0          # chunks accepted by ingest_chunk
        self.enqueued = 0           # per-shard slices enqueued
        self.drained = 0            # slices applied by the writer pool
        self.rejected = 0           # submits refused by backpressure
        self.blocked_s = 0.0        # submit time spent waiting on queues
        self._errors: list[BaseException] = []
        self._closed = False
        # zero reader blocking: readers take self._readers by atomic
        # reference and NEVER rebuild it.  A background refresher
        # re-snapshots at most every refresh_interval_s when the store
        # version moved — under sustained ingest (a version bump per
        # slice) per-query rebuilds would convoy every reader behind
        # writer-held shard locks.  Reads are bounded-stale by the
        # interval; quiesce() forces a synchronous refresh, so
        # read-your-own-quiesced-writes always holds.
        self.refresh_interval_s = float(refresh_interval_s)
        self._snap_lock = threading.Lock()
        self._readers: _SnapshotReaders | None = None
        self.bundles = 0            # snapshot bundles built
        self.capture_s = 0.0        # seconds in their snapshot captures
        self.capture_max_s = 0.0
        # device planes: one finalizer per bundle that built a device
        # scanner (its caches while it lives), the dropped ones' counters
        # summed; an RLock, since a finalizer may run in any thread
        self._planes_lock = threading.RLock()
        self._planes: list[weakref.finalize] = []
        self.device_bundles = 0     # bundles that built a device scanner
        self._retired = dict.fromkeys(_PLANE_COUNTERS, 0)
        self._tuner = None
        self._tuner_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._drain, args=(i,),
                             name=f"ciao-serve-writer-{i}", daemon=True)
            for i in range(self.writers)
        ]
        if self.refresh_interval_s > 0:
            self._threads.append(threading.Thread(
                target=self._refresh_loop, name="ciao-serve-refresher",
                daemon=True))
        for t in self._threads:
            t.start()

    # -- coordinator-facing plan surface --------------------------------------
    @property
    def plan(self):
        return self.store.plan

    @property
    def family(self):
        return self.store.family

    @property
    def epoch(self) -> int:
        return self.store.epoch

    @property
    def stats(self) -> LoadStats:
        return self.store.stats

    # -- ingest (submit side) --------------------------------------------------
    def ingest_chunk(self, chunk, bitvecs, *, epoch: int | None = None,
                     tier: int | None = None,
                     tenant: str = "default") -> LoadStats:
        """Validate, route, and enqueue one chunk; returns live stats.

        Validation is synchronous (stale epochs raise HERE, where the
        coordinator's retry loop can re-evaluate the chunk); the actual
        per-shard ingest happens on the writer pool.  The returned
        :class:`~repro_torch.core.server.LoadStats` is the live aggregate — it
        reflects this chunk only after the writers drain it (callers
        needing post-ingest totals should :meth:`quiesce` first).
        ``tenant`` attributes any backpressure this submit hits to the
        submitting tenant in the store's telemetry plane.
        """
        if self._closed:
            raise RuntimeError("engine is closed")
        store = self.store
        resolve_ingest_coverage(
            store.plan, store.family, n_records=chunk.n_records,
            bitvecs=bitvecs, epoch=epoch, tier=tier)
        if self._sharded and store.n_shards > 1:
            items = [
                (s, sub_chunk, sub_bv, sub_objs, epoch, tier)
                for s, sub_chunk, sub_bv, sub_objs
                in store.route_slices(chunk, bitvecs)
            ]
        else:
            items = [(0, chunk, bitvecs, None, epoch, tier)]
        for item in items:
            self._enqueue(item, tenant)
        with self._stats_lock:
            self.submitted += 1
            self.enqueued += len(items)
        return store.stats

    def _enqueue(self, item, tenant: str = "default") -> None:
        q = self._queues[item[0] % self.writers]
        tele = getattr(self.store, "telemetry", None)
        if self.backpressure == "reject":
            try:
                q.put_nowait(item)
            except queue.Full:
                with self._stats_lock:
                    self.rejected += 1
                if tele is not None:
                    tele.record_backpressure(tenant=tenant, rejected=1)
                raise BackpressureError(
                    f"write queue for shard {item[0]} full "
                    f"(depth {q.maxsize})") from None
        else:
            t0 = time.perf_counter()
            q.put(item)
            dt = time.perf_counter() - t0
            if dt > 0.0:
                with self._stats_lock:
                    self.blocked_s += dt
                if tele is not None:
                    tele.record_backpressure(tenant=tenant, blocked_s=dt)

    # -- ingest (writer pool) --------------------------------------------------
    def _drain(self, wi: int) -> None:
        q = self._queues[wi]
        while True:
            item = q.get()
            try:
                if item is None:
                    return
                self._apply(item)
                with self._stats_lock:
                    self.drained += 1
            except BaseException as e:     # pragma: no cover - defensive
                # post-validation failures are store bugs, not caller
                # errors; record them for quiesce() to surface instead
                # of silently killing the writer
                with self._stats_lock:
                    self._errors.append(e)
            finally:
                q.task_done()

    def _apply(self, item) -> None:
        s, chunk, bv, objs, epoch, tier = item
        if self._sharded and self.store.n_shards > 1:
            self.store.ingest_slice(s, chunk, bv, objs,
                                    epoch=epoch, tier=tier)
            shard = self.store.shards[s]
        else:
            # single store (or 1-shard sharded store): same degenerate
            # path as its own ingest_chunk — no routing parse, no summary
            shard = self._shards[0]
            shard.ingest_chunk(chunk, bv, epoch=epoch, tier=tier)
        if self.eager_promote_uncovered:
            eff = shard.plan.epoch if epoch is None else int(epoch)
            shard.jit_load_raw(only_groups={(eff, 0)})

    def quiesce(self) -> None:
        """Block until every enqueued slice has been applied, then
        refresh the read snapshot; re-raises the first deferred writer
        error, if any.  After quiesce() returns, queries see every
        previously submitted row (read-your-writes)."""
        for q in self._queues:
            q.join()
        self._refresh()
        with self._stats_lock:
            if self._errors:
                raise self._errors[0]

    def advance_epoch(self, new_plan):
        """Quiesce, then install the next plan epoch on the store.

        The quiesce is mandatory: queued slices were validated under the
        old epoch at submit time, and advancing under them would fail
        every one of them at drain time."""
        self.quiesce()
        return self.store.advance_epoch(new_plan)

    # -- snapshot-backed reads ---------------------------------------------
    def _refresh(self) -> None:
        """Swap in a fresh snapshot bundle iff the store version moved.

        Runs on the refresher thread (and synchronously from quiesce /
        the very first read); readers only ever take the resulting
        reference, so a slow rebuild never blocks a query."""
        with self._snap_lock:
            readers = self._readers
            if readers is None or \
                    readers.snap.base_version != self.store.data_version:
                t0 = time.perf_counter()
                snap = self.store.snapshot()
                dt = time.perf_counter() - t0
                self._readers = _SnapshotReaders(self, snap)
                with self._stats_lock:
                    self.bundles += 1
                    self.capture_s += dt
                    self.capture_max_s = max(self.capture_max_s, dt)

    def _count_planes(self, bundle: _SnapshotReaders, caches) -> None:
        """Count a bundle's device caches, now and after it is dropped."""
        with self._planes_lock:
            self.device_bundles += 1
            self._planes = [f for f in self._planes if f.alive]
            fin = weakref.finalize(bundle, self._retire_planes, caches)
            fin.atexit = False
            self._planes.append(fin)

    def _retire_planes(self, caches) -> None:
        with self._planes_lock:
            for k in _PLANE_COUNTERS:
                self._retired[k] += sum(getattr(c, k) for c in caches)

    def _plane_counters(self) -> dict:
        """The device planes' counters: the dropped bundles' and the
        live ones'."""
        with self._planes_lock:
            out = {"device_bundles": self.device_bundles, **self._retired}
            for f in self._planes:
                got = f.peek()
                if got is not None:
                    for k in _PLANE_COUNTERS:
                        out[k] += sum(getattr(c, k) for c in got[2][0])
        return out

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self.refresh_interval_s):
            try:
                self._refresh()
            except BaseException as e:  # pragma: no cover - defensive
                with self._stats_lock:
                    self._errors.append(e)
                return

    def snapshot(self):
        """The engine's current read snapshot (shared, bounded-stale).

        Between refreshes every reader shares one snapshot and its
        scanner bundle (so segment memos and result-cache entries keep
        paying off); staleness is bounded by ``refresh_interval_s``
        under live ingest and by :meth:`quiesce` on demand.
        """
        return self._reader_bundle().snap

    def _reader_bundle(self) -> _SnapshotReaders:
        readers = self._readers
        if readers is None:             # first read builds synchronously
            self._refresh()
            readers = self._readers
        return readers

    def query(self, q: Query, *, tenant: str = "default",
              mode: str = "host") -> ScanResult:
        """COUNT(*) against the current snapshot.

        ``mode``: ``"host"`` (sequential skipping scan / sharded
        scatter-gather), ``"batch"`` (the multi-query batcher, one-query
        batch), or ``"device"`` (device-resident scan plane).  Admission
        control, when configured, gates BEFORE the snapshot is taken.
        """
        return self._admitted(tenant, lambda r: self._scan(r, q, mode, tenant))

    def query_batch(self, queries, *, tenant: str = "default"
                    ) -> list[ScanResult]:
        """N-query batch against ONE consistent snapshot (admitted as a
        single unit of in-flight work)."""
        def run(readers: _SnapshotReaders) -> list[ScanResult]:
            out = readers.batch.scan_batch(queries)
            tele = getattr(self.store, "telemetry", None)
            if tele is not None:
                for r in out:
                    tele.record_scan(r, tenant=tenant)
            return out
        return self._admitted(tenant, run, record=False)

    def _admitted(self, tenant: str, fn, *, record: bool = True):
        tier = self.admission.acquire(tenant) if self.admission else None
        try:
            readers = self._reader_bundle()
            return fn(readers)
        finally:
            if tier is not None:
                self.admission.release(tier)

    def _scan(self, readers: _SnapshotReaders, q: Query,
              mode: str, tenant: str) -> ScanResult:
        if mode == "host":
            r = readers.host.scan(q)
        elif mode == "batch":
            r = readers.batch.scan(q)
        elif mode == "device":
            r = readers.device.scan(q)
        else:
            raise ValueError(f"unknown query mode {mode!r}")
        tele = getattr(self.store, "telemetry", None)
        if tele is not None:
            tele.record_scan(r, tenant=tenant)
        return r

    # -- background physical-design tuning (DESIGN.md §18) -------------------
    def start_tuner(self, tuner, *, interval_s: float = 0.02) -> None:
        """Drive a :class:`~repro_torch.core.tuner.PhysicalDesignTuner` from a
        background thread: one ``tuner.step()`` per ``interval_s`` tick.

        The tuner's migration writer coexists with the writer pool by
        construction — every per-shard mutation on either side happens
        under that shard's ingest lock, and segment moves are fenced
        against ``snapshot()`` — so readers stay non-blocking and counts
        stay exact while rows migrate.  Stopped by :meth:`close`.
        """
        if self._closed:
            raise RuntimeError("engine is closed")
        if self._tuner_thread is not None:
            raise RuntimeError("a tuner is already running")
        self._tuner = tuner
        t = threading.Thread(target=self._tuner_loop,
                             args=(float(interval_s),),
                             name="ciao-serve-tuner", daemon=True)
        self._tuner_thread = t
        t.start()

    def _tuner_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self._tuner.step()
            except BaseException as e:  # pragma: no cover - defensive
                with self._stats_lock:
                    self._errors.append(e)
                return

    # -- lifecycle -----------------------------------------------------------
    def stats_report(self) -> dict:
        """Engine counters + the wrapped store's own report."""
        with self._stats_lock:
            eng = {
                "writers": self.writers,
                "backpressure": self.backpressure,
                "refresh_interval_s": self.refresh_interval_s,
                "submitted": self.submitted,
                "enqueued": self.enqueued,
                "drained": self.drained,
                "rejected": self.rejected,
                "blocked_s": round(self.blocked_s, 6),
                "queue_depths": [q.qsize() for q in self._queues],
                "errors": len(self._errors),
            }
        with self._stats_lock:
            snaps = {"bundles": self.bundles,
                     "capture_s": self.capture_s,
                     "capture_max_s": self.capture_max_s}
        out = {"engine": eng, "snapshots": {**snaps, **self._plane_counters()},
               "store": self.store.stats_report()}
        if self._tuner is not None:
            out["tuner"] = {
                "migrating": bool(getattr(self._tuner, "migrating", False)),
                "events": len(getattr(self._tuner, "history", ())),
            }
        if self.admission is not None:
            out["admission"] = self.admission.stats()
        if self.result_cache is not None:
            out["result_cache"] = {
                "entries": len(self.result_cache),
                "hits": self.result_cache.hits,
                "misses": self.result_cache.misses,
            }
        return out

    def close(self, *, drain: bool = True) -> None:
        """Stop accepting submits, optionally drain, stop the writers."""
        if self._closed:
            return
        self._closed = True
        if drain:
            for q in self._queues:
                q.join()
        self._stop.set()                  # stops the refresher + tuner
        for q in self._queues:
            q.put(None)                   # one sentinel per writer
        for t in self._threads:
            t.join()
        if self._tuner_thread is not None:
            self._tuner_thread.join()
            self._tuner_thread = None

    def __enter__(self) -> "CiaoServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
