"""CIAO-integrated training-data pipeline (port of ``repro.data.pipeline``).

Flow (DESIGN.md §2):

  client shards (raw JSON) ──chunks+bitvectors──▶ ingest ──▶ CiaoStore
        ──recipe query (bitvector AND + verify)──▶ token batches ──▶ device

Pieces:
  * :class:`ClientShard` — one data client: seeded record stream, chunk
    encoding, client-side predicate evaluation under its budget class.
  * :class:`IngestCoordinator` — pulls chunks from many clients with a
    work-stealing scheduler (straggler mitigation: idle fast clients claim
    pending chunks of the slowest; virtual-time simulated, deterministic).
  * :class:`RecipeBatcher` — data-skipping selection of recipe-matching rows
    from the store, tokenization, fixed-shape (batch, seq) arrays.
  * :class:`Prefetcher` — background-thread double buffering so host-side
    CIAO work overlaps device compute (the paper's latency-hiding bet).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Sequence

import numpy as np

from repro_torch import tracing
from repro_torch.core import bitvector
from repro_torch.core.client import Chunk, encode_chunk
from repro_torch.core.columnar import query_mask
from repro_torch.core.predicates import Query
from repro_torch.core.selection import ClientProfile, TierAllocation, allocate_tiers
from repro_torch.core.server import (
    CiaoStore, PlanFamily, PushdownPlan, StaleEpochError,
)
from repro_torch.core.shard import ShardedCiaoStore
from repro_torch.data.datasets import record_stream
from repro_torch.data.tokenizer import ByteTokenizer

# every store front-end the pipeline drives: the coordinator and batcher
# only touch the shared protocol (ingest_chunk / plan / family / blocks /
# pushed_by_epoch), so a sharded store slots in without pipeline changes —
# the ShardRouter inside ShardedCiaoStore.ingest_chunk fans each chunk out
# to its per-shard segment stores.  The async serving plane's
# CiaoServeEngine (repro_torch.serve.store_engine, DESIGN.md §17) duck-types
# the same ingest surface — validation stays synchronous at submit, so
# the coordinator's StaleEpochError retry loop works against it
# unchanged even though the actual ingest happens on a writer pool.
AnyStore = CiaoStore | ShardedCiaoStore


@dataclass
class ClientShard:
    """One data client with its own seed, engine, speed class, and tier.

    Plans are **hot-swappable** between chunks (:meth:`set_plan` /
    :meth:`set_family`): a replan broadcast lands as a plain attribute
    swap, and the kernel engine compiles and uploads a plan's tables once
    per plan; ALL tiers of one family evaluate neutralized views of the
    full plan's tables (``kernels.plan.tier_view``), so a re-tier builds
    no new plan.  On the card (``KernelEngine("cuda")``) every chunk is
    one launch of the pushdown kernel at the client's tier prefix.

    Each shard accumulates measured eval wall-clock
    (:meth:`observed_us_per_record`) — the cost-model recalibration
    feedback the replanner consumes (paper §V-D).  Measured eval time is
    divided by ``speed``, so a simulated slow device reports
    proportionally slower evaluation; :attr:`cost_scale` tracks an EWMA
    of measured-vs-modeled µs (the allocator's per-client speed signal),
    seeded with the ``1/speed`` prior until real timings arrive.
    """

    dataset: str
    shard_id: int
    engine: object                      # core engine protocol
    plan: PushdownPlan
    chunk_records: int = 512
    speed: float = 1.0                  # relative records/sec (straggler sim)
    family: PlanFamily | None = None    # tiered deployments only
    tier: int = 0
    cost_ewma_alpha: float = 0.3
    # optional core.telemetry.TelemetryPlane (typically the store's):
    # every evaluation reports its measured wall-clock there, feeding
    # FleetTierAllocator measured per-client rates (DESIGN.md §16)
    telemetry: object | None = None

    def __post_init__(self) -> None:
        self._stream = record_stream(self.dataset, seed=1000 + self.shard_id)
        self.eval_time_s = 0.0
        self.eval_records = 0
        self.cost_scale = 1.0 / self.speed
        if self.family is not None:
            self.set_family(self.family, self.tier)

    def set_plan(self, plan: PushdownPlan) -> None:
        """Epoch bump: evaluate every subsequent chunk under ``plan``."""
        self.plan = plan
        self.family = None
        self.tier = 0

    def set_family(self, family: PlanFamily, tier: int | None = None) -> None:
        """Tiered epoch bump and/or re-tier: evaluate the tier's prefix."""
        self.family = family
        self.plan = family.plan
        if tier is not None:
            self.set_tier(tier)
        elif self.tier >= family.n_tiers:
            self.tier = family.top_tier

    def set_tier(self, tier: int) -> None:
        if self.family is None:
            raise ValueError("set_tier needs a PlanFamily (set_family first)")
        if not 0 <= tier < self.family.n_tiers:
            raise ValueError(
                f"tier {tier} out of range: family has "
                f"{self.family.n_tiers} tiers")
        self.tier = tier

    @property
    def tier_size(self) -> int:
        if self.family is None:
            return self.plan.n
        return self.family.tier_sizes[self.tier]

    def evaluate(self, chunk: Chunk) -> bitvector.ChunkBitvectors:
        """Tier-aware fused evaluation of one chunk, timed and accounted.

        The single eval dispatch for BOTH the normal produce path and the
        coordinator's stale-epoch retry: every evaluation — retries
        included — lands in ``eval_time_s`` / the cost-scale EWMA, so the
        allocator's per-client speed signal sees all the work done.
        """
        t0 = time.perf_counter()
        if self.family is not None:
            prefix = getattr(self.engine, "eval_fused_prefix", None)
            if prefix is not None:
                bv = prefix(chunk, self.plan.clauses, self.tier_size)
            else:
                bv = self.engine.eval_fused(
                    chunk, self.plan.clauses[: self.tier_size])
        else:
            bv = self.engine.eval_fused(chunk, self.plan.clauses)
        dt = (time.perf_counter() - t0) / self.speed
        self.eval_time_s += dt
        self.eval_records += chunk.n_records
        self._update_cost_scale(dt, chunk.n_records)
        if self.telemetry is not None:
            self.telemetry.record_client_eval(
                self.shard_id, dt, chunk.n_records)
        return bv

    def next_chunk(self) -> tuple[Chunk, bitvector.ChunkBitvectors]:
        recs = [next(self._stream) for _ in range(self.chunk_records)]
        chunk = encode_chunk(recs)
        # fused single-pass evaluation: the ingest load mask ships
        # precomputed alongside the bitvectors (one launch on kernel engines)
        return chunk, self.evaluate(chunk)

    def _update_cost_scale(self, eval_s: float, n_records: int) -> None:
        modeled = 0.0
        if self.family is not None and self.family.tier_costs:
            modeled = self.family.tier_costs[self.tier]
        if modeled <= 0.0 or n_records <= 0:
            return  # empty tier / no cost model: keep the current estimate
        sample = (eval_s / n_records * 1e6) / modeled
        a = self.cost_ewma_alpha
        self.cost_scale = (1.0 - a) * self.cost_scale + a * sample

    def observed_us_per_record(self) -> float:
        if not self.eval_records:
            return 0.0
        return self.eval_time_s / self.eval_records * 1e6


@dataclass(order=True)
class _Pending:
    ready_at: float
    seq: int
    client_idx: int = field(compare=False)


class FleetTierAllocator:
    """Splits a global client-cost budget across a heterogeneous fleet.

    Wraps :func:`repro_torch.core.selection.allocate_tiers` with the live
    signals the pipeline produces: each shard's ``cost_scale`` (measured
    µs per modeled µs, EWMA over its timing reports — the ``1/speed``
    prior until data arrives) and its record rate as the weight.  The
    budget is the fleet-record-weighted average client µs/record: with
    weights normalized to sum 1, ``sum_j w_j * scale_j * tier_cost[t_j]``
    must stay under ``budget_us``.

    Re-tiering: every ``retier_every_records`` ingested records the
    allocation is re-solved from the current cost scales; if any shard's
    tier changes the new assignment is applied in place (a tier change
    within one family needs no epoch bump — the store validates coverage
    per chunk, and kernel engines share one plan table across tiers).
    """

    def __init__(self, family: PlanFamily, budget_us: float, *,
                 retier_every_records: int = 4096,
                 telemetry: object | None = None):
        if not family.tier_costs:
            raise ValueError(
                "allocator needs a family with tier_costs "
                "(build it via planner.build_plan_family)")
        self.family = family
        self.budget_us = float(budget_us)
        self.retier_every_records = retier_every_records
        self.allocation: TierAllocation | None = None
        self.retier_events = 0
        self._records_since = 0
        # optional core.telemetry.TelemetryPlane: when attached (and fed
        # by ClientShard.evaluate reports), profiles() weights clients by
        # their MEASURED record rates instead of the speed*chunk prior
        self.telemetry = telemetry

    def profiles(self, clients: Sequence[ClientShard]) -> list[ClientProfile]:
        rates = []
        for c in clients:
            rate = max(c.speed * c.chunk_records, 1e-12)  # modeled prior
            if self.telemetry is not None:
                m = self.telemetry.client_eval(c.shard_id)
                if m is not None and m["records_per_s"] > 0:
                    rate = m["records_per_s"]             # measured
            rates.append(rate)
        rates = np.array(rates)
        weights = rates / rates.sum()
        return [
            ClientProfile(cost_scale=c.cost_scale, weight=float(w))
            for c, w in zip(clients, weights)
        ]

    def assign(self, clients: Sequence[ClientShard]) -> TierAllocation:
        """Solve the allocation and apply it to every shard."""
        alloc = allocate_tiers(
            self.family.tier_costs, self.family.tier_values,
            self.profiles(clients), self.budget_us,
        )
        for c, t in zip(clients, alloc.tiers):
            c.set_family(self.family, t)
        self.allocation = alloc
        return alloc

    def set_family(self, family: PlanFamily,
                   clients: Sequence[ClientShard]) -> TierAllocation:
        """Epoch bump: re-solve tiers for the new family and broadcast."""
        self.family = family
        self._records_since = 0
        return self.assign(clients)

    def on_records(self, n: int, clients: Sequence[ClientShard]) -> bool:
        """Cost-drift re-tiering hook; returns True when tiers changed."""
        self._records_since += n
        if self._records_since < self.retier_every_records:
            return False
        self._records_since = 0
        before = [c.tier for c in clients]
        self.assign(clients)
        if [c.tier for c in clients] != before:
            self.retier_events += 1
            return True
        return False


class IngestCoordinator:
    """Work-stealing chunk scheduler over N clients (virtual time).

    Each client owns a backlog of `chunks_per_client` chunk slots.  A chunk
    produced by client i takes 1/speed_i virtual seconds.  When a fast client
    drains its backlog it steals a slot from the most-backlogged client and
    produces that chunk itself (clients are stateless record producers in
    this simulation, so stealing = re-assigning the production slot).  This
    bounds makespan by the fastest clients instead of the slowest — the
    framework's straggler-mitigation story, testable without wall-clock.

    ``store`` may be a :class:`ShardedCiaoStore` (DESIGN.md §14): ingest
    then routes each chunk's records through the store's ``ShardRouter``
    to N per-shard segment stores, and the replanner keeps consuming the
    same feedback surface (per-shard observed selectivities are
    aggregated into exact fleet totals on read).
    """

    def __init__(self, clients: Sequence[ClientShard], store: AnyStore,
                 *, steal: bool = True, replanner=None,
                 allocator: FleetTierAllocator | None = None,
                 eval_cost_weight: float = 0.0,
                 on_chunk: Callable[[int], None] | None = None):
        self.clients = list(clients)
        self.store = store
        self.steal = steal
        self.replanner = replanner          # core.replan.Replanner protocol
        self.allocator = allocator          # tiered fleets only
        # virtual seconds added per measured eval second: with a non-zero
        # weight, client-side plan evaluation slows chunk delivery in the
        # virtual-time model (the paper's client-cost side of the
        # trade-off); 0 preserves the pure production-rate simulation
        self.eval_cost_weight = eval_cost_weight
        self.on_chunk = on_chunk            # called with #chunks ingested
        self.stolen = 0
        self.makespan = 0.0
        self.epoch_bumps = 0
        if allocator is not None:
            allocator.assign(self.clients)

    def _broadcast(self, plan) -> None:
        """Epoch bump: every shard evaluates subsequent chunks under it.

        A :class:`PlanFamily` bump re-runs the tier allocator (tier
        assignments are family-relative); a bare plan swaps untiered.
        """
        if isinstance(plan, PlanFamily):
            if self.allocator is not None:
                self.allocator.set_family(plan, self.clients)
            else:
                for c in self.clients:
                    c.set_family(plan)
        else:
            for c in self.clients:
                c.set_plan(plan)
        self.epoch_bumps += 1

    def run(self, chunks_per_client: int) -> None:
        backlog = [chunks_per_client for _ in self.clients]
        clock = [0.0 for _ in self.clients]
        total = chunks_per_client * len(self.clients)
        done = 0
        while done < total:
            # next client to finish a chunk = argmin over clock+1/speed
            i = min(
                range(len(self.clients)),
                key=lambda k: clock[k] + 1.0 / self.clients[k].speed
                if backlog[k] > 0 or (self.steal and max(backlog) > 0)
                else float("inf"),
            )
            if backlog[i] == 0:
                if not self.steal:
                    continue
                j = int(np.argmax(backlog))
                if backlog[j] == 0:
                    break
                backlog[j] -= 1
                self.stolen += 1
            else:
                backlog[i] -= 1
            client = self.clients[i]
            eval_before = client.eval_time_s
            # tier coverage of THIS evaluation (the client may be
            # re-tiered later in the loop): the replanner's cost
            # recalibration must predict over the same clause prefix
            n_eval = (client.tier_size if client.family is not None
                      else None)
            chunk, bv = client.next_chunk()
            # plan-eval wall-clock only (the shard times eval_fused
            # itself) — record generation/encoding must not leak into the
            # replanner's cost-model recalibration
            eval_s = client.eval_time_s - eval_before
            # chunks carry their evaluation (epoch, tier); the window
            # between a broadcast and a client's next chunk is where
            # staleness lives, so a StaleEpochError re-evaluates under the
            # current plan/family (tier carries over, clamped)
            tier = client.tier if client.family is not None else None
            try:
                self.store.ingest_chunk(chunk, bv,
                                        epoch=client.plan.epoch, tier=tier)
            except StaleEpochError:
                if client.family is not None:
                    client.set_family(self.store.family)
                    tier = client.tier
                else:
                    client.set_plan(self.store.plan)
                    tier = None
                bv = client.evaluate(chunk)
                self.store.ingest_chunk(chunk, bv,
                                        epoch=client.plan.epoch, tier=tier)
            # eval_s is already speed-scaled by the shard (slow devices
            # evaluate slower), so it adds directly on top of the
            # production slot
            clock[i] += 1.0 / client.speed + self.eval_cost_weight * eval_s
            done += 1
            if self.on_chunk is not None:
                self.on_chunk(done)
            if self.replanner is not None:
                self.replanner.observe_timing(chunk.n_records, eval_s,
                                              n_clauses=n_eval)
                new_plan = self.replanner.step()
                if new_plan is not None:
                    self._broadcast(new_plan)
            if self.allocator is not None:
                self.allocator.on_records(chunk.n_records, self.clients)
        self.makespan = max(clock)


#: the telemetry tenant under which :class:`RecipeBatcher` counts its rows
RECIPE_TENANT = "recipe"


def _record_segment(telemetry, seg, pushed, mask) -> None:
    """One segment's rows and itself, counted as the store's scan counts
    them in its ``ScanResult`` (``DataSkippingScanner._scan_segment``);
    the segment memoizes its candidate count, so later passes count no
    bits."""
    if mask is None:
        telemetry.record_rows(tenant=RECIPE_TENANT, rows_skipped=seg.n_rows,
                              segments_pruned=1)
        return
    cand = seg.pushed_count(pushed) if pushed else seg.n_rows
    telemetry.record_rows(tenant=RECIPE_TENANT, rows_scanned=cand,
                          rows_skipped=seg.n_rows - cand, segments_scanned=1)


class RecipeBatcher:
    """Turns recipe-matching store rows into fixed-shape token batches.

    Each pass over the store folds its rows scanned and skipped, segment
    by segment, into the store's telemetry plane under
    :data:`RECIPE_TENANT` (``TelemetryPlane.record_rows``), and each batch
    is made inside a ``data.batch`` span (:mod:`repro_torch.tracing`).
    """

    def __init__(self, store: AnyStore, tokenizer: ByteTokenizer,
                 *, seq_len: int, batch_size: int):
        self.store = store
        self.tok = tokenizer
        self.seq_len = seq_len
        self.batch_size = batch_size

    def matching_records(self, recipe: Query) -> Iterator[bytes]:
        # coverage-aware skipping: each segment's bitvector rows follow
        # ITS ingest epoch's plan AND its tier's coverage prefix; raw
        # remainders are JIT-promoted only for (epoch, coverage) groups
        # that push none of the recipe — the skippability invariant is
        # single-sourced in the store's query-path helpers.  Matching is
        # the columnar engine's vectorized exact mask (zone-map prune +
        # bitvector AND + column evaluation), and hits stream the
        # segment's RAW source bytes — no json.dumps round-trip per row.
        store = self.store
        pushed_by_epoch = store.pushed_by_epoch(recipe)
        for seg in store.blocks:
            pushed = pushed_by_epoch[(seg.epoch, seg.n_covered)]
            mask = query_mask(seg, recipe, pushed)
            _record_segment(store.telemetry, seg, pushed, mask)
            if mask is None:                  # zone-map pruned whole
                continue
            for i in np.nonzero(mask)[0]:
                yield seg.record(i)
        store.promote_uncovered_raw(pushed_by_epoch)
        for seg in store.jit_blocks:
            if pushed_by_epoch[(seg.epoch, seg.n_covered)]:
                store.telemetry.record_rows(tenant=RECIPE_TENANT,
                                            rows_skipped=seg.n_rows)
                continue
            mask = query_mask(seg, recipe)
            _record_segment(store.telemetry, seg, (), mask)
            if mask is None:
                continue
            for i in np.nonzero(mask)[0]:
                yield seg.record(i)

    def _rows(self, recipe: Query, repeat: bool) -> Iterator[bytes]:
        """The recipe's rows, pass after pass while ``repeat``; ends after
        a pass that found none."""
        while True:
            made_any = False
            for rec in self.matching_records(recipe):
                made_any = True
                yield rec
            if not repeat or not made_any:
                return

    def batches(self, recipe: Query, *, repeat: bool = True
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yields (tokens, loss_mask) of shape (batch, seq_len): packed docs."""
        n = self.batch_size * self.seq_len
        rows = self._rows(recipe, repeat)
        buf: list[int] = []
        while True:
            with tracing.span("data.batch"):
                while len(buf) < n:
                    rec = next(rows, None)
                    if rec is None:
                        return
                    buf.extend(self.tok.encode(rec).tolist())
                flat = np.array(buf[:n], dtype=np.int32)
                del buf[:n]
                tokens = flat.reshape(self.batch_size, self.seq_len)
                mask = np.ones_like(tokens, dtype=np.float32)
            yield tokens, mask


class Prefetcher:
    """Double-buffered background prefetch (host CIAO work ∥ device step).

    Context-manager aware: an abandoned consumer must call :meth:`close`
    (or use ``with``) so the worker thread — possibly blocked on a full
    queue — is released instead of parking forever.  ``close`` also
    re-raises any exception the worker hit, so failures in a pipeline
    whose consumer stopped early still surface instead of being silently
    dropped with the thread.
    """

    _POLL_S = 0.05
    _JOIN_S = 5.0

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._err_raised = False

        def _put(item) -> bool:
            """Bounded put that gives up when the consumer closed us."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=self._POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def worker() -> None:
            try:
                for item in it:
                    if not _put(item):
                        return  # closed mid-stream: drop the rest
            except BaseException as e:  # propagate to consumer
                self._err = e
            finally:
                _put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration  # closed: the buffer was already dropped
        item = self._q.get()
        if item is self._done:
            if self._err is not None and not self._err_raised:
                self._err_raised = True
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Release the worker thread; re-raise its pending exception.

        Idempotent.  Safe to call with items still buffered: the worker's
        blocked ``put`` observes the stop flag within one poll interval
        and exits, the buffer is drained and dropped.  A worker that is
        stuck INSIDE the wrapped iterator (not in our queue handoff)
        cannot be released from Python — that raises instead of returning
        as if the thread were gone (its later exception would otherwise
        vanish with the daemon thread).
        """
        self._stop.set()
        while True:  # drain so a worker blocked pre-stop wakes immediately
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._t.join(timeout=self._JOIN_S)
        if self._err is not None and not self._err_raised:
            self._err_raised = True
            raise self._err
        if self._t.is_alive():
            raise RuntimeError(
                f"prefetch worker still running inside the wrapped iterator "
                f"after {self._JOIN_S}s — it cannot be released and any "
                "future failure in it will be lost")

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            # don't mask the consumer's exception with the worker's
            self._stop.set()
            self._t.join(timeout=5.0)
            return
        self.close()
