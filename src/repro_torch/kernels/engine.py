"""Kernel-backed client engine (implements the core engine protocol).

The whole plan is compiled ONCE into a flat predicate table + clause
membership matrix (:func:`compile_plan`), uploaded once to the engine's
device, and a chunk is evaluated with a single fused pass
(``ops.clause_bitvectors``): the clause OR-combine, bit-packing, load-mask
OR and popcounts all happen on the device (DESIGN.md §3.4).

``backend="cuda"`` (the default) launches the hand-written kernel on a
card and raises where there is none; ``backend="torch"`` runs the plain
PyTorch version on ``device`` (the CPU unless given).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import bitvector
from repro_torch.core.bitvector import ChunkBitvectors
from repro_torch.core.client import Chunk
from repro_torch.core.predicates import Clause

from . import ops
from .plan import CompiledPlan, compile_plan, tier_view  # noqa: F401 (re-export)


class KernelEngine:
    def __init__(self, backend: str = "cuda", r_blk: int = 256, device=None):
        self.device = ops.resolve_device(backend, device)
        self.backend = backend
        self.r_blk = r_blk
        self.name = backend
        self._fields = (ops.UNIQUE_FIELDS if backend == "torch"
                        else ops.KERNEL_FIELDS)
        # clause tuple -> (plan, its tables on the device; the kernel's
        # packed table is built here, once per plan, not per chunk)
        self._plan_cache: dict[tuple[Clause, ...], tuple] = {}
        # (full clause tuple, tier size) -> neutralized subset view; the
        # views share the full plan's shapes
        self._tier_cache: dict[tuple[tuple[Clause, ...], int], tuple] = {}

    def _on_device(self, plan: CompiledPlan) -> tuple:
        return plan, ops.plan_tensors(plan, self._fields, self.device)

    def _compiled(self, clauses: tuple[Clause, ...]) -> tuple:
        entry = self._plan_cache.get(clauses)
        if entry is None:
            entry = self._on_device(compile_plan(clauses))
            if len(self._plan_cache) > 64:  # plans change rarely; bound it
                self._plan_cache.clear()
                self._tier_cache.clear()
            self._plan_cache[clauses] = entry
        return entry

    def _compiled_tier(self, clauses: tuple[Clause, ...],
                       n_clauses: int) -> tuple:
        key = (clauses, n_clauses)
        entry = self._tier_cache.get(key)
        if entry is None:
            entry = self._on_device(
                tier_view(self._compiled(clauses)[0], n_clauses))
            if len(self._tier_cache) > 256:
                self._tier_cache.clear()
            self._tier_cache[key] = entry
        return entry

    def _run(self, chunk: Chunk, entry: tuple):
        plan, tensors = entry
        return ops.clause_bitvectors(
            chunk.data, plan, backend=self.backend, r_blk=self.r_blk,
            device=self.device, tensors=tensors)

    def eval_fused(self, chunk: Chunk, clauses: Sequence[Clause]) -> ChunkBitvectors:
        """One device launch: packed bitvectors + load mask + popcounts."""
        C, R = len(clauses), chunk.n_records
        W = bitvector.num_words(R)
        if C == 0 or R == 0:
            return ChunkBitvectors(
                words=np.zeros((C, W), np.uint32),
                or_words=np.zeros((W,), np.uint32),
                counts=np.zeros((C,), np.int32),
                n_records=R,
            )
        words, or_words, counts = self._run(
            chunk, self._compiled(tuple(clauses)))
        return ChunkBitvectors(
            words=words, or_words=or_words, counts=counts, n_records=R
        )

    def eval_fused_prefix(self, chunk: Chunk, clauses: Sequence[Clause],
                          n_clauses: int) -> ChunkBitvectors:
        """Tiered evaluation: the first ``n_clauses`` of ``clauses``.

        Evaluates a neutralized subset VIEW of the full compiled plan
        (:func:`repro_torch.kernels.plan.tier_view`), so every tier of a
        family shares the full plan's shapes; out-of-tier predicates
        never match.  The returned bitvectors carry exactly ``n_clauses``
        rows and are bit-identical to a direct evaluation of the subset.
        """
        clauses = tuple(clauses)
        C, R = len(clauses), chunk.n_records
        if not 0 <= n_clauses <= C:
            raise ValueError(f"prefix {n_clauses} out of range 0..{C}")
        if n_clauses == C:
            return self.eval_fused(chunk, clauses)
        W = bitvector.num_words(R)
        if n_clauses == 0 or R == 0:
            return ChunkBitvectors(
                words=np.zeros((n_clauses, W), np.uint32),
                or_words=np.zeros((W,), np.uint32),
                counts=np.zeros((n_clauses,), np.int32),
                n_records=R,
            )
        words, or_words, counts = self._run(
            chunk, self._compiled_tier(clauses, n_clauses))
        # out-of-tier clause rows are all-zero by construction: slice them
        # off so the store sees exactly the tier's coverage
        return ChunkBitvectors(
            words=words[:n_clauses], or_words=or_words,
            counts=counts[:n_clauses], n_records=R,
        )

    def eval(self, chunk: Chunk, clauses: Sequence[Clause]) -> np.ndarray:
        fused = self.eval_fused(chunk, clauses)
        return bitvector.unpack(fused.words, chunk.n_records)

    def eval_packed(self, chunk: Chunk, clauses: Sequence[Clause]) -> np.ndarray:
        return self.eval_fused(chunk, clauses).words
