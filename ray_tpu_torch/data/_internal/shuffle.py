"""All-to-all exchange ops: repartition, random_shuffle, sort.

Reference: ``python/ray/data/_internal/planner/exchange/`` — two-phase
map/reduce exchanges over block refs. Map tasks partition each input
block; reduce tasks concatenate assigned partitions. All phases are
remote tasks; the driver only routes refs.
"""

from __future__ import annotations

import random
from typing import Any, List, Optional, Tuple

import numpy as np
import pyarrow as pa

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor


def _rows(block: Block) -> int:
    return block.num_rows


def _slice_spans(block: Block, spans: List[Tuple[int, int]]) -> List[Block]:
    acc = BlockAccessor(block)
    return [acc.slice(s, e) for s, e in spans]


def _slice_one(block: Block, s: int, e: int) -> Block:
    return BlockAccessor(block).slice(s, e)


def _concat(*blocks: Block) -> Block:
    return BlockAccessor.concat(list(blocks))


def _concat_sorted(key: str, descending: bool, *blocks: Block) -> Block:
    merged = BlockAccessor.concat(list(blocks))
    if merged.num_rows == 0 or key not in merged.column_names:
        return merged
    order = "descending" if descending else "ascending"
    return merged.sort_by([(key, order)])


def _partition_random(block: Block, n: int, seed: Optional[int]) -> List[Block]:
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, n, block.num_rows)
    acc = BlockAccessor(block)
    return [acc.take(np.nonzero(assignment == i)[0]) for i in range(n)]


def _shuffle_rows(block: Block, seed: Optional[int]) -> Block:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(block.num_rows)
    return BlockAccessor(block).take(perm)


def _partition_by_bounds(block: Block, key: str, bounds: List[Any],
                         descending: bool) -> List[Block]:
    acc = BlockAccessor(block)
    if key not in block.column_names:
        # Schema-less empty block (e.g. a fully-filtered map output):
        # contributes nothing to any partition.
        empty = block.slice(0, 0)
        return [empty for _ in range(len(bounds) + 1)]
    col = block[key].to_numpy(zero_copy_only=False)
    idx = np.searchsorted(np.asarray(bounds), col, side="right")
    if descending:
        idx = len(bounds) - idx
    return [acc.take(np.nonzero(idx == i)[0])
            for i in range(len(bounds) + 1)]


def _sample_keys(block: Block, key: str, k: int) -> List[Any]:
    if key not in block.column_names:
        return []
    col = block[key].to_numpy(zero_copy_only=False)
    if len(col) == 0:
        return []
    rng = np.random.default_rng(0)
    take = rng.choice(len(col), size=min(k, len(col)), replace=False)
    return sorted(col[take].tolist())


_remote_cache = {}


def _r(fn):
    if fn not in _remote_cache:
        _remote_cache[fn] = ray_tpu_torch.remote(num_cpus=1)(fn)
    return _remote_cache[fn]


def repartition(refs: List[Any], num_blocks: int) -> List[Any]:
    """Equal-row re-split (reference ``RepartitionTaskSpec``)."""
    counts = ray_tpu_torch.get([_r(_rows).remote(ref) for ref in refs])
    return _repartition_planned(refs, counts, num_blocks)


def repartition_to_counts(refs: List[Any],
                          counts: List[int]) -> List[Any]:
    """Re-split ``refs`` so output block i has exactly counts[i] rows
    (used by zip to align the right side with the left's layout)."""
    have = ray_tpu_torch.get([_r(_rows).remote(ref) for ref in refs])
    if sum(have) != sum(counts):
        raise ValueError(
            f"Cannot align datasets: {sum(have)} vs {sum(counts)} rows")
    out = []
    ref_i, offset = 0, 0
    for need in counts:
        parts = []
        while need > 0:
            avail = have[ref_i] - offset
            take = min(avail, need)
            if take > 0:
                parts.append(_r(_slice_one).remote(
                    refs[ref_i], offset, offset + take))
                offset += take
                need -= take
            if offset >= have[ref_i] and ref_i + 1 < len(refs):
                ref_i += 1
                offset = 0
            elif avail <= 0:
                break
        out.append(_r(_concat).remote(*parts) if len(parts) != 1
                   else parts[0])
    return out


# ---------------------------------------------------- streaming exchange
# Reference: python/ray/data/_internal/planner/exchange/ — the map phase
# of an exchange runs per input block and the reference's streaming
# executor feeds it blocks as upstream tasks finish. The functions below
# take the upstream REF ITERATOR (not a materialized list): map-side
# tasks launch the moment each block materializes, overlapping upstream
# production; only the reduce phase is a true barrier (inherent to an
# all-to-all). Peak driver state is one ref per partition slice — block
# BYTES live in the object store and spill when the budget is exceeded.

def streaming_random_shuffle(ref_iter, seed: Optional[int] = None,
                             num_blocks: Optional[int] = None,
                             count_hint: Optional[int] = None) -> List[Any]:
    n_out = num_blocks or count_hint
    if n_out is None:
        # unknown upstream cardinality (e.g. after limit): drain first
        refs = list(ref_iter)
        n_out = max(1, len(refs))
        ref_iter = iter(refs)
    n_out = max(1, n_out)
    parts: List[List[Any]] = [[] for _ in range(n_out)]
    for i, ref in enumerate(ref_iter):
        s = None if seed is None else seed + i
        part_refs = _r(_partition_random).options(
            num_returns=n_out).remote(ref, n_out, s)
        if n_out == 1:
            part_refs = [part_refs]
        for j, pr in enumerate(part_refs):
            parts[j].append(pr)
    out = []
    for j, plist in enumerate(parts):
        s = None if seed is None else seed + 10_000 + j
        if not plist:
            out.append(_r(_concat).remote())
            continue
        merged = _r(_concat).remote(*plist)
        out.append(_r(_shuffle_rows).remote(merged, s))
    return out


def streaming_sort(ref_iter, key: str,
                   descending: bool = False) -> List[Any]:
    """Sample-as-they-arrive range sort: the sampling pass overlaps
    upstream production; partitioning starts once bounds are known."""
    refs: List[Any] = []
    sample_refs: List[Any] = []
    for ref in ref_iter:
        refs.append(ref)
        sample_refs.append(_r(_sample_keys).remote(ref, key, 16))
    if not refs:
        return refs
    n_out = len(refs)
    samples = ray_tpu_torch.get(sample_refs)
    flat = sorted(x for s in samples for x in s)
    if not flat:
        return refs
    bounds = [flat[int(len(flat) * (i + 1) / n_out)]
              for i in range(n_out - 1)
              if int(len(flat) * (i + 1) / n_out) < len(flat)]
    n_parts = len(bounds) + 1
    parts: List[List[Any]] = [[] for _ in range(n_parts)]
    for ref in refs:
        part_refs = _r(_partition_by_bounds).options(
            num_returns=n_parts).remote(ref, key, bounds, descending)
        if n_parts == 1:
            part_refs = [part_refs]
        for j, pr in enumerate(part_refs):
            parts[j].append(pr)
    return [_r(_concat_sorted).remote(key, descending, *plist)
            for plist in parts]


def streaming_repartition(ref_iter, num_blocks: int) -> List[Any]:
    """Row counting overlaps upstream production; the span plan and
    slicing run once every count is known."""
    refs: List[Any] = []
    count_refs: List[Any] = []
    for ref in ref_iter:
        refs.append(ref)
        count_refs.append(_r(_rows).remote(ref))
    if not refs:
        return refs
    # reuse the span planner on the materialized (ref, count) lists
    return _repartition_planned(refs, ray_tpu_torch.get(count_refs),
                                num_blocks)


def _repartition_planned(refs: List[Any], counts: List[int],
                         num_blocks: int) -> List[Any]:
    if num_blocks <= 0:
        raise ValueError("num_blocks must be > 0")
    total = sum(counts)
    base, extra = divmod(total, num_blocks)
    targets = [base + (1 if i < extra else 0) for i in range(num_blocks)]
    out_spans: List[List[Tuple[int, Tuple[int, int]]]] = [
        [] for _ in range(num_blocks)]
    ref_i, offset = 0, 0
    for out_i, need in enumerate(targets):
        while need > 0 and ref_i < len(refs):
            avail = counts[ref_i] - offset
            take = min(avail, need)
            if take > 0:
                out_spans[out_i].append((ref_i, (offset, offset + take)))
                offset += take
                need -= take
            if offset >= counts[ref_i]:
                ref_i += 1
                offset = 0
    per_ref_spans: List[List[Tuple[int, int]]] = [[] for _ in refs]
    span_pos = {}
    for out_i, spans in enumerate(out_spans):
        for ref_i, (s, e) in spans:
            span_pos[(out_i, ref_i, s, e)] = len(per_ref_spans[ref_i])
            per_ref_spans[ref_i].append((s, e))
    sliced = []
    for i, spans in enumerate(per_ref_spans):
        if not spans:
            sliced.append(None)
        elif len(spans) == 1:
            s, e = spans[0]
            sliced.append([_r(_slice_one).remote(refs[i], s, e)])
        else:
            sliced.append(_r(_slice_spans).options(
                num_returns=len(spans)).remote(refs[i], spans))

    def span_ref(out_i, ref_i, s, e):
        return sliced[ref_i][span_pos[(out_i, ref_i, s, e)]]

    out = []
    for out_i, spans in enumerate(out_spans):
        part_refs = [span_ref(out_i, ref_i, s, e)
                     for ref_i, (s, e) in spans]
        if not part_refs:
            out.append(_r(_concat).remote())
        elif len(part_refs) == 1:
            out.append(part_refs[0])
        else:
            out.append(_r(_concat).remote(*part_refs))
    return out
