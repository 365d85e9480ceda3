"""Batched PSI round executor: the port of ``repro.psi.engine``.

The host protocol layer (``repro_torch.core.tpsi``/``mpsi``) keeps the
sequential bigint work (RSA blind/sign/unblind) and the wire
accounting; this engine takes the data-parallel remainder of every
concurrent pair of an MPSI round, pads all pairs to one (pairs, P)
batch, and runs it on the device:

  oprf_round  : ids --psi_prf kernel--> 62-bit tags --sort-->
                --sorted_intersect kernel--> matched receiver ids
  match_round : host-computed tags (e.g. truncated RSA signatures)
                --host sort--> --sorted_intersect kernel--> matched ids
  union_merge : two sorted tag runs --sorted_intersect kernel--> their
                merged keys (delta-PSI compaction)

Sorting between tag evaluation and merge (``sort=``):

  "device"  one round trip: the PRF kernel over all sides of all pairs,
            ``torch.sort(stable=True)`` of the valid prefix of the
            packed keys ``(tag << 1) | origin`` (below 2^63, so signed
            order is unsigned order), the merge kernel, and id recovery
            ``rank - 1 -> perm -> ids`` on the device.  The pad
            sentinels have the top bit set and are negative as int64,
            so they are never sorted with the valid keys: the pad
            positions sort as INT64_MAX (stably after every valid key)
            and are overwritten with the sentinels afterwards.
  "host"    two dispatches with a numpy u64 sort between them (the
            reference's ``_host_sorted_merge``).

The default is "device" on CUDA and "host" on the CPU.

Sharding (``options.mesh``): a round's pairs split over one mesh dim
(``options.shard_axis`` or ``data``; ``repro_torch.sharding``).  The
pair list pads to a multiple of the dim's size with row-0 filler, each
rank runs its block of pairs through the same per-pair program at the
round's P (every pair of a round pads to the same P on every rank), and
the ragged intersections are all-gathered as one (pairs, 1 + P) int64
block (the length, then the ids) and truncated, so every rank returns
the round's intersections, byte-identical to the unsharded round.
``union_merge`` runs its one pair on every rank unsharded.

Id recovery:
``rank`` is the receiver-key count in merged order, so a selected slot's
id is ``receiver_ids_by_tag[rank - 1]``.

Preconditions: ids are unique per set (tpsi dedups at protocol entry)
and non-negative int64; tags live in [0, 2^62).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import AlignOptions, resolve_device, resolve_impl
from repro_torch.kernels.psi_prf.ops import prf_tags
from repro_torch.kernels.sorted_intersect.ops import (PAD_A64, PAD_B64,
                                                      next_pow2, pack_keys,
                                                      sorted_intersect)
from repro_torch.obs.trace import span
from repro_torch.sharding import (MeshAxis, all_gather_rows, my_rows,
                                  resolve_batch_mesh)

TAG_MASK = (1 << 62) - 1     # engine tag space: 62-bit
_INT64_MAX = 2 ** 63 - 1


def tag_words(x: int) -> int:
    """Map an arbitrary host integer (e.g. an RSA signature) into the
    engine's 62-bit tag space."""
    return x & TAG_MASK


@dataclasses.dataclass
class EngineRound:
    intersections: List[np.ndarray]   # per pair: sorted unique int64 ids
    device_seconds: float             # dispatches + in-between host sort
    dispatches: int = 1
    shards: int = 1                   # mesh-dim size the pairs split over


def _default_sort(sort: Optional[str], device: torch.device) -> str:
    return sort or ("device" if device.type == "cuda" else "host")


def _pack(sets: Sequence[np.ndarray], p: int) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """List of (n_i,) int64 -> ((B, P) int64 zero-padded, (B,) lengths)."""
    ids = np.zeros((len(sets), p), np.int64)
    n = np.zeros((len(sets),), np.int64)
    for i, s in enumerate(sets):
        ids[i, :len(s)] = s
        n[i] = len(s)
    return ids, n


def _host_key_row(tag64_sorted: np.ndarray, origin: int, pad: int, p: int
                  ) -> np.ndarray:
    """Sorted u64 tags -> one padded (P,) int64 key row."""
    key = (tag64_sorted.astype(np.uint64) << np.uint64(1)) | np.uint64(origin)
    row = np.full((p,), pad, np.int64)
    row[:len(key)] = key.astype(np.int64)
    return row


def _host_sorted_merge(r_tags64: Sequence[np.ndarray],
                       receiver_ids: Sequence[np.ndarray],
                       s_tags64: Sequence[np.ndarray], p: int,
                       device: torch.device, impl: str) -> List[np.ndarray]:
    """Host-sort path shared by oprf_round and match_round: numpy-sort
    each pair's u64 tags, pack the padded key batch, run the merge on
    the device, and recover ids from (sel, rank)."""
    b = len(r_tags64)
    a_keys = np.empty((b, p), np.int64)
    b_keys = np.empty((b, p), np.int64)
    ids_by_tag: List[np.ndarray] = []
    with span("align.host_sort", pairs=b, p=p):
        for i in range(b):
            order = np.argsort(r_tags64[i])
            ids_by_tag.append(np.asarray(receiver_ids[i], np.int64)[order])
            a_keys[i] = _host_key_row(r_tags64[i][order], 1, PAD_A64, p)
            b_keys[i] = _host_key_row(np.sort(s_tags64[i]), 0, PAD_B64, p)
    with span("align.dispatch", kind="merge", pairs=b, p=p):
        sel, rank, _ = sorted_intersect(
            torch.from_numpy(a_keys).to(device),
            torch.from_numpy(b_keys).to(device), impl=impl)
        sel = sel.cpu().numpy().astype(bool)
        rank = rank.cpu().numpy()
    return [np.sort(ids_by_tag[i][rank[i][sel[i]] - 1]) for i in range(b)]


def _oprf_single(r_ids: torch.Tensor, r_n: torch.Tensor,
                 s_ids: torch.Tensor, s_n: torch.Tensor,
                 seeds: torch.Tensor, impl: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-sort path: PRF of both sides, valid-prefix sort, merge and
    id recovery.  Returns (B, 2P) (sel, candidate receiver id)."""
    b, p = r_ids.shape
    tags = prf_tags(torch.cat([r_ids, s_ids]), torch.cat([seeds, seeds]),
                    impl=impl)
    keys = torch.cat([pack_keys(tags[:b], 1), pack_keys(tags[b:], 0)])
    n = torch.cat([r_n, s_n])
    valid = torch.arange(p, device=keys.device)[None, :] < n[:, None]
    keys, perm = torch.sort(torch.where(valid, keys, _INT64_MAX), dim=1,
                            stable=True)
    pads = torch.cat([torch.full((b, 1), PAD_A64, device=keys.device),
                      torch.full((b, 1), PAD_B64, device=keys.device)])
    keys = torch.where(valid, keys, pads)
    sel, rank, _ = sorted_intersect(keys[:b].contiguous(),
                                    keys[b:].contiguous(), impl=impl)
    by_tag = (rank.to(torch.int64) - 1).clamp(0, p - 1)
    src = torch.gather(perm[:b], 1, by_tag)      # merged slot -> receiver row
    return sel, torch.gather(r_ids, 1, src)


def _batch_axis(options: AlignOptions) -> Tuple[Optional[MeshAxis], int]:
    """The mesh dim a round's pairs split over (None unsharded), and its
    size."""
    mesh, axis, n = resolve_batch_mesh(options.mesh, options.shard_axis)
    return (None if mesh is None else MeshAxis(mesh, axis)), n


def _gather_intersections(inters: List[np.ndarray],
                          axis: Optional[MeshAxis], p: int, b: int,
                          device: torch.device) -> List[np.ndarray]:
    """Every rank's block of intersections, as one (pairs, 1 + P) int64
    all-gather (the length, then the ids), truncated to the round's
    ``b`` real pairs."""
    if axis is None:
        return inters
    rows = np.zeros((len(inters), 1 + p), np.int64)
    for i, x in enumerate(inters):
        rows[i, 0] = len(x)
        rows[i, 1:1 + len(x)] = x
    with span("align.gather", pairs=len(inters), p=p, shards=axis.size):
        every = all_gather_rows(torch.from_numpy(rows).to(device),
                                axis).cpu().numpy()
    return [every[i, 1:1 + every[i, 0]] for i in range(b)]


def oprf_round(sender_sets: Sequence[np.ndarray],
               receiver_sets: Sequence[np.ndarray],
               seeds: Sequence[Tuple[int, int]], *,
               options: Optional[AlignOptions] = None) -> EngineRound:
    """One MPSI round of OPRF-flavor pairs, batched.

    ``seeds[i]`` is the pair's session key as two u32 words.  Each
    receiver learns intersection(sender_sets[i], receiver_sets[i]).
    ``options`` carries impl/sort/device, and the mesh the pairs shard
    over (module docstring)."""
    options = options or AlignOptions()
    b = len(sender_sets)
    if b == 0:
        return EngineRound([], 0.0, 0)
    device = resolve_device(options.device)
    impl = resolve_impl(options.impl, device)
    sort = _default_sort(options.sort, device)
    axis, n_shards = _batch_axis(options)
    p = next_pow2(max(max((len(s) for s in sender_sets), default=0),
                      max((len(r) for r in receiver_sets), default=0), 1))
    mine = my_rows(b, axis)
    bl = len(mine)
    receivers = [receiver_sets[i] for i in mine]
    s_ids, s_n = _pack([sender_sets[i] for i in mine], p)
    r_ids, r_n = _pack(receivers, p)
    seed_arr = np.asarray(seeds, np.int64).reshape(b, 2)[mine]

    t0 = time.perf_counter()
    if sort == "device":
        with span("align.dispatch", kind="single", pairs=bl, p=p,
                  shards=n_shards):
            to_dev = lambda a: torch.from_numpy(a).to(device)
            sel, cand = _oprf_single(to_dev(r_ids), to_dev(r_n),
                                     to_dev(s_ids), to_dev(s_n),
                                     to_dev(seed_arr), impl)
            sel = sel.cpu().numpy().astype(bool)
            cand = cand.cpu().numpy()
        inters = [np.sort(cand[i][sel[i]]) for i in range(bl)]
        dispatches = 1
    else:
        with span("align.dispatch", kind="prf", pairs=bl, p=p,
                  shards=n_shards):
            tags = prf_tags(
                torch.from_numpy(np.concatenate([r_ids, s_ids])).to(device),
                torch.from_numpy(np.concatenate([seed_arr, seed_arr])
                                 ).to(device),
                impl=impl).cpu().numpy().astype(np.uint64)
        r_tags = [tags[i, :r_n[i]] for i in range(bl)]
        s_tags = [tags[bl + i, :s_n[i]] for i in range(bl)]
        inters = _host_sorted_merge(r_tags, receivers, s_tags, p, device,
                                    impl)
        dispatches = 2
    inters = _gather_intersections(inters, axis, p, b, device)
    return EngineRound(inters, time.perf_counter() - t0, dispatches,
                       shards=n_shards)


def match_round(receiver_tags: Sequence[np.ndarray],
                receiver_ids: Sequence[np.ndarray],
                sender_tags: Sequence[np.ndarray], *,
                options: Optional[AlignOptions] = None) -> EngineRound:
    """One MPSI round of tag-matching pairs (RSA flavor: tags are
    host-computed truncated signatures, already in [0, 2^62)).  Tags
    originate on the host, so sorting is host-side: one merge dispatch.
    ``receiver_ids[i]`` may be any int64 payload aligned with
    ``receiver_tags[i]``; the matched payloads come back sorted.  With
    ``options.mesh`` the pairs shard as ``oprf_round``'s do."""
    options = options or AlignOptions()
    b = len(receiver_tags)
    if b == 0:
        return EngineRound([], 0.0, 0)
    device = resolve_device(options.device)
    impl = resolve_impl(options.impl, device)
    axis, n_shards = _batch_axis(options)
    p = next_pow2(max(max((len(t) for t in receiver_tags), default=0),
                      max((len(t) for t in sender_tags), default=0), 1))
    mine = my_rows(b, axis)
    t0 = time.perf_counter()
    r_tags = [np.asarray(receiver_tags[i], np.int64).astype(np.uint64)
              for i in mine]
    s_tags = [np.asarray(sender_tags[i], np.int64).astype(np.uint64)
              for i in mine]
    inters = _host_sorted_merge(r_tags, [receiver_ids[i] for i in mine],
                                s_tags, p, device, impl)
    inters = _gather_intersections(inters, axis, p, b, device)
    return EngineRound(inters, time.perf_counter() - t0, 1,
                       shards=n_shards)


def union_merge(a_tags64: np.ndarray, b_tags64: np.ndarray, *,
                options: Optional[AlignOptions] = None) -> np.ndarray:
    """Sorted union of two sorted u64 tag arrays (< 2^62) through the
    merge kernel: the delta-PSI run-compaction primitive.

    One (1, P) pair, side A with origin 1 and side B with origin 0, goes
    through ``sorted_intersect``; the merged FULL keys ``(tag << 1) |
    origin`` come back as u64 with the padding stripped (the pads are
    the only keys with the top bit set, i.e. negative as int64), so the
    caller can resolve same-tag collisions by origin
    (``psi/delta.TagIndex`` uses it as run recency).  Every rank of a
    mesh runs the one pair itself (the shard-axis name is still
    checked)."""
    options = options or AlignOptions()
    _batch_axis(options)
    device = resolve_device(options.device)
    impl = resolve_impl(options.impl, device)
    p = next_pow2(max(len(a_tags64), len(b_tags64), 1))
    a = _host_key_row(np.asarray(a_tags64, np.uint64), 1, PAD_A64, p)
    b = _host_key_row(np.asarray(b_tags64, np.uint64), 0, PAD_B64, p)
    with span("align.dispatch", kind="union", pairs=1, p=p):
        _, _, merged = sorted_intersect(
            torch.from_numpy(a[None]).to(device),
            torch.from_numpy(b[None]).to(device), impl=impl)
        merged = merged[0].cpu().numpy()
    return merged[merged >= 0].astype(np.uint64)
