"""Multi-party PSI: Tree-MPSI (the paper, §4.1) + Path/Star baselines.

The host is single-machine, so concurrency is *simulated faithfully*: every
round's wall time is the MAX over its concurrent TPSI pairs (tree), while
path/star serialize where their topology forces it. Network time is modeled
from the counted bytes at a configurable bandwidth/latency (paper cluster:
10 Gbps), and compute time is the *measured* crypto time of each TPSI.

Tree-MPSI (paper steps 1-5):
  1/2. active clients request; scheduler pairs them,
  3.   server tells each client its partner,
  4.   concurrent TPSI per pair — the receiver keeps the intersection and
       stays active for the next round,
  5.   the last holder HE-encrypts the aligned ID list; the server relays it
       to everyone (server never sees plaintext — it has no private key).

Volume-aware scheduling (paper §4.1 "Scheduling optimization"):
  sort active clients by ResLen ascending → pair c_k with c_{k+⌈U/2⌉} →
  RSA: smaller side is receiver; OPRF: larger side is receiver.

Backends: all three schedulers take one ``options=AlignOptions(...)``
object (``repro_torch.config``).  ``psi_backend="host"`` runs every
pair as its own host TPSI session.  ``psi_backend="device"`` hands each
ROUND's concurrent pairs to ``repro_torch.psi.engine`` as ONE padded
batch on the device (tag-eval + sorted-merge intersect) — ⌈log2 m⌉
dispatches for the whole tree; RSA bigint signing stays on host per
pair.  Byte/message/rounds accounting is backend-invariant (both use
tpsi's accounting helpers on the same canonical sets); only the
measured compute seconds change.

This is the port's copy of ``repro.core.mpsi``: the host scheduling and
accounting are the reference's, ``_device_round`` calls the port's
engine.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import AlignOptions
from repro_torch.core import he
from repro_torch.core.tpsi import (ID_BYTES, TPSIResult, canonical_ids,
                             default_rsa_key, oprf_accounting,
                             oprf_seed_words, oprf_session_rng,
                             rsa_accounting, rsa_match_inputs,
                             rsa_sign_stage, run_tpsi)
from repro_torch.obs.metrics import StatsMixin
from repro_torch.obs.trace import span

DEFAULT_BANDWIDTH = 10e9 / 8     # 10 Gbps in bytes/s (paper's cluster)
DEFAULT_LATENCY = 2e-4           # per message


@dataclasses.dataclass
class MPSIStats(StatsMixin):
    """Alignment-stage stats.  ``StatsMixin`` (DESIGN.md §10) provides
    ``to_dict``/``as_row``/``emit`` over the scalar fields (the array
    intersection and per-round lists are skipped by the mixin)."""
    intersection: np.ndarray
    rounds: int
    total_bytes: int
    total_messages: int
    simulated_seconds: float       # makespan: compute + modeled network
    compute_seconds: float         # sum of measured crypto/device time
    per_round_seconds: List[float]
    schedule: List[List[Tuple[int, int]]]   # per round: (sender, receiver)
    device_dispatches: int = 0     # batched engine calls (device backend)


def _net_time(bytes_: int, bandwidth: float, latency: float,
              messages: int = 1) -> float:
    return bytes_ / bandwidth + latency * messages


def _pair_time(res: TPSIResult, bandwidth: float, latency: float) -> float:
    return res.compute_seconds + _net_time(res.total_bytes, bandwidth,
                                           latency, res.messages)


def _broadcast_result(inter: np.ndarray, n_clients: int, *, use_he: bool,
                      bandwidth: float, latency: float
                      ) -> Tuple[int, int, float]:
    """Step 5: holder HE-encrypts [N_align], server relays to all clients.

    Returns (bytes, messages, seconds). With use_he=False we still count the
    relay traffic at ID_BYTES per id (used by baselines for fairness).
    """
    n = len(inter)
    if use_he:
        pk, sk = he.keygen(256, seed=7)  # small key: relay fidelity only
        t0 = time.perf_counter()
        sample = [he.encrypt(pk, int(x) % pk.n) for x in inter[:64]]
        if sample:
            _ = [he.decrypt(sk, c) for c in sample]
        t_he = (time.perf_counter() - t0) * (max(n, 1) / max(len(sample), 1))
        per_id = pk.ciphertext_bytes()
    else:
        t_he, per_id = 0.0, ID_BYTES
    up = n * per_id
    down = n * per_id * n_clients
    secs = t_he + _net_time(up + down, bandwidth, latency, 1 + n_clients)
    return up + down, 1 + n_clients, secs


def _greedy_pairs(order: Sequence[int]) -> Tuple[List[Tuple[int, int]],
                                                 Optional[int]]:
    """Pair k with k+⌈U/2⌉ over an (already sorted) index list."""
    u = len(order)
    half = math.ceil(u / 2)
    pairs = [(order[k], order[k + half]) for k in range(u // 2)]
    passthrough = order[half - 1] if u % 2 else None
    return pairs, passthrough


def _device_round(roles: List[Tuple[int, int]],
                  holdings: Dict[int, np.ndarray],
                  options: AlignOptions, bandwidth: float, latency: float
                  ) -> Tuple[List[np.ndarray], int, int, float, float]:
    """Run one round's concurrent (sender, receiver) pairs as a single
    batched engine round.

    Returns (per-pair intersections, round_bytes, round_messages,
    round_compute_seconds, round_makespan_seconds).  Bytes/messages use
    the same tpsi accounting helpers as the host backend.  The makespan
    model: per-pair host crypto runs concurrently across clients (MAX),
    the batched dispatch is one shared device step (its wall time), and
    network is the MAX pair's modeled transfer — mirroring the host
    backend's max-over-pairs round time.
    """
    from repro_torch.psi import engine as psi_engine

    senders = [holdings[s] for s, _ in roles]
    receivers = [holdings[r] for _, r in roles]
    host_secs: List[float] = []
    net_secs: List[float] = []
    round_bytes = round_msgs = 0

    if options.protocol == "oprf":
        rng = oprf_session_rng()
        seeds = [oprf_seed_words(rng) for _ in roles]
        eng = psi_engine.oprf_round(senders, receivers, seeds,
                                    options=options)
        host_secs = [0.0] * len(roles)
        for s_ids, r_ids in zip(senders, receivers):
            b_s, b_r, msgs = oprf_accounting(len(s_ids), len(r_ids))
            round_bytes += b_s + b_r
            round_msgs += msgs
            net_secs.append(_net_time(b_s + b_r, bandwidth, latency, msgs))
    else:
        key = default_rsa_key()
        r_tags_l, r_vals_l, s_tags_l = [], [], []
        for s_ids, r_ids in zip(senders, receivers):
            t0 = time.perf_counter()
            r_sigs, s_sigs, _, _ = rsa_sign_stage(key, s_ids, r_ids)
            host_secs.append(time.perf_counter() - t0)
            r_tags, r_vals, s_tags = rsa_match_inputs(r_ids, r_sigs, s_sigs)
            r_tags_l.append(r_tags)
            r_vals_l.append(r_vals)
            s_tags_l.append(s_tags)
            b_s, b_r, msgs = rsa_accounting(len(s_ids), len(r_ids), key)
            round_bytes += b_s + b_r
            round_msgs += msgs
            net_secs.append(_net_time(b_s + b_r, bandwidth, latency, msgs))
        eng = psi_engine.match_round(r_tags_l, r_vals_l, s_tags_l,
                                     options=options)

    compute = sum(host_secs) + eng.device_seconds
    makespan = (max(host_secs, default=0.0) + eng.device_seconds
                + max(net_secs, default=0.0))
    return eng.intersections, round_bytes, round_msgs, compute, makespan


def tree_mpsi(id_sets: Sequence[np.ndarray], *,
              volume_aware: bool = True,
              bandwidth: float = DEFAULT_BANDWIDTH,
              latency: float = DEFAULT_LATENCY,
              use_he: bool = True,
              options: AlignOptions | None = None) -> MPSIStats:
    """Tree-MPSI over ``m`` id sets. O(log m) concurrent rounds; with
    ``options.psi_backend="device"``, O(log m) batched engine dispatches
    total."""
    options = options or AlignOptions()
    protocol, backend = options.protocol, options.psi_backend
    m = len(id_sets)
    holdings: Dict[int, np.ndarray] = {i: canonical_ids(s) for i, s in
                                       enumerate(id_sets)}
    active = list(range(m))
    total_bytes = total_msgs = 0
    compute = 0.0
    dispatches = 0
    per_round: List[float] = []
    schedule: List[List[Tuple[int, int]]] = []

    while len(active) > 1:
        if volume_aware:
            order = sorted(active, key=lambda c: len(holdings[c]))
            pairs, passthrough = _greedy_pairs(order)
        else:
            # unoptimized baseline: sequential pairing by request order
            order = list(active)
            pairs = [(order[2 * k], order[2 * k + 1])
                     for k in range(len(order) // 2)]
            passthrough = order[-1] if len(order) % 2 else None
        roles: List[Tuple[int, int]] = []
        for a, b in pairs:
            la, lb = len(holdings[a]), len(holdings[b])
            small, big = (a, b) if la <= lb else (b, a)
            if protocol == "rsa":
                receiver, sender = small, big   # smaller side receives
            else:
                receiver, sender = big, small   # larger side receives
            if not volume_aware:
                # request order: earlier requester is sender (paper step 2)
                sender, receiver = a, b
            roles.append((sender, receiver))

        bytes_before = total_bytes
        with span("align.round", round=len(schedule), pairs=len(roles),
                  topology="tree", protocol=protocol,
                  backend=backend) as round_sp:
            if backend == "device":
                inters, r_bytes, r_msgs, r_compute, r_makespan = \
                    _device_round(roles, holdings, options,
                                  bandwidth, latency)
                for (sender, receiver), inter in zip(roles, inters):
                    holdings[receiver] = inter
                total_bytes += r_bytes
                total_msgs += r_msgs
                compute += r_compute
                dispatches += 1
                per_round.append(r_makespan)
            else:
                round_times: List[float] = []
                for sender, receiver in roles:
                    res = run_tpsi(protocol, holdings[sender],
                                   holdings[receiver])
                    holdings[receiver] = res.intersection
                    total_bytes += res.total_bytes
                    total_msgs += res.messages
                    compute += res.compute_seconds
                    round_times.append(_pair_time(res, bandwidth, latency))
                per_round.append(max(round_times) if round_times else 0.0)
            round_sp.set(comm_bytes=total_bytes - bytes_before,
                         simulated_s=per_round[-1])

        next_active = [receiver for _, receiver in roles]
        if passthrough is not None:
            next_active.append(passthrough)
        active = next_active
        schedule.append(roles)

    inter = holdings[active[0]]
    with span("align.broadcast", n_clients=m, n_align=len(inter),
              use_he=use_he) as bc_sp:
        b_bytes, b_msgs, b_secs = _broadcast_result(
            inter, m, use_he=use_he, bandwidth=bandwidth, latency=latency)
        bc_sp.set(comm_bytes=b_bytes)
    total_bytes += b_bytes
    total_msgs += b_msgs
    per_round.append(b_secs)

    return MPSIStats(
        intersection=inter, rounds=len(schedule),
        total_bytes=total_bytes, total_messages=total_msgs,
        simulated_seconds=sum(per_round), compute_seconds=compute,
        per_round_seconds=per_round, schedule=schedule,
        device_dispatches=dispatches)


def path_mpsi(id_sets: Sequence[np.ndarray], *,
              bandwidth: float = DEFAULT_BANDWIDTH,
              latency: float = DEFAULT_LATENCY,
              use_he: bool = True,
              options: AlignOptions | None = None) -> MPSIStats:
    """Path topology: client i TPSIs with client i+1 — O(m) sequential
    rounds (data-dependent, so the device backend runs one batch-of-one
    dispatch per hop)."""
    options = options or AlignOptions()
    protocol, backend = options.protocol, options.psi_backend
    m = len(id_sets)
    cur = canonical_ids(id_sets[0])
    total_bytes = total_msgs = 0
    compute = 0.0
    per_round: List[float] = []
    schedule: List[List[Tuple[int, int]]] = []
    for i in range(1, m):
        with span("align.round", round=i - 1, pairs=1, topology="path",
                  protocol=protocol, backend=backend) as round_sp:
            res = run_tpsi(protocol, cur, np.asarray(id_sets[i]),
                           options=options)
            round_sp.set(comm_bytes=res.total_bytes)
        cur = res.intersection
        total_bytes += res.total_bytes
        total_msgs += res.messages
        compute += res.compute_seconds
        per_round.append(_pair_time(res, bandwidth, latency))
        schedule.append([(i - 1, i)])
    b_bytes, b_msgs, b_secs = _broadcast_result(
        cur, m, use_he=use_he, bandwidth=bandwidth, latency=latency)
    total_bytes += b_bytes
    total_msgs += b_msgs
    per_round.append(b_secs)
    return MPSIStats(
        intersection=cur, rounds=m - 1, total_bytes=total_bytes,
        total_messages=total_msgs, simulated_seconds=sum(per_round),
        compute_seconds=compute, per_round_seconds=per_round,
        schedule=schedule,
        device_dispatches=(m - 1) if backend == "device" else 0)


def star_mpsi(id_sets: Sequence[np.ndarray], *,
              center: int = 0, bandwidth: float = DEFAULT_BANDWIDTH,
              latency: float = DEFAULT_LATENCY,
              use_he: bool = True,
              options: AlignOptions | None = None) -> MPSIStats:
    """Star topology: the center TPSIs with every other client.

    O(1) logical rounds, but the central server engages the spokes one at a
    time ("the central node runs TPSI separately with each of the remaining
    nodes"): each request/response session is data-dependent (blind → sign →
    unblind), so the makespan sums the FULL pair time of all m-1 sessions —
    the paper's "central bottleneck" critique. All traffic also crosses the
    center's NIC.
    """
    options = options or AlignOptions()
    protocol, backend = options.protocol, options.psi_backend
    m = len(id_sets)
    cur = canonical_ids(id_sets[center])
    total_bytes = total_msgs = 0
    compute = 0.0
    center_busy = 0.0
    schedule: List[List[Tuple[int, int]]] = [[]]
    for i in range(m):
        if i == center:
            continue
        # center acts as receiver (it accumulates the running intersection)
        with span("align.round", round=len(schedule[0]), pairs=1,
                  topology="star", protocol=protocol,
                  backend=backend) as round_sp:
            res = run_tpsi(protocol, np.asarray(id_sets[i]), cur,
                           options=options)
            round_sp.set(comm_bytes=res.total_bytes)
        cur = res.intersection
        total_bytes += res.total_bytes
        total_msgs += res.messages
        compute += res.compute_seconds
        # serialized center session: both sides' (interleaved) crypto plus
        # the session traffic through the center's NIC
        center_busy += _pair_time(res, bandwidth, latency)
        schedule[0].append((i, center))
    b_bytes, b_msgs, b_secs = _broadcast_result(
        cur, m, use_he=use_he, bandwidth=bandwidth, latency=latency)
    total_bytes += b_bytes
    total_msgs += b_msgs
    return MPSIStats(
        intersection=cur, rounds=1, total_bytes=total_bytes,
        total_messages=total_msgs, simulated_seconds=center_busy + b_secs,
        compute_seconds=compute, per_round_seconds=[center_busy, b_secs],
        schedule=schedule,
        device_dispatches=(m - 1) if backend == "device" else 0)


MPSI = {"tree": tree_mpsi, "path": path_mpsi, "star": star_mpsi}
