"""Two-party PSI (TPSI) primitives — RSA blind signature and OPRF/OT flavors.

Both protocols keep their *sequential* crypto on host (RSA bigint
signing is integer work, not MXU work — see DESIGN.md §3) with
*byte-level communication accounting* so the MPSI schedulers above them
can reproduce the paper's cost model:

  RSA flavor: receiver blinds + unblinds (transmits twice: the blinded set
  up, and implicitly holds the result), sender signs once and ships its own
  signature set — worst case O(2·|recv| + |send|) transmitted elements.
  → volume-aware role choice: SMALLER party should be receiver (paper §4.1).

  OPRF/OT flavor: the sender evaluates the PRF over its whole set and ships
  it — O(|send|) dominates. → LARGER party should be receiver (sender =
  smaller side ships less).

Backends: every protocol takes ``options.psi_backend="host"|"device"``.
``host`` runs the per-element hashlib/dict path end-to-end.  ``device``
routes the data-parallel tail — OPRF tag evaluation and the tag-matching
/ intersection step — through ``repro_torch.psi.engine`` (the CUDA PRF
and merge kernels); RSA bigint signing stays host either way.
Both backends consume the same *canonical* id sets (sorted, deduplicated
— PSI is set intersection; duplicate receiver ids previously leaked
double entries into the RSA intersection and were silently dropped by
the OPRF tag dict) and share the accounting helpers below, so modeled
bytes/messages are identical across backends by construction.

Returned ``TPSIResult`` carries the intersection, per-direction byte counts,
message counts, and measured compute seconds for the schedulers' makespan
simulation.

This is the port's copy of ``repro.core.tpsi``; only the engine it
calls and the option handling (option objects only, no legacy kwargs)
differ.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import random
import secrets
import time
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from repro_torch.config import AlignOptions
from repro_torch.core import he

# --------------------------------------------------------------- accounting

ID_BYTES = 8            # an id on the wire (u64)
HASH_BYTES = 32         # sha-256 digest / PRF tag on the wire
OT_BYTES = 32           # per-receiver-element OT-extension traffic
CUCKOO_HASHES = 3       # sender PRF evaluations per element (KKRT)


@dataclasses.dataclass
class TPSIResult:
    intersection: np.ndarray          # sorted unique ids
    bytes_to_sender: int              # receiver -> sender traffic
    bytes_to_receiver: int            # sender -> receiver traffic
    messages: int
    compute_seconds: float            # measured crypto/device time
    sender_compute_seconds: float
    receiver_compute_seconds: float

    @property
    def total_bytes(self) -> int:
        return self.bytes_to_sender + self.bytes_to_receiver


def canonical_ids(ids: Sequence[int]) -> np.ndarray:
    """PSI operates on *sets*: sorted unique non-negative int64 ids.

    Dedup at protocol entry is what makes duplicate inputs well-defined
    (and identical) in both flavors and both backends."""
    arr = np.unique(np.asarray(ids, np.int64).reshape(-1))
    if arr.size and arr[0] < 0:
        raise ValueError("ids must be non-negative (u63 id space)")
    return arr


def rsa_accounting(n_send: int, n_recv: int, key: "RSAKey"
                   ) -> Tuple[int, int, int]:
    """(bytes_to_sender, bytes_to_receiver, messages) of one RSA TPSI.

    Counted wire protocol:
      1. sender -> receiver : public key (negligible)
      2. receiver -> sender : |R| blinded hashes          (|R| · modbytes)
      3. sender -> receiver : |R| blind signatures        (|R| · modbytes)
                              + |S| hashed own signatures (|S| · HASH_BYTES)
      => receiver-side traffic 2·|R|·modbytes dominates when |R| large —
         hence "smaller party should receive".
    """
    mb = key.modulus_bytes()
    return n_recv * mb, n_recv * mb + n_send * HASH_BYTES, 3


def oprf_accounting(n_send: int, n_recv: int) -> Tuple[int, int, int]:
    """(bytes_to_sender, bytes_to_receiver, messages) of one OPRF TPSI:
    |R| OT-extension up-traffic, h·|S| PRF tags down."""
    return (n_recv * OT_BYTES,
            n_recv * OT_BYTES + n_send * CUCKOO_HASHES * HASH_BYTES, 3)


def _h_to_group(x: int, n: int) -> int:
    d = hashlib.sha256(int(x).to_bytes(8, "little")).digest()
    return int.from_bytes(d, "little") % n


def _h2(x: int) -> bytes:
    return hashlib.sha256(x.to_bytes((x.bit_length() + 7) // 8 or 1,
                                     "little")).digest()


# ------------------------------------------------------------- RSA-blind-sig

@dataclasses.dataclass(frozen=True)
class RSAKey:
    n: int
    e: int
    d: int
    # CRT components (sender-private) — standard 3-4x signing speedup
    p: int = 0
    q: int = 0
    dp: int = 0
    dq: int = 0
    qinv: int = 0

    def modulus_bytes(self) -> int:
        return (self.n.bit_length() + 7) // 8

    def sign(self, x: int) -> int:
        """x^d mod n via CRT when available."""
        if not self.p:
            return pow(x, self.d, self.n)
        mp = pow(x % self.p, self.dp, self.p)
        mq = pow(x % self.q, self.dq, self.q)
        h = (self.qinv * (mp - mq)) % self.p
        return mq + h * self.q


_RSA_E = 65537


def rsa_keygen(bits: int = 512, *, seed: int | None = None) -> RSAKey:
    rng = secrets.SystemRandom() if seed is None else random.Random(seed)
    while True:
        p = he._gen_prime(bits // 2, rng)
        q = he._gen_prime(bits // 2, rng)
        if p == q:
            continue
        n = p * q
        phi = (p - 1) * (q - 1)
        if math.gcd(_RSA_E, phi) == 1:
            d = pow(_RSA_E, -1, phi)
            return RSAKey(n, _RSA_E, d, p=p, q=q,
                          dp=d % (p - 1), dq=d % (q - 1),
                          qinv=pow(q, -1, p))


def rsa_sign_stage(key: RSAKey, sender_ids: np.ndarray,
                   receiver_ids: np.ndarray
                   ) -> Tuple[List[int], List[int], float, float]:
    """Host bigint half of RSA TPSI: blind → sign → unblind.

    Returns (receiver_sigs aligned with receiver_ids, sender_sigs,
    sender_seconds, receiver_seconds).  Backend-independent: the device
    path only replaces the tag *matching* that follows.
    """
    n, e = key.n, key.e

    t0 = time.perf_counter()
    blinds: List[int] = []
    rs: List[int] = []
    for y in receiver_ids:
        r = secrets.randbelow(n - 2) + 2
        rs.append(r)
        blinds.append(_h_to_group(y, n) * pow(r, e, n) % n)
    t_blind = time.perf_counter() - t0

    t0 = time.perf_counter()
    signed_blinds = [key.sign(b) for b in blinds]
    sender_sigs = [key.sign(_h_to_group(x, n)) for x in sender_ids]
    t_sign = time.perf_counter() - t0

    t0 = time.perf_counter()
    receiver_sigs = [sb * pow(r, -1, n) % n
                     for sb, r in zip(signed_blinds, rs)]
    t_unblind = time.perf_counter() - t0

    return receiver_sigs, sender_sigs, t_sign, t_blind + t_unblind


def rsa_match_inputs(receiver_ids: np.ndarray, receiver_sigs: List[int],
                     sender_sigs: List[int]
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Project host signatures into the device engine's 63-bit tag space
    (truncation stands in for the 32-byte hash-compare of the host path;
    the modeled wire tags remain HASH_BYTES wide in the accounting)."""
    from repro_torch.psi.engine import tag_words
    r_tags = np.fromiter((tag_words(s) for s in receiver_sigs),
                         np.int64, count=len(receiver_sigs))
    s_tags = np.fromiter((tag_words(s) for s in sender_sigs),
                         np.int64, count=len(sender_sigs))
    return r_tags, np.asarray(receiver_ids, np.int64), s_tags


def tpsi_rsa(sender_ids: Sequence[int], receiver_ids: Sequence[int], *,
             key: RSAKey | None = None,
             options: AlignOptions | None = None) -> TPSIResult:
    """RSA-blind-signature PSI. The RECEIVER learns the intersection.

    Wire protocol/bytes: see ``rsa_accounting``.  ``options``
    (``repro_torch.config.AlignOptions``) selects the backend:
    ``psi_backend="device"`` keeps the bigint blind/sign/unblind on
    host and routes the signature-tag matching through the batched
    sorted-intersect engine.
    """
    options = options or AlignOptions()
    key = key or default_rsa_key()
    s_ids = canonical_ids(sender_ids)
    r_ids = canonical_ids(receiver_ids)

    receiver_sigs, sender_sigs, t_sign, t_recv_crypto = rsa_sign_stage(
        key, s_ids, r_ids)

    if options.psi_backend == "device":
        from repro_torch.psi import engine as psi_engine
        r_tags, r_vals, s_tags = rsa_match_inputs(r_ids, receiver_sigs,
                                                  sender_sigs)
        rnd = psi_engine.match_round([r_tags], [r_vals], [s_tags],
                                     options=options)
        inter = rnd.intersections[0]
        t_match = rnd.device_seconds
    else:
        t0 = time.perf_counter()
        sender_tags: Set[bytes] = {_h2(s) for s in sender_sigs}
        inter = np.asarray([int(y) for y, sig in zip(r_ids, receiver_sigs)
                            if _h2(sig) in sender_tags], np.int64)
        t_match = time.perf_counter() - t0

    to_sender, to_receiver, messages = rsa_accounting(
        len(s_ids), len(r_ids), key)
    return TPSIResult(
        intersection=inter,
        bytes_to_sender=to_sender,
        bytes_to_receiver=to_receiver,
        messages=messages,
        compute_seconds=t_sign + t_recv_crypto + t_match,
        sender_compute_seconds=t_sign,
        receiver_compute_seconds=t_recv_crypto + t_match,
    )


# ---------------------------------------------------------------- OPRF / OT

def _oprf(seed_bytes: bytes, x: int) -> bytes:
    return hashlib.sha256(seed_bytes + int(x).to_bytes(8, "little")).digest()


def oprf_session_rng(seed: int | None = None):
    """Session randomness: system entropy by default, reproducible with
    an explicit seed (no more inline ``__import__`` hacks)."""
    return secrets.SystemRandom() if seed is None else random.Random(seed)


def oprf_seed_words(rng) -> Tuple[int, int]:
    """Two u32 session-key words for the device PRF (the OT-extension
    seed agreement itself is only cost-modeled, as on the host path)."""
    return rng.getrandbits(32), rng.getrandbits(32)


def tpsi_oprf(sender_ids: Sequence[int], receiver_ids: Sequence[int], *,
              seed: int | None = None,
              options: AlignOptions | None = None) -> TPSIResult:
    """OPRF(OT-extension)-style PSI (KKRT pattern). The RECEIVER learns the
    intersection.

    The receiver cuckoo-hashes its set (ONE OPRF evaluation per element via
    OT extension), while the sender must ship ``CUCKOO_HASHES`` PRF
    evaluations PER ELEMENT (one per hash function) — the O(h·|send|) term
    that motivates the paper's "larger party should be the receiver" rule:
    the sender's transmission dominates, so the smaller party should send.

    ``options.psi_backend="device"`` evaluates the PRF with the psi_prf
    kernel and intersects with the sorted-merge kernel in one engine
    round; the wire/cost model (OT traffic, h tags per sender element)
    is unchanged.
    """
    options = options or AlignOptions()
    s_ids = canonical_ids(sender_ids)
    r_ids = canonical_ids(receiver_ids)
    rng = oprf_session_rng(seed)

    if options.psi_backend == "device":
        from repro_torch.psi import engine as psi_engine
        rnd = psi_engine.oprf_round([s_ids], [r_ids],
                                    [oprf_seed_words(rng)],
                                    options=options)
        inter = rnd.intersections[0]
        # one joint dispatch evaluates both parties' tags: split evenly
        t_send = t_recv = rnd.device_seconds / 2.0
    else:
        seed_bytes = rng.getrandbits(256).to_bytes(32, "little")

        t0 = time.perf_counter()
        recv_tags: Dict[bytes, int] = {_oprf(seed_bytes, y): int(y)
                                       for y in r_ids}
        t_recv = time.perf_counter() - t0

        t0 = time.perf_counter()
        # sender evaluates the PRF under each cuckoo hash position; with a
        # shared seed the matching tag is the position-0 one, the rest are
        # decoys the receiver discards (cost-faithful, result-identical)
        sender_tags = [_oprf(seed_bytes, x) for x in s_ids]
        _decoys = [_oprf(seed_bytes + bytes([h]), x)
                   for h in range(1, CUCKOO_HASHES) for x in s_ids]
        t_send = time.perf_counter() - t0

        t0 = time.perf_counter()
        inter = np.asarray(sorted(recv_tags[t] for t in sender_tags
                                  if t in recv_tags), np.int64)
        t_recv += time.perf_counter() - t0

    to_sender, to_receiver, messages = oprf_accounting(len(s_ids),
                                                       len(r_ids))
    return TPSIResult(
        intersection=inter,
        bytes_to_sender=to_sender,
        bytes_to_receiver=to_receiver,
        messages=messages,
        compute_seconds=t_recv + t_send,
        sender_compute_seconds=t_send,
        receiver_compute_seconds=t_recv,
    )


PROTOCOLS = {"rsa": tpsi_rsa, "oprf": tpsi_oprf}

# a module-level default key so benchmarks don't re-keygen per pair; tests
# may pass their own. Generated lazily to keep import fast.
_DEFAULT_RSA_KEY: RSAKey | None = None


def default_rsa_key() -> RSAKey:
    global _DEFAULT_RSA_KEY
    if _DEFAULT_RSA_KEY is None:
        _DEFAULT_RSA_KEY = rsa_keygen(512, seed=0xC0FFEE)
    return _DEFAULT_RSA_KEY


def run_tpsi(protocol: str, sender_ids, receiver_ids, **kw) -> TPSIResult:
    if protocol == "rsa" and "key" not in kw:
        kw["key"] = default_rsa_key()
    return PROTOCOLS[protocol](sender_ids, receiver_ids, **kw)
