"""Additively homomorphic encryption (Paillier) — protocol-fidelity layer.

The paper uses TenSEAL (CKKS) to encrypt (a) the final aligned-ID list
relayed through the aggregation server (Tree-MPSI step 5) and (b) the
per-sample (weight, cluster-index, distance) tuples sent to the label owner
(Cluster-Coreset step 3). Neither is a throughput-critical path, and CKKS
has no TPU analogue, so we implement a compact additive Paillier on host
with *packed* fixed-point payloads (one ciphertext per sample tuple). Key
size defaults to 512-bit modulus — a FIDELITY STUB documented in DESIGN.md,
not a security or performance claim.

enc(m) = (1 + m·n) · r^n  mod n²       (g = n+1 simplification)
dec(c) = L(c^λ mod n²) · μ mod n,  L(x) = (x-1)/n
"""
from __future__ import annotations

import dataclasses
import math
import secrets
from typing import Iterable, List, Sequence, Tuple

# deterministic small-prime pool is NOT used; we generate probable primes.


def _is_probable_prime(n: int, rounds: int = 16) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _gen_prime(bits: int, rng: secrets.SystemRandom) -> int:
    while True:
        cand = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(cand):
            return cand


@dataclasses.dataclass(frozen=True)
class PublicKey:
    n: int
    n_sq: int

    @property
    def bits(self) -> int:
        return self.n.bit_length()

    def ciphertext_bytes(self) -> int:
        return (self.n_sq.bit_length() + 7) // 8


@dataclasses.dataclass(frozen=True)
class PrivateKey:
    lam: int
    mu: int
    n: int
    n_sq: int


def keygen(bits: int = 512, *, seed: int | None = None
           ) -> Tuple[PublicKey, PrivateKey]:
    if seed is not None:
        import random
        rng = random.Random(seed)  # deterministic keys for tests only
    else:
        rng = secrets.SystemRandom()
    half = bits // 2
    while True:
        p = _gen_prime(half, rng)
        q = _gen_prime(half, rng)
        if p != q:
            n = p * q
            if n.bit_length() >= bits - 1:
                break
    lam = (p - 1) * (q - 1) // math.gcd(p - 1, q - 1)
    n_sq = n * n
    # mu = L(g^lam mod n^2)^-1 mod n, with g = n+1 → g^lam = 1 + lam·n (mod n²)
    l_val = (pow(n + 1, lam, n_sq) - 1) // n
    mu = pow(l_val, -1, n)
    return PublicKey(n, n_sq), PrivateKey(lam, mu, n, n_sq)


def encrypt(pk: PublicKey, m: int) -> int:
    assert 0 <= m < pk.n, "plaintext out of range"
    r = secrets.randbelow(pk.n - 2) + 1
    return ((1 + m * pk.n) % pk.n_sq) * pow(r, pk.n, pk.n_sq) % pk.n_sq


def decrypt(sk: PrivateKey, c: int) -> int:
    l_val = (pow(c, sk.lam, sk.n_sq) - 1) // sk.n
    return l_val * sk.mu % sk.n


def add_cipher(pk: PublicKey, c1: int, c2: int) -> int:
    """E(m1) ⊕ E(m2) = E(m1 + m2)."""
    return c1 * c2 % pk.n_sq


def mul_plain(pk: PublicKey, c: int, k: int) -> int:
    """E(m) ⊗ k = E(k·m)."""
    return pow(c, k, pk.n_sq)


# ------------------------------------------------------- fixed-point packing

FP_SCALE = 1 << 20          # 20 fractional bits
FIELD_BITS = 44             # per packed field (valueble up to ~2^23 integer)
FIELD_MASK = (1 << FIELD_BITS) - 1


def pack_fields(values: Sequence[float], *, scale: int = FP_SCALE) -> int:
    """Pack small non-negative fixed-point values into one plaintext int."""
    out = 0
    for i, v in enumerate(values):
        iv = int(round(v * scale))
        assert 0 <= iv <= FIELD_MASK, (v, iv)
        out |= iv << (i * FIELD_BITS)
    return out


def unpack_fields(m: int, k: int, *, scale: int = FP_SCALE) -> List[float]:
    return [((m >> (i * FIELD_BITS)) & FIELD_MASK) / scale for i in range(k)]


def encrypt_tuple(pk: PublicKey, values: Sequence[float]) -> int:
    return encrypt(pk, pack_fields(values))


def decrypt_tuple(sk: PrivateKey, c: int, k: int) -> List[float]:
    return unpack_fields(decrypt(sk, c), k)


def encrypt_ids(pk: PublicKey, ids: Iterable[int]) -> List[int]:
    return [encrypt(pk, int(i)) for i in ids]


def decrypt_ids(sk: PrivateKey, cs: Iterable[int]) -> List[int]:
    return [decrypt(sk, c) for c in cs]
