"""SHA3-256 as NIST FIPS 202 defines it, in plain Python and torch integers:
the benchmark's own reading of the standard, written apart from the circuit
that tests/data/gen_sha3.py builds and from the program under test (it
imports neither).

  * keccak_p(bits, rounds): Keccak-p[b, nr] of Sec. 3.3, the step mappings
    theta, rho, pi, chi and iota of Sec. 3.2 on the state array A[x, y, z]
    (state bit w(5y + x) + z, Sec. 3.1.2), rounds 12 + 2l - nr .. 12 + 2l - 1;
  * sponge(blocks, ...): the state after each absorbed rate block, from the
    all-zero state (Algorithm 8, f = Keccak-p);
  * sha3_256(message): SHA3-256, Sec. 6.1: the message, SHA3's suffix 01 and
    pad10*1 (pad), absorbed 136 bytes at a time, the first 256 bits out.

Bit order (Sec. B.1): bit 8i + j of a bit string is bit j of byte i
(bits, to_bytes).
"""

from __future__ import annotations

import torch

RATE_BYTES = 136                       # SHA3-256: c = 512, r = 1088


def rc(t: int) -> int:
    """rc(t), Algorithm 5."""
    if t % 255 == 0:
        return 1
    r = [1, 0, 0, 0, 0, 0, 0, 0]
    for _ in range(1, t % 255 + 1):
        r = [0] + r
        r[0] ^= r[8]
        r[4] ^= r[8]
        r[5] ^= r[8]
        r[6] ^= r[8]
        r = r[:8]
    return r[0]


def _theta(a):
    c = a[:, 0] ^ a[:, 1] ^ a[:, 2] ^ a[:, 3] ^ a[:, 4]          # [x, z]
    d = torch.roll(c, 1, dims=0) ^ torch.roll(torch.roll(c, -1, dims=0),
                                              1, dims=1)
    return a ^ d[:, None, :]


def _rho(a):
    out = a.clone()
    x, y = 1, 0
    for t in range(24):
        out[x, y] = torch.roll(a[x, y], (t + 1) * (t + 2) // 2)
        x, y = y, (2 * x + 3 * y) % 5
    return out


def _pi(a):
    out = torch.empty_like(a)
    for x in range(5):
        for y in range(5):
            out[x, y] = a[(x + 3 * y) % 5, x]
    return out


def _chi(a):
    return a ^ ((torch.roll(a, -1, dims=0) ^ 1) & torch.roll(a, -2, dims=0))


def _iota(a, ir: int):
    w = a.shape[2]
    rcv = torch.zeros(w, dtype=a.dtype)
    for j in range(w.bit_length()):
        rcv[(1 << j) - 1] = rc(j + 7 * ir)
    out = a.clone()
    out[0, 0] ^= rcv
    return out


def keccak_p(bits, rounds: int = None) -> torch.Tensor:
    """Keccak-p[b, rounds] of a state of b = 25w bits (a 1-d 0/1 tensor in
    string order); rounds defaults to 12 + 2l, Keccak-f[b]."""
    s = torch.as_tensor(bits).to(torch.int64)
    w = s.numel() // 25
    nr = 12 + 2 * (w.bit_length() - 1)
    rounds = nr if rounds is None else rounds
    a = s.reshape(5, 5, w).transpose(0, 1)                     # [x, y, z]
    for ir in range(nr - rounds, nr):
        a = _iota(_chi(_pi(_rho(_theta(a)))), ir)
    return a.transpose(0, 1).reshape(-1).to(torch.uint8)


def sponge(blocks, b: int = 1600, rounds: int = None) -> torch.Tensor:
    """uint8 [n, b]: the state after each of the rate blocks, uint8 [n, r]
    bits each, absorbed from the all-zero state."""
    blocks = torch.as_tensor(blocks).to(torch.uint8)
    r = blocks.shape[1]
    s = torch.zeros(b, dtype=torch.uint8)
    out = []
    for blk in blocks:
        s = keccak_p(torch.cat([s[:r] ^ blk, s[r:]]), rounds)
        out.append(s)
    return torch.stack(out)


def pad(message: bytes) -> list:
    """SHA3-256's padded message, M || 01 || pad10*1, as 136-byte
    blocks."""
    q = RATE_BYTES - len(message) % RATE_BYTES
    tail = bytes([0x86]) if q == 1 else (
        bytes([0x06]) + bytes(q - 2) + bytes([0x80]))
    m = message + tail
    return [m[i: i + RATE_BYTES] for i in range(0, len(m), RATE_BYTES)]


def bits(data) -> torch.Tensor:
    """uint8 [n, 8k] bit strings of byte strings of k bytes each: bit
    8i + j is bit j of byte i."""
    b = torch.tensor([list(d) for d in data], dtype=torch.int64)
    return ((b[:, :, None] >> torch.arange(8)) & 1).reshape(
        b.shape[0], -1).to(torch.uint8)


def to_bytes(bit_rows) -> list:
    """The byte strings of bit strings uint8 [n, 8k]."""
    b = torch.as_tensor(bit_rows).to(torch.int64).reshape(
        len(bit_rows), -1, 8)
    return [bytes(r.tolist()) for r in (b << torch.arange(8)).sum(dim=2)]


def sha3_256(message: bytes) -> bytes:
    states = sponge(bits(pad(message)))
    return to_bytes(states[-1:, :256])[0]
