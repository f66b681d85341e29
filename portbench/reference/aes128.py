"""AES-128 encryption as NIST FIPS-197 defines it, in plain Python and
torch integers: the benchmark's own reading of the cipher, written from the
standard apart from the circuit that tests/data/gen_aes.py builds and from
the program under test (it imports neither).

The S-box is computed from its definition (FIPS-197 Sec. 5.1.1): the
multiplicative inverse in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1 (0 maps
to 0), then the affine map b'_i = b_i ^ b_(i+4) ^ b_(i+5) ^ b_(i+6) ^
b_(i+7) ^ c_i (indices mod 8, c = 0x63).  The rounds are Sec. 5.1's,
the key expansion Sec. 5.2's.  `rounds` below 10 gives the reduced-round
cipher: the key expanded to round key `rounds`, rounds 1 .. rounds-1 full
and round `rounds` the final one, without MixColumns.

Bit order of the circuit's 128-bit ports: bit 8i + j is bit b_j (the
coefficient of x^j) of byte in_i of the block or key (bits, block).
"""

from __future__ import annotations

import functools

import torch

RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def gf_mul(a: int, b: int) -> int:
    """a * b in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1."""
    p = 0
    for _ in range(8):
        if b & 1:
            p ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
    return p


def gf_inv(a: int) -> int:
    """The multiplicative inverse, a^254; 0 for 0."""
    r, x, e = 1, a, 254
    while e:
        if e & 1:
            r = gf_mul(r, x)
        x = gf_mul(x, x)
        e >>= 1
    return r


def sbox() -> list:
    """The 256 entries of SubBytes' table, from the definition."""
    out = []
    for a in range(256):
        b = gf_inv(a)
        out.append(sum((((b >> i) ^ (b >> (i + 4) % 8) ^ (b >> (i + 5) % 8)
                         ^ (b >> (i + 6) % 8) ^ (b >> (i + 7) % 8)
                         ^ (0x63 >> i)) & 1) << i for i in range(8)))
    return out


@functools.cache
def _table() -> torch.Tensor:
    return torch.tensor(sbox(), dtype=torch.int64)


def _xtime(x: torch.Tensor) -> torch.Tensor:
    return ((x << 1) & 0xFF) ^ ((x >> 7) * 0x1B)


def round_keys(keys: torch.Tensor, rounds: int = 10) -> torch.Tensor:
    """int64 [B, rounds + 1, 16]: round keys 0 .. rounds of the keys
    int64 [B, 16] (Sec. 5.2)."""
    s = _table()
    w = [keys[:, 4 * i: 4 * i + 4] for i in range(4)]
    for i in range(4, 4 * (rounds + 1)):
        temp = w[i - 1]
        if i % 4 == 0:
            temp = s[torch.roll(temp, -1, dims=1)]          # SubWord(RotWord)
            temp = temp ^ torch.tensor([RCON[i // 4 - 1], 0, 0, 0])
        w.append(w[i - 4] ^ temp)
    return torch.stack([torch.cat(w[4 * r: 4 * r + 4], dim=1)
                        for r in range(rounds + 1)], dim=1)


# ShiftRows: new byte r + 4c takes old byte r + 4((c + r) mod 4)
_SHIFT = [r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)]


def encrypt_blocks(keys, blocks, rounds: int = 10) -> torch.Tensor:
    """Ciphertexts uint8 [B, 16] of the blocks under the keys, each a
    [B, 16] array of bytes in_0 .. in_15."""
    if not 1 <= rounds <= 10:
        raise ValueError(f"rounds must be 1 .. 10, not {rounds}")
    keys = torch.as_tensor(keys).to(torch.int64)
    state = torch.as_tensor(blocks).to(torch.int64)
    rk = round_keys(keys, rounds)
    s = _table()
    state = state ^ rk[:, 0]
    for r in range(1, rounds + 1):
        state = s[state][:, _SHIFT]
        if r < rounds:
            cols = state.reshape(-1, 4, 4)                   # [B, c, row]
            rot = torch.roll(cols, -1, dims=2)               # a_(row+1)
            t = cols[..., :1] ^ cols[..., 1:2] ^ cols[..., 2:3] ^ cols[..., 3:]
            state = (cols ^ t ^ _xtime(cols ^ rot)).reshape(-1, 16)
        state = state ^ rk[:, r]
    return state.to(torch.uint8)


def encrypt(key: bytes, block: bytes, rounds: int = 10) -> bytes:
    """One block."""
    out = encrypt_blocks(torch.tensor([list(key)]),
                         torch.tensor([list(block)]), rounds)
    return bytes(out[0].tolist())


def bits(blocks) -> torch.Tensor:
    """uint8 [B, 128] port bits of the blocks uint8 [B, 16]: bit 8i + j is
    bit j of byte i."""
    b = torch.as_tensor(blocks).to(torch.int64)
    return ((b[:, :, None] >> torch.arange(8)) & 1).reshape(
        b.shape[0], 128).to(torch.uint8)


def block(port_bits) -> torch.Tensor:
    """uint8 [B, 16] blocks of port bits uint8 [B, 128]."""
    b = torch.as_tensor(port_bits).to(torch.int64).reshape(-1, 16, 8)
    return (b << torch.arange(8)).sum(dim=2).to(torch.uint8)
