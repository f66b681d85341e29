"""Batched homomorphic operations (torch), the gate-bootstrap subset.

Counterpart of iyokan_tpu/crypto/ops.py.  Everything is batched over gates:
the levelized executor evaluates all ready gates of a circuit level in one
call.

Torus representation: torch has no uint32 arithmetic, so lvl0/lvl1 torus
values live in int32 tensors as uint32 bit patterns.  Arithmetic that may
wrap is done in int64 on values in [0, 2^32) and masked (`to_u64`,
`from_u64`); a right shift is only ever taken of such a non-negative int64,
so it is logical, never arithmetic.

Shapes (i32 = int32 bit patterns of u32):
  TLWE lvl0   i32 [..., n+1]
  TLWE lvl1   i32 [..., N+1]
  TRLWE lvl1  i32 [..., 2, N]
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..params import Params
from . import polymul
from .host import EvalKey

MASK32 = 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# uint32 <-> int32 bit patterns
# --------------------------------------------------------------------------- #


def to_u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 value in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def from_u64(v: torch.Tensor) -> torch.Tensor:
    """int64 (any value) -> int32 bit pattern of v mod 2^32."""
    v = v & MASK32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 array -> int32 bit-pattern tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(a, np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy uint32 array (host copy)."""
    return t.detach().cpu().numpy().view(np.uint32)


# --------------------------------------------------------------------------- #
# polynomial rotation / sample extraction
# --------------------------------------------------------------------------- #


def rot_poly(poly: torch.Tensor, r: torch.Tensor, N: int) -> torch.Tensor:
    """X^r * poly mod (X^N + 1), batched.

    poly: i32 [..., N]; r: integer [...] broadcastable against the leading
    dims (one rotation amount per batch row), values in [0, 2N).
    Coefficient k of the result is poly[m] for m = (k - r) mod 2N below N,
    and -poly[m - N] otherwise.
    """
    k = torch.arange(N, device=poly.device)
    m = torch.remainder(k - r.to(torch.int64)[..., None], 2 * N)
    shape = torch.broadcast_shapes(poly.shape, m.shape)
    m = m.expand(shape)
    src = torch.where(m < N, m, m - N)
    v = torch.gather(to_u64(poly).expand(shape), -1, src)
    return from_u64(torch.where(m < N, v, -v))


def sample_extract(trlwe: torch.Tensor, idx: int) -> torch.Tensor:
    """TRLWE [..., 2, N] -> TLWE lvl1 [..., N+1] extracting coefficient idx.

    a'_j = a_{idx-j} (j <= idx), -a_{N+idx-j} (j > idx); b' = b_idx.
    """
    N = trlwe.shape[-1]
    j = torch.arange(N, device=trlwe.device)
    src = torch.remainder(idx - j, N)
    a = to_u64(trlwe[..., 0, :])[..., src]
    a2 = from_u64(torch.where(j > idx, -a, a))
    b = trlwe[..., 1, idx: idx + 1]
    return torch.cat([a2, b], dim=-1)


# --------------------------------------------------------------------------- #
# identity key switch lvl1 -> lvl0
# --------------------------------------------------------------------------- #


def _ks_digits(a: torch.Tensor, t: int, basebit: int) -> torch.Tensor:
    """Signed digits of each 32-bit torus coefficient, int64 [..., t]."""
    base = 1 << basebit
    prec = t * basebit
    off = (1 << (32 - prec - 1)) + sum(
        (base // 2) << (32 - (j + 1) * basebit) for j in range(t)
    )
    xp = (to_u64(a) + (off & MASK32)) & MASK32
    ds = [((xp >> (32 - (j + 1) * basebit)) & (base - 1)) - base // 2
          for j in range(t)]
    return torch.stack(ds, dim=-1)


def keyswitch_10(tlwe1: torch.Tensor, ksk_mat: torch.Tensor,
                 p: Params) -> torch.Tensor:
    """Identity key switch lvl1 -> lvl0 as one dense matmul.

    tlwe1: i32 [..., N+1]; ksk_mat: [N*t, n+1], the i32 key or its float64
    copy (DeviceKeys.ksk_f64).  The i32 bit pattern read as a signed value
    is the centred representative of the key mod 2^32, so one float64
    product of the signed digits against it is exact: |d| <= base/2 = 1
    and |key| <= 2^31 over K = N*t = 16384 rows bound every partial sum by
    2^14 * 2^31 = 2^45 < 2^53.  The sum is reduced mod 2^32 after the
    product.  (No TF32 or bf16 anywhere: float64 is never downcast.)
    """
    a = tlwe1[..., : p.N]
    b = tlwe1[..., p.N]
    d = _ks_digits(a, p.ks_t, p.ks_basebit)
    d = d.reshape(*d.shape[:-2], p.N * p.ks_t)
    key = ksk_mat if ksk_mat.dtype == torch.float64 else ksk_mat.to(
        torch.float64)
    acc = torch.matmul(d.to(torch.float64), key).to(torch.int64)
    out = -acc
    out[..., p.n] += to_u64(b)
    return from_u64(out)


# --------------------------------------------------------------------------- #
# blind rotation (lvl1) and the batched gate bootstrap
# --------------------------------------------------------------------------- #


def _modswitch(x: torch.Tensor, log2n: int) -> torch.Tensor:
    """i32 torus -> Z_{2N} with rounding, int32."""
    sh = 32 - log2n - 1
    v = ((to_u64(x) + (1 << (sh - 1))) & MASK32) >> sh
    return (v & ((1 << (log2n + 1)) - 1)).to(torch.int32)


def blind_rotate(tlwe0: torch.Tensor, bk_prep: torch.Tensor,
                 testv: torch.Tensor, p: Params) -> torch.Tensor:
    """Batched blind rotation lvl0 -> TRLWE lvl1: i32 [G, 2, N] with phase
    testv * X^{-phase_2N}.  Only the fat Toeplitz-slab key is ported, so
    this always routes to the tkey kernel (ops/tkey.py), which rejects any
    other key layout."""
    from ..ops.tkey import blind_rotate_tkey

    return blind_rotate_tkey(tlwe0, bk_prep, testv, p)


def gate_bootstrap_tlwe1(pre: torch.Tensor, bk_prep: torch.Tensor,
                         p: Params) -> torch.Tensor:
    """pre-linear-combined TLWE lvl0 batch -> TLWE lvl1 (+-mu) batch."""
    testv = torch.full((p.N,), p.mu, dtype=torch.int32, device=pre.device)
    acc = blind_rotate(pre, bk_prep, testv, p)
    return sample_extract(acc, 0)


# --------------------------------------------------------------------------- #
# device-resident keys
# --------------------------------------------------------------------------- #


def tkey_default_config(p: Params):
    """The tkey-kernel config: (limbs, layout, lb) -- L=3 key limbs, fat
    layout, asymmetric gadget with lb = min(2, l) b-part digits (the JAX
    package's TPU default, iyokan_tpu/crypto/ops.py:tkey_default_config,
    whose noise budget tests/test_noise_and_params.py asserts)."""
    return 3, "fat", min(2, p.l)


def default_device() -> torch.device:
    """The card when one is present, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False (no CPU fallback for a CUDA request)")
    return device


@dataclasses.dataclass
class DeviceKeys:
    """Evaluation key prepared for the runtime ops on one device.

    bk_tk    int8 [n, (l+lb)*N, 2*L*128]  fat Toeplitz slab (tkey_kernel_key)
    ksk_mat  i32  [N*t, n+1]              identity key-switch key
    ksk_f64  f64  [N*t, n+1]              ksk_mat as centred float64
    """

    params: Params
    device: torch.device
    bk_tk: torch.Tensor
    ksk_mat: torch.Tensor
    ksk_f64: torch.Tensor

    @staticmethod
    def from_evalkey(ek: EvalKey, device) -> "DeviceKeys":
        """Carry the numpy EvalKey (the same object and file in both
        packages) to `device` as the port's tensors.  Circuit-bootstrapping
        material, if present, is not used: CMUX memories are not ported."""
        device = check_device(device)
        p = ek.params
        L, lay, lb = tkey_default_config(p)
        src = ek.bk
        if L < 4 and np.any(src[:2, :, 0, :] & ((1 << (8 * (4 - L))) - 1)):
            # host.genevalkey quantizes bk masks to the 256-grid so the
            # truncated slab is exact on the mask component; a key with
            # full-torus masks rides this kernel with ~2^-6 phase noise --
            # enough to corrupt cascaded gates.
            warnings.warn(
                "eval key has unquantized bootstrapping-key masks: the "
                f"{L}-limb Toeplitz-slab kernel adds ~2^-6 phase noise "
                "on such keys. Regenerate the eval key (host.genevalkey "
                "quantizes masks by default).")
        slab = polymul.tkey_kernel_key(src, p, L, lay, lb=lb)
        bk_tk = torch.from_numpy(slab).to(device)
        del slab
        ksk_mat = u32_tensor(ek.ksk.reshape(p.N * p.ks_t, p.n + 1), device)
        return DeviceKeys(p, device, bk_tk, ksk_mat,
                          ksk_mat.to(torch.float64))


# --------------------------------------------------------------------------- #
# batched homomorphic gates
# --------------------------------------------------------------------------- #


def gate_linear(A: torch.Tensor, B: torch.Tensor, ca: torch.Tensor,
                cb: torch.Tensor, kmu: torch.Tensor,
                p: Params) -> torch.Tensor:
    """pre = ca*A + cb*B + k*mu per row (mod 2^32); coefficients int [G].
    Products are taken in int64 (XOR's coefficient 2 would overflow int32)."""
    pre = (to_u64(A) * ca.to(torch.int64)[:, None]
           + to_u64(B) * cb.to(torch.int64)[:, None])
    pre[:, p.n] += kmu.to(torch.int64) * p.mu
    return from_u64(pre)


def hom_not(c: torch.Tensor) -> torch.Tensor:
    """NOT: torus negation, no bootstrap (reference HomNOT)."""
    return from_u64(-to_u64(c))
