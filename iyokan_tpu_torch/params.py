"""TFHE parameter sets.

Structure mirrors the levels the reference engine relies on
(reference src/tfhepp_cufhe_wrapper.hpp:6-11 aliases lvl0/lvl1/lvl2 and the
switching levels lvl10 / lvl01 / lvl02 / lvl21):

  lvl0  -- LWE over the 32-bit discretized torus, dimension n.  Every wire of
           the evaluated circuit is one lvl0 TLWE sample.
  lvl1  -- ring-LWE (TRLWE) over Z[X]/(X^N+1), 32-bit torus, k=1.  Gate
           bootstrapping accumulators, ROM/RAM words, TRGSW gadgets.
  lvl2  -- ring-LWE over a 64-bit torus, larger N2.  Only used inside circuit
           bootstrapping, which needs output noise far below 2^-18.

Key-switching layers:
  lvl1 -> lvl0 identity key switch (after every gate bootstrap),
  lvl0 -> lvl1 blind rotate (the gate bootstrap itself, key = ``bk``),
  lvl0 -> lvl2 blind rotate (inside circuit bootstrap, key = ``bk2``),
  lvl2 -> lvl1 private functional key switch (key = ``pksk``).

Unlike TFHEpp's table-based key switches (one key row per digit *value*),
this engine uses *signed-digit scalar* key switches: the decomposition digits
multiply single key rows, which turns both key switches into plain integer
matmuls -- the natural MXU mapping on TPU.  The table below documents the
noise consequences; parameters are chosen so the end-to-end budgets match the
reference's TFHEpp defaults (128-bit: n=635/alpha=2^-15, N=1024/l=3/Bgbit=6/
alpha=2^-25, reference CMakeLists.txt:3,63-66 and src/main.cpp:28-34).

Noise budget sketch for ``CGGI128`` (variances on the [0,1) torus scale):

  blind-rotate key term      n*(k+1)*l*N*(Bg/2)^2*alpha1^2   ~= 2^-18.1
  blind-rotate decomp term   n*(1+N)*eps_g^2, eps_g=2^-19/sqrt(12)
                                                             ~= 2^-20.3
  mod-switch (2N) term       (n/2)*(2^-12)^2/3               ~= 2^-19.3
  identity KS (t=16,b=1)     N*t*E[d^2]*alpha0^2, E[d^2]=1/2 ~= 2^-17.0
  => gate output sigma ~= 2^-8.2; worst-case XOR input scaling (x2 on each
  operand) leaves a ~6.5-sigma margin against the 1/16 decryption threshold,
  the same order as the reference stack.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Params:
    name: str

    # lvl0: LWE over 32-bit torus
    n: int
    alpha: float  # stddev of fresh lvl0 noise, relative to the torus

    # lvl1: TRLWE over 32-bit torus, k = 1
    N: int
    l: int       # gadget length for TRGSW lvl1
    Bgbit: int   # gadget base Bg = 2**Bgbit
    alpha1: float

    # identity key switch lvl1 -> lvl0 (signed digits, scalar rows)
    ks_t: int
    ks_basebit: int

    # lvl2: TRLWE over 64-bit torus (circuit bootstrapping only)
    N2: int
    l2: int
    Bgbit2: int
    alpha2: float

    # private functional key switch lvl2 -> lvl1 (signed digits, scalar rows)
    pks_t: int
    pks_basebit: int
    alpha_pks: float

    # ------------------------------------------------------------------ #
    @property
    def Bg(self) -> int:
        return 1 << self.Bgbit

    @property
    def Bg2(self) -> int:
        return 1 << self.Bgbit2

    @property
    def mu(self) -> int:
        """Gate message amplitude: 1/8 of the 32-bit torus."""
        return 1 << 29

    @property
    def logN(self) -> int:
        return int(math.log2(self.N))

    @property
    def logN2(self) -> int:
        return int(math.log2(self.N2))

    def __post_init__(self):
        assert 1 << self.logN == self.N, "N must be a power of two"
        assert 1 << self.logN2 == self.N2, "N2 must be a power of two"
        # strict <: the rounding-offset terms in decompose1/decompose2 and
        # _ks_digits compute 1 << (31 - l*Bgbit) etc., which would need a
        # negative shift at equality (advisor finding, round 1)
        assert self.l * self.Bgbit < 32, "l*Bgbit must leave a rounding bit"
        assert self.l2 * self.Bgbit2 < 64, "l2*Bgbit2 must leave a rounding bit"
        assert self.ks_t * self.ks_basebit < 32
        assert self.pks_t * self.pks_basebit < 64


# 128-bit security (default), dimension/noise pairs matching the reference's
# TFHEpp 128-bit build (reference CMakeLists.txt:63-66).
CGGI128 = Params(
    name="cggi128",
    n=635, alpha=2.0 ** -15,
    N=1024, l=3, Bgbit=6, alpha1=2.0 ** -25,
    ks_t=16, ks_basebit=1,
    N2=2048, l2=5, Bgbit2=8, alpha2=2.0 ** -44,
    pks_t=10, pks_basebit=3, alpha_pks=2.0 ** -31,
)

# CGGI16 80-bit option (reference CMakeLists.txt:3 `IYOKAN_80BIT_SECURITY`).
# (lvl2 digit base Bgbit2 = 8 keeps gadget digits within int8 for the MXU
# polynomial backend; l2 = 5 preserves the 40-bit decomposition precision.)
CGGI16_80 = Params(
    name="cggi16-80",
    n=500, alpha=2.44e-5,
    N=1024, l=3, Bgbit=7, alpha1=3.73e-9,
    ks_t=16, ks_basebit=1,
    N2=2048, l2=5, Bgbit2=8, alpha2=2.0 ** -44,
    pks_t=10, pks_basebit=3, alpha_pks=2.0 ** -31,
)

# Small, *insecure* parameters for fast functional tests.  Same code paths,
# tiny rings, near-zero noise so truth tables are checked quickly on CPU.
TOY = Params(
    name="toy",
    n=64, alpha=2.0 ** -20,
    N=256, l=3, Bgbit=6, alpha1=2.0 ** -30,
    ks_t=16, ks_basebit=1,
    N2=512, l2=5, Bgbit2=8, alpha2=2.0 ** -50,
    pks_t=10, pks_basebit=3, alpha_pks=2.0 ** -38,
)

PARAM_SETS = {p.name: p for p in (CGGI128, CGGI16_80, TOY)}


def by_name(name: str) -> Params:
    try:
        return PARAM_SETS[name]
    except KeyError:
        raise ValueError(
            f"Unknown parameter set {name!r}; available: {sorted(PARAM_SETS)}"
        ) from None
