"""Whether the timed path's answers are right: the program's ciphertexts,
decrypted with the secret key (reference/tfhe.py), against the plain
evaluator's bits (reference/circuit.py) on the same request.

Two numbers, each beside its limit in the configuration ("limits"):

  wrong_bits      decrypted bits that differ from the reference: every
                  @output bit of every cycle (a long request) or of every
                  request's result packet, and every RAM bit of the result
                  packet (after the last cycle run);
  max_phase_err   the largest distance, over all those ciphertexts, of a
                  phase from the ideal phase (+-1/8 of the torus) of the
                  reference's bit, in sixteenths of the torus: noise that
                  has not yet flipped a bit, so that a path computed at a
                  lower precision than the parameter set states shows
                  before it decrypts wrong.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import tfhe
from portbench.reference.circuit import Run


class Tally:
    def __init__(self, sk):
        self.sk = sk
        self.wrong = 0
        self.max_err = 0.0
        self.attempted = 0
        self.failed = 0

    def _add(self, bits, errs, want):
        wrong = int(np.count_nonzero(bits != np.asarray(want, np.uint8)))
        self.wrong += wrong
        if errs.size:
            self.max_err = max(self.max_err, float(errs.max()))
        return wrong

    def outputs(self, got: dict, want: dict) -> int:
        """@output TLWE rows {name: [w, n+1]} against reference bits."""
        wrong = 0
        for name, bits in want.items():
            b, e = tfhe.bits_and_errors(
                tfhe.tlwe_phase(got[name], self.sk["s0"]), bits)
            wrong += self._add(b, e, bits)
        return wrong

    def rams(self, got: dict, want: dict) -> int:
        """RAM TRLWE rows {name: [words * w, 2, N]} against reference
        bits."""
        wrong = 0
        for name, bits in want.items():
            b, e = tfhe.bits_and_errors(
                tfhe.trlwe_phase0(got[name], self.sk["s1"]), bits)
            wrong += self._add(b, e, bits)
        return wrong

    def unit(self, wrong: int) -> None:
        """One answer (a cycle's outputs, a request's result) judged."""
        self.attempted += 1
        self.failed += int(wrong > 0)

    def numbers(self) -> dict:
        return {"wrong_bits": self.wrong, "max_phase_err": self.max_err}


def judge_long(circ, sk, request, outs, result) -> Tally:
    """A long request: outs[c] the @output rows after cycle c, result the
    result packet after the last cycle."""
    t = Tally(sk)
    run = Run(circ, *request)
    for c, got in enumerate(outs):
        wrong = t.outputs(got, run.step())
        if c == len(outs) - 1:
            # the RAM images after the last cycle are that cycle's answer
            wrong += t.rams(result["ram"], run.ram)
        t.unit(wrong)
    return t


def judge_requests(circ, sk, pool, cycles, results) -> Tally:
    """Closed-loop requests: results [(pool index, result packet)]."""
    t = Tally(sk)
    want = {}
    for i, res in results:
        if i not in want:
            run = Run(circ, *pool[i])
            for _ in range(cycles):
                out = run.step()
            want[i] = (out, run.ram)
        out, ram = want[i]
        wrong = t.outputs(res["bits"], out) + t.rams(res["ram"], ram)
        t.unit(wrong)
    return t
