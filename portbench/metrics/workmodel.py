"""The work a cycle's lvl1 blind rotations need, counted from the circuit
and the parameter set alone, never from the kernel that runs them: a move
of a level from one rotation kernel to another leaves this yardstick as it
is.

A blind rotation of one row takes its lvl0 TLWE through n steps; each step
is one external product of the accumulator (a TRLWE: k + 1 polynomials of
N coefficients) with a TRGSW of the key, whose gadget has l digits:

  * transforms: the (k + 1) l digit polynomials forward and the k + 1
    products back, (k + 1)(l + 1) = 8 transforms of N/2 log2 N butterflies
    at k = 1, l = 3, one multiply a butterfly;
  * products: (k + 1) l digit polynomials times (k + 1) key polynomials,
    N pointwise multiplies each;

so n (8 N/2 log2 N + (k + 1) l (k + 1) N) = n * 53,248 multiplies a row at
cggi128 (n = 635, N = 1024).  They are counted at the card's 32-bit
integer multiply rate of peaks.json: 132 SMs x 64 INT32 lanes x 1.98 GHz
= 16.7e12/s, a rate derived from the data sheet's clocks and lanes, not
a data-sheet figure (one chain of independent IMADs reached 97.6 % of it
on this card).

Bytes: the key once a batch, n (k + 1) l (k + 1) N 32-bit words (31.2 MB
at cggi128), and each row's input (a lvl0 TLWE, n + 1 words) and output
(a TRLWE, (k + 1) N words) once, at the HBM rate of peaks.json.

A batch's bound is the larger of the two times; a cycle's is the sum over
its batches:

  * one batch a gate level: its 2-input gates one row each, its MUX gates
    two (reference/circuit.py: Circuit.level_rows);
  * the RAM write: one batch of 2 W rows (the write-enable MUX of every
    written bit, W the written bits of all RAMs together), then the
    refresh: one batch of the W written rows, or, on a refresh cycle
    (every ram_refresh_period-th cycle of the configuration), one batch of
    every RAM bit.

On a mesh of several cards the model counts card 0's rows: the mesh's own
rule (the program's parallel/mesh.py) splits a batch into equal shards,
one a card, where the rows divide evenly and every card gets at least
SHARD_MIN_ROWS of them (the program's default, which the harness leaves
unset), and otherwise runs it whole on every card.  So a roofline share
stays one card's work over one card's time.
"""

from __future__ import annotations

import math

SHARD_MIN_ROWS = 8


def multiplies_per_row(p: dict) -> int:
    k, l, n, N = p.get("k", 1), p["l"], p["n"], p["N"]
    transforms = (k + 1) * (l + 1) * (N // 2) * int(math.log2(N))
    products = (k + 1) * l * (k + 1) * N
    return n * (transforms + products)


def batch_bytes(p: dict, rows: int) -> int:
    k, l, n, N = p.get("k", 1), p["l"], p["n"], p["N"]
    key = n * (k + 1) * l * (k + 1) * N * 4
    return key + rows * ((n + 1) + (k + 1) * N) * 4


def batch_bound_s(p: dict, peaks: dict, rows: int) -> float:
    t_ops = rows * multiplies_per_row(p) / peaks["int32_multiplies_per_s"]
    t_bytes = batch_bytes(p, rows) / peaks["hbm_bytes_per_s"]
    return max(t_ops, t_bytes)


def card_rows(rows: int, chips: int) -> int:
    """Rows of a batch of `rows` that card 0 runs on a mesh of `chips`
    cards."""
    if chips > 1 and rows % chips == 0 and rows >= chips * SHARD_MIN_ROWS:
        return rows // chips
    return rows


def cycle_batches(circ, refresh: bool, chips: int = 1) -> list:
    """Rows of each lvl1 blind-rotation batch of one cycle that card 0
    runs."""
    batches = list(circ.level_rows())
    if circ.rams:
        W = sum(m["width"] for m in circ.rams.values())
        bits = sum(m["words"] * m["width"] for m in circ.rams.values())
        batches += [2 * W, bits if refresh else W]
    return [card_rows(g, chips) for g in batches]


def cycle_bound_s(circ, p: dict, peaks: dict, refresh: bool,
                  chips: int = 1) -> float:
    return sum(batch_bound_s(p, peaks, g)
               for g in cycle_batches(circ, refresh, chips))
