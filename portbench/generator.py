"""The one traffic generator: requests of a circuit from a seed.

A traffic file (traffic/<name>.json) holds only parameters:

  kind            "long": one request that runs cycles until the window
                  closes; "closed_loop": one client sending requests of
                  `cycles` cycles back to back, drawn in turn from a pool
                  of `pool` requests made in set-up
  stream_entries  entries of each circular @input stream of a request
  warmup_cycles   cycles (long) run in set-up before the window, at least
  warmup_seconds  seconds (long) of cycles run in set-up before the window,
                  at least: a card that comes out of idle runs slower for
                  its first seconds of load
  warmup          requests (closed_loop) run in set-up before the window
  trace_cycles / trace_requests
                  cycles or requests profiled after the window of a
                  --trace 1 run

The configuration names the pattern of each @input stream under "inputs"
(default "uniform"); ROM and RAM images are uniform random bits.  TFHE
evaluation is data-oblivious, so the values drawn never change the work:
every seed runs the same cycles, requests and sizes.
"""

from __future__ import annotations

import numpy as np


def _values(kind: str, width: int, entries: int, rng) -> np.ndarray:
    """One stream's entries under a pattern:

    uniform          independent words of `width` bits (bits of the
                     word drawn one by one above 62 bits: make_request)
    distinct_revisit fresh distinct words on odd entries, entry 0's word on
                     even ones (so a write on an odd cycle is read back
                     later; memmac's RAM addresses)
    first_and_odd    1 on entry 0 and odd entries, else 0 (memmac's write
                     enables: write, then read back what was written)
    """
    if kind == "uniform":
        return rng.integers(0, 1 << width, entries)
    if kind == "distinct_revisit":
        if entries > 1 << width:
            raise ValueError(f"{entries} distinct words of {width} bits")
        fresh = rng.choice(1 << width, entries, replace=False)
        return np.array([fresh[c] if c % 2 else fresh[0]
                         for c in range(entries)])
    if kind == "first_and_odd":
        return np.array([int(c == 0 or c % 2 == 1) for c in range(entries)])
    raise ValueError(f"unknown stream pattern {kind!r}")


def _bits(values, width: int) -> np.ndarray:
    return np.array([(int(v) >> k) & 1 for v in values
                     for k in range(width)], np.uint8)


def make_request(circ, config: dict, traffic: dict, seed: int, index: int):
    """(rom, ram, streams) of request `index` under `seed`: bit vectors by
    memory and @input name (see reference/circuit.py for their layout)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    rom = {name: rng.integers(0, 2, m["words"] * m["width"], dtype=np.uint8)
           for name, m in sorted(circ.roms.items())}
    ram = {name: rng.integers(0, 2, m["words"] * m["width"], dtype=np.uint8)
           for name, m in sorted(circ.rams.items())}
    patterns = config.get("inputs", {})
    entries = int(traffic["stream_entries"])
    streams = {}
    for name, width in sorted(circ.input_widths().items()):
        if name == "reset":
            continue
        kind = patterns.get(name, "uniform")
        if kind == "uniform" and width > 62:
            # wider than a numpy integer: the word's bits drawn one by one
            streams[name] = rng.integers(0, 2, width * entries,
                                         dtype=np.uint8)
            continue
        streams[name] = _bits(_values(kind, width, entries, rng), width)
    return rom, ram, streams


def encryption_seed(seed: int, index: int) -> int:
    """The seed of request `index`'s encryption noise."""
    return int(np.random.SeedSequence([seed, index, 1]).generate_state(1)[0])
