"""The program's stage spans: torch.profiler ranges named "iyokan.<stage>".

span(stage) is a torch.profiler.record_function range while a profiler
records and a shared no-op context otherwise, so the spans sit on the
profiler's clock (beside the device's kernels in the same trace) and cost a
run that is not profiled one check each (about 0.1 us; an idle
record_function costs about 13 us on the CPU).  No span syncs the device or
changes the execution mode; there is no knob: any torch.profiler run shows
them.  The stages (driver.py and tfhe.py open them):

  frontend.build   Frontend.__init__: design, compile, engine, state
  reset            the reset settle at the start of go()
  cycle            one cycle of go(), tick to the end-of-cycle sync, closed
                   before on_cycle is called
  inputs           tick, reset negation, initial RAM and SDFF values,
                   circular inputs
  gates            a level group's _run: its eager first use, its capture
                   at its second or a replay; at IYOKAN_FUSE_LEVELS=1 one
                   level's gates, NOT gates and copies, eagerly
  mem.level        a memory level's _run (the same)
  mem.cb, mem.rom_read, mem.ram_read
                   the stages of a memory level where it runs eagerly
  ram_write        the RAM write's _run, refresh included (the same)
  graph.capture    a CUDA graph's capture and instantiation
  result_packet    make_result_packet
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "iyokan."
_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(stage: str):
    """The range "iyokan.<stage>" while a profiler records, else a no-op."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(PREFIX + stage)
