"""iyokan_tpu_torch: the PyTorch + CUDA port of the iyokan-tpu TFHE engine.

The JAX package `iyokan_tpu` is the reference; this package keeps its module
names so each counterpart is easy to find, and runs the encrypted gate path
and the CMUX ROM/RAM memories on an NVIDIA Hopper card:

  crypto   -- params, host keygen/enc (numpy, file-compatible with the JAX
              package), the two-prime NTT and CRT64 external products,
              batched torch ops: modswitch, sample extract, key switch, gate
              linear combination, gate bootstrap, lvl1 CMUX, circuit
              bootstrapping (lvl2 blind rotation, private key switch).
  circuit  -- netlist readers, blueprint TOML, MUX ROM/RAM synthesis,
              levelizing compiler (numpy, shared semantics).
  ops      -- the hand-written CUDA kernels (csrc/): the tkey blind rotation
              and the lvl1 NTT external product, each with its plain torch
              twin, built by nvcc at first use (ops/nvcc.py).
  engine   -- plain + TFHE levelized executors and the per-cycle frontend.
  cli      -- `iyokan` / `iyokan-packet` equivalents
              (python -m iyokan_tpu_torch.cli.iyokan_cli ...).

Torus values of lvl0/lvl1 live in int32 tensors as uint32 bit patterns and
lvl2 values in int64 tensors as uint64 bit patterns (torch has no unsigned
32/64-bit arithmetic); numpy crossings use .view(np.uint32 / np.uint64).
Not yet ported: level fusion / CUDA graphs, the bench and multi-GPU
execution.
"""

__version__ = "0.1.0"
