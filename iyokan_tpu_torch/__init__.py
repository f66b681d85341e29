"""iyokan_tpu_torch: the PyTorch + CUDA port of the iyokan-tpu TFHE engine.

The JAX package `iyokan_tpu` is the reference; this package keeps its module
names so each counterpart is easy to find, and runs the encrypted gate path
on an NVIDIA Hopper card:

  crypto   -- params, host keygen/enc (numpy, file-compatible with the JAX
              package), batched torch ops: modswitch, sample extract, key
              switch, gate linear combination, gate bootstrap.
  circuit  -- netlist readers, blueprint TOML, MUX ROM/RAM synthesis,
              levelizing compiler (numpy, shared semantics).
  ops      -- the hand-written CUDA blind-rotation kernel (csrc/) and its
              plain torch twin.
  engine   -- plain + TFHE levelized executors and the per-cycle frontend.
  cli      -- `iyokan` / `iyokan-packet` equivalents
              (python -m iyokan_tpu_torch.cli.iyokan_cli ...).

Torus values of lvl0/lvl1 live in int32 tensors as uint32 bit patterns
(torch has no uint32 arithmetic); numpy crossings use .view(np.uint32).
Not yet ported: CMUX ROM/RAM (circuit bootstrapping), level fusion and
multi-GPU execution.
"""

__version__ = "0.1.0"
