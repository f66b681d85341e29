"""Gate/node kind enumeration shared by the circuit compiler and both engines.

The 12 gate kinds are exactly the reference's gate-construction surface
(reference src/iyokan.hpp:1270-1282 DEFINE_GATE list); the remaining kinds are
the structural node types of the levelized executor.
"""

from __future__ import annotations

AND = 0
NAND = 1
ANDNOT = 2
OR = 3
NOR = 4
ORNOT = 5
XOR = 6
XNOR = 7
MUX = 8
NOT = 9
CONSTONE = 10
CONSTZERO = 11
# structural kinds
DFF = 12
SDFF0 = 13
SDFF1 = 14
WIRE = 15      # INPUT / OUTPUT / ROM-cell buffer (0 or 1 input)
ROMREAD = 16   # one output bit of a built-in CMUX ROM
RAMREAD = 17   # one output bit of a built-in CMUX RAM

NAMES = [
    "AND", "NAND", "ANDNOT", "OR", "NOR", "ORNOT", "XOR", "XNOR", "MUX",
    "NOT", "CONSTONE", "CONSTZERO", "DFF", "SDFF0", "SDFF1", "WIRE",
    "ROMREAD", "RAMREAD",
]

BINARY_KINDS = (AND, NAND, ANDNOT, OR, NOR, ORNOT, XOR, XNOR)

# TFHE linear pre-bootstrap combination for each 2-input gate:
#   phase = ca * c_a + cb * c_b + k * mu  (mu = 1/8 torus), then one blind
# rotation decides the sign.  Matches CGGI gate equations as used by the
# reference's TFHEpp gate set (reference src/iyokan_tfhepp.hpp:109-146).
#                      ca  cb   k
GATE_LIN = {
    AND:    (1,  1, -1),
    NAND:   (-1, -1, 1),
    ANDNOT: (1, -1, -1),
    OR:     (1,  1,  1),
    NOR:    (-1, -1, -1),
    ORNOT:  (1, -1,  1),
    XOR:    (2,  2,  2),
    XNOR:   (-2, -2, -2),
}
