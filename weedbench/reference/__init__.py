"""The benchmark's plain reference: GF(2^8) Reed-Solomon, CRC32C, the
needle record layout and the stripe map, in NumPy and the standard
library alone.

Frozen copies of the arithmetic the system under test implements: the
field x^8+x^4+x^3+x^2+1 (0x11D) with generator 2, the systematic
Vandermonde encode matrix (klauspost/reedsolomon's buildMatrix), CRC32C
(Castagnoli, reflected), SeaweedFS's version-3 needle record and its EC
stripe map (ec_locate.go). Nothing here imports the program, so a change
to the program cannot move the yardstick.
"""
